"""Run one cell of the benchmark of mlmc_tpu_torch on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. See portbench/README.md.
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, for the program under test
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

if __name__ == "__main__":
    from harness.runner import main

    sys.exit(main())
