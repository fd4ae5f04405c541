"""The pool's synchronous C_l timing probes per traced job (``pool.probes``:
the first and second batch of each fresh (level, cost class) key)."""
from harness.program import count_per_job


def read(run):
    return count_per_job(run, "pool.probes")
