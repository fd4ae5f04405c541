"""A worker of the ``sharded`` job kind: one rank of the group, on its own
device, beside the run's own process (rank 0).

    python3 portbench/jobs/sharded_worker.py --rank R --world W \\
        --address tcp://127.0.0.1:PORT --device cuda:R --parent PID --spec JSON

It joins the group through the program's ``multihost.initialize`` with
its device named, builds ``sharded_synth_pipeline`` over
``global_sample_mesh([device])`` and runs one step for every (seed, go)
that rank 0 broadcasts as one int64 tensor, until a broadcast says stop.
It exits when the process ``--parent`` is gone. On stop it exits non-zero
if a module that may not load in a run (``harness.runner.FORBIDDEN``) was
loaded in its process, as rank 0's run fails then. It prints nothing on
standard output. Rank 0 uses ``join`` and ``make_step`` below too.
"""
import argparse
import json
import os
import sys
import threading
import time

CODE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the checkout's root, for the program under test
sys.path.insert(0, os.path.dirname(CODE_DIR))


def join(rank, world, address, device):
    """Join the group of ``world`` processes as ``rank`` on ``device`` and
    return the global sample mesh."""
    from mlmc_tpu_torch.parallel import multihost

    multihost.initialize(address, num_processes=world, process_id=rank, devices=[device])
    return multihost.global_sample_mesh([device])


def make_step(mesh, spec):
    """The sharded step of a job: ``step(seed)`` -> the accumulators of
    every level, reduced over the mesh."""
    from mlmc_tpu_torch.parallel import sharded_synth_pipeline

    return sharded_synth_pipeline(mesh, int(spec["n_moments"]),
                                  [int(n) for n in spec["n_per_level"]],
                                  [float(h) for h in spec["steps"]],
                                  domain=tuple(spec["domain"]))


def forbidden_loaded():
    """The modules of ``harness.runner.FORBIDDEN`` loaded in this process."""
    if CODE_DIR not in sys.path:
        sys.path.insert(0, CODE_DIR)
    from harness.runner import FORBIDDEN

    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _exit_with(parent):
    while True:
        if os.getppid() != parent:
            os._exit(1)
        time.sleep(0.5)


def main(argv=None):
    p = argparse.ArgumentParser(description="One worker rank of the sharded job kind.")
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--world", type=int, required=True)
    p.add_argument("--address", required=True)
    p.add_argument("--device", required=True)
    p.add_argument("--parent", type=int, required=True)
    p.add_argument("--spec", required=True)
    args = p.parse_args(argv)
    threading.Thread(target=_exit_with, args=(args.parent,), daemon=True).start()

    import torch
    import torch.distributed as dist

    spec = json.loads(args.spec)
    device = torch.device(args.device)
    if device.type == "cpu":
        torch.set_num_threads(1)
    mesh = join(args.rank, args.world, args.address, device)
    try:
        step = make_step(mesh, spec)
        go = torch.zeros(2, dtype=torch.int64, device=device)
        while True:
            dist.broadcast(go, src=0)
            seed, flag = go.tolist()
            if not flag:
                break
            step(seed)
    finally:
        dist.destroy_process_group()
    found = forbidden_loaded()
    if found:
        print("portbench: sharded: rank %d loaded modules that may not load in a run: %s"
              % (args.rank, ", ".join(found)), file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
