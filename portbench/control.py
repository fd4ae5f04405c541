"""Readings for the limits of ``correct``: the program and the control on
many seeds, at a cell's own sizes, in one process.

    python3 portbench/control.py --workload <cell> --seeds 11 12 13 ...

For each seed it runs one job of the cell (the job seed a run with that
--seed gives its first job) and prints one JSON line with two sets of the
numbers the cell compares: the program against the plain reference (the
lower readings of the limits) and the control against the same reference
(the upper readings). The control is the reference computed one step below
each precision the configuration states, put in the program's place. The
benchmark's own runs never run it.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    p.add_argument("--cpu-rehearsal", action="store_true")
    args = p.parse_args()

    from harness.runner import Context, derive_seed, load_cell, open_device
    from harness.tracing import Tracer

    _, entry, config, cell, kind = load_cell(args.root, args.workload)

    import torch

    device = open_device(torch, entry["chips"], args.cpu_rehearsal)
    for seed in args.seeds:
        ctx = Context(torch, device, config, cell, Tracer(torch, device, False), seed)
        job = kind.Job(ctx)
        rec = job.run(derive_seed(seed, 0, 0), True)
        if hasattr(job, "capture"):
            job.capture(rec)
        job.release()
        del job
        out = {"workload": args.workload, "seed": seed,
               "program": kind.check(ctx, [rec], control=False)}
        try:
            out["control"] = kind.check(ctx, [rec], control=True)
        except Exception as exc:  # a control that crashes has failed
            out["control"] = "crashed: %s: %s" % (type(exc).__name__, exc)
        if device.type == "cuda":
            torch.cuda.empty_cache()
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
