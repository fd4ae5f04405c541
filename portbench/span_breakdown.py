"""Run one cell traced, as run.py does, and also put the traced jobs' idle
device time down to the program's own spans.

    python3 portbench/span_breakdown.py --workload <cell> --seed <n> --seconds <s> [--out FILE]

The result line on standard output is run.py's with ``--trace 1``, unchanged.
The harness's breakdown there knows only the benchmark's spans; this one
also counts as spans the program's host ranges (``mlmc.`` and a name, see
``mlmc_tpu_torch/tool/profiling.py``), so each idle gap goes to the
innermost program span open on the host when it happened. It is written as
one JSON object to FILE (default: the last line of standard error), with
the program's span totals and counters per traced job.
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(1, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from harness.tracing import device_trace  # noqa: E402  (the harness's own)

#: the prefix of the program's span names
PROGRAM_PREFIX = "mlmc."


def program_trace(prof, span_names):
    """A DeviceTrace of ``prof`` in which the program's ranges are spans
    beside the benchmark's ``span_names``."""
    names = set(span_names) | {ev.name for ev in prof.events()
                               if ev.name.startswith(PROGRAM_PREFIX)}
    return device_trace(prof, names)


def idle_by_program_span(trace):
    """(idle seconds in all, of them under a program span, [[span, seconds]]
    of every innermost span, largest first)."""
    gaps = trace.breakdown(top=1 << 30)["idle_gaps"]
    total = sum(s for _, s in gaps)
    program = sum(s for n, s in gaps if n.startswith(PROGRAM_PREFIX))
    return total, program, gaps


def main(argv=None):
    p = argparse.ArgumentParser(add_help=False)
    p.add_argument("--out")
    args, rest = p.parse_known_args(argv)
    import harness.tracing as tracing
    from harness import runner

    kept = {}

    def both(prof, span_names):
        kept["trace"] = program_trace(prof, span_names)
        return device_trace(prof, span_names)

    tracing.device_trace = both
    code = runner.main(rest + ["--trace", "1"])
    if "trace" not in kept:
        return code
    from mlmc_tpu_torch.tool import profiling

    trace = kept["trace"]
    n = sum(1 for name, _, _ in trace.spans if name == "job")
    total, program, gaps = idle_by_program_span(trace)
    out = {"traced_jobs": n, "idle_s": total, "idle_in_program_spans_s": program,
           "idle_gaps": gaps,
           "spans_per_job": {k: {"calls": v["calls"] / n, "ms": 1e3 * v["seconds"] / n}
                             for k, v in sorted(profiling.spans().items())},
           "counters_per_job": {k: v / n for k, v in sorted(profiling.counters().items())}}
    text = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print("program breakdown: " + text, file=sys.stderr)
    return code


if __name__ == "__main__":
    sys.exit(main())
