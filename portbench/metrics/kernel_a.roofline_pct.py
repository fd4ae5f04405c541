"""Kernel A's share of its roofline over the traced jobs: the least time
of their float64 work (roofline.fused_work of the valid samples of each
level, counted by the reference) over the device time of the operations
named below (the kernel and the reduction of its block partials)."""
from harness import roofline

PATTERNS = ("synth_mlmc_kernel", "gram_reduce")


def read(run):
    if run.trace is None or not run.traced or any("work" not in r for r in run.traced):
        return None
    seconds = run.trace.op_seconds(PATTERNS)
    if seconds <= 0:
        return None
    least = sum(roofline.least_seconds(*roofline.fused_work(
        r["work"]["n_valid"], r["work"]["n_moments"]))[0] for r in run.traced)
    return 100.0 * least / seconds
