"""Kernels C and D's share of their roofline over the traced jobs: the
least times of the float32 tier (kernel C) and the float64 tier (kernel
D), each from roofline.stream_work over the job's streams with the valid
counts of the reference, over the device time of the operations named
below (the template of both kernels and the reduction of their block
partials)."""
from harness import roofline

PATTERNS = ("samples_gram_kernel", "gram_reduce")


def read(run):
    if run.trace is None or not run.traced or any("work" not in r for r in run.traced):
        return None
    seconds = run.trace.op_seconds(PATTERNS)
    if seconds <= 0:
        return None
    least = 0.0
    for r in run.traced:
        w = r["work"]
        # the two tiers read the same streams and do the same multiply-adds
        least += 2 * roofline.least_seconds(*roofline.stream_work(
            w["counts"], w["has_coarse"], w["n_valid"], w["n_moments"]))[0]
    return 100.0 * least / seconds
