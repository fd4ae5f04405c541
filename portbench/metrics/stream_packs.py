"""Packings of the (component, level) streams per traced job
(``estimate.packs``: one per call of kernel C or D)."""
from harness.program import count_per_job


def read(run):
    return count_per_job(run, "estimate.packs")
