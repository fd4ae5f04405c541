"""Host milliseconds per traced job from the call of kernel A's launcher to
its launch: block tables, uploads and allocations (``fused.prepare``)."""
from harness.program import span_ms_per_job


def read(run):
    return span_ms_per_job(run, "fused.prepare")
