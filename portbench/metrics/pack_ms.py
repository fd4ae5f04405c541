"""Host milliseconds per traced job spent gathering the quantity's values
per level (``estimate.gather``) and packing them into streams for kernels
C and D (``estimate.pack``)."""
from harness.program import span_ms_per_job


def read(run):
    return span_ms_per_job(run, "estimate.gather", "estimate.pack")
