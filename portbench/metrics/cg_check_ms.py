"""Host milliseconds per traced job in the CG's checks of its active mask
(``sim.cg_check``: each waits for the device)."""
from harness.program import span_ms_per_job


def read(run):
    return span_ms_per_job(run, "sim.cg_check")
