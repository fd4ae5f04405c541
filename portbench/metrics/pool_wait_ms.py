"""Host milliseconds per traced job in which the sampling pool waits for the
device: the drain before each C_l timing probe (``pool.drain``) and the
blocking fetches of the failure masks (``pool.fetch``)."""
from harness.program import span_ms_per_job


def read(run):
    return span_ms_per_job(run, "pool.drain", "pool.fetch")
