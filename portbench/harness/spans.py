"""Readings of the benchmark's spans (harness/tracing.py)."""


def mean_span_ms(run, name):
    """Mean per job, in ms, of the seconds spent in span ``name``, over the
    jobs that opened it; None where none did."""
    values = [r["spans"][name] for r in run.records if name in r["spans"]]
    return 1e3 * sum(values) / len(values) if values else None
