"""Readings of the program's own spans and counters over the traced jobs.

The program sums each span's host seconds and each counter while a
``torch.profiler`` records in its process (``mlmc_tpu_torch.tool.profiling``:
``spans()``, ``counters()``). The harness's profiler covers exactly the
traced jobs, so those sums, over the number of traced jobs, are per-job
means. A program without these sums (an older commit) reads as None, as
does a run without a device trace.
"""


def _profiling(run):
    if run.trace is None or not run.traced:
        return None
    try:
        from mlmc_tpu_torch.tool import profiling
    except ImportError:
        return None
    if not (hasattr(profiling, "spans") and hasattr(profiling, "counters")):
        return None
    return profiling


def count_per_job(run, *names):
    """Sum of the named counters per traced job, or None."""
    profiling = _profiling(run)
    if profiling is None:
        return None
    counts = profiling.counters()
    return sum(counts.get(name, 0) for name in names) / len(run.traced)


def span_ms_per_job(run, *names):
    """Host milliseconds in the named spans per traced job, or None."""
    profiling = _profiling(run)
    if profiling is None:
        return None
    totals = profiling.spans()
    seconds = sum(totals[name]["seconds"] for name in names if name in totals)
    return 1e3 * seconds / len(run.traced)
