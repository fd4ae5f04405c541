"""Share of the traced jobs' time (the union of their own intervals) in
which no operation runs on the device: the reader of every ``idle_pct.*``
metric (``idle_pct.fused``, ``idle_pct.stored``), which differ only in the
cells and the end-to-end metric they move."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * run.trace.idle_share()
