"""Samples drawn and reduced by all the window's jobs over the window."""


def read(run):
    if not run.records:
        return None
    return sum(r["samples"] for r in run.records) / run.window_s
