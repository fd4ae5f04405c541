"""The window over the number of jobs it finished: the time to one
solution of the stated accuracy, or to one processed run."""


def read(run):
    if not run.records:
        return None
    return run.window_s / len(run.records)
