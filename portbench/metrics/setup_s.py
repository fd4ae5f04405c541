"""Set-up: from the start of the process to the start of the first timed
job (imports, the device, loading or building the kernels, the cell's own
set-up and its warm-up jobs)."""


def read(run):
    return run.setup_s
