"""Card 0's device milliseconds per traced job in the NCCL all-reduce
kernels: the collectives of the sample mesh's reduction (the program
launches them under ``mesh.allreduce``, and a job of the sharded cell
launches no other all-reduce). A kernel's time holds the collective itself
and card 0's wait in it for the slowest card."""


def _is_allreduce(name):
    return "nccl" in name.lower() and "AllReduce" in name


def read(run):
    if run.trace is None or not run.traced:
        return None
    seconds = sum(e - s for name, s, e in run.trace.ops if _is_allreduce(name))
    if seconds <= 0:
        return None
    return 1e3 * seconds / len(run.traced)
