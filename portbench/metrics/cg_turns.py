"""Turns of the batched CG loop per traced job (``cg.turns``, summed over
every fine and coarse solve of every batch)."""
from harness.program import count_per_job


def read(run):
    return count_per_job(run, "cg.turns")
