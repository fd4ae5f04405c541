"""Newton iterations of the maxent density per traced job
(``newton.iterations``, over every round of its panel grid)."""
from harness.program import count_per_job


def read(run):
    return count_per_job(run, "newton.iterations")
