"""Mean per job of the spans around the estimator's calls (level
variances, their regression and the allocation, the final moments), the
density excluded."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "estimate")
