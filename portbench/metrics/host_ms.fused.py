"""Mean per job of the span from the kernel's end to the estimates on the
host (``accumulators_to_estimates``)."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "estimates")
