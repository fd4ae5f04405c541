"""Mean per job of the span around ``construct_density_fast``."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "density")
