"""Mean per job of the spans around the sampler's requests to the pool
(scheduling, dispatch of the simulation batches, collection)."""
from harness.spans import mean_span_ms


def read(run):
    return mean_span_ms(run, "sampling")
