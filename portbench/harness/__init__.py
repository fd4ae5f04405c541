"""The harness of the benchmark: manifest, closed loop, tracing, checks."""
