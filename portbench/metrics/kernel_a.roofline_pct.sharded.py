"""Kernel A's share of its roofline on card 0 of a sharded run, read as
``kernel_a.roofline_pct`` reads the headline: the least time of the traced
jobs' float64 work over the device time of the kernel and of the reduction
of its block partials. The trace is card 0's alone, so the sharded job
kind counts as each job's ``work`` shard 0's valid samples of each level,
card 0's share, and not the job's."""
from harness.runner import metric_reader

read = metric_reader("kernel_a.roofline_pct").read
