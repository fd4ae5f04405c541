"""Profiling helpers (counterpart of ``mlmc_tpu/tool/profiling.py``).

Replaces the reference's statprof context manager
(mlmc/tool/context_statprof.py:8-13) with a ``torch.profiler`` trace of the
host and the CUDA device, plus a wall-time section timer that waits for the
device before it reads the clock. Per-level cost accounting, the C_l of the
allocation formula, lives in the sampling pools (the storages' n_ops).
"""
import contextlib
import os
import time

import torch


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir="torch-trace"):
    """Capture a ``torch.profiler`` trace of the host and (where there is
    one) the CUDA device, written to ``log_dir`` as a Chrome/TensorBoard
    trace file; yields the profiler (``key_averages()`` summarizes it)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, "trace_%d_%d.json" % (os.getpid(), time.time_ns())))


@contextlib.contextmanager
def section_timer(name="section", results=None):
    """Wall-time a code section, the device's queued work included; append
    (name, seconds) to ``results`` when given, else print it."""
    _synchronize()
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _synchronize()
        elapsed = time.perf_counter() - t0
        if results is not None:
            results.append((name, elapsed))
        else:
            print("[{}] {:.4f} s".format(name, elapsed))


@contextlib.contextmanager
def stat_profiler():
    """API-parity alias of the reference's statprof context
    (context_statprof.py:8-13): yields a section timer printing on exit."""
    with section_timer("stat_profiler"):
        yield
