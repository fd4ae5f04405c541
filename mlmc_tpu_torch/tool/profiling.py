"""Profiling helpers (counterpart of ``mlmc_tpu/tool/profiling.py``).

Replaces the reference's statprof context manager
(mlmc/tool/context_statprof.py:8-13) with a ``torch.profiler`` trace of the
host and the CUDA device, plus a wall-time section timer that waits for the
device before it reads the clock. Per-level cost accounting, the C_l of the
allocation formula, lives in the sampling pools (the storages' n_ops).

Spans and counters. The package marks where its host work happens with
``span(name)`` and counts what it repeats with ``count(name, n)``. Both do
nothing but read one flag unless a ``torch.profiler`` records in this
process (``device_trace`` below, or any profiler a caller starts): that is
the one switch. While it records, a span is a host range named
``SPAN_PREFIX + name`` on the profiler's timeline, nested in the span that
encloses it on the same thread; it never waits for the device, and has no
mirror on the device's timeline, so it changes no device reading of the
trace. Each span's calls and host seconds, and each counter, are summed in
memory per name (``spans()``, ``counters()``) until ``reset()``.
"""
import contextlib
import json
import os
import time

import torch
import torch.autograd.profiler as _profiler_state

#: the prefix of every span's name on the profiler's timeline
SPAN_PREFIX = "mlmc."

_OFF = contextlib.nullcontext()
_counters = {}      # name -> count
_span_totals = {}   # name -> [calls, host seconds]


class _Span:
    __slots__ = ("name", "_range", "_t0")

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        # a FUNCTION-scope range: unlike ``record_function`` (a user
        # annotation) the profiler copies it onto no device timeline
        self._range = torch._C._profiler._RecordFunctionFast(SPAN_PREFIX + self.name)
        self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        seconds = time.perf_counter() - self._t0
        self._range.__exit__(*exc)
        total = _span_totals.setdefault(self.name, [0, 0.0])
        total[0] += 1
        total[1] += seconds
        return False


def span(name):
    """A context manager: the span ``name`` while tracing, else nothing."""
    if not _profiler_state._is_profiler_enabled:
        return _OFF
    return _Span(name)


def count(name, n=1):
    """Add ``n`` to the counter ``name`` while tracing."""
    if _profiler_state._is_profiler_enabled:
        _counters[name] = _counters.get(name, 0) + n


def counters():
    """{name: count} since the last ``reset()``."""
    return dict(_counters)


def spans():
    """{name: {"calls": n, "seconds": host seconds}} of the spans closed
    since the last ``reset()``."""
    return {name: {"calls": n, "seconds": s} for name, (n, s) in _span_totals.items()}


def reset():
    _counters.clear()
    _span_totals.clear()


def _synchronize():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def device_trace(log_dir="torch-trace"):
    """Capture a ``torch.profiler`` trace of the host and (where there is
    one) the CUDA device, written to ``log_dir`` as a Chrome/TensorBoard
    trace file, with the spans' and counters' totals of the trace beside
    it (``<trace>.counters.json``); yields the profiler
    (``key_averages()`` summarizes it)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    reset()
    with profile(activities=activities) as prof:
        yield prof
        _synchronize()
    path = os.path.join(log_dir, "trace_%d_%d" % (os.getpid(), time.time_ns()))
    prof.export_chrome_trace(path + ".json")
    with open(path + ".counters.json", "w") as f:
        json.dump({"counters": counters(), "spans": spans()}, f, indent=1)


@contextlib.contextmanager
def section_timer(name="section", results=None):
    """Wall-time a code section, the device's queued work included; append
    (name, seconds) to ``results`` when given, else print it. It waits for
    the device at both edges, so it is not a span: it changes the timing
    of what it wraps."""
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
    (context_statprof.py:8-13): yields a section timer printing on exit.
    Like ``section_timer`` it waits for the device at both edges and is
    not a span."""
    with section_timer("stat_profiler"):
        yield
