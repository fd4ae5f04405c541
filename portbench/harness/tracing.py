"""Spans, counters and the device trace of a traced run.

A span is the benchmark's own mark around one call into a layer of the
program. With tracing off a span costs nothing and waits for nothing. With
tracing on it waits for the device at both edges (so the device work that
the call queued is inside it), adds its seconds to the current job, and
opens a ``torch.profiler.record_function`` of the same name, which places
it on the profiler's timeline beside the device operations.

The profiler (CPU and CUDA activities) covers a fixed number of whole jobs.
Its events are reduced in memory and never written to disk.
"""
import contextlib
import time


class Tracer:
    def __init__(self, torch, device, enabled):
        self.torch = torch
        self.device = device
        self.enabled = bool(enabled)
        self.spans = {}       # name -> seconds, of the current job
        self.counters = {}    # name -> count, of the current job
        self.names = set()    # every span name opened in this run

    def _sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def new_job(self):
        self.spans, self.counters = {}, {}

    @contextlib.contextmanager
    def span(self, name):
        if not self.enabled:
            yield
            return
        self.names.add(name)
        self._sync()
        with self.torch.profiler.record_function(name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._sync()
                self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t0

    def count(self, name, value):
        self.counters[name] = self.counters.get(name, 0) + value


def _union(intervals):
    """Total length and the merged intervals of (start, end) pairs."""
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return sum(e - s for s, e in merged), merged


class DeviceTrace:
    """What the profiler saw over the traced jobs: device operations
    (kernels, copies, fills) as (name, start, end) in seconds, the host
    spans as (name, start, end), and the traced window: the union of the
    traced jobs' own intervals (what the benchmark does between two jobs is
    outside it)."""

    def __init__(self, ops, spans, jobs):
        self.spans = spans
        self.ops = [(name, max(s, js), min(e, je)) for name, s, e in ops
                    for js, je in jobs if e > js and s < je]
        self.busy_s, merged = _union([(s, e) for _, s, e in self.ops])
        self.window_s = sum(e - s for s, e in jobs)
        self._gaps = []
        for js, je in jobs:
            last = js
            for s, e in [m for m in merged if m[1] > js and m[0] < je] + [[je, je]]:
                if s > last:
                    self._gaps.append((last, s))
                last = max(last, e)

    def op_seconds(self, patterns):
        """Device seconds of the operations whose names hold any pattern."""
        return sum(e - s for name, s, e in self.ops
                   if any(p in name for p in patterns))

    def idle_share(self):
        return 1.0 - self.busy_s / self.window_s

    def _host_span(self, t):
        """The innermost benchmark span open on the host at time t."""
        best = None
        for name, s, e in self.spans:
            if s <= t <= e and (best is None or e - s < best[2] - best[1]):
                best = (name, s, e)
        return best[0] if best else "outside spans"

    def breakdown(self, top=10):
        by_op = {}
        for name, s, e in self.ops:
            by_op[name] = by_op.get(name, 0.0) + (e - s)
        by_span = {}
        for s, e in self._gaps:
            span = self._host_span(0.5 * (s + e))
            by_span[span] = by_span.get(span, 0.0) + (e - s)
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v] for n, v in order(by_op)],
                "idle_gaps": [[n, v] for n, v in order(by_span)]}


def device_trace(prof, span_names):
    """Reduce a finished ``torch.profiler.profile`` to a DeviceTrace: the
    device operations, the benchmark's spans, and the intervals of the
    ``job`` spans. ``span_names`` are the names the run's spans were opened
    under (``Tracer.names``), whatever job kind opened them. Times are the
    profiler's, in seconds."""
    from torch.autograd import DeviceType

    ops, spans = [], []
    for ev in prof.events():
        start, end = ev.time_range.start * 1e-6, ev.time_range.end * 1e-6
        if ev.name in span_names:
            # the profiler mirrors a span onto the device's timeline as
            # well; only the host's copy is a span, and neither is an op
            if ev.device_type != DeviceType.CUDA:
                spans.append((ev.name, start, end))
        elif ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, start, end))
    jobs = sorted((s, e) for name, s, e in spans if name == "job")
    if not jobs:
        raise RuntimeError("the profiler recorded no job span")
    return DeviceTrace(ops, spans, jobs)
