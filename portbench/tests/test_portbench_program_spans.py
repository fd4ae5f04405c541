"""The program's own spans and counters, as the benchmark sees them: the
program's host ranges change no device reading of a trace, the readers of
the metrics built on them read the program's sums per traced job (and
nothing without a trace), and ``span_breakdown`` puts idle device time down
to the innermost program span."""
from types import SimpleNamespace

import pytest
import torch
from torch.autograd import DeviceType

from harness.runner import Run, metric_reader
from harness.tracing import device_trace
from span_breakdown import PROGRAM_PREFIX, idle_by_program_span, program_trace

from mlmc_tpu_torch.tool import profiling

#: (metric, the program's names it sums, ms or a count)
READERS = [("pool_wait_ms", ("pool.drain", "pool.fetch"), "ms"),
           ("pool_probes", ("pool.probes",), "count"),
           ("cg_turns", ("cg.turns",), "count"),
           ("cg_check_ms", ("sim.cg_check",), "ms"),
           ("pack_ms", ("estimate.gather", "estimate.pack"), "ms"),
           ("stream_packs", ("estimate.packs",), "count"),
           ("newton_iters", ("newton.iterations",), "count"),
           ("prepare_ms.fused", ("fused.prepare",), "ms")]


def _ev(name, start_us, end_us, device=DeviceType.CPU):
    return SimpleNamespace(name=name, device_type=device,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def _prof(events):
    return SimpleNamespace(events=lambda: events)


#: two jobs: the benchmark's spans (host copies and their device mirrors),
#: kernel A and the template of C and D, their reduction, and a copy
BENCH = [_ev("job", 0, 10000), _ev("kernel", 100, 4000), _ev("kernel", 150, 4100, DeviceType.CUDA),
         _ev("synth_mlmc_kernel<4>", 1000, 3000, DeviceType.CUDA),
         _ev("gram_reduce", 3000, 3300, DeviceType.CUDA),
         _ev("job", 20000, 30000), _ev("estimate", 20100, 29000),
         _ev("estimate", 20150, 29100, DeviceType.CUDA),
         _ev("samples_gram_kernel<1>", 22000, 25000, DeviceType.CUDA),
         _ev("Memcpy DtoH", 26000, 26500, DeviceType.CUDA)]
NAMES = {"job", "kernel", "estimate"}
#: the program's ranges in the same jobs: host ranges only, nested
PROGRAM = [_ev("mlmc.fused.prepare", 50, 900), _ev("mlmc.fused.launch", 900, 1000),
           _ev("mlmc.fused.fetch", 3300, 3400), _ev("mlmc.fused.host", 3400, 9900),
           _ev("mlmc.estimate.gather", 20200, 21900), _ev("mlmc.estimate.pack", 20500, 21500),
           _ev("mlmc.estimate.fetch", 25000, 28000)]


def _run(trace, n_jobs=2, work=None):
    records = [dict(wall=1.0, spans={}, counters={}, samples=1, work=work or {})
               for _ in range(n_jobs)]
    return Run(records, 2.0, 1.0, trace, records)


def test_program_ranges_leave_every_device_reading_as_it_was():
    plain = device_trace(_prof(BENCH), NAMES)
    spanned = device_trace(_prof(BENCH + PROGRAM), NAMES)
    assert spanned.busy_s == plain.busy_s == pytest.approx(5.8e-3)
    assert spanned.window_s == plain.window_s
    assert spanned.idle_share() == plain.idle_share()
    for patterns in (("synth_mlmc_kernel", "gram_reduce"), ("samples_gram_kernel", "gram_reduce")):
        assert spanned.op_seconds(patterns) == plain.op_seconds(patterns)
    assert spanned.breakdown() == plain.breakdown()
    # the metrics that read the device trace
    work = {"n_valid": [10 ** 6, 10 ** 5], "n_moments": 25, "counts": [10 ** 6, 10 ** 5],
            "has_coarse": [False, True]}
    for name in ("idle_pct.fused", "idle_pct.stored", "kernel_a.roofline_pct",
                 "kernel_cd.roofline_pct"):
        reader = metric_reader(name)
        value = reader.read(_run(spanned, work=work))
        assert value is not None and value == reader.read(_run(plain, work=work)), name


def test_idle_gaps_go_to_the_innermost_program_span():
    trace = program_trace(_prof(BENCH + PROGRAM), NAMES)
    assert trace.busy_s == device_trace(_prof(BENCH), NAMES).busy_s
    total, program, gaps = idle_by_program_span(trace)
    # a gap goes whole to the innermost span open at its middle: job 1's
    # launch path before kernel A and the host's arithmetic after it; job
    # 2's packing (inside the gather) before kernel C, the wait for its
    # results, and after the copy the benchmark's span alone
    assert dict(gaps) == {"mlmc.fused.prepare": pytest.approx(1.0e-3),
                          "mlmc.fused.host": pytest.approx(6.7e-3),
                          "mlmc.estimate.pack": pytest.approx(2.0e-3),
                          "mlmc.estimate.fetch": pytest.approx(1.0e-3),
                          "estimate": pytest.approx(3.5e-3)}
    assert total == pytest.approx(trace.window_s - trace.busy_s)
    assert program == pytest.approx(10.7e-3)
    assert PROGRAM_PREFIX == profiling.SPAN_PREFIX


def _program_sums():
    """Fill the program's sums under a CPU profiler: each span of READERS
    opened once, each counter raised by 6."""
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for _, names, kind in READERS:
            for name in names:
                if kind == "count":
                    profiling.count(name, 6)
                else:
                    with profiling.span(name):
                        pass
    return profiling.spans()


@pytest.mark.parametrize("metric,names,kind", READERS, ids=[r[0] for r in READERS])
def test_each_reader_reads_the_program_sums_per_traced_job(metric, names, kind):
    spans = _program_sums()
    reader = metric_reader(metric)
    want = (3.0 * len(names) if kind == "count"
            else 1e3 * sum(spans[n]["seconds"] for n in names) / 2)
    assert reader.read(_run(trace=object())) == pytest.approx(want)
    assert reader.read(_run(trace=None)) is None


def test_readers_read_nothing_from_a_program_without_the_sums(monkeypatch):
    _program_sums()
    monkeypatch.delattr(profiling, "spans")
    for metric, _, _ in READERS:
        assert metric_reader(metric).read(_run(trace=object())) is None, metric
