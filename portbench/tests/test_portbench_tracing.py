"""The reduction of a device trace, by hand on a small timeline."""
import pytest

from harness.tracing import DeviceTrace


def test_busy_idle_and_breakdown_within_the_jobs():
    ops = [("k1", 0.0, 1.0), ("k2", 0.5, 2.0), ("copy between jobs", 2.5, 3.5),
           ("k3", 4.2, 4.4)]
    spans = [("job", 0.0, 2.2), ("sampling", 0.0, 1.5), ("job", 4.0, 5.0)]
    t = DeviceTrace(ops, spans, [(0.0, 2.2), (4.0, 5.0)])
    assert t.busy_s == pytest.approx(2.2)          # [0, 2] and [4.2, 4.4]
    assert t.window_s == pytest.approx(3.2)        # the two jobs
    assert t.idle_share() == pytest.approx(1.0 / 3.2)
    assert t.op_seconds(("k1", "k3")) == pytest.approx(1.2)
    b = t.breakdown()
    assert [n for n, _ in b["device_ops"]] == ["k2", "k1", "k3"]
    assert b["idle_gaps"] == [["job", pytest.approx(1.0)]]


def test_spans_of_any_name_are_kept_out_of_the_device_operations():
    """The profiler mirrors every span onto the device's timeline; a span
    that a job kind opens under a name the harness has never seen is still
    a span there, not a device operation."""
    from types import SimpleNamespace

    import torch
    from torch.autograd import DeviceType

    from harness.tracing import Tracer, device_trace

    tracer = Tracer(torch, torch.device("cpu"), True)
    with tracer.span("job"):
        with tracer.span("a_new_layer"):
            pass
    assert tracer.names == {"job", "a_new_layer"}

    def ev(name, start_us, end_us, device):
        return SimpleNamespace(name=name, device_type=device,
                               time_range=SimpleNamespace(start=start_us, end=end_us))

    events = [ev("job", 0, 1000, DeviceType.CPU), ev("a_new_layer", 100, 900, DeviceType.CPU),
              ev("a_new_layer", 150, 950, DeviceType.CUDA), ev("kernel_x", 200, 400, DeviceType.CUDA)]
    trace = device_trace(SimpleNamespace(events=lambda: events), tracer.names)
    assert trace.busy_s == pytest.approx(200e-6)
    assert [n for n, _ in trace.breakdown()["device_ops"]] == ["kernel_x"]
    assert trace.breakdown()["idle_gaps"][0][0] == "a_new_layer"
