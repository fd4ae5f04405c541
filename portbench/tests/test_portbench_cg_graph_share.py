"""The reader of ``cg_graph_share``: the CG's turns run inside a CUDA graph
replay over all its turns, from the program's counters over the traced
jobs; nothing from a run without a trace, from a program that counts no
graph turns (an older commit) or from one whose solves never turned."""
import pytest
import torch

from harness.runner import Run, metric_reader

from mlmc_tpu_torch.tool import profiling


def _run(trace):
    records = [dict(wall=1.0, spans={}, counters={}, samples=1) for _ in range(2)]
    return Run(records, 2.0, 1.0, trace, records)


def _counted(counts):
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for name, n in counts.items():
            profiling.count(name, n)


@pytest.mark.parametrize("counts,want", [
    ({"cg.turns": 40, "cg.graphs": 2, "cg.graph_turns": 30}, 75.0),
    ({"cg.turns": 40, "cg.graphs": 0, "cg.graph_turns": 0}, 0.0),
    ({"cg.turns": 40}, None),
    ({"cg.turns": 0, "cg.graphs": 0, "cg.graph_turns": 0}, None),
    ({"pool.probes": 3}, None)])
def test_reads_the_share_of_replayed_turns(counts, want):
    _counted(counts)
    reader = metric_reader("cg_graph_share")
    assert reader.read(_run(trace=object())) == want
    assert reader.read(_run(trace=None)) is None
