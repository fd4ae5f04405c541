"""Share of the batched CG's turns that ran inside a CUDA graph replay
(``cg.graph_turns`` over ``cg.turns``, in %), over the traced jobs. None
where the program counts no graph turns (an older commit) or no turns."""
from harness.program import _profiling


def read(run):
    profiling = _profiling(run)
    if profiling is None:
        return None
    counts = profiling.counters()
    if "cg.graph_turns" not in counts or not counts.get("cg.turns"):
        return None
    return 100.0 * counts["cg.graph_turns"] / counts["cg.turns"]
