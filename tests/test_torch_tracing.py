"""The port's spans and counters (``tool/profiling``): nothing is recorded
while no ``torch.profiler`` runs; under one, the stored path, the
estimators, the maxent density and the fused estimate open their spans,
nested as the code nests them, and the counters equal values computed
from the runs themselves. Tiny sizes, the CPU (the fused launch spans and
the device timeline: one case on the card)."""
import json
import math
import os

import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
from mlmc_tpu_torch.parallel import SampleMesh, sharded_synth_pipeline
from mlmc_tpu_torch.sim import diffusion
from mlmc_tpu_torch.tool import profiling

PREFIX = profiling.SPAN_PREFIX


@pytest.fixture(autouse=True)
def _live_working_directory(tmp_path, monkeypatch):
    """Run in ``tmp_path``; from the tests' directory first where the
    working directory is gone, since ``monkeypatch.chdir`` reads it."""
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(os.path.dirname(os.path.abspath(__file__)))
    monkeypatch.chdir(tmp_path)


def _profiled(fn, activities=(torch.profiler.ProfilerActivity.CPU,)):
    """Run ``fn`` under a profiler: (its result, {span: set of the names
    of its parents}, counters, span totals)."""
    profiling.reset()
    with torch.profiler.profile(activities=list(activities)) as prof:
        out = fn()
    parents = {}
    for ev in prof.events():
        if ev.name.startswith(PREFIX):
            parent = ev.cpu_parent.name if ev.cpu_parent is not None else None
            parents.setdefault(ev.name[len(PREFIX):], set()).add(parent)
    return out, parents, profiling.counters(), profiling.spans()


def _stored_run(sim, levels, initial_n, min_bucket=64, max_batch=64):
    """A Sampler -> DeviceBatchPool -> DeviceMemory run on the CPU:
    (sampler, pool, storage)."""
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=11, device_results=True, min_bucket=min_bucket,
                              max_batch=max_batch, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, levels)
    sampler.set_initial_n_samples(initial_n)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return sampler, pool, storage


def _darcy():
    return mt.DiffusionSimulation(dict(field_method="circulant", corr_length=0.3))


def _synth():
    return mt.SynthSimulation(dict(distr="norm", complexity=2))


def _estimate(storage, sim, quantity=lambda root: root, domain=(-4.0, 4.0)):
    root = mt.make_root_quantity(storage, sim.result_format())
    return mt.Estimate(quantity(root), storage, mt.Legendre(6, domain))


def test_nothing_is_recorded_and_no_range_opens_without_a_profiler(monkeypatch):
    def no_range(name):
        raise AssertionError("a range was opened for %s with no profiler" % name)

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", no_range)
    profiling.reset()
    _, _, storage = _stored_run(_darcy(), [[0.25], [0.125]], [40, 20])
    est = _estimate(storage, _darcy(), domain=(0.05, 8.0))
    est.estimate_moments_fast()
    est.estimate_moments_extended()
    with profiling.span("anything"):
        profiling.count("anything", 3)
    assert profiling.counters() == {} and profiling.spans() == {}


def test_darcy_stored_run_nests_the_pool_and_solver_spans():
    """Sampler -> DeviceBatchPool -> DiffusionSimulation at 8^2 / 4^2: the
    pool's waits inside its wave, the keyed draws, the fields and the
    solves inside a dispatch, the host's checks inside a solve; two C_l
    probes for each fresh (level, cost class) key, one key per level (every
    slice of a level is cut to ``max_batch``)."""
    levels = [[0.25], [0.125]]
    (_, pool, storage), parents, counters, totals = _profiled(
        lambda: _stored_run(_darcy(), levels, [200, 100]))
    assert parents["pool.wave"] == {None}
    for name in ("pool.drain", "pool.fetch", "pool.dispatch", "pool.finalize"):
        assert parents[name] == {PREFIX + "pool.wave"}, name
    for name in ("sim.draws", "sim.field", "sim.solve"):
        assert parents[name] == {PREFIX + "pool.dispatch"}, name
    assert parents["sim.cg_check"] == {PREFIX + "sim.solve"}
    assert parents["sampler.schedule"] == parents["sampler.store"] == {None}
    assert counters["pool.probes"] == 2 * len(levels)
    assert totals["pool.drain"]["calls"] == counters["pool.probes"]
    # level 0 (one solve a batch): 64, 64, 64, 8; level 1 (two): 64, 36
    assert totals["sim.solve"]["calls"] == 4 + 2 * 2
    assert all(t["seconds"] >= 0 for t in totals.values())
    assert sum(storage.get_n_collected()) == 300 and pool.n_dispatches == 6


def test_cg_turns_and_checks_count_the_loop_of_each_solve():
    """A turn runs while any sample is active, and the host sees that they
    all stopped at the first check after the last one did: a solve turns
    ceil(max iterations / E) * E times (at most ``maxiter``), and checks
    (a ``sim.cg_check`` span each) once per E turns plus the check that
    stops it."""
    sim = _darcy()
    config = sim.level_instance([0.125], [0.25]).config_dict
    draws = sim._keyed_draws(config, 5, 1, torch.arange(6), torch.zeros(6, dtype=torch.int64))
    (_, _, it_fine, it_coarse), _, counters, totals = _profiled(
        lambda: sim._calculate(config, **draws))
    every = diffusion.CG_CHECK_EVERY
    turns = checks = 0
    for its, n in ((it_fine, config["fine_n"]), (it_coarse, config["coarse_n"])):
        maxiter = sim.CG_MAXITER_FACTOR * n
        t = min(math.ceil(int(its.max()) / every) * every, maxiter)
        turns += t
        checks += t // every + 1 if t < maxiter else math.ceil(maxiter / every)
    assert counters["cg.turns"] == turns and totals["sim.cg_check"]["calls"] == checks


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_cg_graphs_count_the_replayed_blocks_on_the_card_only(device):
    """On the card a solve that turns captures one graph and replays it for
    each full block of ``CG_CHECK_EVERY`` turns after the first
    (``cg.graphs``, ``cg.graph_turns``); on the CPU both stay 0. The turns
    are counted as before either way."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are captured only on the card")
    sim = _darcy()
    config = sim.level_instance([0.125], [0.25]).config_dict
    draws = sim._keyed_draws(config, 5, 1, torch.arange(6), torch.zeros(6, dtype=torch.int64))
    draws = {"noise": tuple(t.to(device) for t in draws["noise"])}
    (_, _, it_fine, it_coarse), _, counters, _ = _profiled(
        lambda: sim._calculate(config, **draws))
    every = diffusion.CG_CHECK_EVERY
    turns = graphs = graph_turns = 0
    for its, n in ((it_fine, config["fine_n"]), (it_coarse, config["coarse_n"])):
        maxiter = sim.CG_MAXITER_FACTOR * n
        t = min(math.ceil(int(its.max()) / every) * every, maxiter)
        turns += t
        if device == "cuda" and t > 0:
            graphs += 1
            graph_turns += every * (t // every - 1)
    assert counters["cg.turns"] == turns
    assert counters["cg.graphs"] == graphs and counters["cg.graph_turns"] == graph_turns
    if device == "cuda":
        assert graph_turns > 0


def test_cg_turns_count_a_solve_cut_at_maxiter():
    """Cut at ``maxiter`` the loop turns ``maxiter`` times and the host
    checked every E turns of them."""
    b = torch.ones(3, 8, dtype=torch.float64)
    maxiter = 6
    _, _, counters, totals = _profiled(lambda: diffusion.preconditioned_cg(
        lambda p: p * torch.linspace(1.0, 100.0, 8, dtype=torch.float64), lambda r: r,
        b, 1e-30, maxiter))
    assert counters["cg.turns"] == maxiter
    assert totals["sim.cg_check"]["calls"] == math.ceil(maxiter / diffusion.CG_CHECK_EVERY)


def test_synthetic_stored_run_opens_its_draw_spans():
    (_, pool, _), parents, counters, _ = _profiled(
        lambda: _stored_run(_synth(), [[0.5], [0.25], [0.125]], [300, 100, 50],
                            min_bucket=128, max_batch=128))
    assert parents["sim.draws"] == {PREFIX + "pool.dispatch"}
    assert "sim.solve" not in parents and "cg.turns" not in counters
    # level 0: 128, 128, 44; level 1: 100; level 2: 50 -> keys (0, 128),
    # (1, 128), (2, 128); levels 1 and 2 hold one slice, one probe each
    assert counters["pool.probes"] == 2 + 1 + 1


def test_both_tiers_pack_the_streams_once_each():
    _, _, storage = _stored_run(_synth(), [[0.5], [0.25]], [400, 100],
                                min_bucket=512, max_batch=512)
    est = _estimate(storage, _synth(), lambda root: root["length"])
    (fast, ext), parents, counters, totals = _profiled(
        lambda: (est.estimate_moments_fast(), est.estimate_moments_extended()))
    assert counters["estimate.packs"] == 2
    for name in ("estimate.gather", "estimate.pack", "estimate.launch", "estimate.fetch"):
        assert parents[name] == {None} and totals[name]["calls"] == 2, name
    np.testing.assert_allclose(fast[0], ext[0], rtol=1e-5, atol=1e-6)


def test_density_counts_its_newton_iterations():
    _, _, storage = _stored_run(_synth(), [[0.5], [0.25]], [4000, 1000],
                                min_bucket=4096, max_batch=4096)
    est = _estimate(storage, _synth(), lambda root: root["length"][1]["10"][0, 0])
    (dist, _, result, _), parents, counters, totals = _profiled(
        lambda: est.construct_density_fast(tol=1e-8))
    assert result.success
    assert counters["newton.iterations"] == result.nit
    assert totals["density.newton"]["calls"] >= 1
    assert counters["estimate.packs"] == 1     # the covariance of kernel C
    for name in ("density.orth", "density.newton", "density.finish", "density.panels"):
        assert name in parents, name
    assert parents["density.newton"] == parents["density.orth"] == {None}


def test_fused_estimate_fetches_then_computes_on_the_host():
    accs = mt.synth_mlmc_pipeline(7, 5, [2000, 500], [0.5, 0.25], domain=(-4.0, 4.0),
                                  device="cpu")
    out, parents, _, totals = _profiled(lambda: accumulators_to_estimates(accs))
    assert parents["fused.fetch"] == parents["fused.host"] == {None}
    assert totals["fused.fetch"]["calls"] == totals["fused.host"]["calls"] == 1
    assert out["n_samples"].tolist() == [float(a.n_valid) for a in accs]
    assert "fused.prepare" not in parents      # the plain version on the CPU


def test_device_trace_writes_the_counters_beside_the_trace(tmp_path):
    with profiling.device_trace(str(tmp_path)):
        with profiling.span("outer"):
            profiling.count("things", 2)
            profiling.count("things")
    files = sorted(os.listdir(tmp_path))
    assert len(files) == 2 and files[0].endswith(".counters.json")
    assert files[1] == files[0].replace(".counters.json", ".json")
    with open(tmp_path / files[0]) as f:
        saved = json.load(f)
    assert saved["counters"] == {"things": 3}
    assert saved["spans"]["outer"]["calls"] == 1
    profiling.count("things")       # the trace has ended
    assert profiling.counters() == {"things": 3}


@pytest.fixture
def gloo_world(tmp_path):
    """A one-process gloo world (the default group), torn down after the
    test."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"),
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


MESH_STEPS = [0.5, 0.25, 0.125, 0.0625, 0.03125]
MESH_R = 4


def _mesh_step():
    """One sharded headline step over two CPU shards of the world group."""
    mesh = SampleMesh(["cpu", "cpu"])
    assert mesh.group is not None
    return sharded_synth_pipeline(mesh, MESH_R, [64] * 5, MESH_STEPS, domain=(-4.0, 4.0))(3)


def test_mesh_reduce_opens_its_collectives_and_counts_their_bytes(gloo_world):
    """One float64 and one int64 all-reduce inside the reduction; the
    bytes are the five levels' sums, sums of squares and two Grams, and
    their five counts."""
    _, parents, counts, totals = _profiled(_mesh_step)
    assert parents["mesh.allreduce"] == {PREFIX + "mesh.reduce"}
    assert totals["mesh.reduce"]["calls"] == 1 and totals["mesh.allreduce"]["calls"] == 2
    R = MESH_R
    assert counts == {"mesh.collectives": 2,
                      "mesh.reduce_bytes": 5 * (2 * R + 2 * R * R) * 8 + 5 * 8}


def test_mesh_gather_opens_its_collective(gloo_world):
    mesh = SampleMesh(["cpu", "cpu"])
    out, parents, counts, _ = _profiled(
        lambda: mesh.gather([torch.zeros(3, dtype=torch.bool), torch.ones(3, dtype=torch.bool)]))
    assert out.tolist() == [False] * 3 + [True] * 3
    assert "mesh.allgather" in parents and counts == {"mesh.collectives": 1}


def test_mesh_records_nothing_without_a_profiler(gloo_world):
    profiling.reset()
    _mesh_step()
    assert profiling.counters() == {} and profiling.spans() == {}


@pytest.mark.cuda
def test_fused_spans_on_the_card_leave_the_device_timeline_alone():
    """Kernel A's preparation and launch are spans on the host; the
    profiler puts no copy of any span on the device's timeline, so a trace
    reads the same device time with and without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel A runs only on the card")
    from torch.autograd import DeviceType

    dev = torch.device("cuda", 0)
    run = lambda: accumulators_to_estimates(mt.synth_mlmc_pipeline(
        7, 25, [1 << 20, 1 << 18], [0.5, 0.25], domain=(-4.0, 4.0), device=dev))
    run()
    profiling.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize(dev)
    events = list(prof.events())
    host = {ev.name for ev in events if ev.device_type != DeviceType.CUDA}
    device = [ev.name for ev in events if ev.device_type == DeviceType.CUDA]
    for name in ("fused.prepare", "fused.launch", "fused.fetch", "fused.host"):
        assert PREFIX + name in host, name
    assert not [n for n in device if n.startswith(PREFIX)]
    assert any("synth_mlmc_kernel" in n for n in device)
