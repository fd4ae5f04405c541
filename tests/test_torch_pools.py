"""The host pools of mlmc_tpu_torch against mlmc_tpu's: constructors, the
per-sample workspaces, ``ProcessPool`` (spawned workers that never
initialise CUDA) and ``ThreadPool``.

``SynthSimulationWorkspace`` is host numpy code seeded by md5(sample id) in
both packages, so the same sample ids give the same results bit for bit.
"""
import inspect
import os

import numpy as np
import pytest
import torch

import mlmc_tpu
import mlmc_tpu_torch as mt
from mlmc_tpu_torch.sampling_pool import SamplingPool, _SampleWorkspace
from torch_pool_probe import ProbeSimulation

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _working_directory():
    """Start in a working directory that exists: a workspace test run
    earlier in this process (the pools of both packages change into sample
    directories and remove them) may have left it deleted."""
    try:
        os.getcwd()
    except FileNotFoundError:
        os.chdir(os.path.dirname(os.path.abspath(__file__)))

LEVELS = [[0.1], [0.01]]


# --------------------------------------------------------------------- #
# constructors and names
# --------------------------------------------------------------------- #
def _parameters(cls):
    return list(inspect.signature(cls.__init__).parameters)[1:]


@pytest.mark.parametrize("name", ["OneProcessPool", "ProcessPool", "ThreadPool",
                                  "DeviceBatchPool"])
def test_constructor_keeps_the_leading_arguments(name):
    """mlmc_tpu's parameters, in its order, then ``device``."""
    ours, theirs = _parameters(getattr(mt, name)), _parameters(getattr(mlmc_tpu, name))
    assert ours[:len(theirs)] == theirs
    assert ours[len(theirs):] == ([] if name == "ProcessPool" else ["device"])


def test_device_batch_pool_arguments(tmp_path):
    pool = mt.DeviceBatchPool(str(tmp_path), False, 5, 64, device="cpu")
    assert pool._seed == 5 and pool._min_bucket == 64
    assert pool._output_dir == os.path.join(str(tmp_path), "output")
    assert os.path.isdir(os.path.join(pool._output_dir, "failed"))
    assert pool._inflight_bytes == mt.DeviceBatchPool.INFLIGHT_BYTES == 1 << 30
    assert mt.DeviceBatchPool(inflight_bytes=123, device="cpu")._inflight_bytes == 123
    mesh = mt.SampleMesh(["cpu", "cpu"], group=False)
    sharded = mt.DeviceBatchPool(sharding=mesh)     # gathers to the mesh's device
    assert sharded._sharding is mesh and sharded._device == torch.device("cpu")
    host = mt.OneProcessPool(str(tmp_path), True, device="cpu")
    assert host._debug is True and host._device == "cpu"


def test_class_constants_and_version():
    for name in ("FAILED_DIR", "SEVERAL_SUCCESSFUL_DIR", "N_SUCCESSFUL"):
        assert getattr(mt.SamplingPool, name) == getattr(mlmc_tpu.SamplingPool, name)
    assert mt.__version__ == mlmc_tpu.__version__
    for name in ("SampleStorageHDF", "SampleStorageBin", "ProcessPool", "ThreadPool",
                 "SynthSimulationWorkspace", "LogNorm", "Uniform", "TwoGaussians"):
        assert getattr(mt, name) is not None, name


def _level_sims(pkg, sim=None):
    sim = sim or pkg.SynthSimulation(dict(distr="norm", complexity=2))
    sampler = pkg.Sampler(pkg.Memory(), pkg.OneProcessPool(), sim, LEVELS)
    return sampler._level_sim_objects


def test_execute_level_and_bulk_flag():
    """``execute_level`` runs one level's pending samples; ``bulk=False``
    reports the same rows as (id, (fine, coarse)) tuples."""
    sims = _level_sims(mt)
    out = {}
    for bulk in (True, False):
        pool = mt.DeviceBatchPool(seed=4, min_bucket=64, bulk=bulk, device="cpu")
        pool.schedule_level_batch(sims[0], range(0, 10))
        pool.schedule_level_batch(sims[1], range(0, 6))
        succ, failed = pool.execute_level(1)
        assert list(succ) == [1] and failed == {} and pool.n_pending() == 10
        out[bulk] = succ[1]
    (bulk_res,), tuples = out[True], out[False]
    assert list(bulk_res.ids) == [sid for sid, _ in tuples]
    np.testing.assert_array_equal(bulk_res.fine, np.stack([f for _, (f, _c) in tuples]))
    np.testing.assert_array_equal(bulk_res.coarse, np.stack([c for _, (_f, c) in tuples]))
    # the tuple form goes through a storage's per-sample path
    storage = mt.Memory()
    storage.save_global_data(result_format=sims[0].result_format, level_parameters=LEVELS)
    storage.save_samples({1: tuples}, {})
    np.testing.assert_array_equal(storage.sample_pairs()[1][:, :, 0], bulk_res.fine.T)


# --------------------------------------------------------------------- #
# calculate_sample: device by signature, workspace by directory
# --------------------------------------------------------------------- #
def test_calculate_sample_passes_device_by_signature():
    seen = {}

    def with_device(config, seed, device=None):
        seen["with"] = device
        return np.zeros(24), np.zeros(24)

    def without_device(config, seed):
        seen["without"] = True
        return np.zeros(24), np.zeros(24)

    def raises_type_error(config, seed, device=None):
        raise TypeError("a real one")

    level = _level_sims(mt)[0]
    level.calculate = with_device
    assert SamplingPool.calculate_sample("L00_S0000001", level, device="cpu")[2] == ""
    assert seen["with"] == "cpu"
    SamplingPool.calculate_sample("L00_S0000001", level)
    assert seen["with"] is None
    level.calculate = without_device
    assert SamplingPool.calculate_sample("L00_S0000001", level, device="cpu")[2] == ""
    assert seen["without"]
    level.calculate = raises_type_error
    _, result, err, elapsed = SamplingPool.calculate_sample(
        "L00_S0000001", level, device="cpu")
    assert result == (None, None) and "a real one" in err and elapsed == 0


def test_compute_seed_matches_jax():
    for tag in ("L00_S0000000", "L03_S0001234"):
        assert SamplingPool.compute_seed(tag) == mlmc_tpu.SamplingPool.compute_seed(tag)


def _workspace_sim(pkg, tmp_path, nan_fraction=0.0):
    yaml = pytest.importorskip("yaml")
    cfg = tmp_path / "synth_sim_config.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump({"distr": "norm", "nan_fraction": nan_fraction}, f)
    return pkg.SynthSimulationWorkspace(dict(config_yaml=str(cfg)))


def test_workspace_lifecycle(tmp_path, monkeypatch):
    """enter() copies the common files and changes into the sample's
    directory; finish() archives failed samples and the first few
    successful ones and drops the directory."""
    monkeypatch.chdir(tmp_path)
    sim = _workspace_sim(mt, tmp_path)
    level = sim.level_instance([0.1], [0.0])
    ws = _SampleWorkspace(str(tmp_path / "work"))
    out = ws.output_dir
    assert out == str(tmp_path / "work" / "output")
    ws.enter("L00_S0000002", level)
    assert os.getcwd() == os.path.join(out, "L00_S0000002")
    assert os.path.exists("synth_sim_config.yaml")
    os.chdir(tmp_path)
    ws.finish("L00_S0000002", level, failed=False)
    assert not os.path.exists(os.path.join(out, "L00_S0000002"))
    assert os.path.exists(os.path.join(out, "several_successful", "L00_S0000002",
                                       "synth_sim_config.yaml"))
    ws.sample_dir("L00_S0000009")
    ws.finish("L00_S0000009", level, failed=False)       # past the first five
    assert not os.path.exists(os.path.join(out, "several_successful", "L00_S0000009"))
    ws.sample_dir("L00_S0000010")
    ws.finish("L00_S0000010", level, failed=True)
    assert os.path.isdir(os.path.join(out, "failed", "L00_S0000010"))
    # a new pool on the same directory starts clean unless it debugs
    _SampleWorkspace(str(tmp_path / "work"), debug=True)
    assert os.path.isdir(os.path.join(out, "failed", "L00_S0000010"))
    _SampleWorkspace(str(tmp_path / "work"))
    assert os.listdir(os.path.join(out, "failed")) == []


def _collect(pkg, pool, sim, counts=(12, 6)):
    storage = pkg.Memory()
    sampler = pkg.Sampler(storage, pool, sim, LEVELS)
    sampler.set_initial_n_samples(list(counts))
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples(sleep=0.01)
    return storage


def _by_id(storage):
    """{sample id: [2 or 1, M] rows} of a Memory, whatever order the
    samples were collected in."""
    out = {}
    for lid, level in storage._levels.items():
        pairs = np.asarray(level.pairs)
        for tag, row in zip(list(level.ids), pairs):
            out[str(tag)] = row
    return out


POOLS = {
    "one": lambda pkg, **kw: pkg.OneProcessPool(**kw),
    "process2": lambda pkg, **kw: pkg.ProcessPool(2, **kw),
    "thread2": lambda pkg, **kw: pkg.ThreadPool(2, **kw),
}


@pytest.mark.parametrize("pool_kind", sorted(POOLS))
def test_workspace_simulation_matches_jax_bit_for_bit(tmp_path, monkeypatch, pool_kind):
    """The same sample ids through mlmc_tpu's OneProcessPool and this
    package's pool: every stored value is equal, bit for bit."""
    monkeypatch.chdir(tmp_path)
    sim_j = _workspace_sim(mlmc_tpu, tmp_path)
    want = _by_id(_collect(mlmc_tpu, mlmc_tpu.OneProcessPool(
        work_dir=str(tmp_path / "work_j")), sim_j))
    os.chdir(tmp_path)
    sim_t = _workspace_sim(mt, tmp_path)
    pool = POOLS[pool_kind](mt, work_dir=str(tmp_path / "work_t"))
    try:
        got = _by_id(_collect(mt, pool, sim_t))
    finally:
        if hasattr(pool, "close"):
            pool.close()
    assert sorted(got) == sorted(want) and len(got) == 18
    for tag in want:
        assert got[tag].dtype == np.float64
        np.testing.assert_array_equal(got[tag], want[tag])
    out = tmp_path / "work_t" / "output"
    # level 0 and level 1 each keep their samples 0..4; the rest is dropped
    assert sorted(os.listdir(out / "several_successful")) == sorted(
        "L%02d_S%07d" % (l, i) for l in (0, 1) for i in range(5))
    assert os.listdir(out / "failed") == []
    assert sorted(os.listdir(out)) == ["failed", "several_successful"]


@pytest.mark.parametrize("pool_kind", ["one", "thread2"])
def test_workspace_failures_are_archived(tmp_path, monkeypatch, pool_kind):
    """tests/test_workspace_and_io.py's case: failures injected at 10%,
    every sample accounted for, failed directories kept."""
    import scipy.stats as stats

    monkeypatch.chdir(tmp_path)
    sim = _workspace_sim(mt, tmp_path, nan_fraction=0.1)
    pool = POOLS[pool_kind](mt, work_dir=str(tmp_path / "work"), debug=False)
    storage = _collect(mt, pool, sim, counts=(30, 10))
    n_collected = storage.get_n_collected()
    failed = storage.failed_samples()
    n_failed = sum(len(v) for v in failed.values())
    assert n_collected[0] + n_collected[1] + n_failed == 40
    assert n_failed > 0
    out = tmp_path / "work" / "output"
    assert sorted(os.listdir(out / "failed")) == sorted(
        t for v in failed.values() for t in v)
    assert os.path.exists(out / "failed" / failed["0"][0] / "synth_sim_config.yaml")
    root = mt.make_root_quantity(storage, sim.result_format(), device="cpu")
    mfn = mt.Legendre(4, stats.norm(1, 2).ppf([0.001, 0.999]))
    means, _ = mt.Estimate(root["length"][1]["10"][0], storage, mfn).estimate_moments(mfn)
    assert means[0] == 1


def test_workspace_statics_match_jax():
    J, T = mlmc_tpu.SynthSimulationWorkspace, mt.SynthSimulationWorkspace
    x = np.random.default_rng(0).normal(size=6)
    np.testing.assert_array_equal(T.sample_fn(x, 0.3), J.sample_fn(x, 0.3))
    np.testing.assert_array_equal(T.sample_fn_no_error(x, 0.3), x)
    for cls in (J, T):
        cls.n_nans, cls.nan_fraction, cls.len_results = 0, 0.0, 0
    np.testing.assert_array_equal(T.generate_random_samples("norm", 5, 4)[0],
                                  J.generate_random_samples("norm", 5, 4)[0])
    with pytest.raises(NotImplementedError):
        T.generate_random_samples("lognorm", 5, 4)
    assert T.calculate_batch is None and T.calculate_keyed_batch is None
    assert T.CONFIG_FILE == J.CONFIG_FILE


def test_device_batch_pool_refuses_a_workspace_simulation(tmp_path):
    sim = _workspace_sim(mt, tmp_path)
    sampler = mt.Sampler(mt.Memory(), mt.DeviceBatchPool(device="cpu"), sim, LEVELS)
    sampler.set_initial_n_samples([4, 2])
    sampler.schedule_samples()
    with pytest.raises(ValueError, match="use OneProcessPool"):
        sampler.ask_sampling_pool_for_samples()


# --------------------------------------------------------------------- #
# ProcessPool: spawned workers, CPU only
# --------------------------------------------------------------------- #
def test_process_pool_workers_are_spawned_and_never_initialise_cuda():
    pool = mt.ProcessPool(2)
    try:
        assert pool._executor._mp_context.get_start_method() == "spawn"
        storage = _collect(mt, pool, ProbeSimulation(dict(distr="norm")), counts=(6, 2))
    finally:
        pool.close()
    rows = np.concatenate([np.asarray(p)[:, :, 0].T for p in storage.sample_pairs()])
    assert rows.shape == (8, 24)
    assert os.getpid() not in set(rows[:, 0].astype(int))      # computed elsewhere
    assert 1 <= len(set(rows[:, 0].astype(int))) <= 2
    assert np.all(rows[:, 1] == 0.0)                           # CUDA never initialised
    assert np.all(rows[:, 2] == 1.0) and np.all(rows[:, 3] == 1.0)   # device="cpu"
    assert all(c > 0 for c in storage.get_n_ops())


def test_thread_pool_passes_its_device_through():
    pool = mt.ThreadPool(2, device="cpu")
    storage = _collect(mt, pool, ProbeSimulation(dict(distr="norm")), counts=(4, 2))
    pool.close()
    rows = np.concatenate([np.asarray(p)[:, :, 0].T for p in storage.sample_pairs()])
    assert set(rows[:, 0].astype(int)) == {os.getpid()}
    assert np.all(rows[:, 2] == 1.0)


def test_process_pool_reports_an_executor_failure_as_a_failed_sample():
    """A level whose ``calculate`` cannot be pickled never reaches a
    worker: its samples fail, they do not crash the collection."""
    pool = mt.ProcessPool(1)
    try:
        sim = mt.SynthSimulation(dict(distr="norm"))
        storage = mt.Memory()
        sampler = mt.Sampler(storage, pool, sim, LEVELS)
        sampler._level_sim_objects[1].calculate = lambda config, seed: None
        sampler.set_initial_n_samples([2, 2])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples(sleep=0.01)
    finally:
        pool.close()
    assert storage.get_n_collected() == [2, 0]
    assert sorted(storage.failed_samples()["1"]) == ["L01_S0000000", "L01_S0000001"]
    assert "executor failure" in storage._levels[1].failed[0][1]
