"""The end-to-end adaptive MLMC matrix of mlmc_tpu_torch on the CPU: the
counterpart of tests/test_run.py at its small sizes.

{Memory, HDF, Bin} x {OneProcessPool, ProcessPool(2), ThreadPool(2),
DeviceBatchPool} x {SynthSimulation, SynthSimulationWorkspace} in curated
combinations through the target-variance loop, then kill-and-resume from
each file storage (held against mlmc_tpu resuming the same file's
bookkeeping) and renew-failed through a reopened file.
"""
import os

import numpy as np
import pytest
import scipy.stats as stats
import torch

import mlmc_tpu
import mlmc_tpu_torch as mt
from mlmc_tpu_torch import native

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

STEPS = [[0.1], [0.001]]


def _need(kind):
    if kind == "hdf":
        pytest.importorskip("h5py")
    if kind == "bin" and not native.available():
        pytest.skip("no C++ compiler: %s" % native.build_error())


def _make_storage(kind, tmp_path, pkg=mt):
    _need(kind)
    if kind == "memory":
        return pkg.Memory()
    if kind == "hdf":
        return pkg.SampleStorageHDF(file_path=str(tmp_path / "mlmc.hdf5"))
    return pkg.SampleStorageBin(dir_path=str(tmp_path / "binstore"))


def _make_pool(kind, tmp_path, need_workspace):
    work = dict(work_dir=str(tmp_path / "work")) if need_workspace else {}
    if kind == "one":
        return mt.OneProcessPool(device="cpu", **work)
    if kind == "process2":
        return mt.ProcessPool(2, **work)
    if kind == "thread2":
        return mt.ThreadPool(2, device="cpu", **work)
    return mt.DeviceBatchPool(min_bucket=64, device="cpu", **work)


def _make_sim(kind, tmp_path):
    if kind == "synth":
        return mt.SynthSimulation(dict(distr="norm", complexity=2)), False
    yaml = pytest.importorskip("yaml")
    cfg = tmp_path / "synth_sim_config.yaml"
    with open(cfg, "w") as f:
        yaml.safe_dump({"distr": "norm", "nan_fraction": 0.0}, f)
    return mt.SynthSimulationWorkspace(dict(config_yaml=str(cfg))), True


def _adaptive_loop(sampler, estimator, target_var=1e-3, max_rounds=100):
    def allocation():
        variances, n_ops = estimator.estimate_diff_vars_regression(
            sampler._n_scheduled_samples)
        return mt.estimate_n_samples_for_target_variance(
            target_var, variances, n_ops, n_levels=sampler.n_levels)

    n_estimated, n_rounds = allocation(), 0
    while not sampler.process_adding_samples(n_estimated, 0.001, 0.1):
        n_estimated = allocation()
        n_rounds += 1
        assert n_rounds < max_rounds
    return n_estimated


def _estimator(storage, sim, n_moments=5, base=stats.norm(0, 1)):
    mfn = mt.Legendre(n_moments, base.ppf([0.0001, 0.9999]))
    root = mt.make_root_quantity(storage, q_specs=sim.result_format(), device="cpu")
    return mt.Estimate(root["length"][1]["10"][0], storage, mfn), mfn


# curated combinations: every storage, every pool, both sims appear
MATRIX = [
    ("memory", "one", "synth"),
    ("memory", "device", "synth"),
    ("hdf", "device", "synth"),
    ("hdf", "process2", "synth"),
    ("bin", "device", "synth"),
    ("bin", "one", "synth"),
    ("bin", "thread2", "synth"),
    ("memory", "one", "workspace"),
    ("hdf", "one", "workspace"),
    ("bin", "thread2", "workspace"),
    ("memory", "process2", "workspace"),
]


@pytest.mark.parametrize("storage_kind,pool_kind,sim_kind", MATRIX)
def test_mlmc_adaptive(tmp_path, monkeypatch, storage_kind, pool_kind, sim_kind):
    monkeypatch.chdir(tmp_path)          # workspace samples change directory
    np.random.seed(1234)
    sim, need_workspace = _make_sim(sim_kind, tmp_path)
    storage = _make_storage(storage_kind, tmp_path)
    pool = _make_pool(pool_kind, tmp_path, need_workspace)
    try:
        sampler = mt.Sampler(sample_storage=storage, sampling_pool=pool,
                             sim_factory=sim, level_parameters=STEPS)
        # workspace sim draws from norm(1, 2); plain synth from norm(0, 1)
        base = stats.norm(1, 2) if sim_kind == "workspace" else stats.norm(0, 1)
        sampler.set_initial_n_samples([50, 50])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples(sleep=0.001)
        estimator, mfn = _estimator(storage, sim, base=base)
        _adaptive_loop(sampler, estimator, target_var=1e-3)
        means, variances = estimator.estimate_moments(mfn)
    finally:
        if hasattr(pool, "close"):
            pool.close()
    assert means[0] == 1
    assert variances[0] == 0
    assert np.abs(means[1]) < 0.1
    # the adaptive loop actually grew the schedule beyond the initial 50
    assert np.any(np.asarray(sampler._n_scheduled_samples) > 50)
    if storage_kind != "memory":
        storage.close()


@pytest.mark.parametrize("kind", ["hdf", "bin"])
def test_kill_and_resume_adaptive(tmp_path, kind):
    """Run the initial round, 'kill' the process (drop all objects), reopen
    the file and finish the adaptive loop from the stored schedule: the
    file is the checkpoint."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = _make_storage(kind, tmp_path)
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(min_bucket=64, device="cpu"),
                         sim, STEPS)
    sampler.set_initial_n_samples([60, 40])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    n_before = np.array(storage.get_n_collected())
    pairs_before = [np.asarray(p) for p in storage.sample_pairs()]
    storage.close()
    del sampler, storage  # "kill"

    # mlmc_tpu resumes the same file to the same bookkeeping
    theirs = _make_storage(kind, tmp_path, pkg=mlmc_tpu)
    their_sampler = mlmc_tpu.Sampler(
        theirs, mlmc_tpu.DeviceBatchPool(min_bucket=64),
        mlmc_tpu.SynthSimulation(dict(distr="norm", complexity=2)), STEPS)
    their_state = (list(their_sampler._n_scheduled_samples),
                   list(theirs.n_finished()), sorted(theirs.unfinished_ids()))
    theirs.close()
    del their_sampler, theirs

    storage2 = _make_storage(kind, tmp_path)
    assert list(storage2.get_n_collected()) == list(n_before) == [60, 40]
    pool2 = mt.DeviceBatchPool(min_bucket=64, device="cpu")
    sampler2 = mt.Sampler(storage2, pool2, sim, STEPS)
    # resume: scheduled counters continue from the stored schedule log
    assert (list(sampler2._n_scheduled_samples), list(storage2.n_finished()),
            sorted(storage2.unfinished_ids())) == their_state == ([60, 40], [60, 40], [])
    estimator, mfn = _estimator(storage2, sim)
    _adaptive_loop(sampler2, estimator, target_var=1e-3)
    means, variances = estimator.estimate_moments(mfn)
    assert means[0] == 1 and variances[0] == 0
    n_after = np.array(storage2.get_n_collected())
    assert n_after.sum() > n_before.sum()
    # the next sample index went on from n_finished: the first rows are the
    # first run's, and the new ids do not repeat the old ones
    for before, after in zip(pairs_before, storage2.sample_pairs()):
        np.testing.assert_array_equal(np.asarray(after)[:, :before.shape[1]], before)
    scheduled = storage2.load_scheduled_samples()
    for level in (0, 1):
        tags = [str(t) for t in scheduled[level]]
        assert len(set(tags)) == len(tags) == sampler2._n_scheduled_samples[level]
    # the same levels in one uninterrupted run hold the same samples
    memory = mt.Memory()
    whole = mt.Sampler(memory, mt.DeviceBatchPool(min_bucket=64, device="cpu"),
                       sim, STEPS)
    whole.set_initial_n_samples([int(n) for n in n_after])
    whole.schedule_samples()
    whole.ask_sampling_pool_for_samples()
    for a, b in zip(memory.sample_pairs(), storage2.sample_pairs()):
        np.testing.assert_array_equal(a, np.asarray(b))
    storage2.close()


class _RecordingPool(mt.OneProcessPool):
    def __init__(self):
        super().__init__(device="cpu")
        self.permanent = None

    def have_permanent_samples(self, sample_ids):
        self.permanent = list(sample_ids)
        return False


@pytest.mark.parametrize("kind", ["hdf", "bin"])
def test_resume_hands_unfinished_ids_to_the_pool(tmp_path, kind):
    """Scheduled in the file but never finished (the process died while
    they ran): a new sampler tells its pool about exactly these ids, and
    counts go on from what was scheduled."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = _make_storage(kind, tmp_path)
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(min_bucket=64, device="cpu"),
                         sim, STEPS)
    sampler.set_initial_n_samples([10, 6])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    lost = mt.tags.TagRange(1, 6, 9)
    storage.save_scheduled_samples(1, lost)           # scheduled, then "killed"
    storage.close()

    storage2 = _make_storage(kind, tmp_path)
    pool = _RecordingPool()
    sampler2 = mt.Sampler(storage2, pool, sim, STEPS)
    assert sorted(pool.permanent) == list(lost) == sorted(storage2.unfinished_ids())
    assert list(sampler2._n_scheduled_samples) == [10, 9]
    assert list(storage2.n_finished()) == [10, 6]
    sampler2.set_initial_n_samples([12, 10])
    sampler2.schedule_samples()
    sampler2.ask_sampling_pool_for_samples()
    assert [str(t) for t in storage2.load_scheduled_samples()[1]][-1] == "L01_S0000009"
    assert list(storage2.get_n_collected()) == [12, 7]
    assert sorted(storage2.unfinished_ids()) == list(lost)
    storage2.close()


@pytest.mark.parametrize("kind", ["hdf", "bin"])
def test_renew_failed_through_a_reopened_file(tmp_path, kind):
    """Failure injection, a restart, then renewal: failed samples are
    re-dispatched with attempt salts until none remain."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2, nan_fraction=0.2))
    storage = _make_storage(kind, tmp_path)
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(seed=5, min_bucket=64, device="cpu"),
                         sim, STEPS)
    sampler.set_initial_n_samples([80, 40])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    n_failed = sum(len(v) for v in storage.failed_samples().values())
    assert n_failed > 0
    storage.close()

    storage = _make_storage(kind, tmp_path)
    assert sum(len(v) for v in storage.failed_samples().values()) == n_failed
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(seed=5, min_bucket=64, device="cpu"),
                         sim, STEPS)
    assert list(storage.n_finished()) == [80, 40] and storage.unfinished_ids() == []
    for _ in range(25):
        sampler.renew_failed_samples()
        sampler.ask_sampling_pool_for_samples()
        if sum(len(v) for v in storage.failed_samples().values()) == 0:
            break
    assert sum(len(v) for v in storage.failed_samples().values()) == 0
    assert list(storage.get_n_collected()) == [80, 40]
    assert list(storage.n_finished()) == [80, 40] and storage.unfinished_ids() == []
    # estimates over the renewed store still satisfy the invariants
    estimator, mfn = _estimator(storage, sim, n_moments=4)
    means, variances = estimator.estimate_moments(mfn)
    assert means[0] == 1 and variances[0] == 0
    storage.close()


def test_reference_alias_of_the_level_sims():
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    sampler = mt.Sampler(mt.Memory(), mt.OneProcessPool(device="cpu"), sim, STEPS)
    sampler._create_level_sim_objects([[0.5], [0.25], [0.125]], sim)
    assert sampler.n_levels == 3
    assert sampler._level_sim_objects[2].config_dict["coarse_step"] == 0.25
