"""Sample storage, tags, Sampler and sampling pools of mlmc_tpu_torch,
against mlmc_tpu on identical inputs where both have the same contract.

The port's pools draw from Philox counters and mlmc_tpu's from JAX keys,
so their samples differ by design: the storages are compared on samples
written into both with ``save_samples_bulk`` (or copied with
``storage_from_jax``), and the pools on their own contract (counters,
renewals, batching independence, blocking fetches).
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import tags as ttags
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec

torch.set_num_threads(1)


def _result_format():
    return [
        QuantitySpec(name="length", unit="m", shape=(2, 1), times=[1, 2, 3],
                     locations=["10", "20"]),
        QuantitySpec(name="width", unit="mm", shape=(2, 1), times=[1, 2, 3],
                     locations=["30", "40"]),
    ]


M = 24


def _storage(kind):
    return mt.Memory() if kind == "memory" else mt.DeviceMemory(device="cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _fill(storage, n_levels, rng, n=13, start=0):
    successful, failed = {}, {}
    for lvl in range(n_levels):
        res = []
        for i in range(n):
            fine = rng.normal(size=M)
            coarse = np.zeros(M) if lvl == 0 else rng.normal(size=M)
            res.append(("L{:02d}_S{:07d}".format(lvl, start + i), (fine, coarse)))
        successful[lvl] = res
        failed[lvl] = [("L{:02d}_S{:07d}".format(lvl, start + n), "err msg")]
    storage.save_samples(successful, failed)
    return successful


# --------------------------------------------------------------------- #
# storages
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kind", ["memory", "device"])
@pytest.mark.parametrize("n_levels", [1, 2, 5])
def test_storage_roundtrip(kind, n_levels):
    from mlmc_tpu.sample_storage import Memory as JMemory

    storage, jstorage = _storage(kind), JMemory()
    level_params = [[0.5 ** (lvl + 1)] for lvl in range(n_levels)]
    for st in (storage, jstorage):
        st.save_global_data(result_format=_result_format(),
                            level_parameters=level_params)
        for lvl in range(n_levels):
            st.save_scheduled_samples(
                lvl, ["L{:02d}_S{:07d}".format(lvl, i) for i in range(14)])
    successful = _fill(storage, n_levels, np.random.default_rng(123))
    _fill(jstorage, n_levels, np.random.default_rng(123))

    assert [q.name for q in storage.load_result_format()] == ["length", "width"]
    assert storage.get_level_parameters() == level_params
    pairs, jpairs = storage.sample_pairs(), jstorage.sample_pairs()
    assert len(pairs) == n_levels
    assert pairs[0].shape == (M, 13, 1)
    for lvl in range(n_levels):
        np.testing.assert_array_equal(_np(pairs[lvl]), jpairs[lvl])
    for lvl in range(1, n_levels):
        assert np.allclose(_np(pairs[lvl])[:, 0, 0], successful[lvl][0][1][0])
    assert storage.get_n_levels() == n_levels
    assert storage.get_n_collected() == jstorage.get_n_collected() == [13] * n_levels
    assert np.all(storage.n_finished() == 14)
    assert storage.failed_samples() == jstorage.failed_samples()
    storage.clear_failed()
    assert all(len(v) == 0 for v in storage.failed_samples().values())
    assert storage.unfinished_ids() == []
    storage.save_n_ops([(lvl, [2.0, 10]) for lvl in range(n_levels)])
    assert np.allclose(storage.get_n_ops(), 0.2)
    for lvl in range(n_levels):
        chunks = [_np(storage.sample_pairs_level(cs))
                  for cs in storage.chunks(level_id=lvl)]
        assert np.concatenate(chunks, axis=1).shape[1] == 13


def test_chunked_reads_match_jax():
    from mlmc_tpu.sample_storage import Memory as JMemory

    storage, jstorage = mt.Memory(chunk_size=5), JMemory(chunk_size=5)
    for st in (storage, jstorage):
        st.save_global_data(result_format=_result_format())
    _fill(storage, 2, np.random.default_rng(3))
    _fill(jstorage, 2, np.random.default_rng(3))
    specs = list(storage.chunks())
    assert [(c.level_id, c.chunk_slice) for c in specs] == \
        [(c.level_id, c.chunk_slice) for c in jstorage.chunks()]
    for cs in specs:
        np.testing.assert_array_equal(storage.sample_pairs_level(cs),
                                      jstorage.sample_pairs_level(cs))


def test_memory_gap_levels_and_zero_costs():
    m = mt.Memory()
    m.save_samples(
        {1: [("L01_S0000000", (np.array([1.0]), np.array([2.0])))]},
        {0: [("L00_S0000000", "solver crash")]})
    assert m.get_n_collected() == [0, 1]
    pairs = m.sample_pairs()
    assert pairs[0] is None and pairs[1].shape == (1, 1, 2)
    assert m.failed_samples() == {"0": ["L00_S0000000"]}
    assert list(m.n_finished()) == [1, 1]
    m.save_n_ops([(0, (1.0, 10)), (1, (0.5, 10)), (2, (0.0, 10))])
    assert m.get_n_ops() == [0.1, 0.05, 0.0]


def test_device_memory_reserve_capacity():
    """reserve_capacity grows the level buffer once, straight to the
    target's power of two, without changing stored content."""
    st = mt.DeviceMemory(device="cpu")
    ids = lambda lo, n: ["L00_S%07d" % i for i in range(lo, lo + n)]
    rng = np.random.default_rng(1)
    mk = lambda n: torch.from_numpy(rng.normal(size=(n, 2, 3)).astype(np.float32))

    a = mk(100)
    st.save_samples_bulk(0, ids(0, 100), a[:, 0], a[:, 1])
    st.reserve_capacity(0, 5000)
    buf, n = st.raw_level_payload(0)
    assert buf.shape[0] == 8192 and n == 100
    b = mk(600)
    st.save_samples_bulk(0, ids(100, 600), b[:, 0], b[:, 1])
    buf2, n2 = st.raw_level_payload(0)
    assert buf2.shape[0] == 8192 and n2 == 700 and buf2.dtype == torch.float32
    got = st.sample_pairs()[0].numpy()
    assert got.shape == (3, 700, 1)
    np.testing.assert_array_equal(got[:, :, 0],
                                  torch.cat([a, b])[:, 0, :].numpy().T)

    st2 = mt.DeviceMemory(device="cpu")
    st2.reserve_capacity(0, 3000)
    st2.save_samples_bulk(0, ids(0, 10), mk(10)[:, 0], mk(10)[:, 1])
    assert st2.raw_level_payload(0)[0].shape[0] == 4096
    st2.reserve_capacity(0, 100)
    assert st2.raw_level_payload(0)[0].shape[0] == 4096
    # an append past the capacity doubles it and keeps the content
    c = mk(5000)
    st2.save_samples_bulk(0, ids(10, 5000), c[:, 0], c[:, 1])
    assert st2.raw_level_payload(0)[0].shape[0] == 8192
    assert torch.equal(st2.sample_pairs()[0][:, 10:, 0], c[:, 0].T)


def test_memory_vectors_span_all_known_levels():
    storage = mt.Memory()
    storage.save_global_data(result_format=_result_format(),
                             level_parameters=[[0.5], [0.25], [0.125]])
    for lvl in range(3):
        storage.save_scheduled_samples(lvl, ["L%02d_S%07d" % (lvl, 0)])
    storage.save_samples(
        {0: [("L00_S0000000", (np.zeros(M), np.zeros(M)))]},
        {1: [("L01_S0000000", "boom")]})
    storage.save_n_ops([(0, [1.0, 1])])
    assert storage.get_n_levels() == 3
    assert storage.get_n_collected() == [1, 0, 0]
    assert storage.n_finished().tolist() == [1.0, 1.0, 0.0]
    assert storage.get_n_ops()[1:] == [0.0, 0.0]
    pairs = storage.sample_pairs()
    assert len(pairs) == 3 and pairs[1] is None and pairs[2] is None
    empty = storage.sample_pairs_level(next(storage.chunks(level_id=1)))
    assert empty.shape == (M, 0, 2)


@pytest.mark.parametrize("kind", ["memory", "device"])
def test_empty_level_chunk_reads(kind):
    storage = _storage(kind)
    storage.save_global_data(result_format=_result_format(),
                             level_parameters=[[0.5], [0.25]])
    for lvl in range(2):
        storage.save_scheduled_samples(lvl, ["L%02d_S%07d" % (lvl, 0)])
    storage.save_samples({0: [("L00_S0000000", (np.zeros(M), np.zeros(M)))]}, {})
    assert storage.get_n_levels() == 2
    assert list(storage.get_n_collected()) == [1, 0]
    empty = storage.sample_pairs_level(next(storage.chunks(level_id=1)))
    assert empty.shape[0] == M and empty.shape[1] == 0


def test_storage_from_jax_copies_a_sampler_run():
    from mlmc_tpu import DeviceBatchPool as JPool, Memory as JMemory
    from mlmc_tpu import Sampler as JSampler, SynthSimulation as JSynth

    jstorage = JMemory()
    sampler = JSampler(jstorage, JPool(seed=4, min_bucket=64),
                       JSynth(dict(distr="norm", complexity=2, nan_fraction=0.1)),
                       [[0.1], [0.01], [0.001]])
    sampler.set_initial_n_samples([120, 60, 30])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    for storage in (mt.Memory(), mt.DeviceMemory(device="cpu")):
        got = mt.storage_from_jax(jstorage, storage)
        assert got is storage
        assert got.get_n_collected() == jstorage.get_n_collected()
        assert got.get_level_parameters() == jstorage.get_level_parameters()
        assert got.load_result_format() == jstorage.load_result_format()
        np.testing.assert_allclose(got.get_n_ops(), jstorage.get_n_ops(), rtol=1e-15)
        assert {k: len(v) for k, v in got.load_scheduled_samples().items()} == \
            {k: len(v) for k, v in jstorage.load_scheduled_samples().items()}
        for a, b in zip(got.sample_pairs(), jstorage.sample_pairs()):
            np.testing.assert_array_equal(_np(a), np.asarray(b).astype(_np(a).dtype))


# --------------------------------------------------------------------- #
# tags
# --------------------------------------------------------------------- #
def test_tags_match_jax():
    from mlmc_tpu import tags as jtags

    idx = np.array([0, 5, 123, 9_999_999, 12_345_678])
    np.testing.assert_array_equal(ttags.format_tags(3, idx), jtags.format_tags(3, idx))
    assert ttags.format_tag(2, 123) == jtags.format_tag(2, 123) == "L02_S0000123"
    assert ttags.parse_tag(b"L02_S0000123") == (2, 123)
    tagged = jtags.format_tags(1, idx[:4])
    np.testing.assert_array_equal(ttags.parse_tags(tagged), idx[:4])
    np.testing.assert_array_equal(ttags.parse_tags(["L1_S5", "L01_S0000007"]), [5, 7])
    r = ttags.TagRange(1, 10, 20)
    assert len(r) == 10 and list(r[2:4]) == ["L01_S0000012", "L01_S0000013"]
    assert isinstance(r[::3], ttags.TagArray) and list(r[::3]) == list(
        jtags.TagRange(1, 10, 20)[::3])
    a = ttags.TagArray(1, [4, 2]) + ttags.TagArray(1, [9])
    assert a.tolist() == ["L01_S0000004", "L01_S0000002", "L01_S0000009"]
    chain = ttags.TagChain([r, a, ["x"]])
    assert len(chain) == 14 and chain[10] == "L01_S0000004" and chain[-1] == "x"
    np.testing.assert_array_equal(np.asarray(chain),
                                  np.asarray(jtags.TagChain([jtags.TagRange(1, 10, 20),
                                                             ["L01_S0000004", "L01_S0000002",
                                                              "L01_S0000009", "x"]])))


# --------------------------------------------------------------------- #
# Sampler and pools
# --------------------------------------------------------------------- #
def _cpu_pool(**kw):
    return mt.DeviceBatchPool(device="cpu", **kw)


@pytest.mark.parametrize("pool_factory", [mt.OneProcessPool, _cpu_pool])
def test_sampler_counters(pool_factory):
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2, nan_fraction=0.1))
    storage = mt.Memory()
    step_range = [[0.1], [0.01], [0.001]]
    sampler = mt.Sampler(sample_storage=storage, sampling_pool=pool_factory(),
                         sim_factory=sim, level_parameters=step_range)
    assert len(sampler._level_sim_objects) == len(step_range)
    for step, level_sim in zip(step_range, sampler._level_sim_objects):
        assert step[0] == level_sim.config_dict["fine_step"]
    init_samples = list(np.ones(len(step_range)) * 10)
    sampler.set_initial_n_samples(init_samples)
    assert np.allclose(sampler._n_target_samples, init_samples)
    assert 0 == sampler.ask_sampling_pool_for_samples()
    sampler.schedule_samples()
    assert np.allclose(sampler._n_scheduled_samples, init_samples)
    n_estimated = np.array([100, 50, 20])
    sampler.process_adding_samples(n_estimated, 0, 0.1)
    assert np.allclose(sampler._n_target_samples,
                       init_samples + (n_estimated * 0.1), atol=1)
    assert np.all(storage.n_finished() >= sampler._n_target_samples * 0.5)


def test_renew_failed_samples():
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2, nan_fraction=0.3))
    storage = mt.Memory()
    sampler = mt.Sampler(storage, _cpu_pool(seed=3), sim, [[0.1], [0.01]])
    sampler.set_initial_n_samples([50, 50])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert sum(len(v) for v in storage.failed_samples().values()) > 0
    for _ in range(20):
        sampler.renew_failed_samples()
        sampler.ask_sampling_pool_for_samples()
        if sum(len(v) for v in storage.failed_samples().values()) == 0:
            break
    assert sum(len(v) for v in storage.failed_samples().values()) == 0
    assert storage.get_n_collected() == [50, 50]


def test_sample_range():
    sampler = mt.Sampler(mt.Memory(), _cpu_pool(),
                         mt.SynthSimulation(dict(distr="norm", complexity=2)),
                         [[0.1], [0.01], [0.001], [0.0001]])
    rng = sampler.sample_range(1000, 10)
    assert rng[0] == 1000 and rng[-1] == 10
    ratios = rng[:-1] / rng[1:]
    assert np.allclose(ratios, ratios[0], rtol=0.1)


def _run_pool(storage, pool, counts, levels=([0.1], [0.01])):
    sim = mt.SynthSimulation(dict(distr=mt.Norm(), complexity=2))
    sampler = mt.Sampler(storage, pool, sim, list(levels))
    sampler.set_initial_n_samples(list(counts))
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return sampler


def test_keyed_draws_depend_only_on_sample_identity():
    """A sample's values are a function of (seed, level, index, attempt):
    any subset or order of indices reproduces the same rows, and another
    attempt draws anew."""
    sim = mt.SynthSimulation(dict(distr=mt.Norm(), complexity=2, nan_fraction=0.5))
    config = sim.level_instance([0.01], [0.1]).config_dict
    idx = torch.arange(0, 300, dtype=torch.int64)
    zero = torch.zeros_like(idx)
    fine, coarse, failed = sim.calculate_keyed_batch(config, 5, 1, idx, zero)
    assert fine.shape == (300, M) and fine.dtype == torch.float32
    sub = torch.tensor([299, 7, 150], dtype=torch.int64)
    f2, c2, fl2 = sim.calculate_keyed_batch(config, 5, 1, sub, torch.zeros_like(sub))
    assert torch.equal(f2, fine[sub]) and torch.equal(c2, coarse[sub])
    assert torch.equal(fl2, failed[sub])
    f3, _, fl3 = sim.calculate_keyed_batch(config, 5, 1, idx, zero + 1)
    assert not torch.equal(f3, fine) and not torch.equal(fl3, failed)
    f4, _, _ = sim.calculate_keyed_batch(config, 5, 2, idx, zero)
    assert not torch.equal(f4, fine)
    assert 0.4 < float(failed.double().mean()) < 0.6
    z = torch.from_numpy(fine[:, 0].numpy().astype(np.float64))
    assert abs(float(z.mean())) < 0.3


def test_device_pool_slicing_and_range_parity():
    """Results do not depend on how a level is cut into batches, nor on
    whether indices arrive as a range or as an explicit array."""
    results = []
    for max_batch in (10_000, 128):
        storage = mt.Memory()
        _run_pool(storage, _cpu_pool(seed=6, min_bucket=64, max_batch=max_batch),
                  (500, 100))
        results.append(storage.sample_pairs())
    storage = mt.Memory()
    pool = _cpu_pool(seed=6, min_bucket=64, max_batch=256)
    sampler = mt.Sampler(storage, pool, mt.SynthSimulation(dict(distr=mt.Norm())),
                         [[0.1], [0.01]])
    for lvl, n in ((0, 500), (1, 100)):
        pool.schedule_level_batch(sampler._level_sim_objects[lvl],
                                  np.arange(n, dtype=np.int64))
    sampler.ask_sampling_pool_for_samples()
    results.append(storage.sample_pairs())
    for a, b, c in zip(*results):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


def test_device_pool_wave_fetches_and_parity():
    """The first wave pays the C_l probes each (level, cost class) lacks —
    two per class, however many slices of it the wave holds — plus one
    blocking fetch for all other slices; a warm round pays one fetch.
    Results equal a single round of the same indices."""
    storage_a, pool_a = mt.Memory(), _cpu_pool(seed=6, min_bucket=64, max_batch=128)
    sampler_a = _run_pool(storage_a, pool_a, (500, 300))
    # 4 + 3 slices of one cost class per level: 2 + 2 probes, 1 drain
    assert pool_a.n_blocking_fetches == 5
    sampler_a.set_level_target_n_samples([1000, 600])
    sampler_a.schedule_samples()
    sampler_a.ask_sampling_pool_for_samples()
    assert pool_a.n_blocking_fetches == 6
    assert pool_a.n_dispatches == 7 + 7
    storage_b = mt.Memory()
    _run_pool(storage_b, _cpu_pool(seed=6, min_bucket=64, max_batch=128), (1000, 600))
    for a, b in zip(storage_a.sample_pairs(), storage_b.sample_pairs()):
        np.testing.assert_array_equal(a, b)


def test_device_pool_inflight_budget_parity():
    results = []
    for budget in (None, 1):
        storage = mt.Memory()
        # a budget of one byte drains after every batch
        pool = _cpu_pool(seed=6, min_bucket=64, max_batch=128,
                         inflight_bytes=budget)
        assert pool._inflight_bytes == (budget or pool.INFLIGHT_BYTES)
        _run_pool(storage, pool, (700, 300))
        results.append(storage.sample_pairs())
    for a, b in zip(*results):
        np.testing.assert_array_equal(a, b)


def test_device_pool_cost_model():
    storage, pool = mt.Memory(), _cpu_pool(seed=9, min_bucket=64, max_batch=128)
    _run_pool(storage, pool, (500, 300))
    n_ops = storage.get_n_ops()
    assert len(n_ops) == 2 and all(c > 0 for c in n_ops)
    for lvl, t in pool.times.items():
        assert t[1] <= 500
        assert (lvl, 128, True) in pool._timed


def test_device_pool_nan_results_fail():
    """NaN results are failed samples; device results stay tensors."""

    class NanSim(mt.SynthSimulation):
        @staticmethod
        def calculate_keyed_batch(config, seed, level_id, indices, attempts):
            fine, coarse, failed = mt.SynthSimulation.calculate_keyed_batch(
                config, seed, level_id, indices, attempts)
            bad = (indices % 5 == 0) & (attempts == 0)
            fine = torch.where(bad[:, None], torch.full_like(fine, float("nan")), fine)
            return fine, coarse, failed

    storage = mt.DeviceMemory(device="cpu")
    pool = _cpu_pool(seed=1, device_results=True)
    sampler = mt.Sampler(storage, pool, NanSim(dict(distr="norm")), [[0.1], [0.01]])
    sampler.set_initial_n_samples([50, 20])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert storage.get_n_collected() == [40, 16]
    assert storage.failed_samples()["0"][:2] == ["L00_S0000000", "L00_S0000005"]
    assert isinstance(storage.raw_level_payload(0)[0], torch.Tensor)
    sampler.renew_failed_samples()
    sampler.ask_sampling_pool_for_samples()
    assert storage.get_n_collected() == [50, 20]
    assert not torch.isnan(storage.sample_pairs()[0]).any()


def test_device_memory_matches_memory():
    """DeviceMemory + device_results pool give the host path's estimates
    and bookkeeping."""
    import mlmc_tpu_torch.quantity.quantity_estimate as qe

    res = []
    for storage, pool in [
            (mt.Memory(), _cpu_pool(seed=4, min_bucket=64)),
            (mt.DeviceMemory(device="cpu"),
             _cpu_pool(seed=4, min_bucket=64, device_results=True))]:
        sim = mt.SynthSimulation(dict(distr="norm", complexity=2, nan_fraction=0.05))
        s = mt.Sampler(storage, pool, sim, [[0.1], [0.01]])
        s.set_initial_n_samples([200, 100])
        s.schedule_samples()
        s.ask_sampling_pool_for_samples()
        root = mt.make_root_quantity(storage, sim.result_format(), device="cpu")
        m = qe.estimate_mean(qe.moments(root["length"][1]["10"][0],
                                        mt.Legendre(5, (-4, 4))))
        res.append((np.asarray(m.mean), list(m.n_samples),
                    storage.get_n_collected(),
                    {k: list(v) for k, v in storage.failed_samples().items()}))
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-6, atol=1e-7)
    assert res[0][1:] == res[1][1:]
