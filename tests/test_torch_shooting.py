"""mlmc_tpu_torch.sim.shooting against mlmc_tpu.sim.shooting.

Both packages run the same level (``level_config_from_jax`` carries the
wave numbers across) on the same phase trig, made once with numpy; f64 on
both sides: equal NaN masks and results to 1e-9 relative, fine and coarse,
1D and 2D, on the one-matmul route (``log=False``) and the generic route.
A 2-level run through Sampler -> DeviceBatchPool -> Estimate then holds
the port's estimation tiers against mlmc_tpu's on the same samples.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.sim.shooting import ShootingSimulation1D, ShootingSimulation2D

torch.set_num_threads(1)

CONFIG = dict(
    start_position=(0.0, 0.0),
    start_velocity=(10.0, 0.0),
    area_borders=(-100.0, 200.0, -300.0, 400.0),
    max_time=10.0,
    complexity=10.0,
    n_modes=64,
    fields_params=dict(model="gauss", corr_length=1.0, sigma=1.0, log=False),
)


def _jax_cls(name):
    import mlmc_tpu.sim.shooting as js
    return getattr(js, name)


def _configs(cls_name, log, borders=None, model="gauss"):
    """(mlmc_tpu level config, the port's copy of it in f64)."""
    cfg = dict(CONFIG, fields_params=dict(CONFIG["fields_params"], log=log,
                                          model=model))
    if borders is not None:
        cfg["area_borders"] = borders
    jcfg = _jax_cls(cls_name)(cfg).level_instance([0.05], [0.25]).config_dict
    return jcfg, mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")


def _trig(n, axes, seed=0):
    phases = np.random.default_rng(seed).uniform(0, 2 * np.pi, size=(n, 64, axes))
    return np.cos(phases), np.sin(phases)


@pytest.mark.parametrize("which", ["fine", "coarse"])
@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("cls_name,axes", [("ShootingSimulation1D", 1),
                                            ("ShootingSimulation2D", 2)])
def test_calculate_level_matches_mlmc_tpu(cls_name, axes, log, which):
    import jax.numpy as jnp

    # borders tight enough that some trajectories leave (NaN results): a
    # log field's force is positive, so y only grows and the y border sits
    # at the median final y of the open run
    cosp, sinp = _trig(48, axes)
    y_max = 8.0
    if log:
        jcfg, _ = _configs(cls_name, log, borders=(-1e9, 1e9, -1e9, 1e9))
        y_max = float(np.median(np.asarray(_jax_cls(cls_name)._calculate_level(
            jcfg, None, which, trig=(jnp.asarray(cosp), jnp.asarray(sinp))))[:, -1]))
    jcfg, tcfg = _configs(cls_name, log, borders=(-1e4, 1e4, -8.0, y_max))
    want = np.asarray(_jax_cls(cls_name)._calculate_level(
        jcfg, None, which, trig=(jnp.asarray(cosp), jnp.asarray(sinp))))
    tcls = getattr(mt, cls_name)
    trig = (torch.tensor(cosp), torch.tensor(sinp))
    got = tcls._calculate_level(tcfg, trig, which).numpy()
    assert got.shape == want.shape == (48, axes)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert 0 < np.isnan(want).sum() < want.size
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-9, atol=1e-12)
    # the generic route (forces, then the Euler matmul) on the same draws
    generic = tcls._calculate_level(tcfg, trig, which, generic=True).numpy()
    assert np.array_equal(np.isnan(generic), np.isnan(want))
    np.testing.assert_allclose(generic[m], want[m], rtol=1e-9, atol=1e-12)


def test_force_field_and_euler_weights_match_mlmc_tpu():
    import jax.numpy as jnp

    jcfg, tcfg = _configs("ShootingSimulation2D", True, model="exp")
    jcls = _jax_cls("ShootingSimulation2D")
    cosp, sinp = _trig(8, 2, seed=3)
    times = np.linspace(0.0, 10.0, 40)
    want = np.asarray(jcls._force_field_batch(
        jcfg, None, jnp.asarray(times), trig=(jnp.asarray(cosp), jnp.asarray(sinp))))
    got = ShootingSimulation2D._force_field_batch(
        tcfg, (torch.tensor(cosp), torch.tensor(sinp)), torch.tensor(times))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(
        ShootingSimulation1D._euler_weights(7, torch.float64).numpy(),
        np.asarray(jcls._euler_weights(7, jnp.float64)))


def test_wave_numbers_follow_the_spectral_measure_and_the_seed():
    from mlmc_tpu_torch.sim.shooting import _spectral_wave_numbers

    k = _spectral_wave_numbers("gauss", 0.5, 20000, seed=4).numpy()
    var = 2.0 / 0.5 ** 2
    assert abs(k.var() - var) < 5 * var * np.sqrt(2.0 / 20000)
    assert np.array_equal(k, _spectral_wave_numbers("gauss", 0.5, 20000, seed=4).numpy())
    assert not np.array_equal(k, _spectral_wave_numbers("gauss", 0.5, 20000, seed=5).numpy())
    # exp: Cauchy-distributed (Student-t with one degree of freedom)
    c = _spectral_wave_numbers("exp", 1.0, 20000, seed=4).numpy()
    assert abs(np.median(np.abs(c)) - 1.0) < 0.05
    sim = ShootingSimulation1D(dict(CONFIG))
    a = sim.level_instance([0.1], [0.5]).config_dict["_wave_numbers"]
    b = sim.level_instance([0.02], [0.1]).config_dict["_wave_numbers"]
    assert torch.equal(a, b) and a.dtype == torch.float64   # one field, every level


def _port_level(cls=ShootingSimulation1D, **over):
    cfg = dict(CONFIG, dtype="float64", **over)
    return cls(cfg).level_instance([0.05], [0.25])


@pytest.mark.parametrize("cls", [ShootingSimulation1D, ShootingSimulation2D])
def test_keyed_batch_is_a_function_of_the_sample_identity(cls):
    cfg = _port_level(cls).config_dict
    idx = torch.arange(24, dtype=torch.int64)
    att = torch.zeros(24, dtype=torch.int64)
    fine, coarse, failed = cls.calculate_keyed_batch(cfg, 9, 1, idx, att)
    assert fine.shape == coarse.shape == (24, cls.result_dim)
    assert fine.dtype == torch.float64 and not failed.any()
    parts = [cls.calculate_keyed_batch(cfg, 9, 1, idx[a:b], att[a:b])
             for a, b in ((0, 5), (5, 24))]
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts]).numpy(), fine.numpy())
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts]).numpy(), coarse.numpy())
    renewed = cls.calculate_keyed_batch(cfg, 9, 1, idx, att + 1)[0]
    other_level = cls.calculate_keyed_batch(cfg, 9, 2, idx, att)[0]
    assert not np.array_equal(renewed.numpy(), fine.numpy())
    assert not np.array_equal(other_level.numpy(), fine.numpy())


def test_generator_batch_and_host_calculate():
    level = _port_level()
    cfg = level.config_dict
    gen = torch.Generator().manual_seed(3)
    fine, coarse, failed = ShootingSimulation1D.calculate_batch(cfg, gen, 32)
    again = ShootingSimulation1D.calculate_batch(
        cfg, torch.Generator().manual_seed(3), 32, device="cpu")
    assert fine.device.type == "cpu" and torch.equal(fine, again[0])
    assert level.nan_result_is_failure is False and not failed.any()
    f1, c1 = ShootingSimulation1D.calculate(cfg, seed=11, device="cpu")
    assert f1.shape == c1.shape == (1,) and np.isfinite(f1).all()
    # level 0 has no coarse grid: zeros
    l0 = ShootingSimulation1D(dict(CONFIG)).level_instance([0.25], [0])
    f0, c0, _ = ShootingSimulation1D.calculate_batch(
        l0.config_dict, torch.Generator().manual_seed(1), 8)
    assert f0.dtype == torch.float32 and torch.all(c0 == 0)


def test_one_process_pool_hands_its_device_to_calculate():
    """The host loop computes each sample where the pool says; with no
    device named a shooting sample goes to the card, so here it fails."""
    sim = ShootingSimulation1D(dict(CONFIG))
    storage = mt.Memory()
    sampler = mt.Sampler(storage, mt.OneProcessPool(device="cpu"), sim,
                         [[0.25], [0.05]])
    sampler.set_initial_n_samples([6, 3])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert list(storage.get_n_collected()) == [6, 3]
    level_sim = sampler._level_sim_objects[0]
    seed = mt.SamplingPool.compute_seed("L00_S0000000")
    _, result, err, _ = mt.SamplingPool.calculate_sample(
        "L00_S0000000", level_sim, device="cpu")
    want = ShootingSimulation1D.calculate(level_sim.config_dict, seed, device="cpu")
    assert err == "" and np.array_equal(result[0], want[0], equal_nan=True)
    if not torch.cuda.is_available():
        _, _, err, _ = mt.SamplingPool.calculate_sample("L00_S0000000", level_sim)
        assert "is_available" in err


def test_tf32_is_refused_on_a_card():
    """The border test is a strict comparison: a float32 batch on a card
    raises when TF32 matmuls are allowed (checked on a stand-in tensor
    here, where there is no card)."""
    from mlmc_tpu_torch.sim import shooting

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"

    class OnCard:
        is_cuda, dtype = True, torch.float32

    shooting._require_full_precision(OnCard())
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-precision"):
            shooting._require_full_precision(OnCard())
        shooting._require_full_precision(torch.zeros(2))        # the CPU: exact
    finally:
        torch.set_float32_matmul_precision("highest")


def _run_mlmc(sim, n, device_results=True, seed=9):
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=seed, device_results=device_results, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, [[0.25], [0.05]])
    sampler.set_initial_n_samples(n)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return storage, sampler


def test_tight_borders_store_nan_and_count_every_sample():
    """NaN (out of borders) is a stored result, never a failed sample; a
    run whose samples are all NaN has no domain."""
    sim = ShootingSimulation1D(dict(CONFIG, area_borders=(-100.0, 200.0, -3.0, 3.0)))
    storage, _ = _run_mlmc(sim, [100, 20])
    assert storage.get_n_collected() == [100, 20]
    pairs = storage.sample_pairs()
    assert torch.isnan(pairs[0]).any() and not torch.isnan(pairs[0]).all()
    q = mt.make_root_quantity(storage, sim.result_format())["target"][10]["0"][0]
    lo, hi = mt.estimate_domain(q, storage, quantile=0.01)
    assert -3.0 <= lo < hi <= 3.0
    dead = ShootingSimulation1D(dict(CONFIG, area_borders=(-1.0, 1.0, -1e-3, 1e-3)))
    storage, _ = _run_mlmc(dead, [40, 10])
    assert storage.get_n_collected() == [40, 10]
    q = mt.make_root_quantity(storage, dead.result_format())["target"][10]["0"][0]
    with pytest.raises(ValueError, match="no finite sample"):
        mt.estimate_domain(q, storage)


def test_shooting_slice_matches_mlmc_tpu_estimate():
    """Sampler -> DeviceBatchPool -> DeviceMemory -> Estimate on a 2-level
    run; the samples are carried into mlmc_tpu and both packages estimate
    them: f64 tier 1e-10, fast tier within the f32 accumulation bound."""
    import mlmc_tpu as jm
    import mlmc_tpu.estimator as jest
    from mlmc_tpu.ops.precision import accumulation_error_bound
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    sim = ShootingSimulation1D(dict(CONFIG, area_borders=(-100.0, 200.0, -60.0, 60.0)))
    storage, sampler = _run_mlmc(sim, [600, 150])
    q = mt.make_root_quantity(storage, sim.result_format())["target"][10]["0"][0]
    domain = mt.estimate_domain(q, storage, quantile=0.01)
    est = mt.Estimate(q, storage, mt.Legendre(5, domain))

    # the coupling: a shared force field makes the level variance small
    pairs = storage.sample_pairs()[1][0].numpy()          # [N, 2]
    ok = ~np.isnan(pairs).any(axis=1)
    assert ok.sum() > 100
    assert np.var(pairs[ok, 0] - pairs[ok, 1]) < 0.5 * np.var(pairs[ok, 0])

    # the same samples in mlmc_tpu
    jstorage = jm.Memory()
    jstorage.save_global_data(
        result_format=[jm.QuantitySpec(name=s.name, unit=s.unit, shape=s.shape,
                                       times=s.times, locations=s.locations)
                       for s in sim.result_format()],
        level_parameters=storage.get_level_parameters())
    for lid, p in enumerate(storage.sample_pairs()):
        p = p.numpy().astype(np.float64)   # the stored f32 values, exactly
        ids = ["L{:02d}_S{:07d}".format(lid, i) for i in range(p.shape[1])]
        jstorage.save_scheduled_samples(lid, ids)
        coarse = p[:, :, 1].T if p.shape[2] > 1 else np.zeros_like(p[:, :, 0].T)
        jstorage.save_samples_bulk(lid, ids, p[:, :, 0].T, coarse)
    jq = j_root(jstorage, jstorage.load_result_format())["target"][10]["0"][0]
    assert jest.Estimate.estimate_domain(jq, jstorage, quantile=0.01) == \
        pytest.approx(domain, rel=1e-12)
    jes = jest.Estimate(jq, jstorage, jm.Legendre(5, domain))

    # mlmc_tpu's generic tier in f64 is the reference: the f64 tier (rows
    # and sums in f64) meets it to 1e-10, the generic tier of the f32 store
    # (rows in f32) to f32 rounding
    j_mean, j_var = jes.estimate_moments()
    ext_mean, ext_var = est.estimate_moments_extended()
    np.testing.assert_allclose(ext_mean, j_mean, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ext_var, j_var, rtol=1e-9, atol=1e-14)
    mean, var = est.estimate_moments()
    np.testing.assert_allclose(mean, j_mean, rtol=0, atol=2e-6)
    np.testing.assert_allclose(var, j_var, rtol=1e-4, atol=1e-12)
    fast_mean, fast_var = est.estimate_moments_fast()
    s_abs = ck.samples_mlmc_plain(est._packed_streams(est._moments_fn, [0]), 5,
                                  basis="legendre", absolute=True,
                                  consts=ck.transform_constants(domain))
    ns = est.estimate_diff_vars_fast()[1]
    bound = sum(accumulation_error_bound(s_abs.sums[l].numpy()) / ns[l]
                for l in range(2))
    assert np.all(np.abs(fast_mean - j_mean) <= bound + 1e-12)
    assert fast_mean[0] == 1.0 and np.all(fast_var >= 0)

    # allocation from the regressed variances: n0 >= n1 >= 2
    raw, ns = est.estimate_diff_vars_fast()
    variances, n_ops = est.estimate_diff_vars_regression(
        sampler._n_scheduled_samples, raw_vars=raw)
    n_est = mt.estimate_n_samples_for_target_variance(1e-3, variances, n_ops, 2)
    assert n_est[0] >= n_est[1] >= 2
