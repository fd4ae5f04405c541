"""mlmc_tpu_torch.sim.sde against mlmc_tpu.sim.sde.

The same standard normals (made with numpy from a seed) drive both
packages through ``coupled_path_functionals``'s ``z=`` path: every
scheme, the antithetic twin, ``drift_shift``, ``path_extras`` and the
barrier within 1e-12 relative (f64). The Heston system gets the draws
JAX's keys make (``normal(fold_in(key, c), (m, 2))``); the closed forms,
the bridge matrix and ``sde_qmc_level_fns`` are held to mlmc_tpu's. The
keyed and generator entry points are held statistically (prices against
Black-Scholes) and by batching invariance.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.sim import sde as ts

torch.set_num_threads(1)


def _js():
    import mlmc_tpu.sim.sde as js
    return js


def _close(a, b, rtol=1e-12):
    """Equal within rtol relative; infinities (a barrier's log survival)
    and NaNs must sit in the same places."""
    a = np.asarray(a, np.float64)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape
    fin = np.isfinite(a)
    assert np.array_equal(fin, np.isfinite(b)) and np.array_equal(a[~fin], b[~fin])
    np.testing.assert_allclose(b[fin], a[fin], rtol=rtol, atol=1e-300)


def _compare_functionals(res_j, res_t, rtol=1e-12):
    for pj, pt in zip(res_j, res_t):
        assert (pj is None) == (pt is None)
        if pj is None:
            continue
        for f in pj._fields:
            a, b = getattr(pj, f), getattr(pt, f)
            assert (a is None) == (b is None), f
            if a is not None:
                _close(a, b, rtol)


def _models(name):
    js = _js()
    if name == "gbm":
        return js.gbm(0.05, 0.2, 1.0), ts.gbm(0.05, 0.2, 1.0)
    if name == "ou":
        return js.ornstein_uhlenbeck(1.5, 0.2, 0.4, 1.0), ts.ornstein_uhlenbeck(1.5, 0.2, 0.4, 1.0)
    return js.cir(1.0, 1.0, 0.5, 1.0), ts.cir(1.0, 1.0, 0.5, 1.0)


@pytest.mark.parametrize("scheme", ["euler", "milstein"])
@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("shift", [0.0, 0.7])
@pytest.mark.parametrize("extras", ["none", "extras", "barrier"])
def test_coupled_path_functionals_match_mlmc_tpu(scheme, antithetic, shift, extras):
    import jax.numpy as jnp

    js = _js()
    mj, mtt = _models("gbm")
    cfg = dict(total_time=1.0, n_fine=32, n_coarse=8, scheme=scheme,
               antithetic=antithetic, drift_shift=shift,
               path_extras=extras != "none")
    if extras == "barrier":
        cfg["barrier"] = 0.85
    z = np.random.default_rng(7).standard_normal((48, 32))
    rj = js.coupled_path_functionals(dict(cfg, model=mj), z=jnp.asarray(z))
    rt = ts.coupled_path_functionals(dict(cfg, model=mtt), torch.tensor(z))
    _compare_functionals(rj, rt)


@pytest.mark.parametrize("model", ["ou", "cir"])
@pytest.mark.parametrize("n_fine,n_coarse", [(16, 0), (16, 4)])
def test_other_models_and_level0_match_mlmc_tpu(model, n_fine, n_coarse):
    import jax.numpy as jnp

    js = _js()
    mj, mtt = _models(model)
    cfg = dict(total_time=1.0, n_fine=n_fine, n_coarse=n_coarse, scheme="euler")
    z = np.random.default_rng(1).standard_normal((40, n_fine))
    rj = js.coupled_path_functionals(dict(cfg, model=mj), z=jnp.asarray(z))
    rt = ts.coupled_path_functionals(dict(cfg, model=mtt), torch.tensor(z))
    assert (rt[2] is None) == (n_coarse == 0)
    _compare_functionals(rj, rt)


@pytest.mark.parametrize("payoff", ["european_call", "european_put", "asian_call",
                                    "lookback_call", "digital_call", "terminal_value",
                                    "lookback_call_bb", "barrier_call_down_out",
                                    "digital_call_smoothed"])
def test_payoffs_and_assemble_match_mlmc_tpu(payoff):
    import jax.numpy as jnp

    js = _js()
    args = {"european_call": (1.0, 0.95), "european_put": (1.0, 0.95),
            "asian_call": (1.0,), "lookback_call": (0.9,), "digital_call": (1.0,),
            "terminal_value": (), "lookback_call_bb": (0.9,),
            "barrier_call_down_out": (1.0,), "digital_call_smoothed": (1.0,)}[payoff]
    mj, mtt = _models("gbm")
    cfg = dict(total_time=1.0, n_fine=16, n_coarse=4, scheme="milstein",
               path_extras=True, barrier=0.85, antithetic=True,
               payoff=None, qoi="payoff")
    z = np.random.default_rng(2).standard_normal((64, 16))
    cj = dict(cfg, model=mj, payoff=getattr(js, payoff)(*args))
    ct = dict(cfg, model=mtt, payoff=getattr(ts, payoff)(*args))
    pj = js.coupled_path_functionals(cj, z=jnp.asarray(z))
    pt = ts.coupled_path_functionals(ct, torch.tensor(z))
    _close(js.SDESimulation._assemble(cj, pj[0], pj[1]), ts.SDESimulation._assemble(ct, pt[0], pt[1]))
    _close(js.SDESimulation._assemble(cj, pj[2], None), ts.SDESimulation._assemble(ct, pt[2], None))


def test_functionals_qoi_with_log_weight_matches_mlmc_tpu():
    import jax.numpy as jnp

    js = _js()
    mj, mtt = _models("gbm")
    cfg = dict(total_time=1.0, n_fine=16, n_coarse=4, scheme="milstein", drift_shift=0.5,
               qoi="functionals")
    z = np.random.default_rng(3).standard_normal((32, 16))
    pj = js.coupled_path_functionals(dict(cfg, model=mj), z=jnp.asarray(z))
    pt = ts.coupled_path_functionals(dict(cfg, model=mtt), torch.tensor(z))
    a = js.SDESimulation._assemble(dict(cfg, model=mj), pj[0], None)
    b = ts.SDESimulation._assemble(dict(cfg, model=mtt), pt[0], None)
    assert b.shape == (32, 5)
    _close(a, b)
    sim = ts.SDESimulation(dict(qoi="functionals", drift_shift=0.5))
    assert [q.name for q in sim.result_format()][-1] == "log_weight"


def test_precision_df64_integrates_in_float64():
    """'df64' (mlmc_tpu's double-float state) is a float64 state here: a
    float32 batch returns float64 values equal to the float64 run."""
    mtt = ts.gbm(0.05, 0.2, 1.0)
    cfg = dict(model=mtt, total_time=1.0, n_fine=64, n_coarse=16, scheme="milstein")
    z = torch.tensor(np.random.default_rng(4).standard_normal((16, 64)), dtype=torch.float32)
    df = ts.coupled_path_functionals(dict(cfg, precision="df64"), z)
    ref = ts.coupled_path_functionals(cfg, z.double())
    assert df[0].terminal.dtype == torch.float64
    assert torch.equal(df[0].terminal, ref[0].terminal)
    assert torch.equal(df[2].terminal, ref[2].terminal)
    with pytest.raises(ValueError, match="precision"):
        ts.coupled_path_functionals(dict(cfg, precision="half"), z)


@pytest.mark.parametrize("antithetic", [False, True])
@pytest.mark.parametrize("n_fine,n_coarse", [(16, 0), (32, 8)])
def test_heston_system_matches_mlmc_tpu_on_its_keys(antithetic, n_fine, n_coarse):
    """The port's Heston loop on the normals JAX's keys give each coarse
    step (normal(fold_in(key, c), (m, 2)))."""
    import jax

    js = _js()
    keys = jax.random.split(jax.random.key(11), 24)
    m = 1 if n_coarse == 0 else n_fine // n_coarse
    trips = n_fine if n_coarse == 0 else n_coarse
    z = np.stack([np.concatenate([np.asarray(jax.random.normal(
        jax.random.fold_in(k, c), (m, 2))) for c in range(trips)]) for k in keys])
    cfg = dict(total_time=1.0, n_fine=n_fine, n_coarse=n_coarse, antithetic=antithetic)
    rj = js.coupled_system_functionals(dict(cfg, model=js.heston()), keys)
    rt = ts.coupled_system_functionals(dict(cfg, model=ts.heston()), torch.tensor(z))
    _compare_functionals(rj, rt)
    sim = ts.SDESystemSimulation(dict(model="heston", qoi="functionals"))
    c = sim.level_instance([1 / 16], [1 / 4]).config_dict
    fine, coarse, _ = ts.SDESystemSimulation._from_draws(
        c, torch.tensor(np.random.default_rng(0).standard_normal((8, 32))))
    assert fine.shape == coarse.shape == (8, 8)


def test_closed_forms_match_mlmc_tpu():
    js = _js()
    cases = [("black_scholes_call", (1.0, 1.05, 0.05, 0.2, 1.0)),
             ("black_scholes_call", (1.0, 1.05, 0.05, 0.0, 1.0)),
             ("black_scholes_digital", (1.0, 1.05, 0.05, 0.2, 1.0)),
             ("lookback_call_price", (1.0, 0.05, 0.2, 1.0)),
             ("barrier_down_out_call_price", (1.0, 1.0, 0.85, 0.05, 0.2, 1.0)),
             ("gbm_call_shift", (0.05, 0.2, 1.0, 1.8, 1.0))]
    for name, args in cases:
        a, b = getattr(js, name)(*args), getattr(ts, name)(*args)
        assert abs(a - b) <= 1e-12 * abs(a), name
    hp = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    a = js.heston_call_price(1.0, 1.0, 0.05, T=1.0, **hp)
    b = ts.heston_call_price(1.0, 1.0, 0.05, T=1.0, **hp)
    assert abs(a - b) <= 1e-12 * abs(a)
    assert np.array_equal(js.brownian_bridge_increments(13), ts.brownian_bridge_increments(13))


@pytest.mark.parametrize("bridge", [False, True])
def test_sde_qmc_level_fns_match_mlmc_tpu(bridge):
    import jax.numpy as jnp

    js = _js()
    disc = float(np.exp(-0.05))
    lp = [[1 / 4], [1 / 16]]
    sj = js.SDESimulation(dict(model=js.gbm(0.05, 0.2, 1.0), scheme="milstein",
                               payoff=js.european_call(1.0, disc)))
    st = ts.SDESimulation(dict(model=ts.gbm(0.05, 0.2, 1.0), scheme="milstein",
                               payoff=ts.european_call(1.0, disc)))
    fj, dj = js.sde_qmc_level_fns(sj, lp, bridge=bridge)
    ft, dt = ts.sde_qmc_level_fns(st, lp, bridge=bridge)
    assert dj == dt == [4, 16]
    for lev in range(2):
        u = np.random.default_rng(lev).uniform(1e-6, 1 - 1e-6, size=(64, dj[lev]))
        for a, b in zip(fj[lev](jnp.asarray(u)), ft[lev](torch.tensor(u))):
            _close(a, b)
    with pytest.raises(ValueError, match="payoff"):
        ts.sde_qmc_level_fns(ts.SDESimulation(dict(qoi="functionals")), lp)


def test_bridge_product_refuses_tf32_on_a_card():
    """A float32 bridge product on a card raises while TF32 is allowed
    (a stand-in tensor here, where there is no card)."""
    from mlmc_tpu_torch.sim.simulation import require_full_precision

    class OnCard:
        is_cuda, dtype = True, torch.float32

    require_full_precision(OnCard(), "x")
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full-precision"):
            require_full_precision(OnCard(), "the Brownian-bridge QMC paths")
    finally:
        torch.set_float32_matmul_precision("highest")


def _call_sim(**kw):
    return ts.SDESimulation(dict(model=ts.gbm(0.05, 0.2, 1.0), scheme="milstein",
                                 payoff=ts.european_call(1.0, float(np.exp(-0.05))),
                                 dtype="float64", **kw))


def test_keyed_batches_do_not_depend_on_batching_and_price_black_scholes():
    """A keyed level batch equals the same indices in two batches, bit for
    bit; the telescoped keyed price meets Black-Scholes within 6 se plus
    the weak bias; the generator path and calculate work on the CPU."""
    sim = _call_sim()
    bs = ts.black_scholes_call(1.0, 1.0, 0.05, 0.2, 1.0)
    total, var = 0.0, 0.0
    for lev, (h, hc) in enumerate([(1 / 4, 0), (1 / 16, 1 / 4)]):
        cfg = sim.level_instance([h], [hc]).config_dict
        idx = torch.arange(4096)
        f, c, failed = ts.SDESimulation.calculate_keyed_batch(cfg, 3, lev, idx,
                                                              torch.zeros_like(idx))
        f2, c2, _ = ts.SDESimulation.calculate_keyed_batch(cfg, 3, lev, idx[1000:],
                                                           torch.zeros_like(idx[1000:]))
        assert torch.equal(f[1000:], f2) and torch.equal(c[1000:], c2)
        assert not bool(failed.any()) and f.dtype == torch.float64
        d = (f - c)[:, 0]
        total += float(d.mean())
        var += float(d.var()) / 4096
    assert abs(total - bs) <= 6 * np.sqrt(var) + 5e-3
    cfg = sim.level_instance([1 / 8], [1 / 2]).config_dict
    g = torch.Generator().manual_seed(0)
    fine, coarse, _ = ts.SDESimulation.calculate_batch(cfg, g, 16, device="cpu")
    assert fine.shape == coarse.shape == (16, 1)
    one = ts.SDESimulation.calculate(cfg, 5, device="cpu")
    assert one[0].shape == (1,) and np.isfinite(one[0]).all()


def test_girsanov_shift_prices_the_deep_otm_call():
    """The deep out-of-the-money call under the tilt: within 6 se of
    Black-Scholes, with a far smaller variance than the plain estimator."""
    K = 1.8
    theta = ts.gbm_call_shift(0.05, 0.2, 1.0, K, 1.0)
    stats = {}
    for name, shift in (("is", theta), ("plain", 0.0)):
        sim = ts.SDESimulation(dict(model=ts.gbm(0.05, 0.2, 1.0), scheme="milstein",
                                    payoff=ts.european_call(K, float(np.exp(-0.05))),
                                    drift_shift=shift, dtype="float64"))
        cfg = sim.level_instance([1 / 32], [0]).config_dict
        v = ts.SDESimulation.calculate_batch(cfg, torch.Generator().manual_seed(1), 1 << 12,
                                             device="cpu")[0][:, 0]
        stats[name] = (float(v.mean()), float(v.var()))
    bs = ts.black_scholes_call(1.0, K, 0.05, 0.2, 1.0)
    assert abs(stats["is"][0] - bs) <= 6 * np.sqrt(stats["is"][1] / 4096) + 2e-5
    assert stats["plain"][1] > 50 * stats["is"][1]


def test_sampler_stored_run_and_quantity_payoff():
    """qoi='functionals' through Sampler -> DeviceBatchPool ->
    DeviceMemory; the call composed in the Quantity algebra meets
    Black-Scholes; kernel C's and D's plain versions give the moments."""
    from mlmc_tpu_torch.quantity import quantity_estimate as qe

    sim = ts.SDESimulation(dict(model=ts.gbm(0.05, 0.2, 1.0), scheme="milstein",
                                qoi="functionals"))
    storage = mt.DeviceMemory(device="cpu")
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(seed=5, device="cpu"), sim,
                         [[1 / 8], [1 / 32]])
    sampler.set_initial_n_samples([4000, 1000])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert storage.get_n_collected() == [4000, 1000]
    root = mt.make_root_quantity(storage, sim.result_format())
    term = root["terminal"][1.0]["-"][0]
    m = qe.estimate_mean(np.maximum(term - 1.0, 0.0) * np.exp(-0.05))
    price, se = float(np.ravel(m.mean)[0]), float(np.sqrt(np.ravel(m.var)[0]))
    assert abs(price - ts.black_scholes_call(1.0, 1.0, 0.05, 0.2, 1.0)) < 6 * se + 2e-3
    est = mt.Estimate(term, storage, mt.Legendre(5, (0.3, 2.5)))
    fast, _ = est.estimate_moments_fast()
    ext, _ = est.estimate_moments_extended()
    assert fast[0] == ext[0] == 1.0 and np.max(np.abs(fast - ext)) < 1e-5
    pairs = storage.sample_pairs()[0][:, :, 0].numpy()          # [M, N]: fine
    assert np.all(pairs[3] <= pairs[1] + 1e-6) and np.all(pairs[1] <= pairs[2] + 1e-6)
