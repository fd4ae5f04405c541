"""mlmc_tpu_torch.sim.jumps, sim.levy, sim.rough and tool.fourier_pricing
against mlmc_tpu's.

The JAX simulations draw from keys; this file rebuilds each one's draws
with the same ``fold_in``/``split`` sequence and feeds them to the port's
``coupled_*`` functions: Merton, variance gamma and rBergomi functionals
within 1e-12 relative (f64). The Cholesky and PCA factors, the fBm
covariances, the closed forms and the COS prices equal mlmc_tpu's. The
port's own draws (inversion Poisson, boosted Marsaglia-Tsang gamma, keyed
normals) are held to their laws, the prices to their closed forms, and
the keyed batches to batching invariance.
"""
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.sim import jumps as tj
from mlmc_tpu_torch.sim import levy as tv
from mlmc_tpu_torch.sim import rough as tr
from mlmc_tpu_torch.sim import sde as ts
from mlmc_tpu_torch.tool import fourier_pricing as tf

torch.set_num_threads(1)

B = 24


def _keys(seed):
    import jax
    return jax.random.split(jax.random.key(seed), B)


def _per_step(keys, trips, one):
    """JAX's per-step draws: ``one(fold_in(key, step))`` for every key and
    coarse step, as the JAX simulations make them inside their scan."""
    import jax
    import jax.numpy as jnp

    return jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda c: one(jax.random.fold_in(k, c)))(jnp.arange(trips))))(keys)


def _compare(res_j, res_t, rtol=1e-12):
    for pj, pt in zip(res_j, res_t):
        assert (pj is None) == (pt is None)
        if pj is None:
            continue
        for f in ("terminal", "average", "maximum", "minimum"):
            np.testing.assert_allclose(getattr(pt, f).numpy(),
                                       np.asarray(getattr(pj, f)), rtol=rtol)


def _grid(n_fine, n_coarse):
    m = 1 if n_coarse == 0 else n_fine // n_coarse
    return m, (n_fine if n_coarse == 0 else n_coarse)


@pytest.mark.parametrize("n_fine,n_coarse", [(16, 0), (16, 4)])
def test_merton_matches_mlmc_tpu_on_its_draws(n_fine, n_coarse):
    import jax
    import mlmc_tpu.sim.jumps as jj

    m, trips = _grid(n_fine, n_coarse)
    lam = 3.0                                   # jumps in most paths
    keys = _keys(3)

    def one(kk):
        ka, kb, kc = jax.random.split(kk, 3)
        return (jax.random.normal(ka, (m,)), jax.random.poisson(kb, lam / n_fine, (m,)),
                jax.random.normal(kc, (m,)))

    zw, nn, zj = (np.asarray(x, np.float64).reshape(B, n_fine)
                  for x in _per_step(keys, trips, one))
    assert np.sum(nn) > 0
    cfg = dict(total_time=1.0, n_fine=n_fine, n_coarse=n_coarse)
    rj = jj.coupled_jump_functionals(dict(cfg, model=jj.merton(lam=lam)), keys)
    rt = tj.coupled_jump_functionals(
        dict(cfg, model=tj.merton(lam=lam)), tuple(torch.tensor(x) for x in (zw, nn, zj)))
    _compare(rj, rt)


@pytest.mark.parametrize("n_fine,n_coarse", [(16, 0), (16, 4)])
def test_variance_gamma_matches_mlmc_tpu_on_its_draws(n_fine, n_coarse):
    import jax
    import mlmc_tpu.sim.levy as jv

    m, trips = _grid(n_fine, n_coarse)
    nu = 0.2
    keys = _keys(5)

    def one(kk):
        kg, kz = jax.random.split(kk)
        return (nu * jax.random.gamma(kg, (1.0 / n_fine) / nu, (m,)),
                jax.random.normal(kz, (m,)))

    gg, zz = (np.asarray(x, np.float64).reshape(B, n_fine)
              for x in _per_step(keys, trips, one))
    cfg = dict(total_time=1.0, n_fine=n_fine, n_coarse=n_coarse)
    rj = jv.coupled_vg_functionals(dict(cfg, model=jv.variance_gamma()), keys)
    rt = tv.coupled_vg_functionals(dict(cfg, model=tv.variance_gamma()),
                                   (torch.tensor(gg), torch.tensor(zz)))
    _compare(rj, rt)
    if n_coarse:
        assert torch.equal(rt[0].terminal, rt[1].terminal)   # one path, two monitorings


@pytest.mark.parametrize("n_fine,n_coarse", [(16, 0), (16, 8)])
def test_rbergomi_matches_mlmc_tpu_on_its_draws(n_fine, n_coarse):
    import jax
    import mlmc_tpu.sim.rough as jr

    keys = _keys(9)
    zs, dzs = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        zs.append(np.asarray(jax.random.normal(k1, (2 * n_fine,))))
        dzs.append(np.asarray(jax.random.normal(k2, (n_fine,))) * np.sqrt(1.0 / n_fine))
    cfg = dict(total_time=1.0, n_fine=n_fine, n_coarse=n_coarse)
    sj = jr.coupled_rbergomi_paths(dict(cfg, model=jr.rbergomi()), keys)
    st = tr.coupled_rbergomi_paths(dict(cfg, model=tr.rbergomi()),
                                   torch.tensor(np.array(zs)), torch.tensor(np.array(dzs)))
    np.testing.assert_allclose(st[0].numpy(), np.asarray(sj[0]), rtol=1e-12)
    assert (st[1] is None) == (n_coarse == 0)
    if n_coarse:
        np.testing.assert_allclose(st[1].numpy(), np.asarray(sj[1]), rtol=1e-12)


def test_rough_factors_equal_mlmc_tpu():
    import mlmc_tpu.sim.rough as jr

    for name in ("joint_cholesky", "joint_pca_factor"):
        (a, ta), (b, tb) = getattr(jr, name)(12, 1.0, 0.1), getattr(tr, name)(12, 1.0, 0.1)
        assert np.array_equal(a, b) and np.array_equal(ta, tb)
    t = np.linspace(0.1, 1.0, 7)
    assert np.array_equal(jr.rl_fbm_cov(t, 0.3), tr.rl_fbm_cov(t, 0.3))
    grid = np.linspace(0.0, 1.0, 8)
    assert np.array_equal(jr.rl_fbm_w_cov(t, grid, 0.3), tr.rl_fbm_w_cov(t, grid, 0.3))


def test_rbergomi_qmc_level_fns_match_mlmc_tpu():
    import jax.numpy as jnp
    import mlmc_tpu.sim.rough as jr

    levels = [(8, 0), (16, 8)]
    fj, dj = jr.rbergomi_qmc_level_fns(jr.rbergomi(), 1.0, levels,
                                       lambda s: jnp.maximum(s - 1.0, 0.0),
                                       dtype=jnp.float64)
    ft, dt = tr.rbergomi_qmc_level_fns(tr.rbergomi(), 1.0, levels,
                                       lambda s: torch.clamp(s - 1.0, min=0.0),
                                       dtype=torch.float64)
    assert dj == dt == [24, 48]
    for lev in range(2):
        u = np.random.default_rng(lev).uniform(1e-6, 1 - 1e-6, size=(32, dj[lev]))
        for a, b in zip(fj[lev](jnp.asarray(u)), ft[lev](torch.tensor(u))):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-12, atol=1e-15)


def test_fourier_pricing_matches_mlmc_tpu_and_closed_forms():
    import mlmc_tpu.tool.fourier_pricing as jf

    cfs = [("cf_gbm", (0.05, 0.2, 1.0)), ("cf_merton", (0.05, 0.2, 0.8, -0.1, 0.15, 1.0)),
           ("cf_vg", (0.05, 0.12, -0.14, 0.2, 1.0)),
           ("cf_heston", (0.05, 2.0, 0.04, 0.3, -0.7, 0.04, 1.0))]
    u = np.linspace(-3.0, 3.0, 11)
    for name, args in cfs:
        cj, ct = getattr(jf, name)(*args), getattr(tf, name)(*args)
        assert np.array_equal(cj(u), ct(u))
        for kind in ("call", "put"):
            a = jf.cos_price(cj, 1.0, 1.05, 0.05, 1.0, kind=kind)
            b = tf.cos_price(ct, 1.0, 1.05, 0.05, 1.0, kind=kind)
            assert abs(a - b) <= 1e-12 * abs(a)
        assert jf.cumulants_from_cf(cj) == tf.cumulants_from_cf(ct)
    bs = ts.black_scholes_call(1.0, 1.05, 0.05, 0.2, 1.0)
    cf = tf.cf_gbm(0.05, 0.2, 1.0)
    assert abs(tf.cos_price(cf, 1.0, 1.05, 0.05, 1.0, c1=cf.cumulants[0],
                            c2=cf.cumulants[1]) - bs) < 1e-10
    assert tf.vg_omega(0.12, -0.14, 0.2) == jf.vg_omega(0.12, -0.14, 0.2)
    import mlmc_tpu.sim.jumps as jj
    a = jj.merton_call_price(1.0, 1.0, 0.05, 0.2, 0.8, -0.1, 0.15, 1.0)
    assert abs(tj.merton_call_price(1.0, 1.0, 0.05, 0.2, 0.8, -0.1, 0.15, 1.0) - a) \
        <= 1e-12 * a
    a = jf.cos_price(jf.cf_vg(0.05, 0.12, -0.14, 0.2, 1.0), 1.0, 1.0, 0.05, 1.0)
    import mlmc_tpu.sim.levy as jv
    assert abs(tv.vg_call_price(1.0, 1.0, 0.05, 0.12, -0.14, 0.2, 1.0)
               - jv.vg_call_price(1.0, 1.0, 0.05, 0.12, -0.14, 0.2, 1.0)) <= 1e-12 * a
    with pytest.raises(ValueError, match="martingale"):
        tf.vg_omega(0.12, 5.0, 0.5)


@pytest.mark.parametrize("mean", [0.006, 0.8, 5.0])
def test_inversion_poisson_has_the_poisson_law(mean):
    """The table stops below 1e-17 (a 53-bit uniform never reaches past
    it); counts of many uniforms have the Poisson mean and variance, and
    the inversion is monotone in the uniform."""
    tail = tj.poisson_tail_table(mean)
    assert tail[-1] >= tj.POISSON_TAIL_CUT and np.all(np.diff(tail) < 0)
    v = 1.0 - torch.rand(1 << 18, generator=torch.Generator().manual_seed(1),
                         dtype=torch.float64)
    n = tj.poisson_from_uniforms(v, mean).double()
    se = np.sqrt(mean / n.numel())
    assert abs(float(n.mean()) - mean) < 6 * se
    assert abs(float(n.var()) - mean) < 0.05 * mean + 6 * se
    vs = torch.tensor([2.0 ** -53, 1e-10, 0.5, 1.0], dtype=torch.float64)
    counts = tj.poisson_from_uniforms(vs, mean)
    assert bool((counts[:-1] >= counts[1:]).all()) and int(counts[-1]) == 0


@pytest.mark.parametrize("shape", [0.02, 0.3, 1.0, 4.0])
def test_marsaglia_tsang_gamma_has_the_gamma_law(shape):
    g = torch.Generator().manual_seed(2)
    n, K = 1 << 16, tv.GAMMA_PROPOSALS
    x = torch.randn((n, K), generator=g, dtype=torch.float64)
    u = 1.0 - torch.rand((n, K + 1), generator=g, dtype=torch.float64)
    G = tv.gamma_marsaglia_tsang(shape, x, u[:, :K], u[:, K])
    assert G.dtype == torch.float64 and bool((G >= 0).all())
    se = np.sqrt(shape / n)
    assert abs(float(G.mean()) - shape) < 6 * se
    assert abs(float(G.var()) - shape) < 0.1 * shape
    # log space keeps the small shape's draws representable
    assert bool((G > 0).all()) or shape < 0.05
    with pytest.raises(RuntimeError, match="rejected all"):
        tv.gamma_marsaglia_tsang(shape, torch.full((4, 2), -50.0, dtype=torch.float64),
                                 torch.full((4, 2), 0.5, dtype=torch.float64),
                                 torch.full((4,), 0.5, dtype=torch.float64))


SIMS = {
    "merton": lambda: tj.JumpDiffusionSimulation(dict(
        payoff=ts.european_call(1.0, float(np.exp(-0.05))), dtype="float64",
        model=tj.merton(0.05, 0.2, 0.8, -0.1, 0.15, 1.0))),
    "vg": lambda: tv.VarianceGammaSimulation(dict(
        payoff=ts.european_call(1.0, float(np.exp(-0.05))), dtype="float64")),
    "rbergomi": lambda: tr.RBergomiSimulation(dict(
        payoff=lambda s: torch.clamp(s - 1.0, min=0.0), dtype="float64",
        model=tr.rbergomi(xi0=0.04, eta=0.0))),
}
PRICES = {
    "merton": lambda: tj.merton_call_price(1.0, 1.0, 0.05, 0.2, 0.8, -0.1, 0.15, 1.0),
    "vg": lambda: tv.vg_call_price(1.0, 1.0, 0.05, 0.12, -0.14, 0.2, 1.0),
    "rbergomi": lambda: ts.black_scholes_call(1.0, 1.0, 0.0, 0.2, 1.0),
}


@pytest.mark.parametrize("name", sorted(SIMS))
def test_keyed_batches_price_the_closed_form_and_do_not_depend_on_batching(name):
    """Keyed level batches (Poisson by inversion, gamma by Marsaglia-Tsang,
    rBergomi's normals): a batch equals the same indices in two batches
    bit for bit; the telescoped price of two levels meets its closed form
    (rBergomi at eta = 0: Black-Scholes) within 6 se plus the weak bias."""
    sim = SIMS[name]()
    cls = type(sim)
    total, var = 0.0, 0.0
    for lev, (h, hc) in enumerate([(1 / 8, 0), (1 / 16, 1 / 8)]):
        cfg = sim.level_instance([h], [hc]).config_dict
        idx = torch.arange(1 << 12)
        f, c, failed = cls.calculate_keyed_batch(cfg, 7, lev, idx, torch.zeros_like(idx))
        f2, c2, _ = cls.calculate_keyed_batch(cfg, 7, lev, idx[100:], torch.zeros_like(idx[100:]))
        assert torch.equal(f[100:], f2) and torch.equal(c[100:], c2)
        assert f.dtype == torch.float64 and not bool(failed.any())
        d = (f - c)[:, 0]
        total += float(d.mean())
        var += float(d.var()) / idx.numel()
    assert abs(total - PRICES[name]()) <= 6 * np.sqrt(var) + 5e-3
    cfg = sim.level_instance([1 / 8], [1 / 4]).config_dict
    fine, coarse, _ = cls.calculate_batch(cfg, torch.Generator().manual_seed(0), 8,
                                          device="cpu")
    assert fine.shape == coarse.shape == (8, 1)
    assert cls.calculate(cfg, 3, device="cpu")[0].shape == (1,)


def test_simulations_refuse_options_that_do_not_apply():
    for opt in ("antithetic", "path_extras", "drift_shift"):
        with pytest.raises(ValueError):
            tj.JumpDiffusionSimulation({opt: True})
        with pytest.raises(ValueError):
            tv.VarianceGammaSimulation({opt: True})
    with pytest.raises(ValueError, match="Euler"):
        tj.JumpDiffusionSimulation(dict(scheme="milstein"))
    with pytest.raises(ValueError, match="hurst"):
        tr.rbergomi(hurst=1.5)
