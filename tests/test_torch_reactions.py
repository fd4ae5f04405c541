"""mlmc_tpu_torch.sim.reactions against mlmc_tpu's.

The tau-leap counts depend on the state, so JAX's draws cannot be replayed
directly. Inside each test (monkeypatch), ``jax.random.poisson`` becomes
the float64 inversion of ``1 - jax.random.uniform(key, shape)`` written
below; the port's ``_from_draws`` gets the same uniforms, and its Poisson
is the same inversion: the coupled tau-leap agrees count for count on the
three networks. The SSA replays JAX's exponential and Gumbel draws. The
keyed Poisson sampler is held to its law by a chi-square test at four
means; ``immigration_death_moments`` equals mlmc_tpu's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from mlmc_tpu_torch.random.keyed import SampleKeys
from mlmc_tpu_torch.sim import reactions as tr

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

B = 24
#: counts the test's inversion looks at: P(N > 400) < 2^-53 for every mean
#: these tests reach (at most ~130)
K_MAX = 400


def _inversion(v, lam):
    """``N = #{k : v <= P(N > k)}``, P(N > k) = gammainc(k + 1, lam), f64."""
    k = jnp.arange(K_MAX, dtype=jnp.float64)
    lam = jnp.asarray(lam, jnp.float64)
    sf = jax.scipy.special.gammainc(k[:, None] + 1.0, lam[None, :])
    return jnp.sum(v[None, :] <= sf, axis=0)


def _patched_poisson(key, lam, shape=None, dtype=int):
    return _inversion(1.0 - jax.random.uniform(key, shape, jnp.float64), lam)


def _networks(name):
    import mlmc_tpu.sim.reactions as jr

    if name == "immigration_death":
        return jr.immigration_death(10.0, 1.0, 3), tr.immigration_death(10.0, 1.0, 3)
    if name == "dimerization":
        return jr.dimerization(), tr.dimerization()
    return jr.schlogl(x0=250), tr.schlogl(x0=250)


def _jax_uniforms(keys, n_f, coupled, R):
    """The uniforms JAX's patched Poisson inverts: substep i folds i into
    the lane's key, then (coupled) the stream s."""
    def one(kk):
        if not coupled:
            return jax.random.uniform(kk, (1, R), jnp.float64)
        return jnp.stack([jax.random.uniform(jax.random.fold_in(kk, s), (R,), jnp.float64)
                          for s in range(3)])

    u = jax.jit(jax.vmap(lambda k: jax.vmap(
        lambda i: one(jax.random.fold_in(k, i)))(jnp.arange(n_f))))(keys)
    return torch.tensor(1.0 - np.asarray(u))


@pytest.mark.parametrize("name", ["immigration_death", "dimerization", "schlogl"])
@pytest.mark.parametrize("n_fine,n_coarse", [(4, 0), (8, 4)])
def test_coupled_tau_leap_matches_mlmc_tpu_count_for_count(monkeypatch, name, n_fine,
                                                           n_coarse):
    import mlmc_tpu.sim.reactions as jr

    monkeypatch.setattr(jax.random, "poisson", _patched_poisson)
    net_j, net_t = _networks(name)
    T = 0.5
    cfg = dict(total_time=T, n_fine=n_fine, n_coarse=n_coarse, dtype="float64")
    keys = jax.random.split(jax.random.key(4), B)
    xj = jr.coupled_tau_leap(dict(cfg, network=net_j), keys)
    v = _jax_uniforms(keys, n_fine, n_coarse > 0, net_t.n_reactions)
    xt = tr.coupled_tau_leap(dict(cfg, network=net_t), v)
    assert np.array_equal(xt[0].numpy(), np.asarray(xj[0]))
    assert (xt[1] is None) == (xj[1] is None)
    if xj[1] is not None:
        assert np.array_equal(xt[1].numpy(), np.asarray(xj[1]))
        assert not np.array_equal(xt[0].numpy(), xt[1].numpy())
    # the simulation's stored QoI from the same draws
    sim = tr.ReactionSimulation(dict(network=net_t, total_time=T, dtype="float64"))
    level = sim.level_instance([T / n_fine], [0 if n_coarse == 0 else T / n_coarse])
    fine, coarse, failed = tr.ReactionSimulation._from_draws(level.config_dict, v)
    assert torch.equal(fine, xt[0]) and not bool(failed.any())


def test_ssa_matches_mlmc_tpu_on_its_draws():
    import mlmc_tpu.sim.reactions as jr

    net_j, net_t = _networks("dimerization")
    T, steps = 0.1, 36
    keys = jax.random.split(jax.random.key(8), B)

    def draws(k):
        def one(i):
            ke, kc = jax.random.split(jax.random.fold_in(k, i))
            return (jax.random.exponential(ke, dtype=jnp.float64),
                    jax.random.gumbel(kc, (2,), jnp.float64))
        return jax.vmap(one)(jnp.arange(steps))

    e, g = (torch.tensor(np.asarray(a)) for a in jax.jit(jax.vmap(draws))(keys))
    xj, over_j = jr.ssa_exact(net_j, T, keys, steps, dtype=jnp.float64)
    xt, over_t = tr._ssa_from_draws(net_t, T, e, g, torch.float64)
    assert np.array_equal(xt.numpy(), np.asarray(xj))
    assert np.array_equal(over_t.numpy(), np.asarray(over_j))
    assert 0 < int(over_t.sum()) < B          # the budget runs out on some lanes


@pytest.mark.parametrize("mean", [0.5, 5.0, 30.0, 120.0])
def test_keyed_poisson_has_the_poisson_law(mean):
    """Counts of 2^16 keyed 53-bit uniforms: a chi-square test against the
    Poisson pmf (cells with expected count >= 20, tails pooled), the mean
    within 6 se, and the inversion monotone in the uniform."""
    n = 1 << 16
    idx = torch.arange(n)
    v = tr._keyed_uniforms53(3, 1, idx, torch.zeros_like(idx), 1)[:, 0]
    counts = tr.poisson_from_uniforms(v, mean)
    assert counts.dtype == torch.float64
    c = counts.numpy().astype(np.int64)
    assert abs(c.mean() - mean) < 6 * np.sqrt(mean / n)
    lo, hi = int(stats.poisson.ppf(1e-4, mean)), int(stats.poisson.ppf(1 - 1e-4, mean))
    edges = [k for k in range(lo, hi + 1) if n * stats.poisson.pmf(k, mean) >= 20]
    cells = np.array([np.sum(c <= edges[0])] + [np.sum(c == k) for k in edges[1:-1]]
                     + [np.sum(c >= edges[-1])])
    probs = np.array([stats.poisson.cdf(edges[0], mean)]
                     + [stats.poisson.pmf(k, mean) for k in edges[1:-1]]
                     + [stats.poisson.sf(edges[-1] - 1, mean)])
    chi2 = float(np.sum((cells - n * probs) ** 2 / (n * probs)))
    assert stats.chi2.sf(chi2, len(cells) - 1) > 1e-4, (chi2, len(cells))
    vs = torch.tensor([2.0 ** -53, 1e-9, 0.3, 0.7, 1.0], dtype=torch.float64)
    ks = tr.poisson_from_uniforms(vs, mean)
    assert bool((ks[:-1] >= ks[1:]).all())
    # the inversion by definition, term by term
    expect = [int(np.sum(float(x) <= stats.poisson.sf(np.arange(2000), mean))) for x in vs]
    assert ks.long().tolist() == expect


def test_poisson_of_mean_zero_and_large_means():
    v = torch.tensor([1e-12, 0.5, 1.0], dtype=torch.float64)
    assert tr.poisson_from_uniforms(v, 0.0).tolist() == [0.0, 0.0, 0.0]
    # exp(-mean) underflows float32 here; the float64 gamma does not
    k = tr.poisson_from_uniforms(torch.tensor([0.5], dtype=torch.float64), 400.0)
    assert int(k) == int(stats.poisson.isf(0.5, 400.0)) or abs(int(k) - 400) <= 1


def test_immigration_death_moments_equal_mlmc_tpu():
    import mlmc_tpu.sim.reactions as jr

    for args in [(10.0, 1.0, 0, 0.5), (3.0, 0.2, 40, 2.0)]:
        assert tr.immigration_death_moments(*args) == jr.immigration_death_moments(*args)


def test_tau_leap_and_ssa_keyed_means():
    """Keyed tau-leaping of the linear network at a fine leap, and the
    keyed SSA, both within 6 se (plus the leap's bias) of the exact mean."""
    net = tr.immigration_death(10.0, 1.0, 0)
    keys = SampleKeys(2, 0, torch.arange(1 << 12))
    mean, var = tr.immigration_death_moments(10.0, 1.0, 0, 1.0)
    x = tr.tau_leap(net, 1.0, 32, keys, dtype=torch.float64)[:, 0].numpy()
    assert abs(x.mean() - mean) < 6 * np.sqrt(var / x.size) + 0.2
    xs, over = tr.ssa_exact(net, 1.0, keys, 64, dtype=torch.float64)
    assert not bool(over.any())
    assert abs(float(xs[:, 0].mean()) - mean) < 6 * np.sqrt(var / x.size)
    xs2, _ = tr.ssa_exact(net, 1.0, SampleKeys(2, 0, torch.arange(5, 1 << 12)), 64,
                          dtype=torch.float64)
    assert torch.equal(xs[5:], xs2)          # a lane's events do not depend on batching


def test_simulation_entry_points():
    sim = tr.ReactionSimulation(dict(qoi=lambda x: x[:, 0] + 2 * x[:, 1]))
    cfg = sim.level_instance([1 / 8], [1 / 4]).config_dict
    fine, coarse, failed = tr.ReactionSimulation.calculate_batch(
        cfg, torch.Generator().manual_seed(0), 8, device="cpu")
    assert fine.shape == coarse.shape == (8, 1) and not bool(failed.any())
    # 2A <-> B conserves A + 2B
    assert bool((fine == 400.0).all()) and bool((coarse == 400.0).all())
    idx = torch.arange(16)
    f1, _, _ = tr.ReactionSimulation.calculate_keyed_batch(cfg, 1, 1, idx,
                                                           torch.zeros_like(idx))
    f2, _, _ = tr.ReactionSimulation.calculate_keyed_batch(cfg, 1, 1, idx[3:],
                                                           torch.zeros_like(idx[3:]))
    assert torch.equal(f1[3:], f2)
    assert tr.ReactionSimulation.calculate(cfg, 3, device="cpu")[0].shape == (1,)
    with pytest.raises(ValueError, match="integer"):
        sim.level_instance([1 / 6], [1 / 4])
