"""mlmc_tpu_torch.mcmc against mlmc_tpu's, on the CPU in float64.

The chains replay JAX's: ``mlmc_tpu`` draws step s of a chain from
``fold_in(k_run, s)`` and ``split``; ``_JaxDraws`` rebuilds those keys
with JAX and hands their normals and uniforms to the port's chain through
its ``draws`` argument (``init(i)`` and a call per step path). The
forward model is ``make_darcy_inverse`` at 8^2 / 16^2 with the JAX
problem's wave vectors (``convert.darcy_inverse_from_jax``): JAX vmaps
its per-theta function, the port evaluates the batch. Both must take the
same accept decisions, so series, acceptance rates, step sizes, meeting
times, ESS and split-R-hat agree (1e-10 where the CG solves round
differently; 1e-8 for ESS and R-hat of a coupled difference series).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import convert
from mlmc_tpu_torch import mcmc as tm
from mlmc_tpu_torch.random.keyed import keyed_words

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
N_MODES, B = 4, 6


@pytest.fixture(scope="module")
def problems():
    """(JAX problem, port problem, JAX fns, port fns) at 8^2 / 16^2, the CG
    run to 1e-12 in both packages (their class default, 1e-6, leaves
    iterates that two implementations round apart at ~1e-10). The JAX
    functions are jitted, so that the drivers' eager first calls compile
    once."""
    from mlmc_tpu import mcmc as jm
    from mlmc_tpu.sim.diffusion import DiffusionSimulation as JaxDiffusion

    mp = pytest.MonkeyPatch()
    for cls in (JaxDiffusion, mt.DiffusionSimulation):
        mp.setattr(cls, "CG_TOL", 1e-12)
    pj = jm.make_darcy_inverse([8, 16], n_modes=N_MODES, sigma=1.0, noise_std=0.05)
    pt = tm.make_darcy_inverse([8, 16], sigma=1.0, noise_std=0.05,
                               **convert.darcy_inverse_from_jax(pj))
    theta_true = np.random.default_rng(3).normal(size=pj["d"])
    clean = np.asarray(jax.jit(lambda th: pj["forward"](th, 16)[0])(jnp.asarray(theta_true)))
    data = clean + 0.05 * np.random.default_rng(4).normal(size=clean.shape)
    yield (pj, pt, [jax.jit(f) for f in pj["loglik_qoi_fns"](jnp.asarray(data))],
           pt["loglik_qoi_fns"](data))
    mp.undo()


class _JaxDraws:
    """``mlmc_tpu``'s draws of B chains as the port's ``draws`` object."""

    def __init__(self, key, d, mode, subsamples=(), n_levels=2):
        self.d, self.mode, self.subs, self.L = d, mode, subsamples, n_levels
        if mode == "unbiased":
            self.k_x0, self.k_y0, self.k_pre, self.k_run = jax.random.split(key, 4)
        else:
            self.k_init, self.k_run = jax.random.split(key)

    def _normal(self, k):
        return torch.tensor(np.asarray(jax.random.normal(k, (B, self.d))))

    @staticmethod
    def _uniform(k):
        return torch.tensor(np.asarray(jax.random.uniform(
            k, (B,), jnp.float64, minval=jnp.finfo(jnp.float64).tiny)))

    def init(self, i=0):
        if self.mode == "unbiased":
            return self._normal((self.k_x0, self.k_y0)[i])
        return self._normal(self.k_init)

    def __call__(self, path):
        s = path[0]
        if self.mode == "unbiased" and s == 0:
            k_xi, k_u = jax.random.split(self.k_pre)
            return self._normal(k_xi), self._uniform(k_u), None
        k = jax.random.fold_in(self.k_run, s)
        if self.mode in ("pcn",):
            k_xi, k_u = jax.random.split(k)
            return self._normal(k_xi), self._uniform(k_u), None
        if self.mode in ("crn", "unbiased"):
            k_xi, k_u, k_w = jax.random.split(k, 3)
            return self._normal(k_xi), self._uniform(k_u), self._uniform(k_w)
        if self.mode == "dodwell":
            k_sub, k_u = jax.random.split(k)
            if len(path) == 1:
                return None, self._uniform(k_u), None
            k_xi, k_u = jax.random.split(jax.random.split(k_sub, self.subs[0])[path[1]])
            return self._normal(k_xi), self._uniform(k_u), None
        # mlda: walk down the nested splits; level 0 draws (xi, u)
        for depth, j in enumerate(path[1:]):
            parent = self.L - 1 - depth
            k_sub, _ = jax.random.split(k)
            k = jax.random.split(k_sub, self.subs[parent - 1])[j]
        if self.L - len(path) == 0:
            k_xi, k_u = jax.random.split(k)
            return self._normal(k_xi), self._uniform(k_u), None
        _, k_u = jax.random.split(k)
        return None, self._uniform(k_u), None


def _same_series(got, want):
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=1e-13)


def _same_chain(rt, rj):
    _same_series(rt.qoi, rj.qoi)
    assert rt.acc_rate == pytest.approx(rj.acc_rate, abs=1e-12)
    for k in ("beta", "ess", "rhat", "mean", "se"):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=RTOL, err_msg=k)


def test_forward_and_loglik_match_mlmc_tpu(problems):
    pj, pt, fj, ft = problems
    assert pt["d"] == pj["d"] == 2 * N_MODES
    theta = np.random.default_rng(1).normal(size=(5, pj["d"]))
    for n, (gj, gt) in zip((8, 16), zip(fj, ft)):
        obs_j, flux_j = jax.jit(jax.vmap(lambda th: pj["forward"](th, n)))(jnp.asarray(theta))
        obs_t, flux_t = pt["forward"](torch.tensor(theta), n)
        np.testing.assert_allclose(obs_t.numpy(), np.asarray(obs_j), rtol=RTOL)
        np.testing.assert_allclose(flux_t.numpy(), np.asarray(flux_j), rtol=RTOL)
        ll_j, q_j = jax.jit(jax.vmap(gj))(jnp.asarray(theta))
        ll_t, q_t = gt(torch.tensor(theta))
        np.testing.assert_allclose(ll_t.numpy(), np.asarray(ll_j), rtol=RTOL)
        assert q_t.shape == (5, 1)


def test_run_pcn_replays_mlmc_tpu(problems):
    from mlmc_tpu import mcmc as jm

    pj, pt, fj, ft = problems
    key = jax.random.key(4)
    rj = jm.run_pcn(fj[1], pj["d"], 20, n_chains=B, beta=0.4, key=key, burn=6)
    rt = tm.run_pcn(ft[1], pt["d"], 20, n_chains=B, beta=0.4, burn=6, device="cpu",
                    draws=_JaxDraws(key, pt["d"], "pcn"))
    _same_chain(rt, rj)
    np.testing.assert_allclose(rt.theta, np.asarray(rj.theta), rtol=RTOL)
    np.testing.assert_allclose(rt.ll, np.asarray(rj.ll), rtol=RTOL)


@pytest.mark.parametrize("mode", ["crn", "dodwell"])
def test_run_coupled_replays_mlmc_tpu(mode, problems):
    from mlmc_tpu import mcmc as jm

    pj, pt, fj, ft = problems
    key = jax.random.key(5)
    kw = dict(n_chains=B, beta=0.4, subsample=2, burn=5, mode=mode)
    rj = jm.run_coupled(fj[1], fj[0], pj["d"], 16, key=key, **kw)
    rt = tm.run_coupled(ft[1], ft[0], pt["d"], 16, device="cpu",
                        draws=_JaxDraws(key, pt["d"], mode, subsamples=(2,)), **kw)
    _same_series(rt.qoi_f, rj.qoi_f)
    _same_series(rt.qoi_c, rj.qoi_c)
    for k in ("acc_rate", "acc_rate_coarse", "mismatch_rate", "glued_rate"):
        assert getattr(rt, k) == pytest.approx(getattr(rj, k), abs=1e-12), k
    np.testing.assert_allclose(rt.beta, rj.beta, rtol=RTOL)
    # statistics of the difference series: its entries cancel to ~1e-3 of
    # the fluxes, so their rounding is held to the fluxes' scale, and ESS /
    # R-hat (ratios of its autocovariances) to 1e-8
    scale = float(np.max(np.abs(rt.qoi_f)))
    for k in ("mean", "se"):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=RTOL,
                                   atol=RTOL * scale, err_msg=k)
    for k in ("ess", "rhat"):
        np.testing.assert_allclose(getattr(rt, k), getattr(rj, k), rtol=1e-8, err_msg=k)


def test_run_mlda_replays_mlmc_tpu(problems):
    from mlmc_tpu import mcmc as jm

    pj, pt, fj, ft = problems
    key = jax.random.key(6)
    rj = jm.run_mlda(fj, pj["d"], 10, n_chains=B, subsamples=2, beta=0.4, key=key, burn=3)
    rt = tm.run_mlda(ft, pt["d"], 10, n_chains=B, subsamples=2, beta=0.4, burn=3,
                     device="cpu", draws=_JaxDraws(key, pt["d"], "mlda", subsamples=(2,)))
    _same_chain(rt, rj)
    assert rt.n_forward == rj.n_forward


def test_run_unbiased_replays_mlmc_tpu(problems):
    from mlmc_tpu import mcmc as jm

    pj, pt, fj, ft = problems
    key = jax.random.key(7)
    kw = dict(k=3, m=8, n_pairs=B, beta=0.5, n_max=14)
    with pytest.warns(RuntimeWarning, match="did not meet") as rec_j:
        rj = jm.run_unbiased(fj[0], pj["d"], key=key, **kw)
    with pytest.warns(RuntimeWarning, match="did not meet") as rec_t:
        rt = tm.run_unbiased(ft[0], pt["d"], device="cpu",
                             draws=_JaxDraws(key, pt["d"], "unbiased"), **kw)
    assert str(rec_t[0].message) == str(rec_j[0].message)
    assert rt["tau"].tolist() == np.asarray(rj["tau"]).tolist()
    assert rt["frac_unmet"] == rj["frac_unmet"] and rt["n_forward"] == rj["n_forward"]
    assert rt["acc_rate"] == pytest.approx(rj["acc_rate"], abs=1e-12)
    for k in ("H", "mean", "se"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=RTOL, atol=1e-13,
                                   err_msg=k)


def _toy_fns(shift):
    """Linear-Gaussian levels: loglik = -|theta[:2] - (1 + shift)|^2 / 2
    (a batch function and its per-theta JAX twin)."""
    def t(theta):
        r = theta[:, :2] - (1.0 + shift)
        return -0.5 * (r * r).sum(1), theta[:, :1] ** 2

    def j(theta):
        r = theta[:2] - (1.0 + shift)
        return -0.5 * jnp.sum(r * r), theta[:1] ** 2
    return t, j


def test_mlmcmc_replays_mlmc_tpu_and_ess_rhat_match():
    from mlmc_tpu import mcmc as jm

    levels = [_toy_fns(0.1 * 2.0 ** -lv) for lv in range(3)]
    key = jax.random.key(9)
    oj = jm.MLMCMC([f[1] for f in levels], d=3).run([30, 20, 12], n_chains=B, key=key)
    draws = [_JaxDraws(k, 3, "pcn" if lv == 0 else "crn")
             for lv, k in enumerate(jax.random.split(key, 3))]
    ot = tm.MLMCMC([f[0] for f in levels], d=3).run([30, 20, 12], n_chains=B, device="cpu",
                                                    draws=draws)
    for k in ("mean", "se", "level_means", "level_ses", "acc_rates"):
        np.testing.assert_allclose(ot[k], oj[k], rtol=RTOL, err_msg=k)
    x = np.random.default_rng(0).normal(size=(64, 5)).cumsum(0)
    assert tm.ess(x) == jm.ess(x) and tm.split_rhat(x) == jm.split_rhat(x)


def test_crn_fixed_point_and_keyed_draws():
    """Identical level likelihoods: the coupled difference is identically
    zero in both modes. The keyed draws of chain b do not depend on how
    many chains run, and stay inside (0, 1) and finite."""
    t, _ = _toy_fns(0.0)
    for mode in ("crn", "dodwell"):
        r = tm.run_coupled(t, t, 3, 25, n_chains=8, seed=3, mode=mode, device="cpu")
        assert np.all(r.diff == 0.0)
    r = tm.run_coupled(t, t, 3, 25, n_chains=8, seed=3, device="cpu")
    assert r.glued_rate == 1.0 and r.mismatch_rate == 0.0
    big, small = (tm.KeyedChainDraws(1, n, 5, device="cpu", stream=2, fanout=(3,))
                  for n in (8, 4))
    for path in ((0,), (7, 2)):
        for a, b in zip(big(path), small(path)):
            assert torch.equal(a[:4], b)
    xi, u, w = big((5,))
    assert bool(((u > 0) & (u < 1) & (w > 0) & (w < 1)).all()) and bool(xi.isfinite().all())
    # a block of steps takes the words keyed_words makes counter by counter
    idx = (2 << 32) | torch.arange(8)
    for s in (0, 63, 64, 130):
        words = keyed_words(1, s, idx, torch.zeros_like(idx), 4)
        xi, u, w = big((s,))
        assert torch.equal(xi, big._normals(words[:, :12]))
        assert torch.equal(torch.stack([u, w], 1), big._uniforms(words[:, 12:]))
    assert not torch.equal(big((5,))[0], big((5, 0))[0])
    assert abs(float(big.init().mean())) < 2.0
    assert mt.MLMCMC is tm.MLMCMC and mt.make_darcy_inverse is tm.make_darcy_inverse
