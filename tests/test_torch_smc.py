"""mlmc_tpu_torch.smc against mlmc_tpu's, on the CPU in float64.

The populations replay JAX's draws: ``mlmc_tpu.smc_tempering`` splits its
key into (k_init, k_run); stage s folds s into k_run and splits it into
the resampling key (one uniform per island) and the move keys (one
``split`` per pCN sweep, each giving the innovations and the acceptance
uniforms). ``_JaxDraws`` hands those to the port through ``draws=``. The
tempering schedule, the resampling ancestors and every accept decision
must then be equal, so particles, evidence and adapted step sizes agree
to 1e-10.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import smc as ts

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
I = 8


class _JaxDraws:
    """``mlmc_tpu.smc``'s draws under ``key`` as the port's ``draws``."""

    def __init__(self, key, N, d, n_moves):
        self.k_init, self.k_run = jax.random.split(key)
        self.N, self.d, self.n_moves = N, d, n_moves

    def init(self):
        return torch.tensor(np.asarray(jax.random.normal(self.k_init, (self.N, self.d))))

    def __call__(self, path):
        k_r, k_m = jax.random.split(jax.random.fold_in(self.k_run, path[0]))
        if len(path) == 1:
            u01 = np.asarray(jax.random.uniform(k_r, (I, 1), jnp.float64))
            return None, torch.tensor(np.repeat(u01, self.N // I, axis=1).reshape(-1)), None
        k_xi, k_u = jax.random.split(jax.random.split(k_m, self.n_moves)[path[1]])
        xi = jax.random.normal(k_xi, (self.N, self.d))
        u = jax.random.uniform(k_u, (I, self.N // I), jnp.float64,
                               minval=jnp.finfo(jnp.float64).tiny)
        return torch.tensor(np.asarray(xi)), torch.tensor(np.asarray(u).reshape(-1)), None


def _linear_problem(d=3, n_obs=5, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_obs, d))
    y = A @ rng.normal(size=d) + noise * rng.normal(size=n_obs)
    S = A @ A.T + noise ** 2 * np.eye(n_obs)
    log_z = -0.5 * (n_obs * np.log(2 * np.pi) + np.linalg.slogdet(S)[1]
                    + y @ np.linalg.solve(S, y))
    const = -0.5 * n_obs * np.log(2 * np.pi * noise ** 2)
    Aj, yj, At, yt = jnp.asarray(A), jnp.asarray(y), torch.tensor(A), torch.tensor(y)

    def fj(th, scale=1.0):
        r = Aj @ th - yj
        return const - 0.5 * scale * jnp.sum(r * r) / noise ** 2, th

    def ft(th, scale=1.0):
        r = th @ At.T - yt
        return const - 0.5 * scale * (r * r).sum(1) / noise ** 2, th

    return fj, ft, float(log_z)


def _same(rt, rj):
    assert rt["lambdas"] == pytest.approx(rj["lambdas"], rel=RTOL, abs=1e-14)
    np.testing.assert_allclose(rt["theta"], np.asarray(rj["theta"]), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(rt["qoi"], np.asarray(rj["qoi"]), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(rt["acc_rates"], rj["acc_rates"], rtol=RTOL)
    for k in ("log_evidence", "log_evidence_se", "beta", "mean", "se"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, atol=1e-13, err_msg=k)
    assert rt["n_forward"] == rj["n_forward"]


def test_smc_tempering_replays_mlmc_tpu():
    from mlmc_tpu.smc import smc_tempering

    fj, ft, log_z = _linear_problem()
    key, N, d = jax.random.key(1), 256, 3
    rj = smc_tempering(fj, d, n_particles=N, n_moves=4, key=key)
    rt = mt.smc_tempering(ft, d, n_particles=N, n_moves=4, device="cpu",
                          draws=_JaxDraws(key, N, d, 4))
    _same(rt, rj)
    assert len(rt["lambdas"]) > 2 and rt["lambdas"][-1] == 1.0
    assert abs(rt["log_evidence"] - log_z) < 6 * rt["log_evidence_se"] + 0.1


def test_hierarchical_smc_replays_mlmc_tpu():
    from mlmc_tpu.smc import hierarchical_smc

    fj, ft, _ = _linear_problem(seed=2)
    key, N, d = jax.random.key(3), 128, 3
    fjs = [lambda th: fj(th, 0.8), fj]
    fts = [lambda th: ft(th, 0.8), ft]
    rj = hierarchical_smc(fjs, d, switch_lambdas=[0.3], n_particles=N, n_moves=3, key=key)
    rt = mt.hierarchical_smc(fts, d, switch_lambdas=[0.3], n_particles=N, n_moves=3,
                             device="cpu", draws=_JaxDraws(key, N, d, 3))
    _same(rt, rj)
    assert rt["levels"] == rj["levels"] and rt["levels"][-1] == 1


def test_systematic_resample_matches_mlmc_tpu():
    """Ancestors equal JAX's (softmax, cumulative sum, left search,
    clip) on random weights, including a row whose last cumulative weight
    rounds below the largest uniform."""
    from mlmc_tpu.smc import _systematic_resample

    rng = np.random.default_rng(0)
    m = 64
    log_w = rng.normal(size=(I, m)) * 3.0
    u01 = rng.uniform(size=(I, 1))
    u01[0] = 1.0 - 1e-16
    want = np.asarray(_systematic_resample(jnp.asarray(log_w), jnp.asarray(u01), m,
                                           jnp.float64))
    got = ts._systematic_resample(torch.tensor(log_w), torch.tensor(u01), m)
    np.testing.assert_array_equal(got.numpy(), want)


def test_fixed_order_sums_are_shape_independent():
    x = torch.tensor(np.random.default_rng(1).normal(size=(6, 37)))
    whole = ts._tree_sum(x)
    for r in range(6):
        assert ts._tree_sum(x[r:r + 1])[0] == whole[r]
    np.testing.assert_allclose(whole.numpy(), x.sum(1).numpy(), rtol=1e-14)
    np.testing.assert_allclose(ts._scan(x).numpy(), np.cumsum(x.numpy(), 1), rtol=1e-13)


def test_keyed_smc_evidence_and_validation():
    _, ft, log_z = _linear_problem()
    out = mt.smc_tempering(ft, 3, n_particles=1024, n_moves=5, seed=4, device="cpu")
    assert abs(out["log_evidence"] - log_z) < 6 * out["log_evidence_se"] + 0.05
    assert 0.05 < np.mean(out["acc_rates"]) < 0.9
    with pytest.raises(ValueError, match="divisible by 8"):
        mt.smc_tempering(ft, 3, n_particles=100, device="cpu")
    with pytest.raises(ValueError, match="switch_lambdas"):
        mt.hierarchical_smc([ft, ft], 3, switch_lambdas=[1.2], device="cpu")
    with pytest.raises(RuntimeError, match="did not reach"):
        mt.smc_tempering(lambda th: ft(th, 1e4), 3, n_particles=64, max_stages=2,
                         device="cpu")
