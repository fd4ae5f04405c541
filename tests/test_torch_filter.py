"""mlmc_tpu_torch.filter against mlmc_tpu's, on the CPU in float64.

The filters replay JAX's draws: ``mlmc_tpu.enkf`` splits its key into
(k_init, k_run) and step t's key ``split(k_run, T)[t]`` into the
propagation and the update key; ``multilevel_enkf`` does the same per
level under ``fold_in(key, level)`` and splits each into R replicate keys.
``_JaxDraws`` hands the port those normals (a keys object whose
``normals(n)`` is ``jax.random.normal(key, (J, n))`` per replicate, the
layout the test transitions draw). Means, spreads, log-likelihoods and
ensembles agree to 1e-10.

Lorenz-96 is chaotic: two correct implementations round apart by ~1e-16
per step and the gap doubles every few cycles, so the replay holds the
two packages together over at most 10 cycles only; the long run is held by
its RMSE against the truth, below the observation noise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


class _Keys:
    """JAX keys as the port's keys: ``normals(n)`` stacks
    ``normal(key_r, (J, n))`` over the keys."""

    def __init__(self, keys, J):
        self.keys, self.J = keys, J

    def normals(self, n, dtype=torch.float64):
        z = np.concatenate([np.asarray(jax.random.normal(k, (self.J, n))) for k in self.keys])
        return torch.tensor(z).to(dtype)


class _JaxDraws:
    """A filter level's JAX draws as the port's ``draws`` (``R = None``:
    ``enkf``'s single ensemble; else ``multilevel_enkf``'s replicates)."""

    def __init__(self, key, T, J, K, R=None, sampler=False):
        self.k_init, k_run = jax.random.split(key)
        self.keys, self.J, self.K, self.R, self.sampler = jax.random.split(k_run, T), J, K, R, sampler

    def init(self, r=0):
        if self.R is None:
            return _Keys([self.k_init], self.J)
        if self.sampler:
            return _Keys([jax.random.fold_in(self.k_init, r)], self.J)

        class Rep:
            def normals(_, n, dtype=torch.float64):
                z = jax.random.normal(self.k_init, (self.R, self.J, n))[r]
                return torch.tensor(np.asarray(z)).to(dtype)
        return Rep()

    def _split(self, t):
        k_prop, k_upd = jax.random.split(self.keys[t])
        if self.R is None:
            return [k_prop], [k_upd]
        return jax.random.split(k_prop, self.R), jax.random.split(k_upd, self.R)

    def propagate(self, t):
        return _Keys(self._split(t)[0], self.J)

    def perturbation(self, t):
        return _Keys(self._split(t)[1], self.J).normals(self.K).reshape(-1, self.J, self.K)


def _linear_ssm(d=4, k=2, T=10, seed=0):
    rng = np.random.default_rng(seed)
    A = 0.9 * np.linalg.qr(rng.normal(size=(d, d)))[0]
    H = rng.normal(size=(k, d))
    q, r = 0.3, 0.5
    x, ys = rng.normal(size=d), []
    for _ in range(T):
        x = A @ x + q * rng.normal(size=d)
        ys.append(H @ x + r * rng.normal(size=k))
    return A, H, q, r, np.array(ys)


def _linear_models(A, H, q):
    Aj, Hj, At, Ht = jnp.asarray(A), jnp.asarray(H), torch.tensor(A), torch.tensor(H)
    jax_side = (lambda x, key, t: x @ Aj.T + q * jax.random.normal(key, x.shape, x.dtype),
                lambda x: Hj @ x)
    port = (lambda x, keys, t: x @ At.T + q * keys.normals(x.shape[1], x.dtype),
            lambda x: x @ Ht.T)
    return jax_side, port


def _same(rt, rj, keys=("means", "forecast_means", "spread", "ensemble")):
    for k in keys:
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=RTOL, atol=1e-12, err_msg=k)
    assert rt["loglik"] == pytest.approx(rj["loglik"], rel=RTOL)


def test_kalman_filter_is_mlmc_tpus():
    from mlmc_tpu.filter import kalman_filter

    A, H, q, r, ys = _linear_ssm()
    args = (A, H, q ** 2 * np.eye(4), r ** 2 * np.eye(2), np.zeros(4), np.eye(4), ys)
    got, want = mt.kalman_filter(*args), kalman_filter(*args)
    for k in ("means", "covs"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["loglik"] == want["loglik"]


@pytest.mark.parametrize("method,inflation", [("perturbed", 1.0), ("etkf", 1.05)])
def test_enkf_linear_replays_mlmc_tpu(method, inflation):
    from mlmc_tpu.filter import enkf

    A, H, q, r, ys = _linear_ssm()
    (tj, oj), (tt, ot) = _linear_models(A, H, q)
    key, J = jax.random.key(2), 32
    rj = enkf(tj, oj, ys, r, n_ens=J, d=4, key=key, method=method, inflation=inflation)
    rt = mt.enkf(tt, ot, ys, r, n_ens=J, d=4, method=method, inflation=inflation,
                 device="cpu", draws=_JaxDraws(key, len(ys), J, 2))
    _same(rt, rj)


def _l96_truth(T, d=40, dt=0.05, seed=0):
    def rhs(x):
        return (np.roll(x, -1) - np.roll(x, 2)) * np.roll(x, 1) - x + 8.0
    rng = np.random.default_rng(seed)
    x = 8.0 + rng.normal(size=d)
    for _ in range(200):                       # spin up onto the attractor
        k1 = rhs(x); k2 = rhs(x + 0.5 * dt * k1); k3 = rhs(x + 0.5 * dt * k2)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + rhs(x + dt * k3))
    xs, ys = [x.copy()], []
    for _ in range(T):
        k1 = rhs(x); k2 = rhs(x + 0.5 * dt * k1); k3 = rhs(x + 0.5 * dt * k2)
        x = x + dt / 6 * (k1 + 2 * k2 + 2 * k3 + rhs(x + dt * k3))
        xs.append(x.copy())
        ys.append(x[::2] + rng.normal(size=d // 2))
    return np.array(xs[1:]), np.array(ys), xs[0]


@pytest.mark.parametrize("method", ["perturbed", "etkf"])
def test_enkf_lorenz96_replays_mlmc_tpu_short_horizon(method):
    """10 cycles: short enough that the chaotic growth of the packages'
    rounding differences stays below 1e-10."""
    from mlmc_tpu.filter import enkf, lorenz96_step

    xs, ys, _ = _l96_truth(10)
    key, J = jax.random.key(4), 24
    x0 = 8.0 + np.random.default_rng(1).normal(size=(J, 40))
    rj = enkf(lorenz96_step(model_noise=0.1), lambda x: x[::2], ys, 1.0, n_ens=J, d=40,
              x0=x0, key=key, method=method, inflation=1.1)
    rt = mt.enkf(mt.lorenz96_step(model_noise=0.1), lambda x: x[:, ::2], ys, 1.0, n_ens=J,
                 d=40, x0=torch.tensor(x0), method=method, inflation=1.1,
                 draws=_JaxDraws(key, 10, J, 20))
    _same(rt, rj)


def test_enkf_lorenz96_long_run_tracks_truth():
    """150 cycles with the port's keyed draws from an ensemble around the
    spun-up state (``tests/test_filter.py``'s setup): the analysis RMSE
    against the truth stays below the observation noise (1.0)."""
    xs, ys, start = _l96_truth(150, seed=2)
    x0 = start + np.random.default_rng(3).normal(size=(64, 40))
    out = mt.enkf(mt.lorenz96_step(), lambda x: x[:, ::2], ys, 1.0, n_ens=64, d=40,
                  x0=torch.tensor(x0), method="etkf", inflation=1.05, seed=1)
    rmse = np.sqrt(np.mean((out["means"][50:] - xs[50:]) ** 2))
    assert rmse < 1.0, rmse
    assert np.all(np.isfinite(out["spread"]))


def _ou_euler_level(kappa, sig_m, window, n_sub, jax_side):
    """OU over one window by n_sub Euler substeps, the noise drawn as
    [N, n_sub d] from the keys (same keys at any n_sub: pathwise close)."""
    dt = window / n_sub

    def euler(x, z):
        z = z.reshape(x.shape[0], n_sub, x.shape[1])
        for j in range(n_sub):
            x = x - kappa * x * dt + sig_m * np.sqrt(dt) * z[:, j]
        return x

    if jax_side:
        return lambda x, key, t: euler(x, jax.random.normal(
            key, (x.shape[0], n_sub * x.shape[1]), x.dtype))
    return lambda x, keys, t: euler(x, keys.normals(n_sub * x.shape[1], x.dtype))


@pytest.mark.parametrize("method,sampler", [("etkf", False), ("perturbed", True)])
def test_multilevel_enkf_replays_mlmc_tpu(method, sampler):
    from mlmc_tpu.filter import multilevel_enkf

    data = np.asarray(jax.random.normal(jax.random.key(1), (5, 1)))
    key, R, n_ens = jax.random.key(3), 3, [16, 8]
    sj = ((lambda k, J: 0.5 * jax.random.normal(k, (J, 1))) if sampler else None)
    st = ((lambda keys, J: 0.5 * keys.normals(1)) if sampler else None)
    rj = multilevel_enkf(lambda lev: _ou_euler_level(1.0, 0.5, 0.5, 2 ** lev, True),
                         lambda x: x, data, 0.3, n_levels=2, d=1, n_ens=n_ens, key=key,
                         n_replicates=R, method=method, x0_sampler=sj)
    draws = [_JaxDraws(jax.random.fold_in(key, lev), 5, n_ens[lev], 1, R, sampler)
             for lev in range(2)]
    rt = mt.multilevel_enkf(lambda lev: _ou_euler_level(1.0, 0.5, 0.5, 2 ** lev, False),
                            lambda x: x, data, 0.3, n_levels=2, d=1, n_ens=n_ens,
                            n_replicates=R, method=method, x0_sampler=st, device="cpu",
                            draws=draws)
    for k in ("means", "means_se", "correction_l1"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=RTOL, atol=1e-13, err_msg=k)
    for a, b in zip(rt["level_ses"], rj["level_ses"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-13)


def test_multilevel_enkf_identical_kernels_zero_correction():
    tr = _ou_euler_level(1.0, 0.5, 0.5, 4, False)
    data = np.random.default_rng(1).normal(size=(6, 1))
    res = mt.multilevel_enkf(lambda lev: tr, lambda x: x, data, 0.4, n_levels=3, d=1,
                             n_ens=16, n_replicates=4, method="etkf", seed=2, device="cpu")
    assert np.all(res["correction_l1"] == 0.0)
    np.testing.assert_array_equal(res["means"], res["level_means"][0])


def test_validation():
    A, H, q, r, ys = _linear_ssm(T=2)
    _, (tt, ot) = _linear_models(A, H, q)
    with pytest.raises(ValueError, match="unknown method"):
        mt.enkf(tt, ot, ys, r, n_ens=8, d=4, method="3dvar", device="cpu")
    with pytest.raises(ValueError, match="inflation"):
        mt.enkf(tt, ot, ys, r, n_ens=8, d=4, inflation=0.5, device="cpu")
    with pytest.raises(ValueError, match="n_ens gives"):
        mt.multilevel_enkf(lambda lev: tt, ot, ys, r, n_levels=3, d=4, n_ens=[8, 8],
                           device="cpu")
