"""mlmc_tpu_torch.particle against mlmc_tpu's, on the CPU in float64.

The filters replay JAX's draws: ``mlmc_tpu.particle_filter`` splits its
key into (k_init, k_run) and step t's key ``split(k_run, T)[t]`` into the
propagation key and the resampling key; the multilevel filter keys level
l's pairs by ``fold_in(key, 1000 + l)`` and splits each step's resampling
key four ways. ``_JaxDraws`` hands the port those normals (through a keys
object whose ``normals(n)`` is ``jax.random.normal(key, (N, n))``, the
layout the test transitions draw) and uniforms. Resampling ancestors must
then be equal, so filtered means, evidence, ESS and the final population
agree to 1e-10. The port's own keyed draws make a ``SampleMesh`` run equal
the one-device run bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import particle as tp

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


class _Keys:
    """A JAX key as the port's keys: ``normals(n)`` -> [N, n]."""

    def __init__(self, key, N):
        self.key, self.N = key, N

    def normals(self, n, dtype=torch.float64):
        return torch.tensor(np.asarray(jax.random.normal(self.key, (self.N, n)))).to(dtype)


class _JaxDraws:
    """One filter level's JAX draws as the port's ``draws``: ``k_init``,
    and step t's key ``split(k_run, T)[t]``."""

    def __init__(self, k_init, k_run, T, N, I):
        self.k_init, self.keys, self.N, self.I = k_init, jax.random.split(k_run, T), N, I

    def init(self, idx):
        return _Keys(self.k_init, self.N)

    def propagate(self, t, idx):
        return _Keys(jax.random.split(self.keys[t])[0], self.N)

    def resample(self, t, islands):
        k_res = jax.random.split(self.keys[t])[1]
        return torch.tensor(np.asarray(jax.random.uniform(k_res, (self.I, 1), jnp.float64)))

    def coupled(self, t, idx):
        k_res = jax.random.split(self.keys[t])[1]
        return tuple(torch.tensor(np.asarray(jax.random.uniform(
            k, (self.I, self.N // self.I), jnp.float64))).reshape(-1)
            for k in jax.random.split(k_res, 4))


M = np.array([[0.9, 0.1], [0.0, 0.8]])
Q_SD, R_SD = 0.3, 0.4


def _linear_gaussian(T=12, seed=0):
    rng = np.random.default_rng(seed)
    x, ys = rng.standard_normal(2), []
    for _ in range(T):
        x = M @ x + Q_SD * rng.standard_normal(2)
        ys.append([x[0] + R_SD * rng.standard_normal()])
    return np.array(ys)


def _lg_jax():
    Mj = jnp.asarray(M)
    return ((lambda x, key, t: x @ Mj.T + Q_SD * jax.random.normal(key, x.shape, x.dtype)),
            (lambda x, y: -0.5 * ((y[0] - x[0]) / R_SD) ** 2))


def _lg_port():
    Mt = torch.tensor(M)
    return ((lambda x, keys, t: x @ Mt.T + Q_SD * keys.normals(2, x.dtype)),
            (lambda x, y: -0.5 * ((y[0] - x[:, 0]) / R_SD) ** 2))


def _ou_levels(n_levels, jax_side, delta=0.5, theta=1.0, sigma=1.0):
    """Euler OU transitions over one window sharing the finest Brownian
    path through the keys (``tests/test_particle.py``'s hierarchy), on
    JAX's side or the port's."""
    n_fin = 2 ** (n_levels - 1)

    def make(lev):
        n_sub, dt = 2 ** lev, delta / 2 ** lev

        def euler(x, dw):          # jnp or torch arrays alike
            dw = (dw * np.sqrt(delta / n_fin)).reshape(x.shape[0], n_sub, -1).sum(-1)
            xx = x[:, 0]
            for i in range(n_sub):
                xx = xx + (-theta * xx) * dt + sigma * dw[:, i]
            return xx[:, None]

        if jax_side:
            return lambda x, key, t: euler(x, jax.random.normal(key, (x.shape[0], n_fin),
                                                                x.dtype))
        return lambda x, keys, t: euler(x, keys.normals(n_fin, x.dtype))

    return make


def test_particle_filter_replays_mlmc_tpu():
    from mlmc_tpu.particle import particle_filter

    ys = _linear_gaussian()
    key, N, I, T = jax.random.key(1), 512, 8, len(ys)
    tj, lj = _lg_jax()
    rj = particle_filter(tj, lj, ys, n_particles=N, d=2, key=key, ess_threshold=0.7)
    k_init, k_run = jax.random.split(key)
    tt, lt = _lg_port()
    rt = mt.particle_filter(tt, lt, ys, n_particles=N, d=2, ess_threshold=0.7,
                            device="cpu", draws=_JaxDraws(k_init, k_run, T, N, I))
    for k in ("means", "means_se", "loglik_islands", "ess", "particles", "log_weights"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=RTOL, atol=1e-12, err_msg=k)
    assert rt["loglik"] == pytest.approx(rj["loglik"], rel=RTOL)
    assert rt["resample_frac"] == rj["resample_frac"] and 0 < rt["resample_frac"] < 1


def test_particle_filter_matches_kalman_with_keyed_draws():
    ys = _linear_gaussian(T=20, seed=3)
    kf = mt.kalman_filter(M, [[1.0, 0.0]], Q_SD ** 2 * np.eye(2), [[R_SD ** 2]],
                          np.zeros(2), np.eye(2), ys)
    tt, lt = _lg_port()
    out = mt.particle_filter(tt, lt, ys, n_particles=1 << 13, d=2, seed=2, device="cpu")
    assert np.all(np.abs(out["means"] - kf["means"]) < 5.0 * np.maximum(out["means_se"], 0.01))
    assert abs(out["loglik"] - kf["loglik"]) < 0.03 * abs(kf["loglik"])


def test_multilevel_particle_filter_replays_mlmc_tpu():
    from mlmc_tpu.particle import multilevel_particle_filter

    ys = np.asarray(np.random.default_rng(5).standard_normal((5, 1)))
    key, I, T, n_per = jax.random.key(6), 8, 5, [128, 64]
    ll_j = lambda x, y: -0.5 * ((y[0] - x[0]) / 0.5) ** 2
    ll_t = lambda x, y: -0.5 * ((y[0] - x[:, 0]) / 0.5) ** 2
    rj = multilevel_particle_filter(_ou_levels(2, True), ll_j, ys, n_levels=2, d=1,
                                    n_particles=n_per, key=key)
    k0, k2 = jax.random.split(jax.random.fold_in(key, 0))
    draws = [_JaxDraws(*jax.random.split(k0), T, n_per[0], I)]
    draws.append(_JaxDraws(jax.random.fold_in(k2, 2001), jax.random.fold_in(k2, 1001),
                           T, n_per[1], I))
    rt = mt.multilevel_particle_filter(_ou_levels(2, False), ll_t, ys, n_levels=2, d=1,
                                       n_particles=n_per, device="cpu", draws=draws)
    for k in ("means", "means_se", "correction_l1"):
        np.testing.assert_allclose(rt[k], np.asarray(rj[k]), rtol=RTOL, atol=1e-13, err_msg=k)
    for a, b in zip(rt["level_means"], rj["level_means"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=RTOL, atol=1e-13)
    assert rt["loglik"] == pytest.approx(rj["loglik"], rel=RTOL)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_mesh_runs_equal_one_device_bit_for_bit(n_shards):
    ys = _linear_gaussian(T=10, seed=4)
    tt, lt = _lg_port()
    mesh = mt.SampleMesh(["cpu"] * n_shards)
    one = mt.particle_filter(tt, lt, ys, n_particles=256, d=2, seed=3, device="cpu")
    shard = mt.particle_filter(tt, lt, ys, n_particles=256, d=2, seed=3, mesh=mesh)
    for k in ("means", "means_se", "loglik_islands", "ess", "particles", "log_weights"):
        np.testing.assert_array_equal(shard[k], one[k], err_msg=k)
    ll = lambda x, y: -0.5 * (y[0] - x[:, 0]) ** 2
    ml = [mt.multilevel_particle_filter(_ou_levels(3, False), ll, ys[:, :1], n_levels=3,
                                        d=1, n_particles=[128, 64, 64], seed=5, **kw)
          for kw in (dict(device="cpu"), dict(mesh=mesh))]
    np.testing.assert_array_equal(ml[1]["means"], ml[0]["means"])
    np.testing.assert_array_equal(ml[1]["correction_l1"], ml[0]["correction_l1"])


def test_identical_kernels_give_exact_zero_corrections():
    fine = _ou_levels(3, False)(2)
    ys = np.asarray(np.random.default_rng(5).standard_normal((6, 1)))
    out = mt.multilevel_particle_filter(
        lambda lev: fine, lambda x, y: -0.5 * (y[0] - x[:, 0]) ** 2, ys, n_levels=3,
        d=1, n_particles=256, seed=6, mesh=mt.SampleMesh(["cpu"] * 2))
    assert np.all(out["correction_l1"] == 0.0)
    np.testing.assert_array_equal(out["means"], out["level_means"][0])


def test_coupled_resample_matches_mlmc_tpu():
    from mlmc_tpu.particle import _coupled_resample

    rng = np.random.default_rng(11)
    m, I = 32, 4
    logwf = np.log(rng.dirichlet(np.ones(m), size=I))
    logwc = np.log(rng.dirichlet(np.ones(m), size=I))
    key = jax.random.key(3)
    want = _coupled_resample(jnp.asarray(logwf), jnp.asarray(logwc), key, m, jnp.float64)
    us = [torch.tensor(np.asarray(jax.random.uniform(k, (I, m), jnp.float64)))
          for k in jax.random.split(key, 4)]
    got = tp._coupled_resample(torch.tensor(logwf), torch.tensor(logwc), *us, m)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_validation():
    tt, lt = _lg_port()
    ys = _linear_gaussian(T=3)
    with pytest.raises(ValueError, match="ess_threshold"):
        mt.particle_filter(tt, lt, ys, 64, 2, ess_threshold=1.5, device="cpu")
    with pytest.raises(ValueError, match="multiple of n_islands"):
        mt.particle_filter(tt, lt, ys, 60, 2, device="cpu")
    with pytest.raises(ValueError, match="divide by the mesh"):
        mt.particle_filter(tt, lt, ys, 64, 2, mesh=mt.SampleMesh(["cpu"] * 3))
    with pytest.raises(ValueError, match="levels, expected"):
        mt.multilevel_particle_filter(lambda lev: tt, lt, ys, 2, 2, n_particles=[64],
                                      device="cpu")
