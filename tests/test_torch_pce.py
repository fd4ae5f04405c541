"""mlmc_tpu_torch.pce against mlmc_tpu's, on the CPU in float64.

Index sets are the same host code (equal). Design matrices, least-squares
and projection fits, statistics and Sobol' indices agree to 1e-10 on the
same samples. The sparse fit takes JAX's cross-validation folds
(``jax.random.permutation(key(seed), arange(N) % n_folds)``) through
``folds=``; the chosen grid point and the support must then be equal,
the CV errors and the coefficients agree to 1e-10.
The control variate takes JAX's inputs (``fold_in(k, chunk)`` of the fit
and the estimation key) through ``draws=``. A fitted JAX expansion carried
over by ``convert.pce_from_jax`` evaluates to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import convert

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


def _poly(th):
    return 1.0 + th[..., 0] - 0.5 * th[..., 1] * th[..., 2] + 0.25 * th[..., 0] ** 3


@pytest.mark.parametrize("d,p", [(1, 5), (3, 3), (8, 3), (4, 0)])
def test_total_degree_indices_equal(d, p):
    from mlmc_tpu.pce import total_degree_indices

    np.testing.assert_array_equal(mt.total_degree_indices(d, p), total_degree_indices(d, p))


@pytest.mark.parametrize("basis", ["hermite", "legendre"])
def test_design_and_regression_match_mlmc_tpu(basis):
    from mlmc_tpu.pce import PCE

    rng = np.random.default_rng(0)
    theta = rng.normal(size=(200, 3)) if basis == "hermite" else rng.uniform(-1, 1, (200, 3))
    y = np.stack([_poly(theta), np.sin(theta[:, 0])], 1)
    pj = PCE(3, 4, basis).fit_regression(jnp.asarray(theta), jnp.asarray(y))
    pt = mt.PCE(3, 4, basis, device="cpu").fit_regression(theta, y)
    np.testing.assert_allclose(pt.design_matrix(theta).numpy(),
                               np.asarray(pj.design_matrix(jnp.asarray(theta))), rtol=1e-13)
    np.testing.assert_allclose(pt.coefficients.numpy(), np.asarray(pj.coefficients),
                               rtol=RTOL, atol=1e-12)
    for a, b in zip((pt.mean(), pt.var()), (pj.mean(), pj.var())):
        np.testing.assert_allclose(a, b, rtol=RTOL)
    sj, st = pj.sobol(), pt.sobol()
    for k in ("first_order", "total_effect"):
        np.testing.assert_allclose(st[k], sj[k], rtol=RTOL, atol=1e-14)
    ridge_j = PCE(3, 4, basis).fit_regression(jnp.asarray(theta), jnp.asarray(y[:, 0]), reg=1e-3)
    ridge_t = mt.PCE(3, 4, basis, device="cpu").fit_regression(theta, y[:, 0], reg=1e-3)
    np.testing.assert_allclose(ridge_t.coefficients.numpy(), np.asarray(ridge_j.coefficients),
                               rtol=RTOL, atol=1e-13)
    assert ridge_t.mean() == pytest.approx(ridge_j.mean(), rel=RTOL)
    x = rng.normal(size=(7, 3))
    np.testing.assert_allclose(ridge_t(x).numpy(), np.asarray(ridge_j(jnp.asarray(x))), rtol=RTOL)
    assert ridge_t(x[0]).shape == ()


def test_projection_matches_mlmc_tpu():
    from mlmc_tpu.pce import PCE

    pj = PCE(3, 3).fit_projection(lambda th: jnp.stack([_poly(th), jnp.exp(0.3 * th[1])]), 3)
    pt = mt.PCE(3, 3, device="cpu").fit_projection(
        lambda th: torch.stack([_poly(th), torch.exp(0.3 * th[:, 1])], 1), 3)
    np.testing.assert_allclose(pt.coefficients.numpy(), np.asarray(pj.coefficients),
                               rtol=RTOL, atol=1e-14)
    assert not pt._scalar and pt.mean().shape == (2,)
    s = 0.5
    one = mt.PCE(1, 8, device="cpu").fit_projection(lambda th: torch.exp(s * th[:, 0]), 12)
    assert abs(one.mean() - np.exp(s * s / 2)) < 1e-7


def _sparse_truth(d=5, degree=3, s=6, seed=11):
    P = len(mt.total_degree_indices(d, degree))
    rng = np.random.default_rng(seed)
    c = np.zeros(P)
    c[0] = 1.5
    c[rng.choice(np.arange(1, P), size=s - 1, replace=False)] = rng.normal(size=s - 1)
    return c


@pytest.mark.parametrize("noise", [0.0, 0.05])
def test_fit_sparse_matches_mlmc_tpu_with_jax_folds(noise):
    from mlmc_tpu.pce import PCE

    c = _sparse_truth()
    rng = np.random.default_rng(1)
    theta = rng.normal(size=(40, 5))
    y = mt.PCE(5, 3, device="cpu").design_matrix(theta).numpy() @ c
    y = y + noise * rng.normal(size=40)
    pj = PCE(5, 3).fit_sparse(jnp.asarray(theta), jnp.asarray(y), seed=2, max_iter=200)
    folds = np.asarray(jax.random.permutation(jax.random.key(2), np.arange(40) % 5))
    pt = mt.PCE(5, 3, device="cpu").fit_sparse(theta, y, max_iter=200, folds=folds)
    # the same grid point is chosen (lam_max, the grid's scale, is a
    # reduction that rounds in the last bit)
    assert np.argmin(pt.sparse_info["cv_rmse"]) == np.argmin(pj.sparse_info["cv_rmse"])
    assert pt.sparse_info["lam"] == pytest.approx(pj.sparse_info["lam"], rel=1e-14)
    assert pt.sparse_info["support_size"] == pj.sparse_info["support_size"]
    np.testing.assert_array_equal(pt.coefficients.numpy() != 0,
                                  np.asarray(pj.coefficients) != 0)
    np.testing.assert_allclose(pt.sparse_info["cv_rmse"], pj.sparse_info["cv_rmse"], rtol=RTOL)
    np.testing.assert_allclose(pt.coefficients.numpy(), np.asarray(pj.coefficients),
                               rtol=RTOL, atol=1e-12)
    if noise == 0.0:        # exact recovery from N = 40 < P = 56
        assert np.max(np.abs(pt.coefficients.numpy()[:, 0] - c)) < 1e-6


def test_fit_sparse_explicit_lambda_seeded_folds_and_validation():
    from mlmc_tpu.pce import PCE

    c = _sparse_truth(d=3, degree=2, s=3)
    theta = np.random.default_rng(7).normal(size=(30, 3))
    y = mt.PCE(3, 2, device="cpu").design_matrix(theta).numpy() @ c
    pj = PCE(3, 2).fit_sparse(jnp.asarray(theta), jnp.asarray(y), lam=1e-4, max_iter=100)
    pt = mt.PCE(3, 2, device="cpu").fit_sparse(theta, y, lam=1e-4, max_iter=100)
    np.testing.assert_allclose(pt.coefficients.numpy(), np.asarray(pj.coefficients),
                               rtol=1e-9, atol=1e-12)
    a = mt.PCE(3, 2, device="cpu").fit_sparse(theta, y, seed=4, max_iter=50)
    b = mt.PCE(3, 2, device="cpu").fit_sparse(theta, y, seed=4, max_iter=50)
    np.testing.assert_array_equal(a.coefficients.numpy(), b.coefficients.numpy())
    with pytest.raises(ValueError, match="scalar"):
        mt.PCE(3, 2, device="cpu").fit_sparse(theta, np.zeros((30, 2)))
    with pytest.raises(ValueError, match="n_folds"):
        mt.PCE(3, 2, device="cpu").fit_sparse(theta, y, n_folds=1)
    with pytest.raises(ValueError, match="N >= P"):
        mt.PCE(3, 3, device="cpu").fit_regression(np.zeros((5, 3)), np.zeros(5))
    with pytest.raises(RuntimeError, match="fit"):
        mt.PCE(2, 1, device="cpu").mean()


def test_control_variate_replays_mlmc_tpu():
    from mlmc_tpu.pce import PCE, pce_control_variate

    a = np.array([0.6, 0.4, 0.2])
    aj, at = jnp.asarray(a), torch.tensor(a)
    theta = np.random.default_rng(0).normal(size=(200, 3))
    y = np.exp(theta @ a)
    pj = PCE(3, 3).fit_regression(jnp.asarray(theta), jnp.asarray(y))
    pt = mt.PCE(3, 3, device="cpu").fit_regression(theta, y)
    key, chunk = jax.random.key(1), 1000
    rj = pce_control_variate(lambda th: jnp.exp(aj @ th), pj, n=4000, key=key, chunk_size=chunk)
    ks = jax.random.split(key)
    draws = lambda part, c, m: torch.tensor(np.asarray(jax.random.normal(
        jax.random.fold_in(ks[part], c), (m, 3))))
    rt = mt.pce_control_variate(lambda th: torch.exp(th @ at), pt, n=4000, chunk_size=chunk,
                                draws=draws)
    for k in ("mean", "se", "beta", "rho", "var_reduction"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, err_msg=k)
    assert (rt["n_fit"], rt["n_eval"]) == (rj["n_fit"], rj["n_eval"]) == (2000, 2000)
    keyed = mt.pce_control_variate(lambda th: torch.exp(th @ at), pt, n=1 << 14, seed=3)
    exact = np.exp(0.5 * a @ a)
    assert abs(keyed["mean"] - exact) < 5 * keyed["se"] + 1e-6 and keyed["rho"] > 0.99
    with pytest.raises(ValueError, match="split"):
        mt.pce_control_variate(lambda th: th[:, 0], pt, 100, split=1.5)


def test_pce_from_jax_evaluates_jax_fit():
    from mlmc_tpu.pce import PCE

    x = jax.random.uniform(jax.random.key(3), (300, 3), minval=-1.0, maxval=1.0)
    pj = PCE(3, 5, basis="legendre").fit_regression(x, jnp.sin(np.pi * x[:, 0]) * x[:, 2])
    pt = convert.pce_from_jax(pj, device="cpu")
    fresh = np.random.default_rng(9).uniform(-1, 1, size=(50, 3))
    np.testing.assert_allclose(pt(fresh).numpy(), np.asarray(pj(jnp.asarray(fresh))),
                               rtol=1e-12, atol=1e-14)
    assert pt.mean() == pj.mean() and pt.var() == pj.var()
    np.testing.assert_array_equal(pt.sobol()["total_effect"], pj.sobol()["total_effect"])
