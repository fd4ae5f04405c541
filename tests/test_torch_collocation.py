"""mlmc_tpu_torch.collocation against mlmc_tpu's, on the CPU in float64.

Grid construction is the same host numpy in both packages, so Smolyak
nodes and weights are equal bit for bit. The integrands are the same
functions (batched on the port's side), so integrals, one-pass
variances, the adaptive grid's decisions (accepted indices, evaluation
counts, history) and the multilevel corrections agree to 1e-12.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt

torch.set_num_threads(1)

RTOL = 1e-12


@pytest.mark.parametrize("d,level,rule", [(3, 2, "gauss-hermite"), (4, 3, "clenshaw-curtis"),
                                          (2, 4, "gauss-legendre"), (1, 0, "gauss-hermite")])
def test_sparse_grid_nodes_and_weights_equal(d, level, rule):
    from mlmc_tpu.collocation import SparseGrid

    got, want = mt.SparseGrid(d, level, rule), SparseGrid(d, level, rule)
    np.testing.assert_array_equal(got.nodes, want.nodes)
    np.testing.assert_array_equal(got.weights, want.weights)
    assert (got.n_nodes, got.n_tensor) == (want.n_nodes, want.n_tensor)


def test_integrate_and_mean_var_match_mlmc_tpu():
    from mlmc_tpu.collocation import SparseGrid

    a = np.array([0.3, -0.2, 0.5])
    aj, at = jnp.asarray(a), torch.tensor(a)
    gj, gt = SparseGrid(3, 3), mt.SparseGrid(3, 3)
    fj = lambda th: jnp.stack([jnp.exp(aj @ th), th[0] ** 2 * th[1]])
    ft = lambda th: torch.stack([torch.exp(th @ at), th[:, 0] ** 2 * th[:, 1]], 1)
    np.testing.assert_allclose(gt.integrate(ft, chunk_size=7, device="cpu"),
                               gj.integrate(fj), rtol=RTOL, atol=1e-15)
    scalar = gt.integrate(lambda th: torch.exp(th @ at), device="cpu")
    assert scalar.shape == ()
    np.testing.assert_allclose(scalar, gj.integrate(lambda th: jnp.exp(aj @ th)), rtol=RTOL)
    assert abs(scalar - np.exp(0.5 * a @ a)) < 1e-4          # level 3: degree-7 exact
    for got, want in zip(gt.mean_and_var(ft, device="cpu"), gj.mean_and_var(fj)):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-15)


@pytest.mark.parametrize("rule,indicator,min_level", [
    ("gauss-hermite", "surplus", 1), ("gauss-hermite", "surplus_per_eval", 2),
    ("clenshaw-curtis", "surplus", 1)])
def test_adaptive_grid_decisions_match_mlmc_tpu(rule, indicator, min_level):
    from mlmc_tpu.collocation import AdaptiveSparseGrid

    c = np.array([0.8, 0.5, 0.3, 0.2])
    cj, ct = jnp.asarray(c), torch.tensor(c)
    fj = lambda th: jnp.stack([jnp.exp(cj @ th), jnp.cos(cj @ th)])
    ft = lambda th: torch.stack([torch.exp(th @ ct), torch.cos(th @ ct)], 1)
    kw = dict(tol=1e-9, max_evals=400, indicator=indicator, min_level=min_level)
    rj = AdaptiveSparseGrid(4, rule).integrate(fj, **kw)
    rt = mt.AdaptiveSparseGrid(4, rule).integrate(ft, chunk_size=16, device="cpu", **kw)
    assert rt["indices"] == rj["indices"] and rt["n_evals"] == rj["n_evals"]
    assert [h[0] for h in rt["history"]] == [h[0] for h in rj["history"]]
    assert rt["converged"] == rj["converged"]
    np.testing.assert_allclose(rt["mean"], rj["mean"], rtol=RTOL)
    # the indicator is a sum of surpluses made by cancellation of O(1)
    # tensor values: it agrees to the rounding of those, ~1e-15 absolute
    np.testing.assert_allclose(rt["error_est"], rj["error_est"], rtol=RTOL, atol=1e-14)


def test_adaptive_closed_form_scalar():
    """E[x0^4 + x0^2 x1^2] = 4 with the mixed index probed (min_level 2)."""
    res = mt.AdaptiveSparseGrid(2).integrate(
        lambda th: th[:, 0] ** 4 + th[:, 0] ** 2 * th[:, 1] ** 2, tol=1e-12,
        max_evals=2000, min_level=2, device="cpu")
    assert res["converged"] and abs(res["mean"] - 4.0) < 1e-10


def test_multilevel_collocation_matches_mlmc_tpu():
    from mlmc_tpu.collocation import multilevel_collocation

    fjs = [lambda th, h=h: jnp.exp(0.4 * th[0] + h * jnp.sin(th[1])) for h in (0.2, 0.1, 0.05)]
    fts = [lambda th, h=h: torch.exp(0.4 * th[:, 0] + h * torch.sin(th[:, 1]))
           for h in (0.2, 0.1, 0.05)]
    rj = multilevel_collocation(fjs, 2)
    rt = mt.multilevel_collocation(fts, 2, chunk_size=5, device="cpu")
    for k in ("n_nodes", "n_nodes_total", "n_nodes_single", "levels"):
        assert rt[k] == rj[k], k
    np.testing.assert_allclose(rt["mean"], rj["mean"], rtol=RTOL)
    for a, b in zip(rt["corrections"], rj["corrections"]):
        np.testing.assert_allclose(a, b, rtol=1e-11, atol=1e-15)


def test_validation():
    with pytest.raises(ValueError, match="rule"):
        mt.SparseGrid(2, 1, rule="mc")
    with pytest.raises(ValueError, match="d >= 1"):
        mt.SparseGrid(0, 1)
    with pytest.raises(ValueError, match="indicator"):
        mt.AdaptiveSparseGrid(2).integrate(lambda th: th[:, 0], indicator="x", device="cpu")
    with pytest.raises(ValueError, match="min_level"):
        mt.AdaptiveSparseGrid(2).integrate(lambda th: th[:, 0], min_level=0, device="cpu")
    with pytest.raises(ValueError, match="one sparse-grid level"):
        mt.multilevel_collocation([lambda th: th[:, 0]], 2, levels=[1, 2], device="cpu")
