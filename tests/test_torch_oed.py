"""mlmc_tpu_torch.oed against mlmc_tpu's, on the CPU in float64.

Identical draws: ``mlmc_tpu``'s EIG inner function draws an outer
scenario (theta0 from ``fold_in(fold_in(key, 0), 0)``, the noise from
``fold_in(fold_in(key, 0), 1)``) and inner draw j from ``fold_in(key, 1 +
j)``. Those normals are computed once in JAX and handed to the port's
inner function through its ``draws`` argument; the likelihood ratios, the
nested level and value functions and ``eig_nmc`` then agree to 1e-10 on
a linear forward. The port's own keyed estimators land within 6 se (and
the nested estimator's O(1/n_inner) bias) of the closed form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import nested as tn
from mlmc_tpu_torch import oed as to
from mlmc_tpu_torch.random.keyed import SampleKeys

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
G = np.array([[1.0, 0.5], [0.2, -0.7], [0.3, 0.3]])
D, NOISE = 2, 0.5


def _jax_forward(th):
    return jnp.asarray(G) @ th


def _torch_forward(th):
    return th @ torch.tensor(G).T


def _tables(keys, n_inner):
    """(theta0 [C, d], noise [C, K], inner [C, n, d]) as mlmc_tpu draws them."""
    def one(key):
        k_sc = jax.random.fold_in(key, 0)
        th0 = jax.random.normal(jax.random.fold_in(k_sc, 0), (D,))
        eps = jax.random.normal(jax.random.fold_in(k_sc, 1), (G.shape[0],))
        thp = jax.vmap(lambda j: jax.random.normal(jax.random.fold_in(key, 1 + j), (D,)))(
            jnp.arange(n_inner))
        return th0, eps, thp
    return [torch.tensor(np.asarray(a)) for a in jax.jit(jax.vmap(one))(keys)]


def _table_draws(tables):
    th0, eps, thp = tables

    def draws(keys, kind, arg):
        if kind == "theta0":
            return th0[keys.indices]
        if kind == "noise":
            return eps[keys.indices]
        return thp[keys.indices][:, arg[0]]
    return draws


def test_linear_gaussian_eig_matches_mlmc_tpu():
    from mlmc_tpu import oed as jo

    assert to.linear_gaussian_eig(G, NOISE) == jo.linear_gaussian_eig(G, NOISE)
    assert to.linear_gaussian_eig(G, [0.5, 1.0, 2.0]) == jo.linear_gaussian_eig(
        G, [0.5, 1.0, 2.0])


@pytest.mark.parametrize("level", [0, 3])
def test_inner_and_level_functions_match_mlmc_tpu(level):
    from mlmc_tpu import nested as jn
    from mlmc_tpu import oed as jo

    C, n0 = 16, 4
    data = np.stack([np.zeros(C, np.uint32), np.arange(C, dtype=np.uint32)], axis=1)
    keys_j = jax.random.wrap_key_data(jnp.asarray(data))
    keys_t = SampleKeys(0, level, torch.arange(C))
    inner_j = jo.make_eig_inner(_jax_forward, NOISE, D)
    inner_t = to.make_eig_inner(_torch_forward, NOISE, D,
                                draws=_table_draws(_tables(keys_j, n0 << level)))
    offs = np.arange(n0 << level)
    np.testing.assert_allclose(inner_t(keys_t, torch.tensor(offs)).numpy(),
                               np.asarray(jax.jit(inner_j)(keys_j, jnp.asarray(offs))),
                               rtol=RTOL)
    fj = jn.nested_level_fn(inner_j, g=jo._neg_log, n0=n0, block=8)
    ft = tn.nested_level_fn(inner_t, g=to._neg_log, n0=n0, block=8)
    want = jax.jit(fj, static_argnums=0)(level, keys_j)
    np.testing.assert_allclose(ft(level, keys_t).numpy(), np.asarray(want), rtol=RTOL,
                               atol=1e-14)


def test_eig_nmc_matches_mlmc_tpu():
    from mlmc_tpu import oed as jo

    n_outer, n_inner = 64, 32
    key = jax.random.key(3)
    out_j = jo.eig_nmc(_jax_forward, NOISE, D, n_outer=n_outer, n_inner=n_inner, key=key,
                       block=8, chunk_size=16)
    keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(n_outer, dtype=jnp.uint32))
    out_t = to.eig_nmc(_torch_forward, NOISE, D, n_outer=n_outer, n_inner=n_inner, block=8,
                       chunk_size=16, device="cpu",
                       draws=_table_draws(_tables(keys, n_inner)))
    np.testing.assert_allclose(out_t["eig"], out_j["eig"], rtol=RTOL)
    np.testing.assert_allclose(out_t["se"], out_j["se"], rtol=RTOL)
    assert out_t["n_forward"] == out_j["n_forward"]


def test_keyed_estimators_meet_the_closed_form():
    """eig_nmc within 6 se plus its O(1/n) bias, estimated as the drop from
    n/2 to n inner draws on the same (prefix) draws; the unbiased EIG
    within 6 se."""
    exact = to.linear_gaussian_eig(G, NOISE)
    runs = [to.eig_nmc(_torch_forward, NOISE, D, n_outer=1024, n_inner=n, seed=2,
                       device="cpu") for n in (64, 128)]
    bias = max(runs[0]["eig"] - runs[1]["eig"], 0.0)
    assert abs(runs[1]["eig"] - exact) < 6 * runs[1]["se"] + bias
    out = to.expected_information_gain(_torch_forward, NOISE, D, target_var=1e-3, seed=1,
                                       device="cpu")
    assert out["target_met"] and abs(out["mean"] - exact) < 6 * out["se"]
    assert out["n_forward"] > 0
    with pytest.raises(ValueError, match="even"):
        to.eig_nmc(_torch_forward, NOISE, D, n_inner=3, device="cpu")
    assert mt.eig_nmc is to.eig_nmc
