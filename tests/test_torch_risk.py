"""mlmc_tpu_torch.risk against mlmc_tpu's, on the CPU in float64.

Identical draws: every identity the JAX drivers key by ``fold_in`` chains
(the quantile pilot ``(seed, 10001, i)``, the CDF stage ``(seed + 1, l,
i)``, the tail stage ``(seed + 2, l, i)``; the gradient drivers' ``(key,
l, step, i)``) has its normals computed once in JAX; the port's pair and
objective functions look them up by their ``SampleKeys``. VaR, CVaR,
their errors and counts, gradients and a short Adam trajectory (optax's
against ``torch.optim.Adam``) then agree to 1e-10. ``cvar_mlmc`` over a
``SampleMesh`` of repeated CPU devices equals one device bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import risk as tr
from mlmc_tpu_torch.parallel import SampleMesh

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


@jax.jit
def _normals(key):
    return jax.random.normal(key, (2,))


def _table(*path, n):
    """[n, 2] normals of keys fold_in(...fold_in(key(path[0]), path[1])...,
    i), i < n."""
    k = jax.random.key(path[0])
    for p in path[1:]:
        k = jax.random.fold_in(k, p)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(n, dtype=jnp.uint32))
    return torch.tensor(np.asarray(jax.vmap(_normals)(keys)))


def _gauss_pair(draw, ones, c=0.4):
    def fn(level, keys):
        xy = draw(keys)
        fine = xy[:, 0] + c * 2.0 ** -level * xy[:, 1]
        coarse = xy[:, 0] + c * 2.0 ** -(level - 1) * xy[:, 1] if level else 0.0 * fine
        return fine, coarse, ones(fine)
    return fn


def _jax_draw(keys):
    return jax.vmap(_normals)(keys)


def _torch_ones(x):
    return torch.ones_like(x, dtype=torch.bool)


def _jax_ones(x):
    return jnp.ones(x.shape, bool)


CVAR = dict(n_levels=2, alpha=0.9, target_se=0.05, bandwidth=[0.2, 0.1],
            seed=5, cost_fn=lambda lv: 2.0 ** lv, chunk_size=256, n_pilot=1024)


def test_cvar_empirical_matches_mlmc_tpu():
    from mlmc_tpu import risk as jr

    x = np.random.default_rng(0).normal(size=999)
    a, b = tr.cvar_empirical(x, 0.95), jr.cvar_empirical(x, 0.95)
    assert a == b
    with pytest.raises(ValueError, match="alpha"):
        tr.cvar_empirical(x, 1.0)


def test_cvar_mlmc_matches_mlmc_tpu_on_identical_draws():
    from mlmc_tpu import risk as jr

    out_j = jr.cvar_mlmc(_gauss_pair(_jax_draw, _jax_ones), **CVAR)
    seed, L = CVAR["seed"], CVAR["n_levels"]
    tables = {(seed, 10_001): _table(seed, 10_001, n=CVAR["n_pilot"])}
    for lv in range(L):
        tables[(seed + 1, lv)] = _table(seed + 1, lv, n=int(out_j["cdf"]["n_samples"][lv]))
        tables[(seed + 2, lv)] = _table(seed + 2, lv, n=int(out_j["n_per_level"][lv]))
    pair = _gauss_pair(lambda k: tables[(k.seed, k.level)][k.indices], _torch_ones)
    out_t = tr.cvar_mlmc(pair, device="cpu", **CVAR)
    assert out_t["n_per_level"].tolist() == out_j["n_per_level"].tolist()
    assert out_t["cdf"]["n_samples"].tolist() == out_j["cdf"]["n_samples"].tolist()
    assert out_t["rounds"] == out_j["rounds"]
    for k in ("var", "var_se", "cvar", "cvar_se", "tail_mean", "tail_se",
              "level_corrections"):
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=RTOL, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_cvar_mlmc_mesh_equals_one_device_bit_for_bit(n_shards):
    pair = _gauss_pair(lambda k: k.normals(2).double(), _torch_ones)
    kw = dict(CVAR, chunk_size=128)
    one = tr.cvar_mlmc(pair, device="cpu", **kw)
    shard = tr.cvar_mlmc(pair, mesh=SampleMesh(["cpu"] * n_shards, group=False), **kw)
    for k in ("var", "var_se", "cvar", "cvar_se", "tail_mean", "tail_se"):
        assert one[k] == shard[k], k
    assert one["n_per_level"].tolist() == shard["n_per_level"].tolist()
    assert np.array_equal(one["cdf"]["cdf"], shard["cdf"]["cdf"])


def _obj(draw, ones):
    """A hedged quadratic loss, differentiable in theta = [a, b]."""
    def fn(level, theta, keys):
        xy = draw(keys)
        h = 2.0 ** -level
        f = (theta[0] * xy[:, 0] + theta[1] + h * xy[:, 1]) ** 2
        c = (theta[0] * xy[:, 0] + theta[1] + 2 * h * xy[:, 1]) ** 2 if level else 0 * f
        return f, c, ones(f)
    return fn


def _grad_tables(n_levels, steps, n_per):
    """{keyed level id (s << 8 | l): [n_l, 2]} as ``_level_keys`` keys them."""
    return {(s << 8) | lv: _table(0, lv, s, n=n_per[lv])
            for lv in range(n_levels) for s in steps}


def test_mlmc_gradient_matches_mlmc_tpu():
    from mlmc_tpu import risk as jr

    n_per = [512, 256, 128]
    theta = np.array([0.7, -0.2])
    out_j = jr.mlmc_gradient(_obj(_jax_draw, _jax_ones), jnp.asarray(theta), 3, n_per)
    tables = _grad_tables(3, [0], n_per)
    obj_t = _obj(lambda k: tables[k.level][k.indices], _torch_ones)
    out_t = tr.mlmc_gradient(obj_t, theta, 3, n_per, device="cpu")
    for k in ("value", "grad", "level_values", "level_variances", "n_valid"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), rtol=RTOL, err_msg=k)


def test_optimize_expectation_and_cvar_match_mlmc_tpu():
    """Five Adam steps: optax.adam(0.05) against torch.optim.Adam with the
    same constants; and three steps of the joint CVaR program."""
    from mlmc_tpu import risk as jr

    n_per = [256, 128]
    theta0 = np.array([0.5, 0.3])
    out_j = jr.optimize_expectation(_obj(_jax_draw, _jax_ones), jnp.asarray(theta0),
                                    2, n_per, n_steps=5)
    tables = _grad_tables(2, range(1, 6), n_per)
    obj_t = _obj(lambda k: tables[k.level][k.indices], _torch_ones)
    out_t = tr.optimize_expectation(obj_t, theta0, 2, n_per, n_steps=5, device="cpu")
    for k in ("theta", "values", "grad_norms"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), rtol=RTOL, err_msg=k)
    cv_j = jr.optimize_cvar(_obj(_jax_draw, _jax_ones), jnp.asarray(theta0), 0.8, 2,
                            n_per, n_steps=3, smoothing=0.1, t0_init=0.5)
    cv_t = tr.optimize_cvar(obj_t, theta0, 0.8, 2, n_per, n_steps=3, smoothing=0.1,
                            t0_init=0.5, device="cpu")
    np.testing.assert_allclose(cv_t["theta"], np.asarray(cv_j["theta"]), rtol=RTOL)
    for k in ("t", "cvar", "values", "grad_norms"):
        np.testing.assert_allclose(cv_t[k], cv_j[k], rtol=RTOL, err_msg=k)
    assert mt.optimize_cvar is tr.optimize_cvar and mt.cvar_mlmc is tr.cvar_mlmc
