"""mlmc_tpu_torch.multifidelity (MFMC) and mlmc_tpu_torch.mlblue against
mlmc_tpu's, on the CPU in float64.

Identical draws: ``mlmc_tpu.MFMC`` keys stream position i by
``fold_in(key(seed), i)`` and ``mlmc_tpu.mlblue`` group k's sample i by
``fold_in(fold_in(key(seed), 10000 + k), i)``. The normals the synthetic
fidelity family draws from those keys are computed once in JAX; the
port's models look them up by their ``SampleKeys``. Pilot statistics,
model subsets, allocations, weights and estimates then agree to 1e-10.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import multifidelity as tf

tb = importlib.import_module("mlmc_tpu_torch.mlblue")   # the package exports the function

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
RHOS, BIASES = (0.95, 0.8), (0.3, -0.5)


def _fidelity_normals(keys):
    """[n, 3]: Z and U_1, U_2 of each key, as mlmc_tpu's synthetic family
    draws them."""
    return jax.vmap(lambda k: jnp.stack([jax.random.normal(jax.random.fold_in(k, j))
                                         for j in range(3)]))(keys)


def _lookup_models(table, mean=1.0, sigma0=1.0):
    """The port's synthetic family over the JAX normals ``table(keys)``."""
    def hi(keys):
        return mean + sigma0 * table(keys)[:, 0]

    models = [hi]
    for j, (r, b) in enumerate(zip(RHOS, BIASES)):
        def surrogate(keys, r=r, b=b, j=j):
            t = table(keys)
            return b + r * t[:, 0] + np.sqrt(1.0 - r * r) * t[:, j + 1]
        models.append(surrogate)
    return models


def _stream_table(seed, n):
    root = jax.random.key(seed)
    keys = jax.vmap(lambda i: jax.random.fold_in(root, i))(jnp.arange(n, dtype=jnp.uint32))
    return torch.tensor(np.asarray(_fidelity_normals(keys)))


COSTS = [1.0, 0.05, 0.01]


def test_mfmc_matches_mlmc_tpu_on_identical_draws():
    from mlmc_tpu import multifidelity as jf

    chunk = 512
    mf_j = jf.MFMC(jf.synth_fidelity_models(rhos=RHOS, biases=BIASES), costs=COSTS,
                   seed=2, chunk_size=chunk)
    st_j = mf_j.pilot(2000)
    out_j = mf_j.estimate(budget=3000.0)
    n_max = st_j["n_pilot"] + int(np.max(out_j["m"]))
    table = _stream_table(2, -(-n_max // chunk) * chunk)
    mf_t = tf.MFMC(_lookup_models(lambda k: table[k.indices]), costs=COSTS, seed=2,
                   chunk_size=chunk, device="cpu")
    st_t = mf_t.pilot(2000)
    out_t = mf_t.estimate(budget=3000.0)
    assert st_t["n_pilot"] == st_j["n_pilot"]
    for k in ("sigma", "rho", "mean", "costs"):
        np.testing.assert_allclose(st_t[k], st_j[k], rtol=RTOL, err_msg=k)
    assert tuple(out_t["subset"]) == tuple(out_j["subset"])
    assert out_t["m"].tolist() == out_j["m"].tolist()
    for k in ("mean", "var", "alpha", "var_mc", "speedup"):
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=RTOL, err_msg=k)
    for budget in (10.0, 1e4):
        sel_t, sel_j = mf_t.select_models(budget), mf_j.select_models(budget)
        assert tuple(sel_t["subset"]) == tuple(sel_j["subset"])
        np.testing.assert_allclose(sel_t["m"], sel_j["m"], rtol=RTOL)


def test_mlblue_matches_mlmc_tpu_on_identical_draws():
    jb = importlib.import_module("mlmc_tpu.mlblue")
    from mlmc_tpu import multifidelity as jf

    chunk = 256
    kw = dict(budget=400.0, seed=4, n_pilot=600, chunk_size=chunk, min_group=16,
              groups=[(0, 1), (1, 2), (2,)])
    out_j = jb.mlblue(jf.synth_fidelity_models(rhos=RHOS, biases=BIASES), COSTS, **kw)
    groups = out_j["groups"]
    counts = {len(groups) + 1: 600}
    counts.update({k: int(n) for k, n in enumerate(out_j["n_per_group"]) if n})
    tables = {}
    for k, n in counts.items():
        gkey = jax.random.fold_in(jax.random.key(4), 10_000 + k)
        keys = jax.vmap(lambda i: jax.random.fold_in(gkey, i))(
            jnp.arange(-(-n // chunk) * chunk, dtype=jnp.uint32))
        tables[k] = torch.tensor(np.asarray(_fidelity_normals(keys)))
    out_t = tb.mlblue(_lookup_models(lambda k: tables[k.level - 10_000][k.indices]), COSTS,
                      device="cpu", **kw)
    assert out_t["groups"] == groups
    assert out_t["n_per_group"].tolist() == out_j["n_per_group"].tolist()
    assert out_t["n_evaluations"] == out_j["n_evaluations"]
    for k in ("mean", "var", "means", "pilot_cov", "cost_spent", "mlmc_var",
              "efficiency_vs_mlmc"):
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=RTOL, err_msg=k)
    C = out_t["pilot_cov"]
    assert tb.default_groups(4) == jb.default_groups(4)
    np.testing.assert_allclose(tb.blue_variance(groups, C, out_t["n_per_group"]),
                               jb.blue_variance(groups, C, out_t["n_per_group"]), rtol=RTOL)


def test_keyed_fidelity_family_meets_its_law():
    """The port's own keyed family: the MFMC estimate within 6 se of the
    mean, the pilot correlations within 6 se of rho (se of a sample
    correlation ~ (1 - rho^2) / sqrt(n)), MLBLUE within 6 se too."""
    models = tf.synth_fidelity_models(mean=1.0, rhos=RHOS, biases=BIASES)
    mf = tf.MFMC(models, costs=COSTS, seed=5, chunk_size=1024, device="cpu")
    st = mf.pilot(1 << 13)
    n = st["n_pilot"]
    for r, got in zip(RHOS, st["rho"][1:]):
        assert abs(got - r) < 6 * (1 - r * r) / np.sqrt(n)
    out = mf.estimate(budget=5e3)
    assert abs(out["mean"] - 1.0) < 6 * np.sqrt(out["var"])
    res = tb.mlblue(models, COSTS, budget=5e3, seed=6, chunk_size=1024, device="cpu")
    assert abs(res["mean"] - 1.0) < 6 * np.sqrt(res["var"])
    assert res["efficiency_vs_mlmc"] > 0.5
    assert mt.MFMC is tf.MFMC and mt.mlblue is tb.mlblue and mt.default_groups(3)
    with pytest.raises(ValueError, match="exactly one"):
        tb.mlblue(models, COSTS, device="cpu")
