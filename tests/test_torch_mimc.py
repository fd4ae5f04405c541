"""mlmc_tpu_torch.mimc against mlmc_tpu's, on the CPU in float64.

Identical draws: ``mlmc_tpu.MIMC`` keys sample i of the index at position
k by ``fold_in(fold_in(key(seed), k), i)``. The four normals its
synthetic model draws from each such key are computed once in JAX; the
port's value function looks them up by its ``SampleKeys`` (k, i). Both
drivers then see the same samples and must take the same decisions (index
sets, counts, rounds) and agree on the estimates to 1e-10 relative.

The heat and Darcy value functions run on JAX's phases (drawn in JAX from
keys built by ``wrap_key_data``) and JAX's modes, carried across by
``convert.mimc_modes_from_jax``, and agree to 1e-10. Over a
``SampleMesh`` of repeated CPU devices the port's sums equal one device's
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import convert
from mlmc_tpu_torch import mimc as tm
from mlmc_tpu_torch.parallel import SampleMesh
from mlmc_tpu_torch.random.keyed import SampleKeys

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


def _synth_table(seed, counts):
    """{index position: [n, 4] normals} as mlmc_tpu's MIMC draws them."""
    @jax.jit
    def table(k, idx):
        ikey = jax.random.fold_in(jax.random.key(seed), k)
        keys = jax.vmap(lambda i: jax.random.fold_in(ikey, i))(idx)
        return jax.vmap(lambda kk: jax.random.normal(kk, (4,)))(keys)

    return {k: torch.tensor(np.asarray(table(k, jnp.arange(n, dtype=jnp.uint32))))
            for k, n in enumerate(counts) if n}


def _synth_lookup(tables, mean=1.0, c=0.5, rates=(1.0, 1.5), rho=0.5):
    """The port's synthetic model on the JAX draws (the formula of
    ``synth_mimc_value_fn``)."""
    p1, p2 = rates

    def value_fn(alpha, keys):
        hx, hy = 2.0 ** -alpha[0], 2.0 ** -alpha[1]
        z, ax, ay, axy = tables[keys.level][keys.indices].unbind(1)
        return (mean + z + c * (hx ** p1 * (1 + ax) + hy ** p2 * (1 + ay)
                                + rho * hx ** p1 * hy ** p2 * (1 + axy)))

    return value_fn


def _cost(a):
    return 2.0 ** (a[0] + 1.5 * a[1])


def test_index_sets_and_terms_match_mlmc_tpu():
    from mlmc_tpu import mimc as jm

    for args in ((2, 3), (3, 2), (2, 4, (1.0, 2.0))):
        assert tm.total_degree_set(*args) == jm.total_degree_set(*args)
    assert tm.full_tensor_set((2, 1, 3)) == jm.full_tensor_set((2, 1, 3))
    for alpha in ((0, 0), (2, 0), (1, 3), (1, 1, 2)):
        assert tm.mixed_difference_terms(alpha) == jm.mixed_difference_terms(alpha)
    with pytest.raises(ValueError, match="downward closed"):
        tm.MIMC(lambda a, k: k.indices * 0.0, [(0, 0), (1, 1)], device="cpu")


@pytest.mark.parametrize("adaptive", [False, True])
def test_driver_matches_mlmc_tpu_on_identical_draws(adaptive):
    from mlmc_tpu import mimc as jm

    fn_j, _ = jm.synth_mimc_value_fn()
    start = [(0, 0)] if adaptive else jm.total_degree_set(2, 1)
    ml_j = jm.MIMC(fn_j, start, seed=3, cost_fn=_cost, chunk_size=256)
    if adaptive:
        out_j = ml_j.run_adaptive(target_var=4e-4, bias_tol=0.05, n_pilot=256,
                                  max_indices=4)
    else:
        out_j = ml_j.run(target_var=2e-4)
    tables = _synth_table(3, ml_j.n_samples)
    ml_t = tm.MIMC(_synth_lookup(tables), start, seed=3, cost_fn=_cost, chunk_size=256,
                   device="cpu")
    if adaptive:
        out_t = ml_t.run_adaptive(target_var=4e-4, bias_tol=0.05, n_pilot=256,
                                  max_indices=4)
        assert out_t["accepted"] == out_j["accepted"]
        assert out_t["bias_converged"] == out_j["bias_converged"]
        np.testing.assert_allclose(out_t["bias_est"], out_j["bias_est"], rtol=RTOL)
    else:
        out_t = ml_t.run(target_var=2e-4)
    assert out_t["index_set"] == out_j["index_set"]
    assert out_t["n_samples"].tolist() == out_j["n_samples"].tolist()
    assert out_t["rounds"] == out_j["rounds"] and out_t["target_met"] == out_j["target_met"]
    for k in ("mean", "var", "index_means", "index_vars", "boundary_bias", "total_work"):
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=RTOL, atol=1e-14, err_msg=k)


def _wrapped_keys(n):
    data = np.stack([np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)], axis=1)
    return jax.random.wrap_key_data(jnp.asarray(data))


@pytest.mark.parametrize("alpha", [(0, 0), (1, 2), (2, 1)])
def test_heat_values_match_mlmc_tpu(alpha):
    from mlmc_tpu import mimc as jm

    fn_j, _ = jm.heat_mimc_value_fn(sigma=0.5, n_modes=16, n0=(4, 4), total_time=0.25,
                                    seed=5)
    fn_t, d = tm.heat_mimc_value_fn(sigma=0.5, n0=(4, 4), total_time=0.25,
                                    **convert.mimc_modes_from_jax(fn_j))
    keys = _wrapped_keys(8)
    phases = jax.vmap(lambda k: jax.random.uniform(k, (16,), maxval=2 * np.pi))(keys)
    want = np.asarray(fn_j(alpha, keys))
    got = fn_t.from_phases(alpha, torch.tensor(np.asarray(phases)))
    assert d == 2 and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("alpha", [(0, 0), (1, 2), (2, 1)])
def test_darcy_values_match_mlmc_tpu(alpha):
    from mlmc_tpu import mimc as jm

    fn_j, _ = jm.darcy_mimc_value_fn(n_modes=16, n0=(4, 4), seed=2)
    fn_t, _ = tm.darcy_mimc_value_fn(n0=(4, 4), **convert.mimc_modes_from_jax(fn_j))
    keys = _wrapped_keys(6)
    phases = jax.vmap(lambda k: jax.random.uniform(k, (16,), maxval=2 * np.pi))(keys)
    want = np.asarray(fn_j(alpha, keys))
    got = fn_t.from_phases(alpha, torch.tensor(np.asarray(phases)))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


def test_modes_round_trip():
    """JAX's modes -> convert -> the port's value functions, which hold them
    bit for bit and hand them on through convert again."""
    from mlmc_tpu import mimc as jm

    for make_j, make_t, name in ((jm.heat_mimc_value_fn, tm.heat_mimc_value_fn, "k_modes"),
                                 (jm.darcy_mimc_value_fn, tm.darcy_mimc_value_fn,
                                  "wave_vectors")):
        fn_j, _ = make_j(n_modes=8, seed=11)
        modes = convert.mimc_modes_from_jax(fn_j)
        fn_t, _ = make_t(**modes)
        assert np.array_equal(getattr(fn_t, name), modes[name])
        assert np.array_equal(convert.mimc_modes_from_jax(fn_t)[name], modes[name])
    own, _ = tm.heat_mimc_value_fn(n_modes=8, seed=11)       # the port's own draw
    assert own.k_modes.shape == (8,) and not np.array_equal(
        own.k_modes, convert.mimc_modes_from_jax(jm.heat_mimc_value_fn(n_modes=8,
                                                                       seed=11)[0])["k_modes"])


@pytest.mark.parametrize("n_shards", [2, 4])
def test_mesh_equals_one_device_bit_for_bit(n_shards):
    fn, _ = tm.heat_mimc_value_fn(sigma=0.5, n_modes=16, n0=(4, 4))
    iset = tm.total_degree_set(2, 2)
    runs = []
    for mesh in (None, SampleMesh(["cpu"] * n_shards, group=False)):
        ml = tm.MIMC(fn, iset, seed=4, cost_fn=lambda a: 2.0 ** sum(a), chunk_size=64,
                     mesh=mesh, device="cpu")
        runs.append((ml.run(target_var=2e-7), ml))
    (one, m1), (shard, m2) = runs
    assert one["n_samples"].tolist() == shard["n_samples"].tolist()
    for a in iset:
        assert (m1._states[a].sum, m1._states[a].sum_sq) == (m2._states[a].sum,
                                                               m2._states[a].sum_sq)
    assert one["mean"] == shard["mean"] and one["var"] == shard["var"]


def test_keyed_synth_model_meets_its_limit():
    fn, d = tm.synth_mimc_value_fn(mean=1.0)
    ml = tm.MIMC(fn, tm.total_degree_set(d, 4), seed=1, cost_fn=_cost, chunk_size=1024,
                 device="cpu")
    out = ml.run(target_var=1e-4)
    assert out["target_met"]
    assert abs(out["mean"] - 1.0) < 6 * np.sqrt(out["var"]) + out["boundary_bias"]
    # the same identities give the same draws at every corner
    keys = SampleKeys(1, 3, torch.arange(16))
    assert torch.equal(fn((2, 0), keys) - fn((0, 0), keys),
                       fn((2, 0), keys) - fn((0, 0), keys))
    assert mt.MIMC is tm.MIMC and mt.heat_mimc_value_fn is tm.heat_mimc_value_fn
