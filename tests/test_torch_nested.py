"""mlmc_tpu_torch.nested against mlmc_tpu's.

JAX's outer keys are built with ``jax.random.wrap_key_data`` so that a
key's data holds the sample's index; an inner function that reads its
values from a numpy table by (index, offset) then gives both packages the
same inner draws. ``nested_level_fn``, ``nested_value_fn`` and
``evppi_level_fn`` agree to 1e-12 (f64) at levels deep enough to take the
block loop. The port's Gaussian information problem is keyed
(``keyed_call_normals``), and an ``UnbiasedMLMC`` EVPPI run on the CPU
lies within 6 se of the closed form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import nested as tn
from mlmc_tpu_torch.random.keyed import SampleKeys

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

C, N_MAX, D = 32, 256, 3
TABLE = np.random.default_rng(0).normal(size=(C, N_MAX, D))


def _jax_keys():
    data = np.stack([np.zeros(C, np.uint32), np.arange(C, dtype=np.uint32)], axis=1)
    return jax.random.wrap_key_data(jnp.asarray(data))


def _inner_jax(multi):
    tab = jnp.asarray(TABLE if multi else TABLE[..., 0] + 0.3)

    def inner_fn(keys, offsets):
        idx = jax.random.key_data(keys)[:, 1]
        return tab[idx][:, offsets]

    return inner_fn


def _inner_torch(multi):
    tab = torch.tensor(TABLE if multi else TABLE[..., 0] + 0.3)
    return lambda keys, offsets: tab[keys.indices][:, offsets]


@pytest.mark.parametrize("level", [0, 1, 6])
@pytest.mark.parametrize("g", ["max0", "square"])
def test_level_and_value_functions_match_mlmc_tpu(level, g):
    """n0 = 4, block = 16: level 6 has 256 inner draws, 8 blocks per half."""
    from mlmc_tpu import nested as jn

    gj = jn.g_max0 if g == "max0" else (lambda m: m * m)
    gt = tn.g_max0 if g == "max0" else (lambda m: m * m)
    keys_t = SampleKeys(0, level, torch.arange(C))
    fj = jn.nested_level_fn(_inner_jax(False), g=gj, n0=4, block=16)
    ft = tn.nested_level_fn(_inner_torch(False), g=gt, n0=4, block=16)
    want, got = np.asarray(fj(level, _jax_keys())), ft(level, keys_t)
    assert got.dtype == torch.float64 and got.shape == (C,)
    scale = np.max(np.abs(want)) + 1e-300
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12 * scale)
    vj = jn.nested_value_fn(_inner_jax(False), g=gj, n0=4, block=16)
    vt = tn.nested_value_fn(_inner_torch(False), g=gt, n0=4, block=16)
    np.testing.assert_allclose(vt((level,), keys_t).numpy(), np.asarray(vj((level,),
                               _jax_keys())), rtol=1e-12)


@pytest.mark.parametrize("level", [0, 5])
def test_evppi_level_fn_matches_mlmc_tpu(level):
    from mlmc_tpu import nested as jn

    fj = jn.evppi_level_fn(_inner_jax(True), n0=2, block=8)
    ft = tn.evppi_level_fn(_inner_torch(True), n0=2, block=8)
    want = np.asarray(fj(level, _jax_keys()))
    got = ft(level, SampleKeys(0, level, torch.arange(C))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12 * np.max(np.abs(want)))
    with pytest.raises(ValueError, match="multi-decision"):
        tn.evppi_level_fn(_inner_torch(False))(0, SampleKeys(0, 0, torch.arange(C)))


def test_identity_g_collapses_the_corrections():
    ft = tn.nested_level_fn(_inner_torch(False), g=lambda m: m, n0=2, block=8)
    d = ft(4, SampleKeys(0, 4, torch.arange(C)))
    assert float(d.abs().max()) < 1e-13
    with pytest.raises(ValueError, match="even"):
        tn.nested_level_fn(_inner_torch(False), n0=3)


def test_gaussian_inner_draws_are_keyed_by_call():
    """Draw j of a sample is the first normal of its Philox call 1 + j, the
    same in any block; the outer Y is call 0's."""
    inner = tn.gaussian_information_fn(1.0, 2.0, 0.0)
    keys = SampleKeys(3, 2, torch.arange(5))
    whole = inner(keys, torch.arange(16))
    parts = torch.cat([inner(keys, torch.arange(8)), inner(keys, torch.arange(8, 16))], 1)
    assert torch.equal(whole, parts)
    z = mt.random.keyed.keyed_normals(3, 2, keys.indices, torch.zeros(5, dtype=torch.int64),
                                      4 * 17)
    np.testing.assert_allclose(whole.numpy(), (z[:, :1] + 2.0 * z[:, 4::4]).numpy(),
                               rtol=1e-6)


def test_inner_draws_run_past_two_to_the_twenty_calls():
    """A level deep enough for 2^20 inner draws per sample (the unbiased
    ladder reaches it): call 1 + j past 2^20 takes attempt 1's counter."""
    inner = tn.gaussian_information_fn(1.0, 2.0, 0.0)
    keys = SampleKeys(3, 2, torch.arange(4))
    j = torch.tensor([(1 << 20) + 4, (1 << 32) - 2])
    got = inner(keys, j)
    z = mt.random.keyed.keyed_normals(3, 2, keys.indices, torch.ones(4, dtype=torch.int64),
                                      24)
    y = mt.random.keyed.keyed_normals(3, 2, keys.indices, torch.zeros(4, dtype=torch.int64),
                                      1)
    np.testing.assert_allclose(got[:, 0].numpy(), (y[:, 0] + 2.0 * z[:, 20]).numpy(),
                               rtol=1e-6)
    assert bool(torch.isfinite(got).all())
    with pytest.raises(ValueError, match="2\\^32"):
        inner(keys, torch.tensor([1 << 32]))


def test_unbiased_evppi_meets_the_closed_form():
    sigma_y, sigma_x, mu = 1.3, 2.0, 0.2
    fn = tn.nested_level_fn(tn.gaussian_information_fn(sigma_y, sigma_x, mu), n0=4)
    mc = mt.UnbiasedMLMC(fn, mt.GeometricLevels(2.0 ** -1.25), estimator="single",
                         seed=7, chunk_size=lambda lv: max(1024 >> lv, 16),
                         cost_fn=lambda lv: 2.0 ** lv, device="cpu")
    out = mc.run(target_var=5e-5, n_init=1 << 12)
    exact = tn.evppi_gaussian_exact(sigma_y, mu)
    assert out["target_met"]
    assert abs(out["mean"] - exact) < 6 * np.sqrt(out["var"])
