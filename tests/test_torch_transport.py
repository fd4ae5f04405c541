"""mlmc_tpu_torch.sim.transport against mlmc_tpu's.

The same conductivities go through both packages: the circulant noise
JAX's key gives a sample (``kr, ki = split(key)``), and numpy fields for
the transport alone. The breakthrough curves agree to 1e-10 relative
(f64, CG at ``cg_tol=1e-14``) for the upwind and the MUSCL scheme, a
sample that runs out of its step budget is NaN in both, and the sharded
pool equals the one-device pool bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.parallel import SampleMesh
from mlmc_tpu_torch.sim.transport import TransportSimulation as TT, _interp

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)


def _JT():
    from mlmc_tpu.sim.transport import TransportSimulation
    return TransportSimulation


def _K(B, n, seed):
    rng = np.random.default_rng(seed)
    x = (np.arange(n) + 0.5) / n
    g = sum(rng.normal(size=(B, 1, 1)) * np.cos(np.pi * (a * x[:, None] + b * x[None, :])
                                               + rng.uniform(0, 6, size=(B, 1, 1)))
            for a, b in ((1, 0), (0, 1), (2, 1)))
    return np.exp(0.5 * g)


@pytest.mark.parametrize("scheme", ["upwind", "muscl"])
def test_breakthrough_matches_mlmc_tpu(scheme):
    """Four samples at 8^2, one of them so fast (K x 40) that its stable
    step cannot cover the horizon: NaN in both packages."""
    JT = _JT()
    n = 8
    cfg = dict(sigma=1.0, corr_length=0.3, field_method="circulant", scheme=scheme,
               cg_tol=1e-14, diffusion=0.01 if scheme == "upwind" else 0.0)
    jcfg = JT(dict(cfg)).level_instance([1 / n], [0]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    assert tcfg["_n_steps_fine"] == jcfg["_n_steps_fine"] == 96 * n
    K = _K(4, n, 1)
    K[3] *= 40.0
    steps = jcfg["_n_steps_fine"]
    want = np.asarray(jax.jit(jax.vmap(lambda k: JT._breakthrough(jcfg, k, n, steps)))(K))
    got, iters = TT._breakthrough(tcfg, torch.tensor(K), n, steps)
    assert got.shape == (4, 40) and iters.shape == (4,)
    assert np.array_equal(np.isnan(got.numpy()), np.isnan(want))
    assert np.isnan(want[3]).all() and not np.isnan(want[:3]).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-13)


def test_coupled_batch_from_the_same_noise():
    """Fine (16^2) and coarse (4^2) curves of ``calculate_batch(config,
    keys)`` from the circulant noise each key gives, and the failure mask."""
    JT = _JT()
    jcfg = JT(dict(sigma=1.0, corr_length=0.3, field_method="circulant",
                   cg_tol=1e-14)).level_instance([1 / 16], [1 / 4]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    keys = jax.random.split(jax.random.key(2), 3)
    fj, cj, failed_j = jax.jit(lambda k: JT.calculate_batch(jcfg, k))(keys)
    shape = np.shape(jcfg["_circ_eig"])
    noise = []
    for k in keys:
        kr, ki = jax.random.split(k)
        noise.append(np.stack([np.asarray(jax.random.normal(kr, shape)),
                               np.asarray(jax.random.normal(ki, shape))]))
    noise = torch.tensor(np.stack(noise))
    ft, ct, failed_t = TT._from_draws(tcfg, {"noise": (noise[:, 0], noise[:, 1])})
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-10, atol=1e-13)
    assert np.array_equal(failed_t.numpy(), np.asarray(failed_j))
    assert not bool(torch.equal(ft, ct))


def test_interp_matches_jnp_interp():
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    xp = np.cumsum(rng.uniform(0.01, 0.1, size=(3, 20)), axis=1)
    fp = rng.normal(size=(3, 20))
    x = np.array([-1.0, 0.05, 0.3, 0.5, 0.77, 5.0])
    want = np.stack([np.asarray(jnp.interp(x, xp[b], fp[b])) for b in range(3)])
    got = _interp(torch.tensor(x), torch.tensor(xp), torch.tensor(fp)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-15, atol=1e-15)


def test_result_format_and_entry_points():
    sim = TT(dict(field_method="circulant", corr_length=0.3, steps_per_cell=96))
    names = [(q.name, len(q.times), len(q.locations)) for q in sim.result_format()]
    assert names == [("conc_flux", 8, 1), ("conc", 8, 4)]
    level = sim.level_instance([1 / 8], [1 / 4])
    fine, coarse, failed = TT.calculate_batch(level.config_dict,
                                              torch.Generator().manual_seed(0), 3,
                                              device="cpu")
    assert fine.shape == coarse.shape == (3, 40) and fine.dtype == torch.float32
    assert not bool(failed.any()) and bool((fine[:, :8] >= 0).all())
    assert TT.calculate(level.config_dict, 2, device="cpu")[0].shape == (40,)
    with pytest.raises(ValueError, match="scheme"):
        TT._breakthrough(dict(level.config_dict, scheme="weno"), torch.ones(1, 8, 8), 8, 8)


def _pool_payloads(sharding):
    sim = TT(dict(field_method="circulant", corr_length=0.3, sigma=1.0))
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=5, sharding=sharding, device_results=True,
                              device="cpu")
    sampler = mt.Sampler(storage, pool, sim, [[1 / 4], [1 / 8]])
    sampler.set_initial_n_samples([12, 6])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return storage.sample_pairs(), storage.get_n_collected()


def test_sharded_pool_equals_one_device_bit_for_bit():
    one, n_one = _pool_payloads(None)
    two, n_two = _pool_payloads(SampleMesh(["cpu", "cpu"], group=False))
    assert n_one == n_two == [12, 6]
    for a, b in zip(one, two):
        assert a.shape == b.shape and a.shape[0] == 40
        assert torch.equal(a, b)
