"""mlmc_tpu_torch.sim.spde against mlmc_tpu's.

JAX draws coarse step c's ``(m_t, N_f)`` noise block from ``fold_in(key,
c)``; this file rebuilds those normals and feeds them to the port's
``coupled_spde_paths`` / ``_from_draws``: the stochastic heat and the
Allen-Cahn fields agree to 1e-12 relative (f64) at level 0 and at a
coupled level. The closed forms equal mlmc_tpu's; the keyed batches do not
depend on batching and telescope to the discrete closed form.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.sim import spde as ts

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

B = 16
LEVELS = [(16, 16, 0, 0), (16, 32, 8, 8)]


def _per_step_normals(keys, trips, m_t, N_f):
    """JAX's noise: ``normal(fold_in(key, c), (m_t, N_f))`` per coarse step."""
    z = jax.jit(jax.vmap(lambda k: jax.vmap(lambda c: jax.random.normal(
        jax.random.fold_in(k, c), (m_t, N_f), jnp.float64))(jnp.arange(trips))))(keys)
    return torch.tensor(np.asarray(z)).reshape(keys.shape[0], -1)


def _models(name):
    import mlmc_tpu.sim.spde as js

    if name == "heat":
        return js.stochastic_heat(0.7, 1.3), ts.stochastic_heat(0.7, 1.3)
    return js.allen_cahn(nu=0.05, sigma=0.5), ts.allen_cahn(nu=0.05, sigma=0.5)


@pytest.mark.parametrize("name", ["heat", "allen_cahn"])
@pytest.mark.parametrize("level", LEVELS)
def test_coupled_paths_match_mlmc_tpu_on_its_draws(name, level):
    import mlmc_tpu.sim.spde as js

    N_f, n_f, N_c, n_c = level
    m_t = 1 if n_c == 0 else n_f // n_c
    trips = n_f if n_c == 0 else n_c
    mj, mt_ = _models(name)
    cfg = dict(total_time=0.5, n_cells_fine=N_f, n_steps_fine=n_f,
               n_cells_coarse=N_c, n_steps_coarse=n_c)
    keys = jax.random.split(jax.random.key(11), B)
    uj = js.coupled_spde_paths(dict(cfg, model=mj, dtype="float64"), keys)
    z = _per_step_normals(keys, trips, m_t, N_f)
    ut = ts.coupled_spde_paths(dict(cfg, model=mt_), z)
    np.testing.assert_allclose(ut[0].numpy(), np.asarray(uj[0]), rtol=1e-12, atol=1e-14)
    assert (ut[1] is None) == (uj[1] is None)
    if uj[1] is not None:
        np.testing.assert_allclose(ut[1].numpy(), np.asarray(uj[1]), rtol=1e-12,
                                   atol=1e-14)
    # the simulation's QoIs from the same draws
    for qoi in ("l2sq", "point"):
        sim_j = js.SPDESimulation(dict(model=mj, total_time=0.5, qoi=qoi, dtype="float64"))
        sim_t = ts.SPDESimulation(dict(model=mt_, total_time=0.5, qoi=qoi))
        fine_p = [1 / N_f, 0.5 / n_f]
        coarse_p = [0, 0] if n_c == 0 else [1 / N_c, 0.5 / n_c]
        fj, cj, _ = js.SPDESimulation.calculate_batch(
            sim_j.level_instance(fine_p, coarse_p).config_dict, keys)
        ft, ct, failed = ts.SPDESimulation._from_draws(
            sim_t.level_instance(fine_p, coarse_p).config_dict, z)
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(ct.numpy(), np.asarray(cj), rtol=1e-12, atol=1e-14)
        assert not bool(failed.any())


def test_closed_forms_equal_mlmc_tpu():
    import mlmc_tpu.sim.spde as js

    for args in [(1.0, 1.0, 0.5, 128, 256), (0.3, 2.0, 1.0, 16, 8)]:
        assert ts.discrete_heat_l2_moment(*args) == js.discrete_heat_l2_moment(*args)
    assert ts.heat_spde_l2_moment(1.0, 1.0, 0.5) == js.heat_spde_l2_moment(1.0, 1.0, 0.5)
    S_t, lam_t = ts._dst_basis(12)
    S_j, lam_j = js._dst_basis(12)
    assert np.array_equal(S_t, S_j) and np.array_equal(lam_t, lam_j)


def test_keyed_batches_telescope_to_the_discrete_closed_form():
    """Keyed batches equal the same indices in two batches bit for bit; the
    telescoped energy of two levels lies within 6 se of the discrete law of
    the finest grid."""
    sim = ts.SPDESimulation(dict(model=ts.stochastic_heat(), total_time=0.5,
                                 dtype="float64"))
    total, var = 0.0, 0.0
    for lev, (fine, coarse) in enumerate([([1 / 8, 0.5 / 8], [0, 0]),
                                          ([1 / 16, 0.5 / 32], [1 / 8, 0.5 / 8])]):
        cfg = sim.level_instance(fine, coarse).config_dict
        idx = torch.arange(1 << 11)
        f, c, _ = ts.SPDESimulation.calculate_keyed_batch(cfg, 5, lev, idx,
                                                          torch.zeros_like(idx))
        f2, c2, _ = ts.SPDESimulation.calculate_keyed_batch(cfg, 5, lev, idx[7:],
                                                            torch.zeros_like(idx[7:]))
        assert torch.equal(f[7:], f2) and torch.equal(c[7:], c2)
        d = (f - c)[:, 0]
        total += float(d.mean())
        var += float(d.var()) / idx.numel()
    exact = ts.discrete_heat_l2_moment(1.0, 1.0, 0.5, 16, 32)
    assert abs(total - exact) < 6 * np.sqrt(var)


def test_full_precision_whatever_the_tf32_setting():
    """The step's products pin full float32 precision for their duration
    and leave the process's setting as it was."""
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision("high")
        sim = ts.SPDESimulation(dict(total_time=0.5))
        cfg = sim.level_instance([1 / 8, 0.5 / 8], [0, 0]).config_dict
        fine, _, _ = ts.SPDESimulation.calculate_batch(
            cfg, torch.Generator().manual_seed(0), 4, device="cpu")
        assert fine.dtype == torch.float32 and bool(torch.isfinite(fine).all())
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(saved)
    with pytest.raises(ValueError, match="integer"):
        ts.coupled_spde_paths(dict(model=ts.stochastic_heat(), total_time=0.5,
                                   n_cells_fine=8, n_steps_fine=8, n_cells_coarse=3,
                                   n_steps_coarse=4), torch.zeros(1, 64))
