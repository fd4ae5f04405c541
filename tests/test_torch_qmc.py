"""mlmc_tpu_torch.qmc against mlmc_tpu.qmc.

``convert.mlqmc_from_jax`` carries a JAX MLQMC's randomization (Owen
scramble words, or lattice shifts and CBC vectors) into the port, so both
evaluate the same points: level sums within 1e-12 relative and the
adaptive run's decisions (points per level, rounds) identical under a
fixed ``cost_per_sample``. Each adapter is held against its JAX twin on
the same uniforms (1e-12 relative, f64 on both sides), and MLQMC over a
two-shard CPU mesh equals one device.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import qmc as tq
from mlmc_tpu_torch.convert import mlqmc_from_jax
from mlmc_tpu_torch.parallel import SampleMesh

torch.set_num_threads(1)

LEVELS = [[0.5], [0.25], [0.125]]


def _jq():
    from mlmc_tpu import qmc as jq
    return jq


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-300)))


@pytest.mark.parametrize("point_set", ["sobol", "lattice"])
def test_mlqmc_from_jax_same_sums_and_decisions(point_set):
    jq = _jq()
    # two levels: each costs JAX a compile
    fj, dj = jq.synth_qmc_level_fns(LEVELS[:2])
    ft, dt = tq.synth_qmc_level_fns(LEVELS[:2])
    kw = dict(lattice_n_max=1 << 12) if point_set == "lattice" else {}
    ml_j = jq.MLQMC(fj, dj, n_randomizations=4, seed=3, chunk_size=64,
                    point_set=point_set, cost_per_sample=[1, 2], **kw)
    ml_t = mlqmc_from_jax(ml_j, ft, device="cpu")
    res_j = ml_j.run(1e-8, n_init=64)
    res_t = ml_t.run(1e-8, n_init=64)
    assert np.array_equal(res_j["n_samples"], res_t["n_samples"])
    assert res_j["rounds"] == res_t["rounds"] and res_t["target_met"]
    for a, b in zip(ml_j._levels, ml_t._levels):
        assert _rel(a.sums, b.sums) <= 1e-12 and _rel(a.sums_sq, b.sums_sq) <= 1e-12
    assert abs(res_j["mean"] - res_t["mean"]) <= 1e-12 * abs(res_j["mean"])
    np.testing.assert_allclose(res_t["level_vars"], res_j["level_vars"], rtol=1e-9)


def test_mlqmc_from_jax_carries_a_started_run():
    """A JAX run already extended: its points, sums and chunks come along
    and the port continues it as JAX would."""
    jq = _jq()
    fj, dj = jq.synth_qmc_level_fns(LEVELS)
    ft, _ = tq.synth_qmc_level_fns(LEVELS)
    ml_j = jq.MLQMC(fj, dj, n_randomizations=4, seed=9, chunk_size=32,
                    cost_per_sample=[1, 1, 1])
    ml_j.extend(0, 64)
    ml_t = mlqmc_from_jax(ml_j, ft, device="cpu")
    assert ml_t.n_samples.tolist() == [64, 0, 0] and ml_t._chunks == {0: 32}
    for ml in (ml_j, ml_t):
        ml.extend(0, 64)
        ml.extend(2, 32)
    for a, b in zip(ml_j._levels, ml_t._levels):
        assert a.n == b.n and _rel(a.sums, b.sums) <= 1e-12


@pytest.mark.parametrize("point_set", ["sobol", "lattice"])
def test_mlqmc_mesh_equals_one_device(point_set):
    fns, dims = tq.synth_qmc_level_fns(LEVELS)
    kw = dict(lattice_n_max=1 << 12) if point_set == "lattice" else {}
    runs = []
    for mesh in (None, SampleMesh(["cpu", "cpu"], group=False)):
        ml = tq.MLQMC(fns, dims, n_randomizations=4, seed=5, chunk_size=64,
                      dtype=torch.float64, point_set=point_set, cost_per_sample=[1, 2, 4],
                      mesh=mesh, device="cpu" if mesh is None else None, **kw)
        runs.append((ml, ml.run(1e-8, n_init=64)))
    (one, r1), (two, r2) = runs
    assert np.array_equal(r1["n_samples"], r2["n_samples"]) and r1["rounds"] == r2["rounds"]
    for a, b in zip(one._levels, two._levels):
        assert np.array_equal(a.sums, b.sums) and np.array_equal(a.sums_sq, b.sums_sq)
    with pytest.raises(ValueError, match="divide"):
        tq.MLQMC(fns, dims, n_randomizations=3,
                 mesh=SampleMesh(["cpu", "cpu"], group=False))


def test_mlqmc_vector_qoi_and_guards():
    """qoi_dim: [n, K] level functions, the worst component drives the
    loop; a non-finite level result raises; option misuse raises."""
    fns, dims = tq.synth_qmc_level_fns(LEVELS)
    vfns, vdims, K = tq.moments_qmc_level_fns(fns, dims, mt.Legendre(4, (-6, 6)),
                                              out_of_domain="clip")
    ml = tq.MLQMC(vfns, vdims, n_randomizations=4, seed=1, chunk_size=64,
                  dtype=torch.float64, qoi_dim=K, cost_per_sample=[1, 2, 4], device="cpu")
    res = ml.run(1e-7, n_init=64)
    assert res["mean"].shape == (K,) and abs(res["mean"][0] - 1.0) < 1e-12
    assert res["target_met"] and np.max(res["var"]) <= 1e-7
    bad = tq.MLQMC([lambda u: (u[:, 0] / 0.0, u[:, 0])], 1, n_randomizations=2,
                   device="cpu")
    with pytest.raises(FloatingPointError, match="non-finite"):
        bad.extend(0, 16)
    with pytest.raises(ValueError, match="lattice"):
        tq.MLQMC(fns, dims, lattice_tent=False, device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        tq.MLQMC(fns, dims, point_set="lattice", lattice_n_max=64,
                 chunk_size=64, device="cpu").extend(0, 128)


def _uniforms(n, d, seed=0):
    return np.random.default_rng(seed).uniform(1e-6, 1 - 1e-6, size=(n, d))


def _check_fns(fns_j, fns_t, dims, rtol=1e-12, n=32):
    import jax.numpy as jnp

    for lev, (fj, ft) in enumerate(zip(fns_j, fns_t)):
        u = _uniforms(n, dims[lev], lev)
        a = fj(jnp.asarray(u))
        b = ft(torch.tensor(u))
        for x, y in zip(a, b):
            np.testing.assert_allclose(y.numpy(), np.asarray(x), rtol=rtol, atol=1e-300)


def _carried(cls, jax_sim):
    """``cls`` whose levels carry ``jax_sim``'s level configs (its drawn
    wave numbers / vectors) across, so both packages share the modes."""
    class Carried(cls):
        def level_instance(self, fine, coarse):
            level = super().level_instance(fine, coarse)
            level.config_dict = mt.level_config_from_jax(
                jax_sim.level_instance(fine, coarse).config_dict, device="cpu",
                dtype="float64")
            return level

    return Carried


@pytest.mark.parametrize("distr", ["norm", "lognorm"])
def test_synth_adapter_matches_mlmc_tpu(distr):
    jq = _jq()
    fns_j, dims = jq.synth_qmc_level_fns(LEVELS, distr=distr)
    fns_t, dims_t = tq.synth_qmc_level_fns(LEVELS, distr=distr)
    assert dims == dims_t
    _check_fns(fns_j, fns_t, dims)


def test_shooting_adapter_matches_mlmc_tpu():
    import mlmc_tpu.sim.shooting as js

    cfg = dict(start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
               area_borders=(-2000.0, 2000.0, -2000.0, 2000.0), max_time=10.0,
               complexity=20.0, n_modes=16, dtype="float64",
               fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5, log=False))
    lp = [[1.0], [0.5]]
    jsim = js.ShootingSimulation1D(cfg)
    fns_j, dims = _jq().shooting_qmc_level_fns(jsim, lp)
    fns_t, dims_t = tq.shooting_qmc_level_fns(
        _carried(mt.ShootingSimulation1D, jsim)(cfg), lp)
    assert dims == dims_t == [16, 16]
    _check_fns(fns_j, fns_t, dims)


def test_darcy_adapter_matches_mlmc_tpu():
    import mlmc_tpu.sim.diffusion as jd

    cfg = dict(field_method="rff", corr_length=0.3, n_modes=16, dtype="float64",
               cg_tol=1e-14)
    lp = [[1 / 4], [1 / 8]]
    jsim = jd.DiffusionSimulation(cfg)
    fns_j, dims = _jq().darcy_qmc_level_fns(jsim, lp)
    fns_t, dims_t = tq.darcy_qmc_level_fns(_carried(mt.DiffusionSimulation, jsim)(cfg), lp)
    assert dims == dims_t == [16, 16]
    # level 1 has both resolutions; each level costs JAX one CG compile
    _check_fns(fns_j[1:], fns_t[1:], dims[1:], n=8)
    with pytest.raises(ValueError, match="rff"):
        tq.darcy_qmc_level_fns(mt.DiffusionSimulation(dict(field_method="circulant")), lp)


@pytest.mark.parametrize("out_of_domain", ["error", "clip"])
def test_moments_and_normals_adapters_match_mlmc_tpu(out_of_domain):
    import mlmc_tpu as jm

    jq = _jq()
    fns_j, dims = jq.synth_qmc_level_fns(LEVELS)
    fns_t, _ = tq.synth_qmc_level_fns(LEVELS)
    mj, mtt = jm.Legendre(5, (-2.0, 2.0)), mt.Legendre(5, (-2.0, 2.0))
    vj, _, kj = jq.moments_qmc_level_fns(fns_j, dims, mj, out_of_domain=out_of_domain)
    vt, _, kt = tq.moments_qmc_level_fns(fns_t, dims, mtt, out_of_domain=out_of_domain)
    assert kj == kt == 5
    import jax.numpy as jnp
    for lev in range(3):
        u = _uniforms(64, 1, lev)
        a, b = vj[lev](jnp.asarray(u)), vt[lev](torch.tensor(u))
        for x, y in zip(a, b):
            x = np.asarray(x)
            assert np.array_equal(np.isnan(x), np.isnan(y.numpy()))
            np.testing.assert_allclose(y.numpy()[~np.isnan(x)], x[~np.isnan(x)], rtol=1e-12,
                                       atol=1e-14)

    fj = [lambda z: (jnp.sum(z ** 2, axis=1), z[:, 0] * 0.0)]
    ft = [lambda z: ((z ** 2).sum(dim=1), z[:, 0] * 0.0)]
    nj, dnj = jq.qmc_level_fns_from_normals(fj, 3)
    nt, dnt = tq.qmc_level_fns_from_normals(ft, 3)
    assert dnj == dnt == [3]
    _check_fns(nj, nt, [3])
