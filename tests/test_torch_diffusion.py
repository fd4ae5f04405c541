"""mlmc_tpu_torch.sim.diffusion against mlmc_tpu.sim.diffusion.

Same inputs on both sides, made from a seed with numpy (or drawn exactly
as the JAX function draws them: ``kr, ki = split(key)``), f64 on both
sides. The port's functions take a batch, mlmc_tpu's one sample: each
batch row is held against the per-sample call. Tolerances: operator
pieces 1e-12; pressures 1e-8 relative at ``cg_tol=1e-12`` and CG iteration
counts within 1 of a per-sample solve; fluxes 1e-8.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.sim import diffusion
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation as TD

torch.set_num_threads(1)


def _JD():
    from mlmc_tpu.sim.diffusion import DiffusionSimulation
    return DiffusionSimulation


def _K(B, n, seed=0, sigma=1.0):
    """Smooth log-normal conductivities [B, n, n] (numpy f64)."""
    rng = np.random.default_rng(seed)
    x = (np.arange(n) + 0.5) / n
    g = sum(rng.normal(size=(B, 1, 1)) * np.cos(np.pi * (a * x[:, None] + b * x[None, :])
                                               + rng.uniform(0, 6, size=(B, 1, 1)))
            for a, b in ((1, 0), (0, 1), (2, 1), (1, 3)))
    return np.exp(sigma * g / 2.0)


def test_operator_pieces_match_mlmc_tpu():
    import jax.numpy as jnp

    JD = _JD()
    K = _K(3, 8, seed=1)
    p = np.random.default_rng(2).normal(size=(3, 8, 8))
    tK, tp = torch.tensor(K), torch.tensor(p)
    Kx, Ky = TD._face_conductivities(tK)
    Kl, Kr = 2.0 * tK[:, :, 0], 2.0 * tK[:, :, -1]
    Av = TD._stencil_matvec(tp, Kx, Ky, Kl, Kr)
    diag = TD._stencil_diag(Kx, Ky, Kl, Kr, 8)
    coarse = TD._galerkin_coarsen(Kx, Ky, Kl, Kr)
    for b in range(3):
        jK = jnp.asarray(K[b])
        jKx, jKy = JD._face_conductivities(jK)
        jKl, jKr = 2.0 * jK[:, 0], 2.0 * jK[:, -1]
        kw = dict(rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(Kx[b].numpy(), np.asarray(jKx), **kw)
        np.testing.assert_allclose(Ky[b].numpy(), np.asarray(jKy), **kw)
        np.testing.assert_allclose(
            Av[b].numpy(),
            np.asarray(JD._stencil_matvec(jnp.asarray(p[b]), jKx, jKy, jKl, jKr)), **kw)
        np.testing.assert_allclose(
            diag[b].numpy(), np.asarray(JD._stencil_diag(jKx, jKy, jKl, jKr, 8)), **kw)
        for got, want in zip(coarse, JD._galerkin_coarsen(jKx, jKy, jKl, jKr)):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **kw)
    # the matvec broadcasts leading dimensions (the multigrid setup's
    # identity columns): [3, 1, ...] operators on [1, 5, 8, 8] vectors
    cols = torch.tensor(np.random.default_rng(3).normal(size=(1, 5, 8, 8)))
    out = TD._stencil_matvec(cols, Kx[:, None], Ky[:, None], Kl[:, None], Kr[:, None])
    assert out.shape == (3, 5, 8, 8)
    np.testing.assert_allclose(
        out[1, 4].numpy(),
        TD._stencil_matvec(cols[0, 4], Kx[1], Ky[1], Kl[1], Kr[1]).numpy(), rtol=1e-15)


@pytest.mark.parametrize("n", [4, 8, 16])
def test_spectral_basis_and_const_diag_match_mlmc_tpu(n):
    for got, want in zip(TD._spectral_basis(n), _JD()._spectral_basis(n)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(TD._const_diag(n), _JD()._const_diag(n))
    # the basis diagonalizes the unit-K operator: A = (Cy x Sx)^T lam (Cy x Sx)
    Sx, Cy, lam = TD._spectral_basis(n)
    one = torch.ones(n, n, dtype=torch.float64)
    Kx, Ky = TD._face_conductivities(one)
    p = torch.tensor(np.random.default_rng(0).normal(size=(n, n)))
    Ap = TD._stencil_matvec(p, Kx, Ky, 2.0 * one[:, 0], 2.0 * one[:, -1]).numpy()
    np.testing.assert_allclose(Cy.T @ (lam * (Cy @ p.numpy() @ Sx.T)) @ Sx, Ap, atol=1e-12)


def _reference_ops(jax_cls, n, precond):
    """mlmc_tpu's stencil and preconditioner as jitted functions of (vector,
    face arrays), compiled once for all samples of a test."""
    import jax
    import jax.numpy as jnp

    A = jax.jit(jax_cls._stencil_matvec)
    if precond == "mg":
        M = jax.jit(lambda r, *faces: jax_cls._mg_vcycle_preconditioner(
            *faces, n)(r.reshape(-1)).reshape(n, n))
    elif precond == "spectral":
        Sx, Cy, lam = jax_cls._spectral_basis(n)
        cdiag = jax_cls._const_diag(n)

        def M(r, *faces):
            w = jnp.sqrt(cdiag / jax_cls._stencil_diag(*faces, n))
            return w * (Cy.T @ ((Cy @ (w * r) @ Sx.T) / lam) @ Sx)
    else:
        M = lambda r, *faces: r / jax_cls._stencil_diag(*faces, n)
    return A, M


def _reference_pcg(jax_cls, config, K, ops):
    """A per-sample preconditioned CG with mlmc_tpu's operators (its
    stencil, its preconditioner pieces) and the stopping rule of
    jax.scipy.sparse.linalg.cg: x0 = 0, stop when |r|^2 <= tol^2 |b|^2 or
    at maxiter. :return: (pressure [n, n], iterations)"""
    import jax.numpy as jnp

    n = K.shape[0]
    K = jnp.asarray(K)
    Kx, Ky = jax_cls._face_conductivities(K)
    faces = (Kx, Ky, 2.0 * K[:, 0], 2.0 * K[:, -1])
    A = lambda p: np.asarray(ops[0](jnp.asarray(p), *faces))
    M = lambda r: np.asarray(ops[1](jnp.asarray(r), *faces))
    factor = (jax_cls.CG_MAXITER_FACTOR_MG if config["precond"] == "mg"
              else jax_cls.CG_MAXITER_FACTOR)
    b = np.zeros((n, n))
    b[:, 0] = np.asarray(faces[2])
    atol2 = config["cg_tol"] ** 2 * np.sum(b * b)
    x, r = np.zeros_like(b), b.copy()
    z = M(r)
    p, gamma, k = z, np.sum(r * z), 0
    while np.sum(r * r) > atol2 and k < factor * n:
        Ap = A(p)
        alpha = gamma / np.sum(p * Ap)
        x, r = x + alpha * p, r - alpha * Ap
        z = M(r)
        gamma_new = np.sum(r * z)
        p, gamma, k = z + (gamma_new / gamma) * p, gamma_new, k + 1
    return x, k


@pytest.mark.parametrize("precond", ["spectral", "jacobi", "mg"])
@pytest.mark.parametrize("n", [8, 16])
def test_solve_pressure_matches_mlmc_tpu(n, precond):
    import jax
    import jax.numpy as jnp

    JD = _JD()
    B = 2
    K = _K(B, n, seed=n)
    config = dict(precond=precond, cg_tol=1e-12, dtype="float64")
    got, iters = TD._solve_pressure(config, torch.tensor(K))
    assert got.shape == (B, n, n) and iters.shape == (B,)
    j_solve = jax.jit(lambda k: JD._solve_pressure(config, k))
    ops = _reference_ops(JD, n, precond)
    for b in range(B):
        want = np.asarray(j_solve(jnp.asarray(K[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-8, atol=1e-10)
        ref, k = _reference_pcg(JD, config, K[b], ops)
        # the reference is mlmc_tpu's solve, so its count is that solve's
        np.testing.assert_allclose(ref, want, rtol=1e-8, atol=1e-10)
        assert abs(int(iters[b]) - k) <= 1, (b, int(iters[b]), k)


@pytest.mark.parametrize("precond", ["spectral", "jacobi", "mg"])
def test_batch_equals_samples_solved_one_by_one(precond, monkeypatch):
    """Samples that converge at different iterations: each is frozen by
    the active mask when it is done, so the batch equals the samples
    solved alone, whatever the host's check interval."""
    K = _K(5, 16, seed=7, sigma=1.5)
    K[0] = 2.0                      # homogeneous: done after one iteration
    K = torch.tensor(K)
    base = dict(precond=precond, cg_tol=1e-10, dtype="float64")
    monkeypatch.setattr(diffusion, "CG_CHECK_EVERY", 1)
    p, iters = TD._solve_pressure(base, K)
    assert len(set(iters.tolist())) > 1
    if precond == "spectral":
        assert int(iters[0]) == 1   # exact for constant K
    for every in (3, 7, 1000):
        monkeypatch.setattr(diffusion, "CG_CHECK_EVERY", every)
        p2, it2 = TD._solve_pressure(base, K)
        assert torch.equal(p2, p) and torch.equal(it2, iters)
    monkeypatch.undo()
    for b in range(5):
        alone, it1 = TD._solve_pressure(base, K[b:b + 1])
        assert int(it1[0]) == int(iters[b])
        np.testing.assert_allclose(alone[0].numpy(), p[b].numpy(), rtol=1e-12, atol=1e-14)


def test_homogeneous_limit():
    """K = k0 gives flux k0 (Darcy on the unit square); sigma = 0 gives 1."""
    for k0 in (1.0, 2.5):
        K = torch.full((2, 16, 16), k0, dtype=torch.float64)
        p, _ = TD._solve_pressure(dict(cg_tol=1e-12), K)
        np.testing.assert_allclose(TD._flux(K, p).numpy(), k0, rtol=1e-10)
    level = TD(dict(sigma=0.0, corr_length=0.2)).level_instance([1 / 16], [0])
    fine, coarse = TD.calculate(level.config_dict, seed=7, device="cpu")
    assert abs(float(fine[0]) - 1.0) < 1e-6 and coarse[0] == 0.0


@pytest.mark.parametrize("precond", ["spectral", "mg"])
def test_circulant_flux_from_the_same_noise(precond):
    """Fine and coarse flux of mlmc_tpu's ``_calculate_one(config, key)``
    from the noise that key gives it."""
    import jax

    JD = _JD()
    jcfg = JD(dict(sigma=1.0, corr_length=0.3, field_method="circulant",
                   precond=precond, cg_tol=1e-12)).level_instance(
        [1 / 16], [1 / 4]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    keys = jax.random.split(jax.random.key(3), 3)
    j_one = jax.jit(lambda k: JD._calculate_one(jcfg, k))
    shape = jcfg["_circ_eig"].shape
    noise, want = [], []
    for k in keys:
        kr, ki = jax.random.split(k)
        noise.append(np.stack([np.asarray(jax.random.normal(kr, shape)),
                               np.asarray(jax.random.normal(ki, shape))]))
        f, c = j_one(k)
        want.append([float(f[0]), float(c[0])])
    noise = torch.tensor(np.stack(noise))                  # [3, 2, 32, 32]
    fine, coarse, it_f, it_c = TD._calculate(tcfg, noise=(noise[:, 0], noise[:, 1]))
    want = np.asarray(want)
    np.testing.assert_allclose(fine[:, 0].numpy(), want[:, 0], rtol=1e-8)
    np.testing.assert_allclose(coarse[:, 0].numpy(), want[:, 1], rtol=1e-8)
    assert it_f.max() > 1 and it_c.max() >= 1   # mg solves a 4^2 grid directly
    # the conductivity itself, fine and point-sampled coarse
    for n in (16, 4):
        K = TD._conductivity(tcfg, n, noise=(noise[:1, 0], noise[:1, 1]))[0]
        np.testing.assert_allclose(
            K.numpy(), np.asarray(JD._conductivity(jcfg, keys[0], n)), rtol=1e-10)


def test_rff_flux_from_the_same_phases():
    import jax
    import jax.numpy as jnp

    JD = _JD()
    jcfg = JD(dict(sigma=1.0, corr_length=0.3, n_modes=32, cg_tol=1e-12)
              ).level_instance([1 / 8], [1 / 4]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    phases = np.random.default_rng(5).uniform(0, 2 * np.pi, size=(3, 32))
    fine, coarse, _, _ = TD._calculate(tcfg, phases=torch.tensor(phases))
    j_one = jax.jit(lambda ph: JD._calculate_one(jcfg, None, phases=ph))
    for b in range(3):
        f, c = j_one(jnp.asarray(phases[b]))
        np.testing.assert_allclose(float(fine[b, 0]), float(f[0]), rtol=1e-8)
        np.testing.assert_allclose(float(coarse[b, 0]), float(c[0]), rtol=1e-8)
    with pytest.raises(ValueError, match="rff"):
        circ = TD(dict(field_method="circulant")).level_instance([1 / 4], [0])
        TD._conductivity(circ.config_dict, 4, phases=torch.zeros(1, 4))
    with pytest.raises(ValueError, match="unknown field_method"):
        TD(dict(field_method="kl")).level_instance([1 / 4], [0])


@pytest.mark.parametrize("method", ["circulant", "rff"])
def test_keyed_batch_is_a_function_of_the_sample_identity(method):
    cfg = TD(dict(sigma=1.0, corr_length=0.3, field_method=method, n_modes=16,
                  dtype="float64")).level_instance([1 / 8], [1 / 4]).config_dict
    idx = torch.arange(12, dtype=torch.int64)
    att = torch.zeros(12, dtype=torch.int64)
    fine, coarse, failed = TD.calculate_keyed_batch(cfg, 23, 1, idx, att)
    assert fine.shape == coarse.shape == (12, 1) and not failed.any()
    assert torch.all(fine > 0) and torch.all(coarse > 0)
    parts = [TD.calculate_keyed_batch(cfg, 23, 1, idx[a:b], att[a:b])
             for a, b in ((0, 7), (7, 12))]
    # batched matmuls may round differently with the batch size
    np.testing.assert_allclose(torch.cat([p[0] for p in parts]).numpy(),
                               fine.numpy(), rtol=1e-12)
    np.testing.assert_allclose(torch.cat([p[1] for p in parts]).numpy(),
                               coarse.numpy(), rtol=1e-12)
    renewed = TD.calculate_keyed_batch(cfg, 23, 1, idx, att + 1)[0]
    assert not np.allclose(renewed.numpy(), fine.numpy())
    # fine and coarse share one realization
    assert np.corrcoef(fine[:, 0].numpy(), coarse[:, 0].numpy())[0, 1] > 0.8


def test_generator_batch_in_float32():
    cfg = TD(dict(sigma=1.0, corr_length=0.3, field_method="circulant")
             ).level_instance([1 / 16], [1 / 4]).config_dict
    fine, coarse, failed = TD.calculate_batch(
        cfg, torch.Generator().manual_seed(0), 64)
    assert fine.dtype == torch.float32 and fine.device.type == "cpu"
    assert torch.isfinite(fine).all() and not failed.any()
    again = TD.calculate_batch(cfg, torch.Generator().manual_seed(0), 64, device="cpu")
    assert torch.equal(again[0], fine)
    # 2-D lognormal medium: effective K ~ geometric mean = 1
    f = fine[:, 0].double().numpy()
    assert abs(f.mean() - 1.0) < max(5 * f.std() / 8, 0.15)
    assert np.var(f - coarse[:, 0].double().numpy()) < 0.5 * np.var(f)


def test_darcy_slice_matches_mlmc_tpu_estimate():
    """A 2-level 8^2 / 4^2 run through Sampler -> DeviceBatchPool ->
    DeviceMemory -> Estimate; mlmc_tpu estimates the same samples: f64 tier
    1e-10, fast tier within the f32 accumulation bound; then three rounds
    of the adaptive loop with the rates' diagnostics."""
    import mlmc_tpu as jm
    import mlmc_tpu.estimator as jest
    from mlmc_tpu.ops.precision import accumulation_error_bound
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    import mlmc_tpu_torch.quantity.quantity_estimate as tqe

    sim = TD(dict(sigma=1.0, corr_length=0.3, field_method="circulant"))
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=23, device_results=True, min_bucket=64,
                              max_batch=256, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, [[1 / 4], [1 / 8]])
    sampler.set_initial_n_samples([400, 100])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    q = mt.make_root_quantity(storage, sim.result_format())["flux"][0]["outflow"][0]
    mfn = mt.Legendre(6, (0.05, 8.0))
    est = mt.Estimate(q, storage, mfn)

    jstorage = jm.Memory()
    jstorage.save_global_data(
        result_format=[jm.QuantitySpec(name=s.name, unit=s.unit, shape=s.shape,
                                       times=s.times, locations=s.locations)
                       for s in sim.result_format()],
        level_parameters=storage.get_level_parameters())
    for lid, p in enumerate(storage.sample_pairs()):
        p = p.numpy().astype(np.float64)   # the stored f32 values, exactly
        ids = ["L{:02d}_S{:07d}".format(lid, i) for i in range(p.shape[1])]
        jstorage.save_scheduled_samples(lid, ids)
        coarse = p[:, :, 1].T if p.shape[2] > 1 else np.zeros_like(p[:, :, 0].T)
        jstorage.save_samples_bulk(lid, ids, p[:, :, 0].T, coarse)
    jq = j_root(jstorage, jstorage.load_result_format())["flux"][0]["outflow"][0]
    j_mean, j_var = jest.Estimate(jq, jstorage, jm.Legendre(6, (0.05, 8.0))
                                  ).estimate_moments()
    ext_mean, ext_var = est.estimate_moments_extended()
    np.testing.assert_allclose(ext_mean, j_mean, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ext_var, j_var, rtol=1e-9, atol=1e-14)
    fast_mean, _ = est.estimate_moments_fast()
    s_abs = ck.samples_mlmc_plain(est._packed_streams(mfn, [0]), 6, basis="legendre",
                                  absolute=True,
                                  consts=ck.transform_constants(mfn.domain))
    raw, ns = est.estimate_diff_vars_fast()
    bound = sum(accumulation_error_bound(s_abs.sums[l].numpy()) / ns[l]
                for l in range(2))
    assert np.all(np.abs(fast_mean - j_mean) <= bound + 1e-12)

    for _ in range(3):
        raw, _ = est.estimate_diff_vars_fast()
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw)
        n_est = mt.estimate_n_samples_for_target_variance(
            1e-5, variances, n_ops, n_levels=2)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            break
    assert sum(storage.get_n_collected()) > 500
    m = tqe.estimate_mean(q)
    rates = mt.estimate_convergence_rates(
        m.l_means, m.l_vars, storage.get_level_parameters(), storage.get_n_ops())
    assert set(rates) == {"alpha", "beta", "gamma", "n_fit_levels"}
    assert 0.5 < float(np.ravel(m.mean)[0]) < 2.0
    assert m.l_vars[1] < 0.5 * m.l_vars[0]          # the coupling
