"""mlmc_tpu_torch.sim.diffusion3d against mlmc_tpu.sim.diffusion3d.

Same inputs on both sides, made from a seed with numpy (or drawn exactly as
the JAX function draws them: its phases from its key), f64 on both sides.
The port's functions take a batch, mlmc_tpu's one sample: each batch row is
held against the per-sample call. Tolerances: operator pieces, spectral
bases and Galerkin coarsening 1e-12; pressures 1e-8 relative at
``cg_tol=1e-12`` and CG iteration counts within 1 of a per-sample solve
with mlmc_tpu's operators; fluxes 1e-8; the f64 tier of a stored run
against mlmc_tpu's estimate 1e-10.

mlmc_tpu is imported inside the tests that compare with it, so the
``cuda`` cases run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_diffusion3d.py -m cuda``.
There kernels C and D are held against their plain versions at the
streams of a 3-D Darcy run: C within 1e-12 * S_abs, D within the f64
tier's derived bound (``ops/precision.extended_error_bound``).
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.sim import diffusion
from mlmc_tpu_torch.sim.diffusion3d import DiffusionSimulation3D as TD

torch.set_num_threads(1)


def _JD():
    from mlmc_tpu.sim.diffusion3d import DiffusionSimulation3D
    return DiffusionSimulation3D


def _K(B, n, seed=0, sigma=1.0):
    """Smooth log-normal conductivities [B, n, n, n] (numpy f64)."""
    rng = np.random.default_rng(seed)
    x = (np.arange(n) + 0.5) / n
    X, Y, Z = np.meshgrid(x, x, x, indexing="ij")
    g = sum(rng.normal(size=(B, 1, 1, 1))
            * np.cos(np.pi * (a * X + b * Y + c * Z) + rng.uniform(0, 6, size=(B, 1, 1, 1)))
            for a, b, c in ((1, 0, 0), (0, 1, 1), (2, 1, 0), (1, 0, 3)))
    return np.exp(sigma * g / 2.0)


def _faces(cls, K):
    Kx, Ky, Kz = cls._face_conductivities(K)
    return Kx, Ky, Kz, 2.0 * K[..., 0, :, :], 2.0 * K[..., -1, :, :]


def test_operator_pieces_match_mlmc_tpu():
    import jax.numpy as jnp

    JD = _JD()
    K = _K(2, 8, seed=1)
    p = np.random.default_rng(2).normal(size=(2, 8, 8, 8))
    faces = _faces(TD, torch.tensor(K))
    Av = TD._stencil_matvec(torch.tensor(p), *faces)
    diag = TD._stencil_diag(*faces, 8)
    coarse = TD._galerkin_coarsen(*faces)
    kw = dict(rtol=1e-12, atol=1e-12)
    for b in range(2):
        jfaces = _faces(JD, jnp.asarray(K[b]))
        for got, want in zip(faces, jfaces):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **kw)
        np.testing.assert_allclose(
            Av[b].numpy(), np.asarray(JD._stencil_matvec(jnp.asarray(p[b]), *jfaces)), **kw)
        np.testing.assert_allclose(
            diag[b].numpy(), np.asarray(JD._stencil_diag(*jfaces, 8)), **kw)
        for got, want in zip(coarse, JD._galerkin_coarsen(*jfaces)):
            np.testing.assert_allclose(got[b].numpy(), np.asarray(want), **kw)
    # leading dimensions broadcast (the multigrid setup's identity columns)
    cols = torch.tensor(np.random.default_rng(3).normal(size=(1, 3, 8, 8, 8)))
    out = TD._stencil_matvec(cols, *(f[:, None] for f in faces))
    assert out.shape == (2, 3, 8, 8, 8)
    np.testing.assert_allclose(
        out[1, 2].numpy(), TD._stencil_matvec(cols[0, 2], *(f[1] for f in faces)).numpy(),
        rtol=1e-15)


@pytest.mark.parametrize("n", [4, 8])
def test_spectral_basis_and_const_diag_match_mlmc_tpu(n):
    for got, want in zip(TD._spectral_basis(n), _JD()._spectral_basis(n)):
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    np.testing.assert_array_equal(TD._const_diag(n), _JD()._const_diag(n))
    # the basis diagonalizes the unit-K operator
    Sx, Cn, lam = TD._spectral_basis(n)
    one = torch.ones(n, n, n, dtype=torch.float64)
    p = np.random.default_rng(0).normal(size=(n, n, n))
    Ap = TD._stencil_matvec(torch.tensor(p), *_faces(TD, one)).numpy()
    p_hat = np.einsum("ai,bj,ck,ijk->abc", Sx, Cn, Cn, p)
    np.testing.assert_allclose(np.einsum("ai,bj,ck,abc->ijk", Sx, Cn, Cn, lam * p_hat),
                               Ap, atol=1e-12)
    np.testing.assert_allclose(np.diag(TD._stencil_diag(*_faces(TD, one), n).reshape(-1)),
                               np.diag(TD._const_diag(n).reshape(-1)), atol=1e-12)


def test_galerkin_coarsening_is_exact():
    """P^T A P: the coarse operator of the summed interface
    transmissibilities equals restrict(A_fine(prolong v)) to 1e-12."""
    faces = _faces(TD, torch.tensor(_K(3, 8, seed=4, sigma=2.0)))
    coarse = TD._galerkin_coarsen(*faces)
    v = torch.tensor(np.random.default_rng(1).normal(size=(3, 4, 4, 4)))
    vp = v.repeat_interleave(2, 1).repeat_interleave(2, 2).repeat_interleave(2, 3)
    lhs = TD._stencil_matvec(vp, *faces).reshape(3, 4, 2, 4, 2, 4, 2).sum((2, 4, 6))
    rhs = TD._stencil_matvec(v, *coarse)
    assert float((lhs - rhs).abs().max()) < 1e-12


def _jax_preconditioner(precond, n):
    """mlmc_tpu's preconditioner as one jitted function of (r, K) for
    [n, n, n] grids."""
    import jax
    import jax.numpy as jnp

    JD = _JD()

    def M(r, K):
        faces = _faces(JD, K)
        if precond == "mg":
            return JD._mg_vcycle_preconditioner(*faces, n)(r.reshape(-1)).reshape(n, n, n)
        diag = JD._stencil_diag(*faces, n)
        if precond == "jacobi":
            return r / diag
        Sx, Cn, lam = JD._spectral_basis(n)
        w = jnp.sqrt(JD._const_diag(n) / diag)

        def transform(r, U0, U1, U2):
            r = jnp.einsum("ab,bjk->ajk", U0, r)
            r = jnp.einsum("ab,ibk->iak", U1, r)
            return jnp.einsum("ab,ijb->ija", U2, r)

        return w * transform(transform(w * r, Sx, Cn, Cn) / lam, Sx.T, Cn.T, Cn.T)

    return jax.jit(M)


@pytest.mark.parametrize("precond", ["spectral", "jacobi", "mg"])
def test_preconditioners_match_mlmc_tpu(precond):
    K = _K(2, 8, seed=6, sigma=1.5)
    r = np.random.default_rng(9).normal(size=(2, 8, 8, 8))
    tK = torch.tensor(K)
    faces = _faces(TD, tK)
    M = TD._preconditioner(dict(precond=precond), *faces,
                           TD._stencil_diag(*faces, 8), 8)
    got = M(torch.tensor(r)).numpy()
    j_M = _jax_preconditioner(precond, 8)
    for b in range(2):
        want = np.asarray(j_M(r[b], K[b]))
        np.testing.assert_allclose(got[b], want, rtol=1e-12, atol=1e-12)


def _reference_pcg(config, K):
    """A per-sample preconditioned CG in numpy with the stopping rule of
    jax.scipy.sparse.linalg.cg (x0 = 0, stop when |r|^2 <= tol^2 |b|^2 or
    at maxiter), over the stencil and preconditioner of one sample (held
    against mlmc_tpu's to 1e-12 above). :return: (pressure, iterations)"""
    n = K.shape[-1]
    faces = _faces(TD, torch.tensor(K)[None])
    M = TD._preconditioner(config, *faces, TD._stencil_diag(*faces, n), n)
    A = lambda p: TD._stencil_matvec(torch.tensor(p)[None], *faces)[0].numpy()
    Mn = lambda r: M(torch.tensor(r)[None])[0].numpy()
    factor = TD.CG_MAXITER_FACTOR_MG if config["precond"] == "mg" else TD.CG_MAXITER_FACTOR
    b = np.zeros((n, n, n))
    b[0] = faces[3][0].numpy()
    atol2 = config["cg_tol"] ** 2 * np.sum(b * b)
    x, r = np.zeros_like(b), b.copy()
    z = Mn(r)
    p, gamma, k = z, np.sum(r * z), 0
    while np.sum(r * r) > atol2 and k < factor * n:
        Ap = A(p)
        alpha = gamma / np.sum(p * Ap)
        x, r = x + alpha * p, r - alpha * Ap
        z = Mn(r)
        gamma_new = np.sum(r * z)
        p, gamma, k = z + (gamma_new / gamma) * p, gamma_new, k + 1
    return x, k


@pytest.mark.parametrize("precond", ["spectral", "jacobi", "mg"])
def test_solve_pressure_matches_mlmc_tpu(precond):
    import jax
    import jax.numpy as jnp

    JD = _JD()
    K = _K(2, 8, seed=8)
    config = dict(precond=precond, cg_tol=1e-12, dtype="float64")
    got, iters = TD._solve_pressure(config, torch.tensor(K))
    assert got.shape == (2, 8, 8, 8) and iters.shape == (2,)
    j_solve = jax.jit(lambda k: JD._solve_pressure(config, k))
    for b in range(2):
        want = np.asarray(j_solve(jnp.asarray(K[b])))
        np.testing.assert_allclose(got[b].numpy(), want, rtol=1e-8, atol=1e-10)
        ref, k = _reference_pcg(config, K[b])
        np.testing.assert_allclose(ref, want, rtol=1e-8, atol=1e-10)
        assert abs(int(iters[b]) - k) <= 1, (b, int(iters[b]), k)


@pytest.mark.parametrize("precond", ["spectral", "mg"])
def test_batch_equals_samples_solved_one_by_one(precond, monkeypatch):
    """Samples that converge at different iterations: each is frozen by the
    active mask (the CG loop the 2-D simulation uses) when it is done, so
    the batch equals the samples solved alone, whatever the host's check
    interval."""
    K = _K(4, 8, seed=7, sigma=1.5)
    K[0] = 2.0                      # homogeneous
    K = torch.tensor(K)
    base = dict(precond=precond, cg_tol=1e-10, dtype="float64")
    monkeypatch.setattr(diffusion, "CG_CHECK_EVERY", 1)
    p, iters = TD._solve_pressure(base, K)
    assert len(set(iters.tolist())) > 1
    if precond == "spectral":
        assert int(iters[0]) == 1   # exact for constant K
    for every in (3, 1000):
        monkeypatch.setattr(diffusion, "CG_CHECK_EVERY", every)
        p2, it2 = TD._solve_pressure(base, K)
        assert torch.equal(p2, p) and torch.equal(it2, iters)
    monkeypatch.undo()
    for b in range(4):
        alone, it1 = TD._solve_pressure(base, K[b:b + 1])
        assert int(it1[0]) == int(iters[b])
        np.testing.assert_allclose(alone[0].numpy(), p[b].numpy(), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("precond", ["spectral", "mg"])
def test_homogeneous_limit(precond):
    """K = k0 gives flux k0 (linear pressure); sigma = 0 gives 1."""
    for k0 in (1.0, 2.5):
        K = torch.full((2, 8, 8, 8), k0, dtype=torch.float64)
        p, _ = TD._solve_pressure(dict(cg_tol=1e-12, precond=precond), K)
        np.testing.assert_allclose(TD._flux(K, p).numpy(), k0, rtol=1e-10)
    level = TD(dict(sigma=0.0, precond=precond, n_modes=16)).level_instance([1 / 8], [0])
    fine, coarse = TD.calculate(level.config_dict, seed=7, device="cpu")
    assert abs(float(fine[0]) - 1.0) < 1e-6 and coarse[0] == 0.0


@pytest.mark.parametrize("precond", ["spectral", "mg"])
def test_flux_from_the_same_phases(precond):
    """Fine and coarse flux of mlmc_tpu's ``_calculate_one(config, None,
    phases)``; the conductivity of the phases its key draws."""
    import jax
    import jax.numpy as jnp

    JD = _JD()
    jcfg = JD(dict(sigma=1.0, corr_length=0.3, n_modes=32, precond=precond,
                   cg_tol=1e-12)).level_instance([1 / 8], [1 / 4]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    phases = np.random.default_rng(5).uniform(0, 2 * np.pi, size=(2, 32))
    fine, coarse, it_f, it_c = TD._calculate(tcfg, phases=torch.tensor(phases))
    assert fine.shape == coarse.shape == (2, 1) and it_f.shape == (2,)
    j_one = jax.jit(lambda ph: JD._calculate_one(jcfg, None, phases=ph))
    for b in range(2):
        f, c = j_one(jnp.asarray(phases[b]))
        np.testing.assert_allclose(float(fine[b, 0]), float(f[0]), rtol=1e-8)
        np.testing.assert_allclose(float(coarse[b, 0]), float(c[0]), rtol=1e-8)
    key = jax.random.key(11)
    drawn = jax.random.uniform(key, (32,), maxval=2 * np.pi)
    for n in (8, 4):
        K = TD._conductivity(tcfg, n, phases=torch.tensor(np.asarray(drawn))[None])[0]
        np.testing.assert_allclose(K.numpy(), np.asarray(JD._conductivity(jcfg, key, n)),
                                   rtol=1e-10)


def test_wave_vectors_and_level_config():
    sim = TD(dict(corr_length=0.3, n_modes=64, seed=3))
    cfg = sim.level_instance([1 / 8], [1 / 4]).config_dict
    assert cfg["fine_n"] == 8 and cfg["coarse_n"] == 4
    assert cfg["_wave_vectors"].shape == (64, 3)
    again = sim.level_instance([1 / 16], [1 / 8]).config_dict
    assert torch.equal(cfg["_wave_vectors"], again["_wave_vectors"])
    other = TD(dict(corr_length=0.3, n_modes=64, seed=4)).level_instance([1 / 8], [0])
    assert not torch.equal(cfg["_wave_vectors"], other.config_dict["_wave_vectors"])
    exp = TD(dict(model="exp", n_modes=64)).level_instance([1 / 8], [0]).config_dict
    assert exp["_wave_vectors"].shape == (64, 3)
    assert sim.n_ops_estimate(1 / 8) == pytest.approx(512 * np.log(8))
    assert _JD()(dict()).n_ops_estimate(1 / 8) == pytest.approx(sim.n_ops_estimate(1 / 8))
    with pytest.raises(ValueError, match="phases"):
        TD._conductivity(cfg, 4)
    with pytest.raises(ValueError, match="unknown precond"):
        K = torch.ones(1, 4, 4, 4, dtype=torch.float64)
        TD._solve_pressure(dict(precond="ilu"), K)


def test_keyed_batch_is_a_function_of_the_sample_identity():
    cfg = TD(dict(sigma=1.0, corr_length=0.3, n_modes=16, dtype="float64")
             ).level_instance([1 / 8], [1 / 4]).config_dict
    idx = torch.arange(6, dtype=torch.int64)
    att = torch.zeros(6, dtype=torch.int64)
    fine, coarse, failed = TD.calculate_keyed_batch(cfg, 23, 1, idx, att)
    assert fine.shape == coarse.shape == (6, 1) and not failed.any()
    parts = [TD.calculate_keyed_batch(cfg, 23, 1, idx[a:b], att[a:b])
             for a, b in ((0, 4), (4, 6))]
    np.testing.assert_allclose(torch.cat([p[0] for p in parts]).numpy(),
                               fine.numpy(), rtol=1e-12)
    np.testing.assert_allclose(torch.cat([p[1] for p in parts]).numpy(),
                               coarse.numpy(), rtol=1e-12)
    renewed = TD.calculate_keyed_batch(cfg, 23, 1, idx, att + 1)[0]
    assert not np.allclose(renewed.numpy(), fine.numpy())


def test_generator_batch_coupling_and_effective_conductivity():
    """f32 batches from a generator: replayable, fine and coarse share the
    realization (the correction varies far less than the flux), and the
    mean flux lies inside the Wiener bounds near Matheron's exp(1/6)."""
    cfg = TD(dict(sigma=1.0, corr_length=0.3, n_modes=64)
             ).level_instance([1 / 8], [1 / 4]).config_dict
    fine, coarse, failed = TD.calculate_batch(cfg, torch.Generator().manual_seed(0), 48)
    assert fine.dtype == torch.float32 and fine.device.type == "cpu"
    assert torch.isfinite(fine).all() and not failed.any()
    again = TD.calculate_batch(cfg, torch.Generator().manual_seed(0), 48, device="cpu")
    assert torch.equal(again[0], fine)
    f = fine[:, 0].double().numpy()
    d = f - coarse[:, 0].double().numpy()
    assert d.var() < 0.1 * f.var()
    assert np.exp(-0.5) < f.mean() < np.exp(0.5)
    assert abs(f.mean() - np.exp(1 / 6)) < max(5 * f.std() / np.sqrt(48), 0.12)


def test_darcy3d_slice_matches_mlmc_tpu_estimate():
    """A 2-level 8^3 / 4^3 run through Sampler -> DeviceBatchPool ->
    DeviceMemory -> Estimate; mlmc_tpu estimates the same samples: f64
    tier 1e-10; then the fast tier's level variances and the rates."""
    import mlmc_tpu as jm
    import mlmc_tpu.estimator as jest
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root
    import mlmc_tpu_torch.quantity.quantity_estimate as tqe

    sim = TD(dict(sigma=1.0, corr_length=0.3, n_modes=64))
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=11, device_results=True, min_bucket=32,
                              max_batch=128, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, [[1 / 4], [1 / 8]])
    sampler.set_initial_n_samples([96, 24])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    assert storage.get_n_collected() == [96, 24]
    q = mt.make_root_quantity(storage, sim.result_format())["flux"][0]["outflow"][0]
    mfn = mt.Legendre(6, (0.05, 6.0))
    est = mt.Estimate(q, storage, mfn)

    jstorage = jm.Memory()
    jstorage.save_global_data(
        result_format=[jm.QuantitySpec(name=s.name, unit=s.unit, shape=s.shape,
                                       times=s.times, locations=s.locations)
                       for s in sim.result_format()],
        level_parameters=storage.get_level_parameters())
    for lid, p in enumerate(storage.sample_pairs()):
        p = p.numpy().astype(np.float64)
        ids = ["L{:02d}_S{:07d}".format(lid, i) for i in range(p.shape[1])]
        jstorage.save_scheduled_samples(lid, ids)
        coarse = p[:, :, 1].T if p.shape[2] > 1 else np.zeros_like(p[:, :, 0].T)
        jstorage.save_samples_bulk(lid, ids, p[:, :, 0].T, coarse)
    jq = j_root(jstorage, jstorage.load_result_format())["flux"][0]["outflow"][0]
    j_mean, j_var = jest.Estimate(jq, jstorage, jm.Legendre(6, (0.05, 6.0))).estimate_moments()
    ext_mean, ext_var = est.estimate_moments_extended()
    np.testing.assert_allclose(ext_mean, j_mean, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(ext_var, j_var, rtol=1e-9, atol=1e-14)
    assert ext_mean[0] == 1.0
    raw, ns = est.estimate_diff_vars_fast()
    assert list(ns) == [96, 24] and raw[1, 1] < raw[0, 1]   # the coupling
    m = tqe.estimate_mean(q)
    assert 0.7 < float(np.ravel(m.mean)[0]) < 2.0


def _darcy3d_streams(device):
    """The packed fine/coarse flux streams of a 3-level 3-D Darcy run
    (8^3 / 16^3 / 32^3 at 256, 64, 16 samples) and the run's basis."""
    sim = TD(dict(sigma=1.0, corr_length=0.3))
    storage = mt.DeviceMemory(device=device)
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(seed=11, device_results=True,
                                                     device=device),
                         sim, [[1 / 8], [1 / 16], [1 / 32]])
    sampler.set_initial_n_samples([256, 64, 16])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    q = mt.make_root_quantity(storage, sim.result_format())["flux"][0]["outflow"][0]
    mfn = mt.Legendre(10, (0.05, 6.0))
    return mt.Estimate(q, storage, mfn)._packed_streams(mfn, [0]), mfn


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["C", "D"])
def test_cuda_kernels_at_the_3d_flux_streams(cuda_device, kernel):
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops import precision

    streams, mfn = _darcy3d_streams(cuda_device)
    if kernel == "C":
        launch, plain_fn, consts = (ck.samples_mlmc_cuda, ck.samples_mlmc_plain,
                                    ck.transform_constants(mfn.domain))
    else:
        launch, plain_fn, consts = (cx.samples_ext_cuda, cx.samples_ext_plain,
                                    ck.transform_constants(mfn.domain, f64=True))
    before = launch.launches
    got = launch(streams, mfn.size, basis="legendre", consts=consts, device=cuda_device)
    assert launch.launches == before + 1
    plain, s_abs = (plain_fn(streams, mfn.size, basis="legendre", consts=consts,
                             absolute=a) for a in (False, True))
    assert torch.equal(got.n_valid.cpu(), plain.n_valid.cpu())
    assert [int(v) for v in got.n_valid] == [256, 64, 16]
    for name in ("sums", "sums2", "cov_fine", "cov_coarse"):
        err = (getattr(got, name) - getattr(plain, name)).abs().cpu().numpy()
        scale = getattr(s_abs, name).clamp(min=1.0).cpu().numpy()
        bound = 1e-12 * scale if kernel == "C" else precision.extended_error_bound(scale)
        assert np.all(err <= bound), name
