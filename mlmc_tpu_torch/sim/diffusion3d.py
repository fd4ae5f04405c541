"""3-D Darcy flow with GRF conductivity (counterpart of
``mlmc_tpu/sim/diffusion3d.py``).

* unit cube, n^3 regular cells (n = 1/step),
* log-normal conductivity ``K = exp(sigma * G)`` with G a 3-D random
  Fourier feature field at the cell centers; the fine and coarse grids of
  a sample share the modes and the phases (the level coupling),
* pressure solve ``-div(K grad p) = 0``, p=1 at x=0, p=0 at x=1, no-flux
  elsewhere: 7-point finite volumes with harmonic face conductivities,
  solved by preconditioned CG (``diffusion.preconditioned_cg``, the loop
  the 2-D simulation uses). The default preconditioner is the diagonally
  scaled spectral inverse: the unit-K operator separates into three 1-D
  tridiagonals whose eigenbases are DST-II (x, Dirichlet half-cell) and
  DCT-II (y, z, Neumann), applied as three [n, n] matmuls per iteration;
  ``precond="mg"`` takes the geometric multigrid V-cycle,
* QoI = total outflow through the x=1 face = the medium's effective
  conductivity (homogeneous K = k0 gives exactly k0).

Every function takes a batch: axis 0 is the sample, axes 1, 2, 3 are x, y,
z. Values are float32 unless the config says ``dtype="float64"``. The
``phases=`` argument of ``_conductivity`` / ``_calculate`` is the entry
point of phase-driven (quasi-Monte Carlo) sampling.
"""
import copy
from typing import List

import numpy as np
import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.sim.diffusion import (DarcyBatchEntryPoints,
                                          preconditioned_cg)
from mlmc_tpu_torch.sim.simulation import Simulation, level_cached


def _wave_vectors_3d(model, corr_length, mode_no, seed=0):
    """3-D spectral-measure wave vectors [M, 3] (float64, host), drawn from
    a generator seeded by ``seed`` (gauss: N(0, 2/L^2 I); exp: the
    multivariate Student-t(1) as a chi-square mixture)."""
    gen = torch.Generator().manual_seed(int(seed))
    y = torch.randn((mode_no, 3), generator=gen, dtype=torch.float64)
    if model == "exp":
        w = torch.randn((mode_no, 1), generator=gen, dtype=torch.float64) ** 2
        return y / torch.sqrt(w) / corr_length
    return y * (np.sqrt(2.0) / corr_length)


class DiffusionSimulation3D(DarcyBatchEntryPoints, Simulation):
    """3-D Darcy flow with random log-normal conductivity."""

    N_MODES = 256
    CG_TOL = 1e-6
    CG_MAXITER_FACTOR = 10
    # default preconditioner; subclasses with rough media override
    PRECOND = "spectral"
    CG_MAXITER_FACTOR_MG = 4

    def __init__(self, config=None):
        """:param config: dict with keys sigma (log-field std, default 1),
        corr_length (default 0.3), model ('gauss'|'exp'), n_modes, seed (of
        the wave vectors), precond ('spectral'|'jacobi'|'mg'), cg_tol,
        cg_maxiter_factor, dtype ('float32'|'float64')."""
        super().__init__()
        self._config = dict(config or {})
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        fine_step = float(fine_level_params[0])
        coarse_step = float(coarse_level_params[0])
        config["fine_n"] = max(int(round(1.0 / fine_step)), 2)
        config["coarse_n"] = (max(int(round(1.0 / coarse_step)), 2)
                              if coarse_step > 0 else 0)
        config["res_format"] = self.result_format()
        config["_wave_vectors"] = _wave_vectors_3d(
            config.get("model", "gauss"), config.get("corr_length", 0.3),
            config.get("n_modes", self.N_MODES), seed=config.get("seed", 0))
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(fine_step))

    # ------------------------------------------------------------------ #
    # conductivity
    # ------------------------------------------------------------------ #
    @classmethod
    def _conductivity(cls, config, n, phases=None):
        """K = exp(sigma * G) at the n^3 cell centers for a batch of RFF
        phases [B, M]: [B, n, n, n]. The same phases give the same
        realization on every grid (the level coupling)."""
        if phases is None:
            raise ValueError("the 3-D conductivity is a function of the mode "
                             "phases [B, M]")
        sigma = config.get("sigma", 1.0)
        device, dtype = phases.device, phases.dtype

        def mode_trig():
            k_vec = torch.as_tensor(config["_wave_vectors"]).to(device, dtype)
            c = (torch.arange(n, device=device, dtype=dtype) + 0.5) * (1.0 / n)
            X, Y, Z = torch.meshgrid(c, c, c, indexing="ij")
            pts = torch.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)], dim=1)
            proj = pts @ k_vec.T
            return torch.cos(proj), torch.sin(proj)          # [n^3, M]

        # cos(x.k + phi) = cos(x.k) cos(phi) - sin(x.k) sin(phi): the
        # [n^3, M] mode matrices are sample-independent
        C, S = level_cached(config, ("rff3", n, device, dtype), mode_trig)
        g = np.sqrt(2.0 / C.shape[1]) * (torch.cos(phases) @ C.T
                                         - torch.sin(phases) @ S.T)
        return torch.exp(sigma * g).reshape(-1, n, n, n)

    # ------------------------------------------------------------------ #
    # constant-coefficient operator: the spectral preconditioner's pieces
    # ------------------------------------------------------------------ #
    @staticmethod
    def _spectral_basis(n):
        """Eigen-bases of the unit-K 7-point operator: DST-II along the
        Dirichlet x axis, DCT-II along the Neumann y/z axes, and the
        separable eigenvalue tensor lam[i, j, k] (float64 numpy, cast at
        use site)."""
        j = np.arange(n)
        k = np.arange(1, n + 1)
        Sx = np.sin((j[None, :] + 0.5) * k[:, None] * np.pi / n)
        Sx *= np.where(k[:, None] == n, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
        lx = 4.0 * np.sin(k * np.pi / (2 * n)) ** 2
        ll = np.arange(n)
        Cn = np.cos((j[None, :] + 0.5) * ll[:, None] * np.pi / n)
        Cn *= np.where(ll[:, None] == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
        ln = 4.0 * np.sin(ll * np.pi / (2 * n)) ** 2
        lam = lx[:, None, None] + ln[None, :, None] + ln[None, None, :]
        return Sx, Cn, lam

    @staticmethod
    def _const_diag(n):
        """Diagonal of the unit-K constant-coefficient 7-point operator
        (x: Dirichlet half-cell, interior 2 / boundary 3; y, z: Neumann,
        interior 2 / boundary 1)."""
        dx = np.full(n, 2.0)
        dx[0] += 1.0
        dx[-1] += 1.0
        dn = np.full(n, 2.0)
        dn[0] -= 1.0
        dn[-1] -= 1.0
        return dx[:, None, None] + dn[None, :, None] + dn[None, None, :]

    # ------------------------------------------------------------------ #
    # stencil operator pieces; every array may carry leading batch
    # dimensions, the last three are x, y, z
    # ------------------------------------------------------------------ #
    @staticmethod
    def _face_conductivities(K):
        """Harmonic averages on the three interior face families:
        K [..., n, n, n] -> Kx [..., n-1, n, n], Ky [..., n, n-1, n],
        Kz [..., n, n, n-1]."""
        a, b = K[..., :-1, :, :], K[..., 1:, :, :]
        Kx = 2.0 * a * b / (a + b)
        a, b = K[..., :, :-1, :], K[..., :, 1:, :]
        Ky = 2.0 * a * b / (a + b)
        a, b = K[..., :-1], K[..., 1:]
        Kz = 2.0 * a * b / (a + b)
        return Kx, Ky, Kz

    @staticmethod
    def _stencil_matvec(p, Kx, Ky, Kz, Kin, Kout):
        """A @ p for the 7-point FV operator, p [..., n, n, n]; the
        Dirichlet x faces enter through the half-cell transmissibilities
        Kin, Kout [..., n, n]. Leading dimensions broadcast."""
        fx = Kx * (p[..., 1:, :, :] - p[..., :-1, :, :])
        fy = Ky * (p[..., :, 1:, :] - p[..., :, :-1, :])
        fz = Kz * (p[..., 1:] - p[..., :-1])
        div = fx.new_zeros(fx.shape[:-3] + (fx.shape[-3] + 1,) + fx.shape[-2:])
        div[..., :-1, :, :] += fx
        div[..., 1:, :, :] -= fx
        div[..., :, :-1, :] += fy
        div[..., :, 1:, :] -= fy
        div[..., :-1] += fz
        div[..., 1:] -= fz
        div[..., 0, :, :] -= Kin * p[..., 0, :, :]
        div[..., -1, :, :] -= Kout * p[..., -1, :, :]
        return -div

    @staticmethod
    def _stencil_diag(Kx, Ky, Kz, Kin, Kout, n):
        diag = Kx.new_zeros(Kx.shape[:-3] + (n, n, n))
        diag[..., :-1, :, :] += Kx
        diag[..., 1:, :, :] += Kx
        diag[..., :, :-1, :] += Ky
        diag[..., :, 1:, :] += Ky
        diag[..., :-1] += Kz
        diag[..., 1:] += Kz
        diag[..., 0, :, :] += Kin
        diag[..., -1, :, :] += Kout
        return diag

    @staticmethod
    def _galerkin_coarsen(Kx, Ky, Kz, Kin, Kout):
        """Exact Galerkin (P^T A P) coarsening under 2x2x2 aggregation with
        piecewise-constant prolongation: the coarse operator is again a
        7-point FV operator whose face transmissibilities are the SUMS of
        the fine faces crossing each aggregate interface (internal faces
        cancel; the graph-Laplacian identity of the 2-D version)."""
        lead = Kin.shape[:-2]
        nc = Kin.shape[-1] // 2
        # the coarse interface I|I+1 collects the fine plane 2I+1's 2x2
        # footprint
        Kx_c = Kx[..., 1::2, :, :].reshape(lead + (nc - 1, nc, 2, nc, 2)).sum((-3, -1))
        Ky_c = Ky[..., :, 1::2, :].reshape(lead + (nc, 2, nc - 1, nc, 2)).sum((-4, -1))
        Kz_c = Kz[..., 1::2].reshape(lead + (nc, 2, nc, 2, nc - 1)).sum((-4, -2))
        Kin_c = Kin.reshape(lead + (nc, 2, nc, 2)).sum((-3, -1))
        Kout_c = Kout.reshape(lead + (nc, 2, nc, 2)).sum((-3, -1))
        return Kx_c, Ky_c, Kz_c, Kin_c, Kout_c

    @classmethod
    def _mg_vcycle_preconditioner(cls, Kx, Ky, Kz, Kin, Kout, n,
                                  nu=2, omega=0.8, coarsest=4):
        """Geometric multigrid V-cycle as a linear SPD preconditioner on a
        batch ``r [B, n, n, n]`` (damped-Jacobi smoothing, 2x2x2
        piecewise-constant aggregation): the 3-D twin of
        ``DiffusionSimulation._mg_vcycle_preconditioner``. The coarsest
        grid's [c^3, c^3] matrix of each sample assembles by the matvec on
        identity columns and is inverted once, in one batched
        ``torch.linalg.inv``."""
        levels = []
        while n > coarsest and n % 2 == 0:
            diag = cls._stencil_diag(Kx, Ky, Kz, Kin, Kout, n)
            levels.append((Kx, Ky, Kz, Kin, Kout, diag, n))
            Kx, Ky, Kz, Kin, Kout = cls._galerkin_coarsen(Kx, Ky, Kz, Kin, Kout)
            n = n // 2
        c_n, c3 = n, n ** 3
        eye = torch.eye(c3, dtype=Kx.dtype, device=Kx.device).reshape(1, c3, n, n, n)
        # column j of A_c is A @ e_j; A_c is symmetric
        A_c = cls._stencil_matvec(eye, Kx[:, None], Ky[:, None], Kz[:, None],
                                  Kin[:, None], Kout[:, None]).reshape(-1, c3, c3)
        A_c_inv = torch.linalg.inv(A_c.transpose(1, 2))

        def vcycle(r, lvl):
            if lvl == len(levels):
                return torch.matmul(A_c_inv, r.reshape(-1, c3, 1)
                                    ).reshape(-1, c_n, c_n, c_n)
            Kx_l, Ky_l, Kz_l, Ki_l, Ko_l, diag, n_l = levels[lvl]
            mv = lambda p: cls._stencil_matvec(p, Kx_l, Ky_l, Kz_l, Ki_l, Ko_l)
            x = (omega / diag) * r
            for _ in range(nu - 1):
                x = x + (omega / diag) * (r - mv(x))
            res = r - mv(x)
            h = n_l // 2
            r_c = res.reshape(-1, h, 2, h, 2, h, 2).sum(dim=(2, 4, 6))
            e_c = vcycle(r_c, lvl + 1)
            x = x + (e_c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
                     .repeat_interleave(2, dim=3))
            for _ in range(nu):
                x = x + (omega / diag) * (r - mv(x))
            return x

        return lambda r: vcycle(r, 0)

    # ------------------------------------------------------------------ #
    # the solve
    # ------------------------------------------------------------------ #
    @classmethod
    def _spectral_consts(cls, config, n, device, dtype):
        """(Sx, Cn, lam, const diag) of an n^3 grid as tensors, built once
        per (level, grid, device, dtype)."""
        def build():
            pieces = cls._spectral_basis(n) + (cls._const_diag(n),)
            return tuple(torch.as_tensor(a).to(device, dtype) for a in pieces)

        return level_cached(config, ("spectral3", n, device, dtype), build)

    @classmethod
    def _preconditioner(cls, config, Kx, Ky, Kz, Kin, Kout, diag, n):
        """M(r) on a batch [B, n, n, n] for the config's ``precond``."""
        precond = config.get("precond", cls.PRECOND)
        if precond == "mg":
            return cls._mg_vcycle_preconditioner(
                Kx, Ky, Kz, Kin, Kout, n,
                nu=config.get("mg_nu", 2),
                omega=config.get("mg_omega", 0.8),
                coarsest=config.get("mg_coarsest", 4))
        if precond == "spectral":
            # M = W C_1^{-1} W with W = diag(sqrt(diag_C / diag_A)): the
            # exact inverse of the unit-K operator scaled by the field's
            # local contrast (see DiffusionSimulation._preconditioner)
            Sx, Cn, lam, cdiag = cls._spectral_consts(config, n, diag.device,
                                                      diag.dtype)
            w = torch.sqrt(cdiag / diag)

            def transform(r, U0, U1, U2):
                # U0 along x, U1 along y, U2 along z, as matmuls
                r = (U0 @ r.reshape(-1, n, n * n)).reshape(-1, n, n, n)
                r = U1 @ r
                return r @ U2.T

            def M(r):
                r_hat = transform(w * r, Sx, Cn, Cn)
                return w * transform(r_hat / lam, Sx.T, Cn.T, Cn.T)

            return M
        if precond == "jacobi":
            return lambda r: r / diag
        raise ValueError("unknown precond %r" % (precond,))

    @classmethod
    def _solve_pressure(cls, config, K):
        """Preconditioned CG solve of the 7-point system for a batch of
        conductivities ``K [B, n, n, n]`` (see the module doc): each sample
        stops on its own when ``|r|^2 <= tol^2 |b|^2`` or at
        ``maxiter = factor * n``.

        :return: (pressures [B, n, n, n], iterations per sample [B])
        """
        n = K.shape[-1]
        Kx, Ky, Kz = cls._face_conductivities(K)
        Kin = 2.0 * K[..., 0, :, :]       # [B, n, n] half-cell faces at x=0
        Kout = 2.0 * K[..., -1, :, :]     # at x=1

        def matvec(p):
            return cls._stencil_matvec(p, Kx, Ky, Kz, Kin, Kout)

        b = torch.zeros_like(K)
        b[..., 0, :, :] += Kin            # p=1 on the x=0 face
        diag = cls._stencil_diag(Kx, Ky, Kz, Kin, Kout, n)
        M = cls._preconditioner(config, Kx, Ky, Kz, Kin, Kout, diag, n)
        precond = config.get("precond", cls.PRECOND)
        default_factor = (cls.CG_MAXITER_FACTOR_MG if precond == "mg"
                          else cls.CG_MAXITER_FACTOR)
        maxiter = int(config.get("cg_maxiter_factor", default_factor) * n)
        return preconditioned_cg(matvec, M, b, config.get("cg_tol", cls.CG_TOL),
                                 maxiter)

    @staticmethod
    def _flux(K, p):
        """Outflow through x=1: the boundary half-face transmissibility is
        2 K h^2 / (h/2) = 2 K h per face, so flux = (1/n) sum 2 K p,
        exactly k0 for homogeneous K = k0 (linear pressure)."""
        n = K.shape[-1]
        return (2.0 * K[..., -1, :, :] * p[..., -1, :, :]).sum(dim=(-2, -1)) / n

    @classmethod
    def _sample_flux(cls, config, n, phases=None, **extra):
        """The flux of a batch on the n^3 grid and its CG iterations."""
        K = cls._conductivity(config, n, phases=phases, **extra)
        p, iters = cls._solve_pressure(config, K)
        return cls._flux(K, p), iters

    @classmethod
    def _calculate(cls, config, phases=None, **extra):
        """A batch from its draws (``phases`` [B, M]; ``extra``: further
        draws a subclass's ``_conductivity`` takes).

        :return: (fine [B, 1], coarse [B, 1], CG iterations of the fine
            solves [B], of the coarse solves [B] or None)
        """
        fine, it_fine = cls._sample_flux(config, config["fine_n"],
                                         phases=phases, **extra)
        if config["coarse_n"] > 0:
            coarse, it_coarse = cls._sample_flux(config, config["coarse_n"],
                                                 phases=phases, **extra)
        else:
            coarse, it_coarse = torch.zeros_like(fine), None
        return fine[:, None], coarse[:, None], it_fine, it_coarse

    @classmethod
    def _draws_shape(cls, config):
        """One sample draws its mode phases: ('phases', (M,))."""
        return "phases", (len(config["_wave_vectors"]),)

    def n_ops_estimate(self, step):
        n = 1.0 / step
        return n ** 3 * np.log(max(n, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="flux", unit="m^3/s", shape=(1,),
                             times=[0], locations=["outflow"])]
