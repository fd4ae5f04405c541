"""Solute transport on the Darcy velocity field (counterpart of
``mlmc_tpu/sim/transport.py``; the reference's ``02_conc`` workflow as
tensor code).

A sample is a log-normal conductivity field (``DiffusionSimulation``'s
draws), the pressure solve of ``DiffusionSimulation`` (the batched CG),
the face fluxes, explicit finite-volume transport of a unit concentration
released in a source box, and the breakthrough curve: the outflux rate at
the right edge and the concentrations at ``observe_points``, interpolated
at ``obs_times``. Fine and coarse grids share the conductivity realization.

Schemes: ``"upwind"`` (first-order donor cell) and ``"muscl"``
(minmod-limited reconstruction with SSP-RK2 steps). The step count is
static per level (``steps_per_cell * n``); the step size is per sample,
``dt = min(cfl-stable dt, t_end / n_steps)`` (a ``[B]`` tensor), and a
sample whose stable step cannot cover ``t_end`` in the budget fails (NaN
results, a failed sample).

Departures from ``mlmc_tpu`` (same results to rounding): the upwind step
is written as the linear five-point update it is, ``c' = K_c c + K_w c_w
+ K_e c_e + K_s c_s + K_n c_n`` with per-sample coefficients built once
from the face fluxes (a few launches per step; ``mlmc_tpu`` rebuilds the
face values every step, which is one XLA program there); the
interpolation of ``jnp.interp`` is written with ``searchsorted``.
"""
from typing import List

import numpy as np
import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation

__all__ = ["TransportSimulation"]


def _interp(x, xp, fp):
    """``jnp.interp(x, xp, fp)`` row by row: x [T], xp and fp [B, S] with
    xp sorted; constant beyond the ends."""
    B, S = xp.shape
    xq = x.expand(B, -1).contiguous()
    i = torch.searchsorted(xp.contiguous(), xq, right=True).clamp(1, S - 1)
    x0, x1 = xp.gather(1, i - 1), xp.gather(1, i)
    f0, f1 = fp.gather(1, i - 1), fp.gather(1, i)
    dx = x1 - x0
    eps = float(np.spacing(np.finfo(np.float32 if xp.dtype == torch.float32
                                    else np.float64).eps))
    small = dx.abs() <= eps
    f = torch.where(small, f0, f0 + ((xq - x0) / torch.where(small, torch.ones_like(dx), dx))
                    * (f1 - f0))
    f = torch.where(xq < xp[:, :1], fp[:, :1], f)
    return torch.where(xq > xp[:, -1:], fp[:, -1:], f)


def _minmod(a, b):
    return torch.where(a * b > 0, torch.where(a.abs() < b.abs(), a, b),
                       torch.zeros_like(a))


class TransportSimulation(DiffusionSimulation):
    """Darcy flow + finite-volume solute transport, breakthrough-curve QoI.

    Config keys on top of ``DiffusionSimulation``'s: ``porosity`` (0.1),
    ``diffusion`` (isotropic face coefficient D, 0), ``obs_times`` (8
    points in [0.05, 0.4]), ``source_box`` ((x0, x1, y0, y1)),
    ``observe_points`` (4 points on the centerline), ``scheme``
    ('upwind' | 'muscl'), ``cfl`` (0.5), ``steps_per_cell`` (96).
    """

    PHI = 0.1
    CFL = 0.5
    STEPS_PER_CELL = 96
    SOURCE_BOX = (0.125, 0.375, 0.375, 0.625)
    OBS_TIMES = tuple(float(t) for t in np.linspace(0.05, 0.4, 8))
    OBSERVE_POINTS = ((0.45, 0.5), (0.6, 0.5), (0.75, 0.5), (0.9, 0.5))

    def __init__(self, config=None):
        super().__init__(config)
        self._config.setdefault("obs_times", self.OBS_TIMES)
        self._config.setdefault("observe_points", self.OBSERVE_POINTS)

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        level_sim = super().level_instance(fine_level_params, coarse_level_params)
        config = level_sim.config_dict
        config["res_format"] = self.result_format()
        factor = int(config.get("steps_per_cell", self.STEPS_PER_CELL))
        config["_n_steps_fine"] = factor * config["fine_n"]
        config["_n_steps_coarse"] = factor * max(config["coarse_n"], 1)
        return level_sim

    # ------------------------------------------------------------------ #
    # physics
    # ------------------------------------------------------------------ #
    @classmethod
    def _face_fluxes(cls, config, K, p):
        """Volumetric face fluxes from the pressures of a batch [B, n, n]:
        Fx [B, n, n-1] (j -> j+1), Fy [B, n-1, n] (i -> i+1), the inflow
        F_in [B, n] at the left edge and the outflow F_out [B, n] at the
        right edge."""
        Kx, Ky = cls._face_conductivities(K)
        Fx = Kx * (p[:, :, :-1] - p[:, :, 1:])
        Fy = Ky * (p[:, :-1, :] - p[:, 1:, :])
        F_in = 2.0 * K[:, :, 0] * (1.0 - p[:, :, 0])
        F_out = 2.0 * K[:, :, -1] * p[:, :, -1]
        return Fx, Fy, F_in, F_out

    @classmethod
    def _initial_concentration(cls, config, n):
        """Unit concentration in the source box (rows span y, columns x),
        host float64 [n, n]."""
        box = config.get("source_box", cls.SOURCE_BOX)
        centers = (np.arange(n) + 0.5) * (1.0 / n)
        X, Y = np.meshgrid(centers, centers, indexing="ij")
        inside = ((X >= box[2]) & (X <= box[3]) & (Y >= box[0]) & (Y <= box[1]))
        return inside.astype(np.float64)

    @staticmethod
    def _stable_dt(Fx, Fy, F_in, F_out, D, vol, cfl, amp, t_end, n_steps):
        """Per-sample step: ``min(cfl * vol / s_max, t_end / n_steps)`` with
        s_max the largest sum of a cell's outgoing coefficients."""
        B, n = F_in.shape
        zr = torch.zeros((B, 1, n), dtype=Fx.dtype, device=Fx.device)
        out_x = (torch.cat([Fx.clamp(min=0), F_out.clamp(min=0)[:, :, None]], 2)
                 + torch.cat([(-F_in).clamp(min=0)[:, :, None], (-Fx).clamp(min=0)], 2))
        out_y = torch.cat([Fy.clamp(min=0), zr], 1) + torch.cat([zr, (-Fy).clamp(min=0)], 1)
        s_max = amp * (out_x + out_y).amax(dim=(1, 2)) + 4.0 * D
        return torch.clamp(cfl * vol / s_max, max=t_end / n_steps)

    @staticmethod
    def _upwind_coefficients(Fx, Fy, F_in, F_out, D, scale):
        """The upwind step as a five-point linear update: ``(K_c, K_w, K_e,
        K_s, K_n)`` [B, n, n] with ``c' = K_c c + K_w c[:, :, j-1] + K_e
        c[:, :, j+1] + K_s c[:, i-1] + K_n c[:, i+1]`` (zero beyond the
        grid), ``scale = dt / vol`` [B, 1, 1]."""
        Px, Nx = Fx.clamp(min=0), Fx.clamp(max=0)
        Py, Ny = Fy.clamp(min=0), Fy.clamp(max=0)
        B, n = F_in.shape
        zc = torch.zeros((B, n, 1), dtype=Fx.dtype, device=Fx.device)
        zr = torch.zeros((B, 1, n), dtype=Fx.dtype, device=Fx.device)
        # a face's flux Mx = (Px + D) c_left + (Nx - D) c_right leaves its
        # left cell and enters its right cell
        west = torch.cat([F_in.clamp(max=0)[:, :, None], Nx - D], 2)     # own, via west face
        east = torch.cat([-(Px + D), -F_out.clamp(min=0)[:, :, None]], 2)
        south = torch.cat([zr, Ny - D], 1)
        north = torch.cat([-(Py + D), zr], 1)
        K_c = 1.0 + scale * (west + east + south + north)
        K_w = scale * torch.cat([zc, Px + D], 2)
        K_e = scale * torch.cat([-(Nx - D), zc], 2)
        K_s = scale * torch.cat([zr, Py + D], 1)
        K_n = scale * torch.cat([-(Ny - D), zr], 1)
        return K_c, K_w, K_e, K_s, K_n

    @classmethod
    def _breakthrough(cls, config, K, n, n_steps):
        """Transport on one grid for a batch of conductivities K [B, n, n]:
        the QoI rows [B, T + P * T] (the outflux rate at ``obs_times``, then
        each observed cell's series, [time, location] order), NaN where the
        stable step cannot cover the horizon in the budget.

        :return: (qoi [B, T (1 + P)], CG iterations [B])
        """
        phi = config.get("porosity", cls.PHI)
        D = float(config.get("diffusion", 0.0))
        cfl = config.get("cfl", cls.CFL)
        scheme = config.get("scheme", "upwind")
        if scheme not in ("upwind", "muscl"):
            raise ValueError("scheme must be 'upwind' or 'muscl', got %r" % (scheme,))
        B, dtype, device = K.shape[0], K.dtype, K.device
        obs_times = torch.tensor([float(t) for t in config["obs_times"]], dtype=dtype,
                                 device=device)
        t_end = float(obs_times.max())
        h = 1.0 / n
        vol = phi * h * h

        p, iters = cls._solve_pressure(config, K)
        Fx, Fy, F_in, F_out = cls._face_fluxes(config, K, p)
        dt = cls._stable_dt(Fx, Fy, F_in, F_out, D, vol, cfl,
                            1.5 if scheme == "muscl" else 1.0, t_end, n_steps)
        scale = (dt / vol)[:, None, None]

        pts = config.get("observe_points", cls.OBSERVE_POINTS)
        cells = [min(int(pt[1] * n), n - 1) * n + min(int(pt[0] * n), n - 1) for pt in pts]
        # observed per step: the right column (for the outflux) and the points
        idx = torch.tensor([i * n + n - 1 for i in range(n)] + cells, device=device)
        P_out = F_out.clamp(min=0)

        c = torch.tensor(cls._initial_concentration(config, n)).to(device, dtype)
        c = c.expand(B, n, n).contiguous()
        obs = [c.reshape(B, -1).index_select(1, idx)]
        if scheme == "upwind":
            K_c, K_w, K_e, K_s, K_n = cls._upwind_coefficients(Fx, Fy, F_in, F_out, D, scale)
            for _ in range(n_steps):
                cp = torch.nn.functional.pad(c, (1, 1, 1, 1))
                c = K_c * c
                c.addcmul_(K_w, cp[:, 1:-1, :-2]).addcmul_(K_e, cp[:, 1:-1, 2:])
                c.addcmul_(K_s, cp[:, :-2, 1:-1]).addcmul_(K_n, cp[:, 2:, 1:-1])
                obs.append(c.reshape(B, -1).index_select(1, idx))
        else:
            rate = cls._muscl_rate(Fx, Fy, F_in, F_out, D)
            for _ in range(n_steps):
                c1 = c + scale * rate(c)
                c = 0.5 * (c + c1 + scale * rate(c1))
                obs.append(c.reshape(B, -1).index_select(1, idx))
        obs = torch.stack(obs, dim=1)                         # [B, S, n + P]
        series = (obs[:, :, :n] * P_out[:, None, :]).sum(dim=2)
        times = torch.arange(n_steps + 1, dtype=dtype, device=device)[None, :] * dt[:, None]
        q_flux = _interp(obs_times, times, series)                           # [B, T]
        parts = [q_flux]
        if len(pts):                                   # [B, T, P], time-major
            parts.append(torch.stack([_interp(obs_times, times, obs[:, :, n + k])
                                      for k in range(len(pts))], dim=2).reshape(B, -1))
        qoi = torch.cat(parts, dim=1)
        covered = dt * n_steps >= t_end * (1.0 - 1e-6)
        return torch.where(covered[:, None], qoi, torch.full_like(qoi, float("nan"))), iters

    @staticmethod
    def _muscl_rate(Fx, Fy, F_in, F_out, D):
        """The conservative mass rate into each cell of the minmod-limited
        MUSCL reconstruction (boundary cells first order)."""
        B, n = F_in.shape
        zc = torch.zeros((B, n, 1), dtype=Fx.dtype, device=Fx.device)
        zr = torch.zeros((B, 1, n), dtype=Fx.dtype, device=Fx.device)
        px, py = Fx > 0, Fy > 0
        inflow, outflow = F_in > 0, F_out > 0

        def rate(c):
            dx = c[:, :, 1:] - c[:, :, :-1]
            sx = 0.5 * _minmod(torch.cat([zc, dx], 2), torch.cat([dx, zc], 2))
            dy = c[:, 1:, :] - c[:, :-1, :]
            sy = 0.5 * _minmod(torch.cat([zr, dy], 1), torch.cat([dy, zr], 1))
            cfx = torch.where(px, c[:, :, :-1] + sx[:, :, :-1], c[:, :, 1:] - sx[:, :, 1:])
            cfy = torch.where(py, c[:, :-1, :] + sy[:, :-1, :], c[:, 1:, :] - sy[:, 1:, :])
            Mx, My = Fx * cfx, Fy * cfy
            M_in = F_in * torch.where(inflow, torch.zeros_like(F_in), c[:, :, 0])
            M_out = F_out * torch.where(outflow, c[:, :, -1], torch.zeros_like(F_out))
            if D:
                Mx = Mx + D * (c[:, :, :-1] - c[:, :, 1:])
                My = My + D * (c[:, :-1, :] - c[:, 1:, :])
            return (torch.cat([M_in[:, :, None], Mx], 2) - torch.cat([Mx, M_out[:, :, None]], 2)
                    + torch.cat([zr, My], 1) - torch.cat([My, zr], 1))

        return rate

    # ------------------------------------------------------------------ #
    # Simulation interface
    # ------------------------------------------------------------------ #
    @classmethod
    def _calculate(cls, config, noise=None, phases=None, **extra):
        """A batch from its draws: (fine [B, Q], coarse [B, Q], CG
        iterations of the fine solves [B], of the coarse solves [B] or
        None)."""
        fine_n, coarse_n = config["fine_n"], config["coarse_n"]
        K_fine = cls._conductivity(config, fine_n, noise=noise, phases=phases, **extra)
        fine, it_fine = cls._breakthrough(config, K_fine, fine_n, config["_n_steps_fine"])
        if coarse_n > 0:
            if "_circ_eig" in config:
                K_coarse = cls._coarse_from_fine_K(config, K_fine)
            else:
                K_coarse = cls._conductivity(config, coarse_n, phases=phases, **extra)
            coarse, it_coarse = cls._breakthrough(config, K_coarse, coarse_n,
                                                  config["_n_steps_coarse"])
        else:
            coarse, it_coarse = torch.zeros_like(fine), None
        return fine, coarse, it_fine, it_coarse

    @classmethod
    def _from_draws(cls, config, draws):
        fine, coarse = cls._calculate(config, **draws)[:2]
        failed = torch.isnan(fine).any(dim=1) | torch.isnan(coarse).any(dim=1)
        return fine, coarse, failed

    def n_ops_estimate(self, step):
        n = 1.0 / step
        return n * n * (np.log(max(n, 2.0)) + 0.25 * n)

    def result_format(self) -> List[QuantitySpec]:
        obs = [float(t) for t in self._config.get("obs_times", self.OBS_TIMES)]
        pts = self._config.get("observe_points", self.OBSERVE_POINTS)
        specs = [QuantitySpec(name="conc_flux", unit="kg/s", shape=(1,), times=obs,
                              locations=["outflow"])]
        if len(pts):
            specs.append(QuantitySpec(name="conc", unit="1", shape=(1,), times=obs,
                                      locations=["(%g, %g)" % (p[0], p[1]) for p in pts]))
        return specs
