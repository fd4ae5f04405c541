"""Backward SDE solver: regression-based probabilistic solution of
semilinear parabolic PDEs (counterpart of ``mlmc_tpu/bsde.py``).

The BSDE

    dX_t = mu(X_t, t) dt + sigma(X_t, t) dW_t,      X_0 = x0,
    -dY_t = f(t, X_t, Y_t, Z_t) dt - Z_t dW_t,      Y_T = g(X_T),

has ``Y_t = u(t, X_t)``, ``Z_t = sigma d_x u(t, X_t)`` for the semilinear
PDE ``u_t + mu u_x + 1/2 sigma^2 u_xx + f(t, x, u, sigma u_x) = 0``
(Pardoux-Peng). The solver is the Gobet-Lemor-Warin least-squares scheme
(Ann. Appl. Prob. 15(3), 2005): an Euler forward panel, then a backward
sweep over dates regressing ``E_i[Y_{i+1}]`` and ``Z_i = E_i[Y_{i+1}
DW_i] / dt`` on per-date standardized monomials of X_i, with a
trapezoidal driver (the implicit left half by Picard sweeps), two-fold
cross-fitted regressions (fit on one half of the paths, predict the
other), and error bars from the pathwise accumulator whose mean the
estimate is.

The normal equations are float64 Grams whatever the paths' dtype (where
``mlmc_tpu`` bounds float32 accumulation windows), solved after Jacobi
equilibration with a ridge of 1e-6 (float32 paths) or 1e-12 (float64).
The forward normals are keyed: path b is the identity (seed, 0, b), its
normal i the Brownian increment of step i.
"""
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.random.keyed import keyed_normals
from mlmc_tpu_torch.sim.american import _equilibrated_solve, _normal_eq, _ridge_eps
from mlmc_tpu_torch.sim.sde import SDEModel
from mlmc_tpu_torch.sim.simulation import ieee_float32_matmuls

__all__ = ["solve_bsde"]


def _solve(model, terminal, driver, T, n_steps, z, degree, scale, picard):
    """The backward sweep over the forward normals ``z [B, n_steps]``."""
    B, dtype, device = z.shape[0], z.dtype, z.device
    dt = float(T) / int(n_steps)
    x0 = float(model.s0)
    sc = float(scale if scale is not None else (abs(x0) or 1.0))
    K = degree + 1
    half = B // 2
    eps = _ridge_eps(dtype)
    powers = torch.arange(K, dtype=dtype, device=device)
    at = lambda v: torch.tensor(v, dtype=dtype, device=device)     # times as tensors

    def basis(x):
        mu = x.mean()
        sd = torch.clamp(x.std(correction=0), min=1e-12 * sc)
        return ((x - mu) / sd)[:, None] ** powers

    def fit_predict(x, y2):
        G = basis(x)
        c1 = _equilibrated_solve(*_normal_eq(G[:half], y2[:half]), eps).to(dtype)
        c2 = _equilibrated_solve(*_normal_eq(G[half:], y2[half:]), eps).to(dtype)
        return torch.cat([G[:half] @ c2, G[half:] @ c1])

    # forward panel: X_0 .. X_{n-1} with their increments
    dws = float(np.sqrt(dt)) * z
    x = torch.full((B,), x0, dtype=dtype, device=device)
    xs = []
    for i in range(int(n_steps)):
        xs.append(x)
        t = at(i * dt)
        x = x + model.drift(x, t) * dt + model.diffusion(x, t) * dws[:, i]
    y = terminal(x)
    zz = torch.zeros_like(y)
    acc = y
    x_next, w = x, 0.0
    for i in range(int(n_steps) - 1, 0, -1):
        t = at(i * dt)
        f_right = driver(at((i + 1) * dt), x_next, y, zz)
        rhs = y + w * f_right
        pred = fit_predict(xs[i], torch.stack([rhs, y * dws[:, i]], dim=1))
        ey, z_new = pred[:, 0], pred[:, 1] / dt
        y_new = ey
        for _ in range(picard):
            y_new = ey + (dt - w) * driver(t, xs[i], y_new, z_new)
        acc = acc + w * f_right + (dt - w) * driver(t, xs[i], y_new, z_new)
        y, zz, x_next, w = y_new, z_new, xs[i], dt / 2
    f1 = driver(at(dt), x_next, y, zz)
    ey0 = (y + w * f1).mean()
    z0 = (y * dws[:, 0]).mean() / dt
    y0 = ey0
    x0_t = torch.full((), x0, dtype=dtype, device=device)
    for _ in range(picard):
        y0 = ey0 + (dt - w) * driver(at(0.0), x0_t, y0, z0)
    acc = acc + w * f1
    var0 = ((acc - acc.mean()) ** 2).mean()
    varz = ((y * dws[:, 0] / dt - z0) ** 2).mean()
    return y0, z0, var0, varz


def solve_bsde(model: SDEModel, terminal: Callable, driver: Callable, T: float,
               n_steps: int, n_paths: int = 1 << 16, degree: int = 4,
               scale: Optional[float] = None, picard: int = 3, seed: int = 0,
               dtype=None, device=None):
    """Solve the scalar BSDE; returns the time-0 pair.

    :param model: forward ``SDEModel`` (``drift``/``diffusion``/``s0``)
    :param terminal: ``g(x) -> y`` tensor callable
    :param driver: ``f(t, x, y, z) -> value`` tensor callable (t a 0-d
        tensor)
    :param T/n_steps: horizon and Euler grid
    :param degree: regression degree (per-date standardized monomials)
    :param scale: basis scale (default ``|x0|`` or 1)
    :param picard: implicit-update fixed-point sweeps
    :param seed: the paths' identities (seed, 0, b)
    :param dtype: the paths' dtype (default float32)
    :param device: None = the current CUDA device
    :return: dict with ``y0``, ``z0``, ``y0_se``, ``z0_se``, ``wall_s``
    """
    if n_steps < 1:
        raise ValueError("n_steps must be >= 1")
    if picard < 1:
        raise ValueError("picard must be >= 1")
    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    B = int(n_paths)
    t0 = time.perf_counter()
    idx = torch.arange(B, dtype=torch.int64, device=device)
    z = keyed_normals(seed, 0, idx, torch.zeros_like(idx), int(n_steps), dtype)
    with ieee_float32_matmuls():
        y0, z0, var0, varz = (float(v) for v in _solve(
            model, terminal, driver, T, n_steps, z, degree, scale, picard))
    return {"y0": y0, "z0": z0, "y0_se": float(np.sqrt(var0 / B)),
            "z0_se": float(np.sqrt(varz / B)), "wall_s": time.perf_counter() - t0}
