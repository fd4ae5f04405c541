"""Multilevel Richardson-Romberg extrapolation (counterpart of
``mlmc_tpu/ml2r.py``).

Lemaire & Pagès ("Multilevel Richardson-Romberg extrapolation",
Bernoulli 23(4A), 2017): when the weak bias expands in powers of the step,
``E[Y_h] = I + c_1 h^alpha + c_2 h^{2 alpha} + ...``, re-weight the
telescoped corrections,

    I_ML2R = sum_l  W_l * mean(Y_l - Y_{l-1}),     W_l = sum_{j>=l} w_j,

with weights solving the Vandermonde system ``sum_j w_j = 1``,
``sum_j w_j h_j^{k alpha} = 0`` for k = 1..L: every expansion term up to
``h^{(L+1) alpha}`` cancels. The level variances pick up ``W_l^2``, so the
allocation uses ``W_l^2 V_l``.

The level extensions are the continuation driver's (``cmlmc._mean_program``):
sample ``i`` of level ``l`` is the identity (seed, l, i). Both estimates
come back from the same samples: ``mean`` (ML2R) and ``mean_mlmc`` (the
unweighted telescope).

Level contract: ``pair_fn(level, keys) -> (fine [C], coarse [C], valid
[C])`` with ``keys`` a ``random.keyed.SampleKeys``.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.cmlmc import _mean_program
from mlmc_tpu_torch.parallel.mesh import single_device_mesh

__all__ = ["ml2r_weights", "ml2r"]


def ml2r_weights(level_steps: Sequence[float], alpha: float = 1.0):
    """Solve the ML2R weight system for a decreasing step hierarchy:
    ``sum_j w_j = 1`` and ``sum_j w_j h_j^{k alpha} = 0`` for k = 1..L.

    :return: (w, W): the weights ``w`` [L+1] and their tail sums
        ``W_l = sum_{j>=l} w_j`` [L+1] (``W[0] == 1``)

    The system is a Vandermonde in ``h^alpha``; its condition number is
    checked before the solve and a system past 1e12 raises.
    """
    h = np.asarray(level_steps, np.float64).ravel()
    if len(h) < 1:
        raise ValueError("need at least one level")
    if np.any(h <= 0) or np.any(h[1:] >= h[:-1]):
        raise ValueError("level_steps must be positive and decrease "
                         "(finest last)")
    if alpha <= 0:
        raise ValueError("alpha must be positive")
    n = len(h)
    # nodes scaled by the coarsest step for conditioning
    x = (h / h[0]) ** float(alpha)
    V = np.vander(x, n, increasing=True).T        # row k: x^k
    rhs = np.zeros(n)
    rhs[0] = 1.0
    # the residual of the solve stays small even when the weights lose
    # their digits: test the conditioning before solving
    cond = float(np.linalg.cond(V))
    if not np.isfinite(cond) or cond > 1e12:
        raise ValueError(
            "ML2R weight system ill-conditioned (cond %.2e > 1e12) — "
            "hierarchy too deep or steps too close for f64 weights; "
            "reduce the level count" % cond)
    w = np.linalg.solve(V, rhs)
    W = np.cumsum(w[::-1])[::-1]
    return w, W


def ml2r(pair_fn: Callable, level_steps: Sequence[float],
         target_var: float, alpha: float = 1.0, seed: int = 0,
         cost_fn: Optional[Callable] = None, chunk_size: int = 1 << 12,
         n_pilot: int = 1 << 12, max_rounds: int = 30, dtype=torch.float64,
         mesh=None, device=None):
    """Run the ML2R estimator to a statistical variance target.

    :param pair_fn: level contract above
    :param level_steps: steps ``h_l``, coarsest first; all levels are used
    :param target_var: allocation target for ``sum_l W_l^2 V_l / n_l``
    :param alpha: weak-expansion exponent (Euler-Maruyama: 1.0)
    :param cost_fn: optional ``level -> relative cost``; measured wall
        time per sample otherwise
    :param mesh: a ``parallel.SampleMesh``: chunks split over the shards
        (chunk_size must divide by the device count), one reduction per
        extension
    :param device: where the chunks run without a mesh; None = the
        current CUDA device
    :return: dict with ``mean`` (ML2R), ``mean_mlmc`` (the unweighted
        telescope on the same samples), ``var``, ``se``, ``weights``
        (w, W), ``n_per_level``, ``level_means``, ``level_vars``,
        ``rounds``, ``target_met``, ``n_forward``, ``wall_s``
    """
    h = np.asarray(level_steps, np.float64).ravel()
    if len(h) < 2:
        raise ValueError("need at least a 2-level hierarchy")
    if target_var <= 0:
        raise ValueError("target_var must be positive")
    w, W = ml2r_weights(h, alpha)
    L = len(h)
    mesh = mesh if mesh is not None else single_device_mesh(device)
    if chunk_size % mesh.n_devices:
        raise ValueError(
            "chunk_size=%d must divide by the mesh's %d devices"
            % (chunk_size, mesh.n_devices))
    programs = [_mean_program(pair_fn, lv, chunk_size, dtype, int(seed),
                              mesh=mesh)
                for lv in range(L)]
    sums = np.zeros(L)
    sums2 = np.zeros(L)
    nval = np.zeros(L)
    ndrawn = np.zeros(L, dtype=np.int64)
    elapsed = np.zeros(L)
    t0 = time.perf_counter()

    def extend(lv, n_add):
        n_chunks = -(-int(n_add) // chunk_size)
        if n_chunks <= 0:
            return
        start = ndrawn[lv] // chunk_size
        tt = time.perf_counter()
        flat = programs[lv](start, n_chunks)
        elapsed[lv] += time.perf_counter() - tt
        sums[lv] += flat[0]
        sums2[lv] += flat[1]
        nval[lv] += flat[2]
        ndrawn[lv] += n_chunks * chunk_size

    def stats():
        n = np.maximum(nval, 1.0)
        m = sums / n
        v = np.maximum(sums2 / n - m * m, 1e-300)
        return m, v

    def costs():
        if cost_fn is not None:
            return np.array([float(cost_fn(lv)) for lv in range(L)])
        return np.maximum(elapsed / np.maximum(ndrawn, 1), 1e-12)

    for lv in range(L):
        extend(lv, n_pilot)
    rounds = 0
    while rounds < max_rounds:
        m, v = stats()
        wv = W * W * v
        est_var = float(np.sum(wv / np.maximum(nval, 1.0)))
        if est_var <= target_var:
            break
        c = costs()
        lam = float(np.sum(np.sqrt(wv * c))) / target_var
        n_opt = np.ceil(lam * np.sqrt(wv / c)).astype(np.int64)
        gaps = n_opt - ndrawn
        if not np.any(gaps > 0):
            break
        for lv in range(L):
            if gaps[lv] > 0:
                extend(lv, int(gaps[lv]))
        rounds += 1
    m, v = stats()
    est_var = float(np.sum(W * W * v / np.maximum(nval, 1.0)))
    return {"mean": float(np.sum(W * m)),
            "mean_mlmc": float(np.sum(m)),
            "var": est_var, "se": float(np.sqrt(est_var)),
            "weights": (w, W), "n_per_level": ndrawn.copy(),
            "level_means": m, "level_vars": v, "rounds": rounds,
            "target_met": bool(est_var <= target_var),
            "n_forward": int(ndrawn.sum()),
            "wall_s": time.perf_counter() - t0}
