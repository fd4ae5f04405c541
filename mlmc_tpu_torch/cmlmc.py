"""Continuation multilevel Monte Carlo (counterpart of ``mlmc_tpu/cmlmc.py``).

Collier, Haji-Ali, Nobile, von Schwerin & Tempone ("A continuation
multilevel Monte Carlo algorithm", BIT 55, 2015): solve a sequence of
relaxed tolerances ``eps_i = r_tol^(k-i) * eps``; each stage re-fits the
weak (alpha), variance (beta) and cost (gamma) rates from everything
measured so far, picks the level count L from the extrapolated remaining
bias, and re-allocates. Error contract: ``|bias| + z * se <= eps`` with
``bias <= (1 - theta) eps`` and ``z * se <= theta eps``; the bias at the
chosen L is the Richardson-style extrapolation ``|Y_L| / (r_h^alpha - 1)``.

Each level streams chunks of samples into Kahan-compensated sums of the
correction and its square; sample ``i`` of level ``l`` is the identity
(seed, l, i), so a stage's extension never redraws and a sample mesh
splits each chunk over its shards without changing it.

Level contract (shared with the CDF and unbiased drivers):
``pair_fn(level, keys) -> (fine [C], coarse [C], valid [C])`` with
``keys`` a ``random.keyed.SampleKeys``; adapt a Simulation with
``cdf_estimate.simulation_pair_fn``.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.estimator import estimate_convergence_rates
from mlmc_tpu_torch.parallel.mesh import chunk_indices, single_device_mesh
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["cmlmc"]


def _mean_program(pair_fn, level, chunk, dtype, seed, mesh=None, device=None):
    """The level's extension: ``run(start, n_chunks) -> [sum, sum^2,
    n_valid]`` (numpy f64) of the corrections of chunks [start, start +
    n_chunks), Kahan-compensated per shard and summed over the mesh. Each
    chunk's samples split over the shards at the same indices as on one
    device (offset by shard position)."""
    mesh = mesh if mesh is not None else single_device_mesh(device)
    is_l0 = level == 0

    def shard_sums(shard, device, start, n_chunks):
        z = torch.zeros((), dtype=dtype, device=device)
        s, cs, s2, cs2 = z, z, z, z
        nv = torch.zeros((), dtype=torch.int64, device=device)
        for c in range(start, start + n_chunks):
            idx = chunk_indices(mesh, shard, chunk, c, device)
            fine, coarse, valid = pair_fn(level, SampleKeys(seed, level, idx))
            d = fine.to(dtype)
            valid = valid & torch.isfinite(d)
            if not is_l0:
                c_ = coarse.to(dtype)
                valid = valid & torch.isfinite(c_)
                d = d - c_
            d = torch.where(valid, d, torch.zeros_like(d))
            y = d.sum() - cs
            t = s + y
            s, cs = t, (t - s) - y
            y = (d * d).sum() - cs2
            t = s2 + y
            s2, cs2 = t, (t - s2) - y
            nv = nv + valid.sum()
        return s - cs, s2 - cs2, nv

    def run(start, n_chunks):
        s, s2, nv = mesh.reduce([shard_sums(sh, d, int(start), int(n_chunks))
                                 for sh, d in mesh.local_shards()])
        return np.array([float(s), float(s2), float(nv)])

    return run


def cmlmc(pair_fn: Callable, level_steps: Sequence[float], eps: float,
          theta: float = 0.5, z: float = 2.0, r_tol: float = 2.0,
          n_stages: int = 4, seed: int = 0,
          cost_fn: Optional[Callable] = None, chunk_size: int = 1 << 12,
          n_pilot: int = 1 << 12, min_levels: int = 2,
          alpha_floor: float = 0.25, dtype=torch.float64, mesh=None,
          device=None):
    """Run the continuation algorithm to total error ``eps``.

    :param pair_fn: level contract above
    :param level_steps: steps ``h_l`` of the available hierarchy, finest
        last; the driver activates a prefix of it
    :param eps: final error target for ``|bias| + z * se``
    :param theta: error split (bias share ``1 - theta``)
    :param z: confidence factor on the statistical half
    :param r_tol / n_stages: tolerance sequence
        ``eps * r_tol^(n_stages - 1 - i)``, i = 0..n_stages-1
    :param cost_fn: optional ``level -> relative cost``; measured wall
        time per sample otherwise
    :param alpha_floor: lower bound for the fitted weak rate
    :param mesh: a ``parallel.SampleMesh``: each chunk's samples split
        over the shards (chunk_size must divide by the device count), one
        reduction per level extension
    :param device: where the chunks run without a mesh; None = the
        current CUDA device
    :return: dict with ``mean``, ``bias``, ``se``, ``error_bound``,
        ``n_levels``, ``bias_target_met``, ``n_per_level``,
        ``level_means``, ``level_vars``, ``rates``, ``stage_history``,
        ``n_forward``, ``wall_s``
    """
    h = np.asarray(level_steps, np.float64).ravel()
    max_l = len(h)
    if max_l < 2:
        raise ValueError("need at least a 2-level hierarchy")
    if np.any(h[1:] >= h[:-1]):
        raise ValueError("level_steps must decrease (finest last)")
    if not 0.0 < theta < 1.0:
        raise ValueError("theta must be in (0, 1)")
    if eps <= 0:
        raise ValueError("eps must be positive")
    mesh = mesh if mesh is not None else single_device_mesh(device)
    if chunk_size % mesh.n_devices:
        raise ValueError(
            "chunk_size=%d must divide by the mesh's %d devices"
            % (chunk_size, mesh.n_devices))
    programs = [_mean_program(pair_fn, lv, chunk_size, dtype, int(seed),
                              mesh=mesh)
                for lv in range(max_l)]
    sums = np.zeros(max_l)
    sums2 = np.zeros(max_l)
    nval = np.zeros(max_l)
    ndrawn = np.zeros(max_l, dtype=np.int64)
    elapsed = np.zeros(max_l)
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

    def stats(L):
        n = np.maximum(nval[:L], 1.0)
        m = sums[:L] / n
        v = np.maximum(sums2[:L] / n - m * m, 1e-300)
        return m, v

    def costs(L):
        if cost_fn is not None:
            return np.array([cost_fn(lv) for lv in range(L)])
        return np.maximum(elapsed[:L] / np.maximum(ndrawn[:L], 1),
                          1e-12)

    # pilot the minimal hierarchy
    L = max(min_levels, 2)
    for lv in range(L):
        extend(lv, n_pilot)

    history = []
    for stage in range(n_stages):
        eps_i = eps * r_tol ** (n_stages - 1 - stage)
        m, v = stats(L)
        rates = estimate_convergence_rates(m, v, h[:L])
        alpha = rates["alpha"]
        if not np.isfinite(alpha) or alpha < alpha_floor:
            alpha = alpha_floor
        r_h = float(h[L - 2] / h[L - 1])
        # grow L until the extrapolated remaining bias fits the split;
        # predict |Y_L| for candidate levels from the fitted decay
        y_last = abs(m[L - 1])
        while (y_last / (r_h ** alpha - 1.0) > (1 - theta) * eps_i
               and L < max_l):
            ratio = float(h[L] / h[L - 1])
            y_last = y_last * ratio ** alpha
            L += 1
            if ndrawn[L - 1] == 0:
                extend(L - 1, n_pilot)
            m, v = stats(L)
            if np.isfinite(m[L - 1]) and nval[L - 1] > 0:
                y_last = abs(m[L - 1])     # replace the prediction
            r_h = float(h[L - 2] / h[L - 1])
        # optimal allocation for the statistical half
        m, v = stats(L)
        c = costs(L)
        target_var = (theta * eps_i / z) ** 2
        lam = np.sum(np.sqrt(v * c)) / target_var
        n_opt = np.ceil(lam * np.sqrt(v / c)).astype(np.int64)
        for lv in range(L):
            extend(lv, n_opt[lv] - ndrawn[lv])
        m, v = stats(L)
        se = float(np.sqrt(np.sum(v / np.maximum(nval[:L], 1.0))))
        bias = float(abs(m[L - 1]) / (r_h ** alpha - 1.0))
        history.append(dict(eps=eps_i, n_levels=L, alpha=float(alpha),
                            beta=float(rates["beta"]), se=se,
                            bias=bias,
                            n_per_level=ndrawn[:L].copy()))

    m, v = stats(L)
    rates = estimate_convergence_rates(m, v, h[:L], n_ops=costs(L))
    se = float(np.sqrt(np.sum(v / np.maximum(nval[:L], 1.0))))
    alpha = rates["alpha"]
    if not np.isfinite(alpha) or alpha < alpha_floor:
        alpha = alpha_floor
    bias = float(abs(m[L - 1]) / ((h[L - 2] / h[L - 1]) ** alpha - 1.0))
    bias_target_met = bias <= (1 - theta) * eps * 1.05
    if not bias_target_met:
        import warnings
        warnings.warn(
            f"CMLMC exhausted the {max_l}-level hierarchy with "
            f"extrapolated bias {bias:.3g} > the (1-theta)*eps = "
            f"{(1 - theta) * eps:.3g} budget — extend level_steps or "
            "loosen eps; the returned error_bound is honest",
            RuntimeWarning)
    return {"mean": float(np.sum(m)), "bias": bias, "se": se,
            "error_bound": bias + z * se, "n_levels": L,
            "bias_target_met": bool(bias_target_met),
            "n_per_level": ndrawn[:L].copy(),
            "level_means": m, "level_vars": v, "rates": rates,
            "stage_history": history,
            "n_forward": int(ndrawn.sum()),
            "wall_s": time.perf_counter() - t0}
