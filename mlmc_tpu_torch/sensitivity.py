"""Variance-based global sensitivity analysis: Sobol' indices and active
subspaces (counterpart of ``mlmc_tpu/sensitivity.py``).

First-order indices ``S_i = Var(E[Q|x_i]) / Var(Q)`` and total-effect
indices ``S_Ti = 1 - Var(E[Q|x_~i]) / Var(Q)`` by Saltelli's pick-freeze
design with Jansen's difference estimators (Saltelli et al. 2010):
per randomization, ``n (d + 2)`` model evaluations reduced to ``2d + 4``
sums.

- :func:`sobol_indices` — one model;
- :func:`sobol_indices_mlmc` — a level hierarchy under the MLMC contract
  (each level evaluates fine and coarse on the same input); every
  pick-freeze expectation telescopes (Mycek & Le Maître 2019).

The blocks A and B are the first and last ``d`` columns of one
``2d``-dimensional Owen-scrambled Sobol' sequence (``ops/sobol``); the R
randomizations run as a leading axis of one evaluation per block, and the
indices come per randomization with their spread as standard errors. The
sums accumulate in float64, where ``mlmc_tpu`` compensates float32 sums
(``df64.two_sum``). The scramble words come from ``sobol.scramble_seeds
(seed, level, R, 2d)``; ``mlmc_tpu`` takes them from a JAX key.

:func:`active_subspace` eigendecomposes ``E[grad f grad f^T]`` from
per-sample gradients: ``torch.autograd.grad`` of the sum of
``torch.func.vmap(fn)`` over a chunk (each sample's value depends on its
own input alone). ``torch.func.grad`` would import ``torch._dynamo``,
whose config reads the working directory, which ``mlmc_tpu``'s
``jax.grad`` never needs.
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops import sobol
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["sobol_indices", "sobol_indices_mlmc", "SobolIndices", "active_subspace"]


class SobolIndices(dict):
    """Result mapping with attribute access (``res.first_order`` ==
    ``res["first_order"]``)."""

    __getattr__ = dict.__getitem__


def _check_args(dim, n_randomizations, chunk_size):
    if dim < 1:
        raise ValueError("dim must be >= 1")
    if n_randomizations < 2:
        raise ValueError("need >= 2 randomizations for standard errors")
    if chunk_size & (chunk_size - 1):
        raise ValueError("chunk_size must be a power of two")


def _round_to_chunks(n, chunk_size):
    chunk = min(int(chunk_size), max(64, 1 << (int(n) - 1).bit_length()))
    n_chunks = -(-int(n) // chunk)
    return chunk, n_chunks, n_chunks * chunk


def _design_accumulators(level_fn, dim, chunk, n_chunks, seeds, work_dtype, transform):
    """The pick-freeze design through ``level_fn(x) -> (fine, coarse)``
    (``coarse`` may be None: a single model), accumulated in float64 per
    randomization:

    ``sa = sum D(A)``, ``sa2 = sum D2(A)`` (D2: fine^2 - coarse^2), the
    same for B, and per factor i ``d1_i = sum [(f_B - f_ABi)^2 - (c_B -
    c_ABi)^2]``, ``dt_i = sum [(f_A - f_ABi)^2 - (c_A - c_ABi)^2]``.

    :param seeds: int64 tensor [R, 2 dim] of scramble words; its device is
        where the design runs
    :return: (sa, sa2, sb, sb2 [R], d1, dt [R, dim]) float64 numpy
    """
    R, device = seeds.shape[0], seeds.device
    dv = sobol.direction_numbers(2 * dim)
    eye = torch.eye(dim, dtype=torch.bool, device=device)
    f64 = torch.float64
    acc = [torch.zeros(R, dtype=f64, device=device) for _ in range(4)] + [
        torch.zeros((R, dim), dtype=f64, device=device) for _ in range(2)]

    def evaluate(x):
        f, c = level_fn(x.reshape(-1, dim))
        f = f.to(f64)
        c = torch.zeros_like(f) if c is None else c.to(f64)
        return f.reshape(x.shape[:-1]), c.reshape(x.shape[:-1])

    for k in range(int(n_chunks)):
        bits = sobol.sobol_bits(dv, k * chunk, chunk, device=device)           # [chunk, 2d]
        u = sobol.uniforms_from_bits(sobol.owen_scramble(bits[None], seeds[:, None, :]),
                                     dtype=work_dtype)                        # [R, chunk, 2d]
        a, b = u[..., :dim], u[..., dim:]
        if transform is not None:
            a, b = transform(a), transform(b)
        f_a, c_a = evaluate(a)                                                # [R, chunk]
        f_b, c_b = evaluate(b)
        ab = torch.where(eye[None, :, None, :], b[:, None], a[:, None])       # [R, d, chunk, d]
        f_ab, c_ab = evaluate(ab)
        terms = ((f_a - c_a).sum(dim=1), (f_a * f_a - c_a * c_a).sum(dim=1),
                 (f_b - c_b).sum(dim=1), (f_b * f_b - c_b * c_b).sum(dim=1),
                 ((f_b[:, None] - f_ab) ** 2 - (c_b[:, None] - c_ab) ** 2).sum(dim=2),
                 ((f_a[:, None] - f_ab) ** 2 - (c_a[:, None] - c_ab) ** 2).sum(dim=2))
        acc = [s + t for s, t in zip(acc, terms)]
    out = tuple(s.cpu().numpy() for s in acc)
    if not all(np.all(np.isfinite(x)) for x in out):
        raise FloatingPointError(
            "model produced non-finite values on the design; Sobol-index "
            "estimators cannot drop points without bias")
    return out


def _aggregate(s1, st, var, m, n, R, n_evaluations):
    def agg(x):
        return np.mean(x, axis=0), np.std(x, axis=0, ddof=1) / np.sqrt(R)

    s1_m, s1_se = agg(s1)
    st_m, st_se = agg(st)
    return SobolIndices(first_order=s1_m, first_order_se=s1_se,
                        total_effect=st_m, total_effect_se=st_se,
                        variance=float(np.mean(var)), mean=float(np.mean(m)),
                        n=n, n_randomizations=R, n_evaluations=n_evaluations)


def _indices_from_accumulators(accs, n, R, dim):
    sa, sa2, sb, sb2, d1, dt = accs
    m = (sa + sb) / (2 * n)
    var = ((sa2 + sb2) / (2 * n) - m * m) * (2 * n) / (2 * n - 1)
    if np.any(var <= 0):
        raise ValueError("model variance is zero on the design; Sobol' indices are "
                         "undefined")
    s1 = (var[:, None] - d1 / (2 * n)) / var[:, None]
    st = (dt / (2 * n)) / var[:, None]
    return _aggregate(s1, st, var, m, n, R, R * n * (dim + 2))


def sobol_indices(fn: Callable, dim: int, n: int = 1 << 13, n_randomizations: int = 8,
                  seed: int = 0, chunk_size: int = 1 << 11, dtype=None,
                  transform: Optional[Callable] = None, device=None) -> SobolIndices:
    """First-order and total-effect Sobol' indices of ``fn``.

    :param fn: model ``f(x [m, dim]) -> y [m]`` on the unit hypercube
        (after ``transform``), row by row
    :param n: design size per randomization (rounded up to a chunk multiple;
        ``n_randomizations * n * (dim + 2)`` evaluations)
    :param n_randomizations: independent Owen scramblings
    :param seed: the scramble words' seed (``sobol.scramble_seeds(seed, 0,
        R, 2 dim)``)
    :param chunk_size: design points per evaluation
    :param dtype: the design's dtype (default float32); sums are float64
    :param transform: pointwise map of the uniform columns (e.g.
        ``ops.sobol.normals_from_uniforms``), applied to A and B once
    :param device: None = the current CUDA device
    :return: :class:`SobolIndices`
    """
    dim, R = int(dim), int(n_randomizations)
    _check_args(dim, R, int(chunk_size))
    chunk, n_chunks, n = _round_to_chunks(n, chunk_size)
    seeds = sobol.scramble_seeds(seed, 0, R, 2 * dim, device=resolve_device(device))
    accs = _design_accumulators(lambda x: (fn(x), None), dim, chunk, n_chunks, seeds,
                                torch.float32 if dtype is None else dtype, transform)
    return _indices_from_accumulators(accs, n, R, dim)


def sobol_indices_mlmc(level_fns: Sequence[Callable], dim: int,
                       n_per_level: Sequence[int], n_randomizations: int = 8,
                       seed: int = 0, chunk_size: int = 1 << 11, dtype=None,
                       transform: Optional[Callable] = None, device=None) -> SobolIndices:
    """Multilevel Sobol' indices: every pick-freeze expectation telescoped
    across a model hierarchy ``level_fns[l](x [m, dim]) -> (fine [m],
    coarse [m])`` (level 0's coarse is zero), independent scrambles per
    level (``scramble_seeds(seed, level, R, 2 dim)``), the variance in the
    population form ``E[f^2] - E[f]^2``.

    :return: :class:`SobolIndices`; ``n`` the per-level design sizes and
        ``level_terms`` the per-level contributions to (E[f^2], mean)
    """
    dim, R = int(dim), int(n_randomizations)
    _check_args(dim, R, int(chunk_size))
    if len(n_per_level) != len(level_fns):
        raise ValueError("n_per_level must match level_fns")
    device = resolve_device(device)
    work_dtype = torch.float32 if dtype is None else dtype
    m, ef2 = np.zeros(R), np.zeros(R)
    t1, tt = np.zeros((R, dim)), np.zeros((R, dim))
    ns, level_v, level_m = [], [], []
    n_evaluations = 0
    for lev, (fn, n_l) in enumerate(zip(level_fns, n_per_level)):
        chunk, n_chunks, n_l = _round_to_chunks(n_l, chunk_size)
        ns.append(n_l)
        n_evaluations += 2 * R * n_l * (dim + 2)
        seeds = sobol.scramble_seeds(seed, lev, R, 2 * dim, device=device)
        sa, sa2, sb, sb2, d1, dt = _design_accumulators(fn, dim, chunk, n_chunks, seeds,
                                                        work_dtype, transform)
        m += (sa + sb) / (2 * n_l)
        ef2 += (sa2 + sb2) / (2 * n_l)
        t1 += d1 / (2 * n_l)
        tt += dt / (2 * n_l)
        level_v.append(float(np.mean((sa2 + sb2) / (2 * n_l))))
        level_m.append(float(np.mean((sa + sb) / (2 * n_l))))
    var = ef2 - m * m
    if np.any(var <= 0):
        raise ValueError("telescoped variance is not positive — coarse levels "
                         "overwhelm the fine correction at these design sizes")
    out = _aggregate((var[:, None] - t1) / var[:, None], tt / var[:, None], var, m,
                     np.asarray(ns), R, n_evaluations)
    out["level_terms"] = dict(e_f2=level_v, mean=level_m)
    return out


# --------------------------------------------------------------------- #
# active subspaces
# --------------------------------------------------------------------- #
def active_subspace(fn: Callable, dim: int, n_samples: int = 8192, seed: int = 0,
                    sampler: Optional[Callable] = None, chunk_size: int = 2048,
                    dtype=None, device=None):
    """Constantine's active subspaces (SIAM Spotlights 2, 2015): the
    eigendecomposition of ``C = E[grad f(x) grad f(x)^T]``; even and odd
    chunks give two independent half-estimates whose principal-subspace
    distances are the stability diagnostic.

    :param fn: ``x [d] -> scalar`` differentiable tensor function
    :param sampler: ``(keys, n) -> x [n, d]`` with ``keys`` the chunk's
        ``SampleKeys(seed, c, arange(n))`` (default: ``keys.normals(d)``,
        N(0, I))
    :param dtype: default float32; the Gram sums are float64
    :param device: None = the current CUDA device
    :return: dict with ``eigvals`` (descending), ``W`` (columns =
        directions), ``activity``, ``explained``, ``subspace_dist``, ``C``,
        ``n_samples``, ``wall_s``
    """
    if dim < 1:
        raise ValueError("dim must be >= 1")
    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    chunk = int(min(chunk_size, n_samples))
    n_chunks = max(-(-int(n_samples) // chunk), 2)
    value_fn = torch.func.vmap(fn)
    idx = torch.arange(chunk, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    halves = [torch.zeros((dim, dim), dtype=torch.float64, device=device) for _ in range(2)]
    for c in range(n_chunks):
        keys = SampleKeys(seed, c, idx)
        x = (keys.normals(dim, dtype) if sampler is None
             else torch.as_tensor(sampler(keys, chunk)).to(device, dtype))
        with torch.enable_grad():
            x = x.detach().requires_grad_(True)
            g = torch.autograd.grad(value_fn(x).sum(), x)[0].to(torch.float64)
        halves[c % 2] = halves[c % 2] + g.T @ g
    c_even, c_odd = (h.cpu().numpy() for h in halves)
    n_even = chunk * ((n_chunks + 1) // 2)
    n_odd = chunk * (n_chunks // 2)
    C = (c_even + c_odd) / (n_even + n_odd)
    lam, W = np.linalg.eigh(C)
    order = np.argsort(lam)[::-1]
    lam, W = np.maximum(lam[order], 0.0), W[:, order]
    total = max(lam.sum(), np.finfo(float).tiny)
    _, W1 = np.linalg.eigh(c_even / max(n_even, 1))
    _, W2 = np.linalg.eigh(c_odd / max(n_odd, 1))
    W1, W2 = W1[:, ::-1], W2[:, ::-1]
    dists = [float(np.linalg.norm(W1[:, :k] @ W1[:, :k].T - W2[:, :k] @ W2[:, :k].T, 2))
             for k in range(1, dim)]
    return {"eigvals": lam, "W": W, "activity": (W ** 2 @ lam),
            "explained": np.cumsum(lam) / total, "subspace_dist": np.asarray(dists),
            "C": C, "n_samples": n_even + n_odd, "wall_s": time.perf_counter() - t0}
