"""Rank-1 lattice rules (counterpart of ``mlmc_tpu/ops/lattice.py``): the
second randomized-QMC family beside the Owen-scrambled Sobol' points of
``ops/sobol.py``.

A rank-1 lattice with ``n`` points and generating vector ``z`` has the
nodes ``x_i = frac(i z / n)``; a random shift ``Delta ~ U[0,1)^d`` makes
the rule unbiased (``frac(i z / n + Delta)``), and R independent shifts
give the error across shift estimates. The generating vector comes from
the component-by-component construction (Sloan-Kuo-Joe 2002; the fast
Nuyens-Cools variant for power-of-two ``n``), built once on the host in
numpy exactly as ``mlmc_tpu`` builds it; the tent transform
``1 - |2u - 1|`` periodizes smooth non-periodic integrands.

The node formula is exact integer arithmetic: ``i z mod n`` wraps mod
2^32 in ``mlmc_tpu``'s uint32 code; here the words live in int64 tensors
and the product's low word is formed from 16-bit halves, so nothing
overflows and the residues equal the uint32 ones. The residue divided by
``n`` in the dtype is exact while ``n`` stays inside the dtype's exact
integer range (``_check_exact_range``).

Departure from ``mlmc_tpu``: ``lattice_estimate``'s random shifts are
Philox uniforms of the identities (seed, level 0, shift r)
(``random_shifts``) in place of ``jax.random.uniform`` of a JAX key. The
shift sums accumulate in float64 whatever the point dtype.
"""
from typing import Callable

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops.cuda_kernels import MASK32
from mlmc_tpu_torch.random.keyed import keyed_words

__all__ = ["cbc_vector", "lattice_points", "lattice_points_extensible",
           "p_alpha", "lattice_estimate", "tent", "random_shifts"]


def _bernoulli2_kernel(x):
    """``omega(x) = 2 pi^2 B_2(x) = 2 pi^2 (x^2 - x + 1/6)``: the alpha=2
    Korobov worst-case kernel."""
    return 2.0 * np.pi ** 2 * (x * x - x + 1.0 / 6.0)


def cbc_vector(n, dim, weights=None, method="auto"):
    """Component-by-component generating vector for the weighted Korobov
    space with alpha=2 and product weights (host numpy, the same numbers as
    ``mlmc_tpu``'s).

    :param n: points (power of two).
    :param dim: dimensions.
    :param weights: per-dimension product weights (default ``0.9^j``).
    :param method: ``direct`` (blocked O(d n^2) sweep), ``fft`` (the fast
        CBC of Nuyens & Cools for power-of-two n) or ``auto`` (fft for
        n >= 512).
    :return: ``z [dim]`` int64 (z[0] = 1).
    """
    n, dim = int(n), int(dim)
    if n < 2 or n & (n - 1):
        raise ValueError("n must be a power of two >= 2")
    if dim < 1:
        raise ValueError("dim must be >= 1")
    if weights is None:
        weights = 0.9 ** np.arange(1, dim + 1)
    gamma = np.asarray(weights, np.float64)
    if gamma.shape != (dim,) or np.any(gamma <= 0):
        raise ValueError("weights must be %d positive floats" % dim)
    if method not in ("auto", "direct", "fft"):
        raise ValueError("method must be auto|direct|fft")
    if method == "auto":
        method = "fft" if n >= 512 else "direct"
    if method == "fft" and n >= 16:
        return _cbc_vector_fft(n, dim, gamma)
    k = np.arange(n, dtype=np.int64)
    cand = np.arange(1, n, 2, dtype=np.int64)          # odd = coprime
    z = np.empty(dim, np.int64)
    z[0] = 1
    prod = 1.0 + gamma[0] * _bernoulli2_kernel(k / float(n))  # [n]
    # candidate blocks bound the omega({k z / n}) table at ~32 MB
    blk = max(1, min(cand.shape[0], (1 << 22) // n))
    for d in range(1, dim):
        best, best_err = 1, np.inf
        for s in range(0, cand.shape[0], blk):
            cb = cand[s:s + blk]
            om = _bernoulli2_kernel((k[None, :] * cb[:, None] % n)
                                    / float(n))        # [blk, n]
            err = (1.0 + gamma[d] * om) @ prod         # [blk]
            j = int(np.argmin(err))
            if err[j] < best_err:
                best, best_err = int(cb[j]), float(err[j])
        z[d] = best
        prod = prod * (1.0 + gamma[d]
                       * _bernoulli2_kernel((k * best % n) / float(n)))
    return z


def _cbc_vector_fft(n, dim, gamma):
    """Fast CBC for n = 2^m: the candidate errors are group correlations
    over ``(Z/2^t)* = {+-3^i}``, one FFT per dyadic block (see
    ``mlmc_tpu/ops/lattice.py`` for the derivation)."""
    m = int(n - 1).bit_length()
    U = n >> 2                                  # 2^(m-2) exponents
    pow3 = np.empty(U, np.int64)
    acc = 1
    for u in range(U):
        pow3[u] = acc
        acc = (acc * 3) % n
    z_of = np.stack([pow3, n - pow3])           # [sigma, u] -> candidate
    sign_u = np.where(np.arange(U) % 2 == 0, 1, -1)

    k = np.arange(n, dtype=np.int64)
    z = np.empty(dim, np.int64)
    z[0] = 1
    prod = 1.0 + gamma[0] * _bernoulli2_kernel(k / float(n))

    for d in range(1, dim):
        E = np.zeros((2, U))
        E += prod[0] * _bernoulli2_kernel(0.0)            # k = 0
        if m >= 1:                                         # t=1: j=1
            E += prod[n >> 1] * _bernoulli2_kernel(0.5)
        if m >= 2:                                         # t=2: j in {1,3}
            a = m - 2
            q1, q3 = prod[1 << a], prod[3 << a]
            w1, w3 = (_bernoulli2_kernel(0.25),
                      _bernoulli2_kernel(0.75))
            zmod4_is1 = np.stack([sign_u == 1, sign_u == -1])
            E += np.where(zmod4_is1, q1 * w1 + q3 * w3,
                          q1 * w3 + q3 * w1)
        for t in range(3, m + 1):
            a = m - t
            P = 1 << (t - 2)
            mod = 1 << t
            p3t = pow3[:P] % mod                # 3^i mod 2^t
            j_pos = p3t                         # eps = +1
            j_neg = mod - p3t                   # eps = -1
            qp = prod[j_pos << a]
            qn = prod[j_neg << a]
            wp = _bernoulli2_kernel(j_pos / float(mod))
            wn = _bernoulli2_kernel(j_neg / float(mod))
            fqp, fqn = np.fft.rfft(qp), np.fft.rfft(qn)
            fwp, fwn = np.fft.rfft(wp), np.fft.rfft(wn)
            corr = lambda fa, fb: np.fft.irfft(np.conj(fa) * fb, P)
            c_pos = corr(fqp, fwp) + corr(fqn, fwn)
            c_neg = corr(fqp, fwn) + corr(fqn, fwp)
            reps = U // P
            E[0] += np.tile(c_pos, reps)
            E[1] += np.tile(c_neg, reps)
        si, ui = np.unravel_index(np.argmin(E), E.shape)
        best = int(z_of[si, ui])
        z[d] = best
        prod = prod * (1.0 + gamma[d]
                       * _bernoulli2_kernel((k * best % n) / float(n)))
    return z


def p_alpha(z, n, weights=None):
    """Squared shift-averaged worst-case error of the lattice ``(z, n)``
    in the alpha=2 weighted Korobov space (closed form, host numpy)."""
    z = np.asarray(z, np.int64)
    n = int(n)
    if weights is None:
        weights = 0.9 ** np.arange(1, z.shape[0] + 1)
    gamma = np.asarray(weights, np.float64)
    k = np.arange(n, dtype=np.int64)
    prod = np.prod(1.0 + gamma[None, :] * _bernoulli2_kernel(
        (k[:, None] * z[None, :] % n) / float(n)), axis=1)
    return float(prod.mean() - 1.0)


def _check_exact_range(n, dtype):
    """The nodes divide the exact residue ``i z mod n`` by ``n`` in
    ``dtype``: residues past the dtype's exact-integer range (2^24 for
    float32) would round; past 2^32 the word arithmetic itself wraps.
    Refuse instead."""
    exact = {4: 1 << 24, 8: 1 << 32}.get(torch.empty((), dtype=dtype).element_size(), 0)
    if n > exact:
        raise ValueError(
            "n=%d exceeds the exact range for %s lattices (%d): float32 "
            "residues would round past 2^24; beyond 2^32 the 32-bit index "
            "arithmetic itself wraps; pass dtype=torch.float64 for n in "
            "(2^24, 2^32]" % (n, dtype, exact))


def _mul_lo_words(a, b):
    """Low 32 bits of ``a * b`` for int64 tensors holding uint32 values
    (the uint32 wrap of ``mlmc_tpu``'s node formula), from 16-bit halves
    of ``b`` so no product leaves int64."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & MASK32


def _z_words(z, n, device):
    if isinstance(z, torch.Tensor):
        return z.to(device=device, dtype=torch.int64) % n
    return torch.as_tensor(np.asarray(z, np.int64) % n, device=device)


def _shifted(frac, shift, dtype):
    if shift is None:
        return frac
    shift = torch.as_tensor(shift, dtype=dtype, device=frac.device)
    if shift.dim() == 1:
        return torch.remainder(frac + shift[None, :], 1.0)
    return torch.remainder(frac[None] + shift[:, None, :], 1.0)


def lattice_points(z, n, shift=None, start=0, count=None, dtype=torch.float32,
                   device=None):
    """Lattice nodes ``frac(i z / n + shift)`` for ``i = start ..
    start+count-1``.

    :param z: ``[d]`` generating vector (host ints or a tensor).
    :param shift: ``[d]`` (one shift) or ``[R, d]`` (returns ``[R, count,
        d]``); None = the raw rule.
    :param device: None: the device of a tensor ``z`` or ``shift``, else
        the current CUDA device.
    :return: ``[count, d]`` (or ``[R, count, d]``) uniforms.
    """
    n = int(n)
    if n < 1 or n & (n - 1):
        raise ValueError("n must be a power of two")
    _check_exact_range(n, dtype)
    device = resolve_device(device, like=z if isinstance(z, torch.Tensor) else shift)
    if count is None:
        count = n
    zz = _z_words(z, n, device)
    i = (int(start) + torch.arange(int(count), dtype=torch.int64, device=device)) & MASK32
    frac = (_mul_lo_words(i[:, None], zz[None, :]) & (n - 1)).to(dtype) / n
    return _shifted(frac, shift, dtype)


def lattice_points_extensible(z, n_max, shift=None, start=0, count=None,
                              dtype=torch.float32, device=None):
    """Prefix-extensible lattice sequence: the ``n_max``-point lattice in
    bit-reversed index order, so every power-of-two prefix is exactly the
    smaller lattice rule with the same ``z`` (Hickernell-Hong-L'Ecuyer-
    Lemieux 2000), the lattice analogue of the Sobol' prefix property.

    :return: as :func:`lattice_points`.
    """
    n_max = int(n_max)
    if n_max < 2 or n_max & (n_max - 1):
        raise ValueError("n_max must be a power of two")
    _check_exact_range(n_max, dtype)
    device = resolve_device(device, like=z if isinstance(z, torch.Tensor) else shift)
    if count is None:
        count = n_max - int(start)
    bits = int(n_max - 1).bit_length()
    i = (int(start) + torch.arange(int(count), dtype=torch.int64, device=device)) & MASK32
    rev = torch.zeros_like(i)
    for b in range(bits):
        rev = rev | (((i >> b) & 1) << (bits - 1 - b))
    zz = _z_words(z, n_max, device)
    frac = (_mul_lo_words(rev[:, None], zz[None, :]) & (n_max - 1)).to(dtype) / n_max
    return _shifted(frac, shift, dtype)


def tent(u):
    """Baker's transform ``1 - |2u - 1|``: U[0,1) to U[0,1), periodizing
    smooth integrands (Hickernell 2002)."""
    return 1.0 - torch.abs(2.0 * u - 1.0)


def random_shifts(seed, level, n_shifts, dim, dtype=torch.float32, device=None):
    """``n_shifts`` independent uniform shifts [R, dim] in [0, 1): Philox
    words of the identities (seed, level, shift r); float64 keeps each
    word's 32 bits, float32 its top 24 (so no shift rounds up to 1)."""
    device = resolve_device(device)
    r = torch.arange(int(n_shifts), dtype=torch.int64, device=device)
    w = keyed_words(seed, level, r, torch.zeros_like(r), -(-int(dim) // 4))[:, :int(dim)]
    if dtype == torch.float64:
        return w.to(torch.float64) * 2.0 ** -32
    return (w >> 8).to(dtype) * 2.0 ** -24


def _shift_sums(fn, z, n, chunk, shifts, use_tent, dtype):
    """(sum y, sum y^2) [R] over the n nodes of each shifted lattice, the
    R shifts as a leading axis, chunk by chunk, in float64."""
    R = shifts.shape[0]
    s = torch.zeros(R, dtype=torch.float64, device=shifts.device)
    s2 = torch.zeros_like(s)
    for c in range(n // chunk):
        u = lattice_points(z, n, shifts, start=c * chunk, count=chunk,
                           dtype=dtype, device=shifts.device)     # [R, chunk, d]
        if use_tent:
            u = tent(u)
        y = fn(u.reshape(R * chunk, -1)).reshape(R, chunk).to(torch.float64)
        # one reduction per shift, so a mesh shard sums as one device does
        s = s + torch.stack([row.sum() for row in y])
        s2 = s2 + torch.stack([(row * row).sum() for row in y])
    return s, s2


def lattice_estimate(fn: Callable, dim: int, n: int = 1 << 12,
                     n_shifts: int = 16, z=None, seed: int = 0,
                     use_tent: bool = False, weights=None,
                     chunk_size: int = 1 << 14, dtype=torch.float32, mesh=None,
                     device=None):
    """Randomly shifted lattice estimate of ``E[fn(U)]`` over the unit cube.

    :param fn: tensor function ``f(u [m, dim]) -> y [m]``.
    :param n: points per shift (power of two; ``n_shifts * n`` evaluations).
    :param z: generating vector (default: CBC-built for ``(n, dim)``).
    :param use_tent: apply the baker's transform.
    :param mesh: a ``parallel.SampleMesh``: the R shifts split over its
        shards (R must divide by the shard count), each shard's estimates
        gathered in shard order; equal to the one-device run.
    :param device: where the points are made without a mesh (None: the
        current CUDA device).
    :return: dict with ``mean``, ``se`` (spread across shifts),
        ``per_shift`` [R], ``within_shift_var`` [R], ``z``, ``n``,
        ``n_shifts``.
    """
    dim, n, R = int(dim), int(n), int(n_shifts)
    if R < 2:
        raise ValueError("need >= 2 shifts for a standard error")
    if n & (n - 1):
        raise ValueError("n must be a power of two")
    if z is None:
        z = cbc_vector(n, dim, weights)
    z = np.asarray(z, np.int64)
    if z.shape != (dim,):
        raise ValueError("z must have shape [dim]")
    chunk = min(int(chunk_size), n)
    if n % chunk:
        raise ValueError("chunk_size must divide n")
    home = mesh.devices[0] if mesh is not None else resolve_device(device)
    shifts = random_shifts(seed, 0, R, dim, dtype, home)
    if mesh is None:
        s, s2 = _shift_sums(fn, z, n, chunk, shifts, use_tent, dtype)
    else:
        if R % mesh.n_devices:
            raise ValueError("n_shifts=%d must divide by the mesh's %d "
                             "devices" % (R, mesh.n_devices))
        parts = [_shift_sums(fn, z, n, chunk, sh, use_tent, dtype)
                 for sh in mesh.shard_batch(shifts)]
        s = mesh.gather([p[0] for p in parts])
        s2 = mesh.gather([p[1] for p in parts])
    means = (s / n).cpu().numpy()
    m2 = (s2 / n).cpu().numpy()
    if not np.all(np.isfinite(means)):
        raise FloatingPointError(
            "integrand produced non-finite values on the lattice; QMC "
            "points cannot be dropped without bias")
    # descriptive spread of fn over each shifted node set (the nodes are
    # correlated, so this is not an error estimate; `se` across shifts is)
    within = np.maximum(m2 - means * means, 0.0) * (n / max(n - 1, 1))
    return {"mean": float(means.mean()),
            "se": float(means.std(ddof=1) / np.sqrt(R)),
            "per_shift": means, "within_shift_var": within,
            "z": z, "n": n, "n_shifts": R}
