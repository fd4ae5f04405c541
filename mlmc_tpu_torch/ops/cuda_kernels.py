"""Sample -> moment kernels on the GPU: synthetic samples (kernels A, B)
and stored QoI samples (kernels C and D).

Counterpart of ``mlmc_tpu/ops/pallas_kernels.py``. Each entry point takes
the same arguments as its Pallas twin plus a ``device`` (default: the
current CUDA device, or the device of a tensor input). On a CUDA device it
launches the hand-written kernels of ``csrc/synth_mlmc.cu`` and
``csrc/samples_mlmc.cu``; on the CPU it runs the plain PyTorch version of
the same computation. A CUDA call never falls back to the plain version:
if the kernel cannot be built or launched, it raises.

Kernel A (``synth_mlmc_cuda``) computes, for every level at once,

    sums   [L, R]     sum (phi_f - phi_c)       (phi_c = 0 on level 0)
    sums2  [L, R]     sum (phi_f - phi_c)^2
    cov_f  [L, R, R]  sum phi_f phi_f^T
    cov_c  [L, R, R]  sum phi_c phi_c^T
    n_valid [L]       exact count of valid samples

with per-sample values in f32 (the Pallas value path) and every sum in
f64. It either draws x ~ N(0, 1) in the kernel (RNG mode) or reads x from
memory (memory mode). Kernel B (``normals_dump_cuda``) writes the normals
that RNG mode draws, for statistical tests of the stream.

Kernel C (``samples_mlmc_cuda``) computes the same five accumulators from
stored fine/coarse QoI streams (``SampleStreams``): every (component,
level) stream in one launch, with the transform t = (x - a)·scale + ref_lo
and Legendre, monomial or Fourier rows in f32, as ``_samples_mlmc_kernel``
does. Its f64 twin, kernel D, is launched from ``ops/cuda_extended.py``;
``samples_moments`` is the one dispatcher of both tiers.

Random numbers: sample ``i`` of level ``l`` under ``seed`` is slot
``j = i & 3`` of Philox4x32-10 call ``q = i >> 2``, with key (seed low
word, seed high word) and counter (q low word, q high word, l, 0). Its
words w0..w3 feed Box-Muller with the bit map of mlmc_tpu's
``_normal_pair`` (top 24 bits, u1 offset by half an ulp; f32 ``log``,
``sqrt``, ``cos`` and ``sin`` of 2 pi u2): slots 0 and 1 are the cosine
and sine branch of (w0, w1), slots 2 and 3 those of (w2, w3). One call
gives four normals, as ``torch.randn``'s Philox does. A normal depends on
(seed, level, index) alone, so a level cut at any index (shards, resumed
ranges) draws the samples of the whole. The plain version
(``philox_normals``) maps indices to normals the same way: on the card
kernel B equals it bit for bit (the kernels use the f32 ``logf``,
``sinf`` and ``cosf`` that PyTorch's CUDA ``log``, ``sin`` and ``cos``
call, and a correctly rounded ``sqrtf``); on the CPU it differs in the
last bits of the transcendentals. ``random/keyed.py`` sets bit 31 of word
2 in every counter, so its streams never meet this one;
``SynthSimulation.calculate_keyed_batch`` does not, and its call 0 of
attempt 0 for sample index ``q`` is this stream's call ``q`` of the same
level (samples 4q .. 4q + 3).
"""
from typing import NamedTuple

import numpy as np
import torch

from mlmc_tpu_torch.device import cuda_device, resolve_device
from mlmc_tpu_torch.ops._build import load_library
from mlmc_tpu_torch.tool import profiling

R_PAD = 32  # largest supported moment count (as in the Pallas kernels)
#: samples per thread block of kernel A; ~1.5k blocks at 1e8 samples
SPAN = 1 << 16
#: samples per step of the plain version's chunk loop
PLAIN_CHUNK = 1 << 20

MASK32 = 0xFFFFFFFF
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85
_TWO_PI_F32 = float(np.float32(6.283185307179586))
_ERR_FLOOR_F32 = float(np.float32(1e-4))


class SynthMomentResult(NamedTuple):
    """Accumulators of one level ([R], [R], [R, R], [R, R], []) or, from
    the stacked internal calls, of all levels ([L, R], ..., [L])."""

    sums: torch.Tensor
    sums2: torch.Tensor
    cov_fine: torch.Tensor
    cov_coarse: torch.Tensor
    n_valid: torch.Tensor


# --------------------------------------------------------------------- #
# plain PyTorch version: Philox4x32-10 + Box-Muller
# --------------------------------------------------------------------- #
def _sqrt_f32(a):
    """Correctly rounded f32 square root, as the kernel's ``sqrtf``.
    PyTorch's CPU f32 ``sqrt`` is not always correctly rounded; the f64
    root rounded to f32 is (53 >= 2 * 24 + 2 bits)."""
    return torch.sqrt(a.to(torch.float64)).to(torch.float32)


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of ``a * m`` for int64 tensors holding uint32
    values and a uint32 constant, without overflowing int64."""
    p_lo = a * (m & 0xFFFF)
    p_hi = a * (m >> 16)
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & MASK32


def philox4x32_10(counter, key):
    """Philox4x32-10 (Salmon et al., Random123) on int64 tensors.

    :param counter: four int64 tensors (or ints) holding uint32 words
    :param key: two Python ints (uint32 words)
    :return: four int64 tensors holding the output uint32 words
    """
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd > 0:
            k0 = (k0 + PHILOX_W0) & MASK32
            k1 = (k1 + PHILOX_W1) & MASK32
        hi0, lo0 = _mulhilo(c0, PHILOX_M0)
        hi1, lo1 = _mulhilo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def box_muller(bits0, bits1):
    """The two standard normals of a pair of uint32 words, mapped as
    mlmc_tpu's ``_normal_pair``: top 24 bits, ``u1`` offset by half an
    ulp; f32.

    :return: (cosine branch, sine branch)
    """
    u1 = (bits0 >> 8).to(torch.float32) * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (bits1 >> 8).to(torch.float32) * (1.0 / (1 << 24))
    r = _sqrt_f32(-2.0 * torch.log(u1))
    angle = _TWO_PI_F32 * u2
    return r * torch.cos(angle), r * torch.sin(angle)


def key_words(seed):
    """The Philox key of a 64-bit seed: its (low, high) uint32 words."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def philox_normals(seed, level, start, n, *, device=None):
    """Plain version of the kernels' normal stream: normals of sample
    indices ``start .. start + n - 1`` of ``level`` under ``seed``, one
    Philox call per quad of indices (module docstring)."""
    start, n = int(start), int(n)
    quads = torch.arange(start >> 2, (start + n + 3) >> 2, dtype=torch.int64,
                         device=device)
    zero = torch.zeros_like(quads)
    w = philox4x32_10((quads & MASK32, quads >> 32, zero + int(level), zero),
                      key_words(seed))
    z = torch.stack(box_muller(w[0], w[1]) + box_muller(w[2], w[3]), dim=1)
    return z.reshape(-1)[start & 3:(start & 3) + n]


# --------------------------------------------------------------------- #
# plain PyTorch version: per-sample values and f64 sums
# --------------------------------------------------------------------- #
def _f32(value):
    """A Python float rounded to the nearest f32, as Pallas sees constants."""
    return float(np.float32(value))


def _domain_map(domain):
    a, b = float(domain[0]), float(domain[1])
    return _f32(2.0 / (b - a)), _f32((a + b) / 2.0)


def _basis_rows_plain(t, valid, n_moments, basis="legendre"):
    """Rows of ``pallas_kernels._basis_rows`` [n, R] in t's dtype: the
    Legendre three-term recurrence, monomial powers, or Fourier
    [1, cos, sin, ...] by angle addition; invalid samples give zero rows.

    Division is by 0-d tensors on the same device: PyTorch's CUDA
    division by a host scalar multiplies by its reciprocal, which is not
    the correctly rounded quotient the kernels compute."""
    t = torch.where(valid, t, torch.zeros_like(t))
    v = valid.to(t.dtype)
    rows = [v]
    if basis == "legendre":
        denoms = torch.arange(n_moments, dtype=t.dtype, device=t.device)
        if n_moments > 1:
            rows.append(t)
        prev2, prev1 = v, t
        for n in range(2, n_moments):
            cur = ((2 * n - 1) * t * prev1 - (n - 1) * prev2) / denoms[n]
            rows.append(cur)
            prev2, prev1 = prev1, cur
    elif basis == "monomial":
        power = v
        for _ in range(1, n_moments):
            power = power * t
            rows.append(power)
    else:
        c1, s1 = torch.cos(t) * v, torch.sin(t) * v
        ck, sk = c1, s1
        for i in range(1, n_moments):
            if i % 2 == 1:
                rows.append(ck)
            else:
                rows.append(sk)
                ck, sk = ck * c1 - sk * s1, sk * c1 + ck * s1
    return torch.stack(rows, dim=1)


def _row_sums(pf, pc, absolute=False):
    """(sum d, sum d^2, pf^T pf, pc^T pc) in f64 of [n, R] rows, with
    d = pf - pc, or d = pf where there is no coarse part (pc None).

    :param absolute: sum the absolute values of the terms instead (the
        S_abs that scales the error bounds of ``ops/precision.py``)
    """
    pf = pf.to(torch.float64)
    pc = None if pc is None else pc.to(torch.float64)
    d = pf if pc is None else pf - pc
    if absolute:
        d, pf = d.abs(), pf.abs()
        pc = None if pc is None else pc.abs()
    cov_c = pc.T @ pc if pc is not None else torch.zeros(
        pf.shape[1], pf.shape[1], dtype=torch.float64, device=pf.device)
    return d.sum(0), (d * d).sum(0), pf.T @ pf, cov_c


def synth_qoi(x, fine_step, coarse_step):
    """The synthetic simulation's (fine, coarse) QoIs x + h sqrt(1e-4 + |x|)
    of normals ``x`` in f32, as kernel A computes them: steps and floor
    rounded to f32, the correctly rounded f32 square root.

    :return: (fine, coarse) float32 tensors shaped as ``x``
    """
    x = x.to(torch.float32)
    err = _sqrt_f32(_ERR_FLOOR_F32 + torch.abs(x))
    return x + _f32(fine_step) * err, x + _f32(coarse_step) * err


def level_moments_plain(x, n_moments, *, fine_step, coarse_step, has_coarse,
                        domain, absolute=False):
    """Plain version of kernel A's body for one block of samples ``x``.

    :param absolute: sum the absolute values of the terms instead (S_abs)
    :return: (sums, sums2, cov_f, cov_c) float64 and n_valid int64
    """
    t_scale, t_shift = _domain_map(domain)
    fine, coarse = synth_qoi(x, fine_step, coarse_step)
    t_f = (fine - t_shift) * t_scale
    t_c = (coarse - t_shift) * t_scale
    valid = (t_f >= -1.0) & (t_f <= 1.0)
    if has_coarse:
        valid = valid & (t_c >= -1.0) & (t_c <= 1.0)
    pf = _basis_rows_plain(t_f, valid, n_moments)
    pc = _basis_rows_plain(t_c, valid, n_moments) if has_coarse else None
    return _row_sums(pf, pc, absolute) + (valid.sum().to(torch.int64),)


def synth_mlmc_plain(x_levels, seed, n_per_level, fine_steps, coarse_steps,
                     has_coarse, n_moments, *, domain, device, absolute=False,
                     starts=None):
    """Plain version of kernel A for all levels; stacked SynthMomentResult.

    :param x_levels: per-level f32 tensors (memory mode) or None (draw the
        normals of ``seed``, as RNG mode does)
    :param absolute: return the sums of absolute terms (S_abs) instead
    :param starts: RNG mode: the first sample index of each level
        (default 0): level l draws indices starts[l] .. starts[l] + n_l - 1
    """
    L = len(n_per_level)
    R = n_moments
    f64 = dict(dtype=torch.float64, device=device)
    sums = torch.zeros(L, R, **f64)
    sums2 = torch.zeros(L, R, **f64)
    cov_f = torch.zeros(L, R, R, **f64)
    cov_c = torch.zeros(L, R, R, **f64)
    n_valid = torch.zeros(L, dtype=torch.int64, device=device)
    for lvl in range(L):
        n = int(n_per_level[lvl])
        first = 0 if starts is None else int(starts[lvl])
        for start in range(0, n, PLAIN_CHUNK):
            m = min(PLAIN_CHUNK, n - start)
            if x_levels is None:
                x = philox_normals(seed, lvl, first + start, m, device=device)
            else:
                x = x_levels[lvl][start:start + m]
            s, s2, cf, cc, nv = level_moments_plain(
                x, R, fine_step=fine_steps[lvl], coarse_step=coarse_steps[lvl],
                has_coarse=has_coarse[lvl], domain=domain, absolute=absolute)
            sums[lvl] += s
            sums2[lvl] += s2
            cov_f[lvl] += cf
            cov_c[lvl] += cc
            n_valid[lvl] += nv
    return SynthMomentResult(sums, sums2, cov_f, cov_c, n_valid)


# --------------------------------------------------------------------- #
# CUDA kernel wrappers
# --------------------------------------------------------------------- #
def _tile_schedule(n_moments, has_coarse=True):
    """Output tiles of kernels A, C and D (csrc/moment_gram.cuh): the 16x8
    tiles (P, J), 2P <= J < ceil(R / 8), that cover the upper triangle of
    each Gram, coded gram << 16 | P << 8 | J (gram 0 fine, 1 coarse), the
    fine Gram's first. A fine-only schedule is the prefix of the full one:
    a block without a coarse part runs only those tiles. The reduction
    writes entry (i, j) of tile (P, J) to cov[a, b] and cov[b, a],
    a = 16P + i, b = 8J + j, where a <= b < R."""
    nb = -(-int(n_moments) // 8)
    tiles = [(p, j) for p in range((nb + 1) // 2) for j in range(2 * p, nb)]
    return np.asarray([(g << 16) | (p << 8) | j
                       for g in range(2 if has_coarse else 1)
                       for p, j in tiles], dtype=np.int32)


def _gram_partial_size(codes):
    """Doubles of one block's partial row: 128 per scheduled tile, then
    sum(d) and sum(d^2) padded to R_PAD each."""
    return codes.shape[0] * 128 + 2 * R_PAD


def _block_tables(n_per_level, x_offsets, has_coarse, span=SPAN, starts=None):
    """Per-block (level, start, count, x offset) and per-level (first
    block, block count); a zero-sample level keeps one empty block, so
    its outputs are written as zeros. The blocks of levels with a coarse
    part come first: they cost about twice as much as fine-only blocks,
    and started last they would leave the card's last wave half empty.
    ``starts`` offsets each level's sample indices (the RNG counter;
    default 0), not its x offsets.

    Whole-array numpy in int64 (starts pass 2^34): the cost of a table of
    tens of thousands of blocks is that of a few array operations."""
    L = len(n_per_level)
    order = sorted(range(L), key=lambda lvl: not has_coarse[lvl])
    rows = np.array([(lvl, 0 if starts is None else int(starts[lvl]),
                      int(n_per_level[lvl]), int(x_offsets[lvl])) for lvl in order],
                    dtype=np.int64).reshape(L, 4)
    n_blk = np.maximum(-(-rows[:, 2] // span), 1)
    first_blk = np.cumsum(n_blk) - n_blk
    blocks = np.repeat(rows, n_blk, axis=0)          # a level's row per block
    start = (np.arange(blocks.shape[0], dtype=np.int64)
             - np.repeat(first_blk, n_blk)) * span
    blocks[:, 1] += start
    blocks[:, 3] += start
    np.clip(blocks[:, 2] - start, 0, span, out=blocks[:, 2])
    lvl_blocks = np.empty((L, 2), np.int64)
    lvl_blocks[order] = np.stack([first_blk, n_blk], axis=1)
    return blocks, lvl_blocks


def _check(code, what):
    if code != 0:
        raise RuntimeError("%s: CUDA error %d" % (what, code))


def synth_mlmc_cuda(x, seed, n_per_level, fine_steps, coarse_steps,
                    has_coarse, n_moments, *, domain, device, starts=None):
    """Launch kernel A (and its per-level reduction) on ``device``.

    :param x: flat f32 CUDA tensor of all levels' samples, level after
        level (memory mode), or None (RNG mode)
    :param starts: RNG mode: the first sample index of each level (the
        Philox counter of its first sample; default 0)
    :return: stacked SynthMomentResult (float64, int64 counts)
    """
    with profiling.span("fused.prepare"):
        device = cuda_device(device)
        lib = load_library("synth_mlmc")
        L, R = len(n_per_level), int(n_moments)
        if x is not None:
            if x.device != device or x.dtype != torch.float32 \
                    or not x.is_contiguous():
                raise ValueError("x must be a contiguous float32 tensor on %s"
                                 % device)
            if x.numel() != sum(int(n) for n in n_per_level):
                raise ValueError("x holds %d samples, levels need %d"
                                 % (x.numel(), sum(int(n) for n in n_per_level)))
        offsets = np.concatenate([[0], np.cumsum([int(n) for n in n_per_level])])
        with profiling.span("kernels.tables"):
            blocks, lvl_blocks = _block_tables(n_per_level, offsets[:-1],
                                               has_coarse, starts=starts)
        lvl = np.asarray([(_f32(f), _f32(c), 1.0 if h else 0.0) for f, c, h in
                          zip(fine_steps, coarse_steps, has_coarse)],
                         dtype=np.float32)
        codes = _tile_schedule(R)
        t_scale, t_shift = _domain_map(domain)
        k0, k1 = key_words(seed)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        blk_d, lvl_d, lb_d, codes_d = (dev(blocks), dev(lvl), dev(lvl_blocks),
                                       dev(codes))
        n_blk, n_codes = blocks.shape[0], codes.shape[0]
        partial = torch.empty(n_blk, _gram_partial_size(codes),
                              dtype=torch.float64, device=device)
        partial_n = torch.empty(n_blk, dtype=torch.int64, device=device)
        sums = torch.empty(L, R, dtype=torch.float64, device=device)
        sums2 = torch.empty(L, R, dtype=torch.float64, device=device)
        cov_f = torch.empty(L, R, R, dtype=torch.float64, device=device)
        cov_c = torch.empty(L, R, R, dtype=torch.float64, device=device)
        n_valid = torch.empty(L, dtype=torch.int64, device=device)
    # the C launcher runs on the current device: make it ``device``
    with profiling.span("fused.launch"), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib.synth_mlmc_launch(
            None if x is None else x.data_ptr(), blk_d.data_ptr(), n_blk,
            lvl_d.data_ptr(), lb_d.data_ptr(), L, codes_d.data_ptr(), n_codes,
            R, t_scale, t_shift, k0, k1, partial.data_ptr(),
            partial_n.data_ptr(), sums.data_ptr(), sums2.data_ptr(),
            cov_f.data_ptr(), cov_c.data_ptr(), n_valid.data_ptr(), stream),
            "synth_mlmc kernel")
    synth_mlmc_cuda.launches += 1
    return SynthMomentResult(sums, sums2, cov_f, cov_c, n_valid)


synth_mlmc_cuda.launches = 0


def normals_dump_cuda(seed, n_samples, *, level=0, start=0, device):
    """Launch kernel B: the RNG-mode normals of ``level`` on ``device``.

    The result is a view that starts ``start & 3`` floats into its buffer,
    so that every whole quad of the stream lands on a 16-byte boundary and
    the kernel stores it with one vector store."""
    device = cuda_device(device)
    lib = load_library("synth_mlmc")
    head = int(start) & 3
    out = torch.empty(int(n_samples) + head, dtype=torch.float32,
                      device=device)[head:]
    k0, k1 = key_words(seed)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(lib.normals_dump_launch(out.data_ptr(), int(n_samples),
                                       int(start), int(level), k0, k1, stream),
               "normals_dump kernel")
    normals_dump_cuda.launches += 1
    return out


normals_dump_cuda.launches = 0


# --------------------------------------------------------------------- #
# stored samples: kernel C (f32 values, f64 sums) and its plain version
# --------------------------------------------------------------------- #
#: samples per thread block of kernels C and D
SAMPLES_SPAN = 1 << 14
#: basis codes of csrc/samples_mlmc.cu
BASES = {"legendre": 0, "monomial": 1, "fourier": 2}


class SampleStreams(NamedTuple):
    """Stored QoI streams packed for kernels C and D: stream ``s`` holds
    ``counts[s]`` samples at ``fine[offsets[s]:]`` and, where
    ``has_coarse[s]``, at ``coarse[offsets[s]:]`` (f32, one device)."""

    fine: torch.Tensor
    coarse: torch.Tensor
    offsets: tuple
    counts: tuple
    has_coarse: tuple


def pack_streams(fine_streams, coarse_streams, has_coarse):
    """Concatenate per-stream 1-D tensors (one device) into SampleStreams;
    a stream without a coarse part (None) gets zeros in ``coarse``."""
    counts = tuple(int(f.numel()) for f in fine_streams)
    offsets = tuple(int(o) for o in np.concatenate([[0], np.cumsum(counts)])[:-1])
    fine = torch.cat([f.reshape(-1).to(torch.float32) for f in fine_streams])
    coarse = torch.cat([
        torch.zeros_like(f, dtype=torch.float32).reshape(-1) if c is None
        else c.reshape(-1).to(torch.float32)
        for f, c in zip(fine_streams, coarse_streams)])
    return SampleStreams(fine, coarse, offsets, counts,
                         tuple(bool(h) for h in has_coarse))


def transform_constants(domain, ref_domain=(-1.0, 1.0), *, f64=False,
                        symmetric=False):
    """(scale, shift, offset, lo, hi) of ``t = (x - shift) * scale + offset``
    and the validity test ``lo <= t <= hi``.

    f32 (kernel C): the constants of ``Moments.linear`` rounded to f32, as
    the Pallas kernel and ``Estimate._harmonize_validity`` use them. f64
    (kernel D): the f64 constants; ``symmetric`` shifts by the midpoint
    (a + b) / 2 with offset 0, the transform of the strict f64 reference.
    """
    a, b = float(domain[0]), float(domain[1])
    lo, hi = float(ref_domain[0]), float(ref_domain[1])
    scale = (hi - lo) / (b - a)
    shift, offset = ((a + b) / 2.0, 0.0) if symmetric else (a, lo)
    consts = (scale, shift, offset, lo, hi)
    return consts if f64 else tuple(_f32(c) for c in consts)


def _check_basis(basis, n_moments):
    if basis not in BASES:
        raise ValueError("unknown basis %r" % (basis,))
    if not 1 <= n_moments <= R_PAD:
        raise ValueError("n_moments must be in [1, %d], got %d"
                         % (R_PAD, n_moments))


def samples_plain(streams, n_moments, *, basis, consts, f64=False,
                  absolute=False):
    """Plain version of kernels C (``f64=False``: transform and rows in
    f32) and D (in f64); sums in f64.

    :param consts: ``transform_constants`` of the call
    :param absolute: return the sums of absolute terms (S_abs) instead
    :return: stacked SynthMomentResult [S, ...] on the streams' device
    """
    dtype = torch.float64 if f64 else torch.float32
    scale, shift, offset, lo, hi = consts
    S, R = len(streams.counts), int(n_moments)
    device = streams.fine.device
    f64_kw = dict(dtype=torch.float64, device=device)
    out = SynthMomentResult(
        torch.zeros(S, R, **f64_kw), torch.zeros(S, R, **f64_kw),
        torch.zeros(S, R, R, **f64_kw), torch.zeros(S, R, R, **f64_kw),
        torch.zeros(S, dtype=torch.int64, device=device))

    def transform(x):
        return (x.to(dtype) - shift) * scale + offset

    for s, (off, n, hc) in enumerate(zip(streams.offsets, streams.counts,
                                         streams.has_coarse)):
        for start in range(0, n, PLAIN_CHUNK):
            sl = slice(off + start, off + min(start + PLAIN_CHUNK, n))
            t_f = transform(streams.fine[sl])
            valid = (t_f >= lo) & (t_f <= hi)
            if hc:
                t_c = transform(streams.coarse[sl])
                valid = valid & (t_c >= lo) & (t_c <= hi)
            pf = _basis_rows_plain(t_f, valid, R, basis)
            pc = _basis_rows_plain(t_c, valid, R, basis) if hc else None
            for field, value in zip(out[:4], _row_sums(pf, pc, absolute)):
                field[s] += value
            out.n_valid[s] += valid.sum()
    return out


def samples_launch(fn_name, streams, n_moments, basis, consts, device):
    """Launch kernel C or D (``fn_name``, its C symbol) and its per-stream
    reduction; ``samples_mlmc_cuda`` and ``cuda_extended.samples_ext_cuda``
    count their launches over it."""
    device = cuda_device(device)
    lib = load_library("samples_mlmc")
    for x in (streams.fine, streams.coarse):
        if x.device != device or x.dtype != torch.float32 \
                or not x.is_contiguous():
            raise ValueError("streams must be contiguous float32 tensors on %s"
                             % device)
    S, R = len(streams.counts), int(n_moments)
    if S == 0:
        raise ValueError("no streams to reduce")
    if streams.coarse.numel() != streams.fine.numel() or any(
            o < 0 or n < 0 or o + n > streams.fine.numel()
            for o, n in zip(streams.offsets, streams.counts)):
        raise ValueError("stream offsets/counts exceed the packed buffers")
    with profiling.span("kernels.tables"):
        blocks, stream_blocks = _block_tables(streams.counts, streams.offsets,
                                              streams.has_coarse,
                                              span=SAMPLES_SPAN)
    hasc = np.asarray([1 if h else 0 for h in streams.has_coarse], np.int32)
    codes = _tile_schedule(R)

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    blk_d, sb_d, hasc_d, codes_d = (dev(blocks), dev(stream_blocks),
                                    dev(hasc), dev(codes))
    n_blk, n_codes = blocks.shape[0], codes.shape[0]
    partial = torch.empty(n_blk, _gram_partial_size(codes),
                          dtype=torch.float64, device=device)
    partial_n = torch.empty(n_blk, dtype=torch.int64, device=device)
    out = SynthMomentResult(
        torch.empty(S, R, dtype=torch.float64, device=device),
        torch.empty(S, R, dtype=torch.float64, device=device),
        torch.empty(S, R, R, dtype=torch.float64, device=device),
        torch.empty(S, R, R, dtype=torch.float64, device=device),
        torch.empty(S, dtype=torch.int64, device=device))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _check(getattr(lib, fn_name)(
            streams.fine.data_ptr(), streams.coarse.data_ptr(),
            blk_d.data_ptr(), n_blk, hasc_d.data_ptr(), sb_d.data_ptr(), S,
            codes_d.data_ptr(), n_codes, R, BASES[basis], *consts,
            partial.data_ptr(), partial_n.data_ptr(),
            *(field.data_ptr() for field in out), stream), fn_name)
    return out


def samples_mlmc_cuda(streams, n_moments, *, basis, consts, device):
    """Launch kernel C: every stream's accumulators in one launch.

    :param consts: f32 ``transform_constants``
    :return: stacked SynthMomentResult [S, ...] (float64, int64 counts)
    """
    out = samples_launch("samples_mlmc_launch", streams, n_moments, basis,
                         consts, device)
    samples_mlmc_cuda.launches += 1
    return out


samples_mlmc_cuda.launches = 0


def samples_mlmc_plain(streams, n_moments, *, basis, consts, absolute=False):
    """Plain version of kernel C (f32 transform and rows, f64 sums)."""
    return samples_plain(streams, n_moments, basis=basis, consts=consts,
                         absolute=absolute)


def samples_moments(streams, n_moments, *, domain, ref_domain=(-1.0, 1.0),
                    basis="legendre", f64=False, symmetric=False):
    """The one way from packed streams to kernels C and D: kernel C (the
    f32 tier) or, with ``f64``, kernel D (the f64 tier; ``symmetric``
    selects the strict reference's transform) for streams on a CUDA
    device, their plain version for streams on the CPU.

    :return: stacked SynthMomentResult [S, ...]
    """
    _check_basis(basis, n_moments)
    if symmetric and not f64:
        raise ValueError("the symmetric transform is the f64 tier's")
    consts = transform_constants(domain, ref_domain, f64=f64,
                                 symmetric=symmetric)
    if streams.fine.device.type != "cuda":
        return samples_plain(streams, n_moments, basis=basis, consts=consts,
                             f64=f64)
    if f64:  # kernel D's launcher imports this module
        from mlmc_tpu_torch.ops.cuda_extended import samples_ext_cuda as launch
    else:
        launch = samples_mlmc_cuda
    return launch(streams, n_moments, basis=basis, consts=consts,
                  device=streams.fine.device)


def launch_counts():
    """Launches of each kernel of this module since the last reset."""
    return {"synth_mlmc": synth_mlmc_cuda.launches,
            "normals_dump": normals_dump_cuda.launches,
            "samples_mlmc": samples_mlmc_cuda.launches}


def reset_launch_counts():
    synth_mlmc_cuda.launches = 0
    normals_dump_cuda.launches = 0
    samples_mlmc_cuda.launches = 0


# --------------------------------------------------------------------- #
# public entry points (mlmc_tpu.ops.pallas_kernels names)
# --------------------------------------------------------------------- #
def _synth_levels(x_levels, seed, n_per_level, fine_steps, coarse_steps,
                  has_coarse, n_moments, domain, device, starts=None):
    """Dispatch on the device: kernel A on CUDA, the plain version on CPU."""
    if not 1 <= n_moments <= R_PAD:
        raise ValueError("n_moments must be in [1, %d], got %d"
                         % (R_PAD, n_moments))
    if device.type == "cuda":
        x = None if x_levels is None else torch.cat(
            [xl.reshape(-1) for xl in x_levels]).contiguous()
        return synth_mlmc_cuda(x, seed, n_per_level, fine_steps, coarse_steps,
                               has_coarse, n_moments, domain=domain,
                               device=device, starts=starts)
    return synth_mlmc_plain(x_levels, seed, n_per_level, fine_steps,
                            coarse_steps, has_coarse, n_moments,
                            domain=domain, device=device, starts=starts)


def _per_level(stacked):
    return [SynthMomentResult(*(field[lvl] for field in stacked))
            for lvl in range(stacked.sums.shape[0])]


def _ladder(level_steps):
    fine = [float(h) for h in level_steps]
    coarse = [0.0] + fine[:-1]
    has_coarse = [lvl > 0 for lvl in range(len(fine))]
    return fine, coarse, has_coarse


def synth_mlmc_pipeline(seed, n_moments, n_per_level, level_steps, *,
                        domain, device=None, starts=None):
    """The whole multi-level synthetic estimate in one kernel launch.

    :param seed: integer seed of the Philox stream
    :param n_per_level: per-level sample counts
    :param level_steps: fine steps; level l's coarse step is
        level_steps[l-1] and level 0 has no coarse part
    :param domain: moment domain (a, b) mapped onto [-1, 1]
    :param starts: the first sample index of each level (default 0):
        level l reduces samples starts[l] .. starts[l] + n_l - 1 of its
        stream, so a level split into index ranges (the shards of a
        sample mesh) draws the samples of the whole
    :return: list of SynthMomentResult (float64 sums, int64 n_valid)
    """
    if len(n_per_level) != len(level_steps):
        raise ValueError(
            "n_per_level has %d entries but level_steps has %d"
            % (len(n_per_level), len(level_steps)))
    if starts is not None and len(starts) != len(level_steps):
        raise ValueError("starts has %d entries but level_steps has %d"
                         % (len(starts), len(level_steps)))
    fine, coarse, has_coarse = _ladder(level_steps)
    return _per_level(_synth_levels(
        None, seed, [int(n) for n in n_per_level], fine, coarse, has_coarse,
        int(n_moments), domain, resolve_device(device), starts=starts))


def as_f32_tensor(x, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32).reshape(-1)
    return torch.as_tensor(np.asarray(x, dtype=np.float32).reshape(-1),
                           device=device)


def synth_mlmc_pipeline_from_noise(noise_per_level, n_moments, level_steps, *,
                                   domain, device=None):
    """Memory mode of kernel A: level l's x values come from
    ``noise_per_level[l]`` instead of the in-kernel generator.

    :param device: defaults to the device of the first tensor (the current
        CUDA device for numpy input)
    :return: list of SynthMomentResult, one per level
    """
    if len(noise_per_level) != len(level_steps):
        raise ValueError(
            "noise_per_level has %d entries but level_steps has %d"
            % (len(noise_per_level), len(level_steps)))
    device = resolve_device(device, like=noise_per_level[0])
    xs = [as_f32_tensor(x, device) for x in noise_per_level]
    fine, coarse, has_coarse = _ladder(level_steps)
    return _per_level(_synth_levels(
        xs, 0, [x.numel() for x in xs], fine, coarse, has_coarse,
        int(n_moments), domain, device))


def synth_moment_pipeline(seed, n_moments, n_samples, *, fine_step,
                          coarse_step, domain, is_level0=False, device=None):
    """One level (the Pallas single-level entry point): an L=1 call of
    kernel A drawing level 0's stream of ``seed``.

    :param is_level0: no coarse part (dphi = phi_f, cov_coarse = 0)
    :return: SynthMomentResult
    """
    return _per_level(_synth_levels(
        None, seed, [int(n_samples)], [float(fine_step)], [float(coarse_step)],
        [not is_level0], int(n_moments), domain, resolve_device(device)))[0]


def synth_moment_pipeline_from_noise(noise, n_moments, *, fine_step,
                                     coarse_step, domain, is_level0=False,
                                     device=None):
    """Memory mode of kernel A for one level (x read from ``noise``).

    :return: SynthMomentResult
    """
    device = resolve_device(device, like=noise)
    x = as_f32_tensor(noise, device)
    return _per_level(_synth_levels(
        [x], 0, [x.numel()], [float(fine_step)], [float(coarse_step)],
        [not is_level0], int(n_moments), domain, device))[0]


def synth_normals(seed, n_samples, *, level=0, start=0, device=None):
    """The normals that RNG mode draws for ``level`` (kernel B on CUDA).

    :return: float32 tensor [n_samples]
    """
    device = resolve_device(device)
    if device.type == "cuda":
        return normals_dump_cuda(seed, n_samples, level=level, start=start,
                                 device=device)
    return philox_normals(seed, level, start, n_samples, device=device)


def level_stream(fine, coarse, *, is_level0, device=None):
    """One level's stored QoIs as one f32 stream for kernels C and D.

    :param fine/coarse: [N] arrays or tensors (coarse ignored, and may be
        None, for level 0)
    :param device: defaults to the device of ``fine`` (the current CUDA
        device for numpy input)
    """
    device = resolve_device(device, like=fine)
    f = as_f32_tensor(fine, device)
    c = None if is_level0 or coarse is None else as_f32_tensor(coarse, device)
    return pack_streams([f], [c], [not is_level0])


def moment_pipeline_from_samples(fine, coarse, n_moments, *, domain,
                                 ref_domain=(-1.0, 1.0), basis="legendre",
                                 is_level0=False, device=None):
    """Moment accumulators of one stream of stored QoIs: an L=1 call of
    kernel C. NaN and out-of-domain samples are dropped.

    :param fine/coarse: [N] arrays or tensors (coarse ignored, and may be
        None, for level 0)
    :param ref_domain: the basis' reference domain (clip bounds)
    :param device: defaults to the device of ``fine`` (the current CUDA
        device for numpy input)
    :return: SynthMomentResult (float64 sums, int64 n_valid)
    """
    streams = level_stream(fine, coarse, is_level0=is_level0, device=device)
    return _per_level(samples_moments(streams, int(n_moments), domain=domain,
                                      ref_domain=ref_domain, basis=basis))[0]


def _pow2_chunks(n, chunk):
    """Chunks of a packed stream: a power of two >= ceil(n / chunk), >= 1."""
    return 1 << (max(-(-int(n) // chunk), 1) - 1).bit_length()


def pack_level_samples(level_fine, level_coarse, chunk=16384):
    """Concatenate per-level QoI arrays, NaN-padding each level to a
    power-of-two number of chunks (the layout of
    ``mlmc_moment_pipeline_from_samples``). Tensors stay on their device;
    numpy inputs stay numpy.

    :return: (fine [total_pad], coarse [total_pad], n_per_level tuple)
    """
    on_torch = any(isinstance(f, torch.Tensor) for f in level_fine)
    f_parts, c_parts, counts = [], [], []
    for f, c in zip(level_fine, level_coarse):
        if on_torch:
            f = torch.as_tensor(f, dtype=torch.float32).reshape(-1)
            c = torch.zeros_like(f) if c is None else torch.as_tensor(
                c, dtype=torch.float32, device=f.device).reshape(-1)
            pad = torch.full((_pow2_chunks(f.numel(), chunk) * chunk
                              - f.numel(),), float("nan"), dtype=torch.float32,
                             device=f.device)
            f_parts += [f, pad]
            c_parts += [c, pad]
        else:
            f = np.asarray(f, dtype=np.float32).reshape(-1)
            c = np.zeros_like(f) if c is None else np.asarray(
                c, dtype=np.float32).reshape(-1)
            pad = _pow2_chunks(f.size, chunk) * chunk - f.size
            f_parts.append(np.pad(f, (0, pad), constant_values=np.nan))
            c_parts.append(np.pad(c, (0, pad), constant_values=np.nan))
        counts.append(int(f.shape[0]))
    cat = torch.cat if on_torch else np.concatenate
    return cat(f_parts), cat(c_parts), tuple(counts)


def mlmc_moment_pipeline_from_samples(fine, coarse, n_per_level, n_moments,
                                      *, domain, ref_domain=(-1.0, 1.0),
                                      basis="legendre", chunk=16384,
                                      has_coarse=None, device=None):
    """All levels (or (component, level) streams) of a stored-sample
    moment estimate in one kernel C launch.

    :param fine/coarse: the packed buffers of ``pack_level_samples``
    :param n_per_level: true per-stream counts
    :param has_coarse: per-stream coarse flags; default: every level but
        level 0
    :param device: defaults to the device of ``fine`` (the current CUDA
        device for numpy input)
    :return: list of SynthMomentResult, one per stream
    """
    counts = [int(n) for n in n_per_level]
    if has_coarse is None:
        has_coarse = [lvl > 0 for lvl in range(len(counts))]
    if len(has_coarse) != len(counts):
        raise ValueError("has_coarse has %d entries but n_per_level has %d"
                         % (len(has_coarse), len(counts)))
    sizes = [_pow2_chunks(n, chunk) * chunk for n in counts]
    device = resolve_device(device, like=fine)
    f = as_f32_tensor(fine, device)
    c = as_f32_tensor(coarse, device)
    if f.numel() != sum(sizes) or c.numel() != sum(sizes):
        raise ValueError("packed buffers hold %d samples, the chunk layout "
                         "needs %d" % (f.numel(), sum(sizes)))
    offsets = tuple(int(o) for o in np.concatenate([[0], np.cumsum(sizes)])[:-1])
    streams = SampleStreams(f.contiguous(), c.contiguous(), offsets,
                            tuple(counts), tuple(bool(h) for h in has_coarse))
    return _per_level(samples_moments(streams, int(n_moments), domain=domain,
                                      ref_domain=ref_domain, basis=basis))
