"""Owen-scrambled Sobol' sequences as tensor code (counterpart of
``mlmc_tpu/ops/sobol.py``): the point engine of the MLQMC driver
(``mlmc_tpu_torch.qmc``).

Point ``i`` of the sequence is ``XOR_{b set in gray(i)} v[:, b]``
(Antonov-Saleev Gray-code order, scipy's draw order bit for bit) over the
Joe-Kuo direction numbers that scipy ships (``scipy.stats.qmc.Sobol``,
21201 dimensions), read once on the host. Owen scrambling is the
hash-based nested-uniform scramble (Laine-Karras as refined by Burley,
2020): reverse the bits, apply a per-dimension seeded hash whose bit ``b``
depends only on bits ``<= b`` of its input, reverse back.

PyTorch has few uint32 operations, so 32-bit words live in int64 tensors
masked to 32 bits (as ``random/keyed`` and ``ops/cuda_kernels`` hold
them); the hash's wrapping multiplies take the low word from 16-bit
halves of the constant, never from a signed overflow.

Departure from ``mlmc_tpu``: the per-dimension scramble words come from
Philox keyed by (seed, level, randomization) (``scramble_seeds``), in
place of ``jax.random.bits`` of a JAX key. ``convert.mlqmc_from_jax``
carries a JAX run's words across.
"""
import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops.cuda_kernels import MASK32
from mlmc_tpu_torch.random.keyed import keyed_words

_MAXBIT = 30  # scipy's Joe-Kuo table stores 30-bit direction numbers

__all__ = [
    "direction_numbers", "sobol_bits", "sobol_uniforms", "sobol_normals",
    "owen_scramble", "scramble_seeds", "uniforms_from_bits",
    "normals_from_uniforms",
]


def direction_numbers(dim):
    """Joe-Kuo direction numbers for ``dim`` dimensions as a [dim, 32]
    uint32 matrix (numpy) scaled so points are ``bits * 2**-32``."""
    if dim < 1:
        raise ValueError("dim must be >= 1, got %r" % (dim,))
    from scipy.stats import qmc as _scipy_qmc

    sob = _scipy_qmc.Sobol(d=int(dim), scramble=False)
    sv = np.asarray(sob._sv, dtype=np.uint64)[:, :_MAXBIT]
    if int(sv.max()).bit_length() > _MAXBIT:
        raise RuntimeError("unexpected scipy Sobol table scale")
    dv = np.zeros((int(dim), 32), dtype=np.uint32)
    dv[:, :_MAXBIT] = (sv << (32 - _MAXBIT)).astype(np.uint32)
    return dv


def _words(x, device=None):
    """uint32 words (numpy or tensor) as an int64 tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int64) & MASK32
    return torch.as_tensor(np.asarray(x, dtype=np.int64), device=device) & MASK32


def _reverse_bits32(x):
    """The 32 bits of each word in reverse order (in-place steps on fresh
    tensors: half the memory traffic of the out-of-place form)."""
    for sh, m in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        y = (x >> sh) & m
        x = (x & m).bitwise_left_shift_(sh).bitwise_or_(y)
    return ((x << 16) & MASK32).bitwise_or_(x >> 16)


def _mul_lo(x, m):
    """Low 32 bits of ``x * m`` (x: int64 words, m: uint32 constant), from
    m's 16-bit halves: no product leaves int64."""
    hi = (x * (m >> 16)).bitwise_and_(0xFFFF).bitwise_left_shift_(16)
    return (x * (m & 0xFFFF)).add_(hi).bitwise_and_(MASK32)


def _laine_karras(x, seed):
    """Avalanche hash whose output bit b depends only on input bits <= b
    (plus the seed): a nested-uniform scramble in reversed-bit order
    (Burley 2020)."""
    x = (x + seed).bitwise_and_(MASK32)
    for m in (0x6C50B47C, 0xB82F1E52, 0xC7AFE638, 0x8D22F6E6):
        x.bitwise_xor_(_mul_lo(x, m))
    return x


def sobol_bits(dv, start, n, device=None):
    """Raw Sobol' integers: points ``start .. start+n`` of the sequence.

    :param dv: [d, 32] direction numbers (``direction_numbers``; numpy or
        an int64 tensor)
    :param start: first point index
    :param n: number of points
    :param device: where the points are made (None: the tensor ``dv``'s
        device, or the current CUDA device for a numpy ``dv``)
    :return: int64 tensor [n, d] of uint32 words, point = bits * 2**-32
    """
    device = resolve_device(device, like=dv)
    dv = _words(dv, device)
    start, n = int(start), int(n)
    # gray(hi + lo) = gray(hi) ^ gray(lo) for hi a multiple of 2^k and
    # lo < 2^k, and a point is XOR-linear in its Gray code: the points are
    # a table of the 2^k low parts XORed with a table of the few high parts
    k = max(min((n - 1).bit_length(), 16), 1) // 2 + 1
    lo_mask = (1 << k) - 1
    idx = (start + torch.arange(n, dtype=torch.int64, device=device)) & MASK32
    lo_table = _gray_points(dv, torch.arange(1 << k, dtype=torch.int64, device=device))
    if (start & MASK32) + n <= 1 << 32:        # the high parts run consecutively
        hi0 = (start & MASK32) >> k
        hi_vals = hi0 + torch.arange(((start & MASK32) + n - 1 >> k) - hi0 + 1 if n else 0,
                                     dtype=torch.int64, device=device)
        hi_pos = (idx >> k) - hi0
    else:                                       # the indices wrap past 2^32
        hi_vals, hi_pos = torch.unique(idx >> k, return_inverse=True)
    return _gray_points(dv, hi_vals << k)[hi_pos] ^ lo_table[idx & lo_mask]


def _gray_points(dv, idx):
    """The points of indices ``idx`` by the definition: XOR of the
    direction numbers of the set bits of gray(idx) ([len(idx), d])."""
    gray = idx ^ (idx >> 1)
    acc = torch.zeros((idx.shape[0], dv.shape[0]), dtype=torch.int64, device=idx.device)
    for b in range(32):
        take = ((gray >> b) & 1).bool()
        acc = acc ^ torch.where(take[:, None], dv[None, :, b], 0)
    return acc


def scramble_seeds(seed, level, n_randomizations, dim, device=None):
    """Per-dimension scramble words of ``n_randomizations`` independent
    scramblings of one level: Philox words of the identities (seed, level,
    randomization r), as ``random/keyed.keyed_words`` makes them.

    :return: int64 tensor [R, dim] of uint32 words
    """
    device = resolve_device(device)
    r = torch.arange(int(n_randomizations), dtype=torch.int64, device=device)
    words = keyed_words(seed, level, r, torch.zeros_like(r), -(-int(dim) // 4))
    return words[:, :int(dim)]


def owen_scramble(bits, seeds):
    """Owen-scramble raw Sobol' integers.

    :param bits: int64 [..., d] uint32 points
    :param seeds: int64 [d] (or broadcastable) per-dimension scramble words
    """
    x = _reverse_bits32(bits)
    x = _laine_karras(x, seeds)
    return _reverse_bits32(x)


def uniforms_from_bits(bits, dtype=torch.float32):
    """Map uint32 points to floats strictly inside (0, 1).

    float32 keeps the top 23 bits: ``top + 0.5`` with ``top < 2^23`` is
    exact, so the range is [2^-24, 1 - 2^-24] (keeping 24 bits would round
    ``(2^24 - 1) + 0.5`` up to ``2^24`` and give ``ndtri`` a 1.0). float64
    keeps all 32 bits.
    """
    if dtype == torch.float64:
        return (bits.to(torch.float64) + 0.5) * 2.0 ** -32
    top = (bits >> 9).to(torch.float32)
    return (top + 0.5) * 2.0 ** -23


def normals_from_uniforms(u):
    """Standard normals by the inverse CDF (one ``ndtri`` per point)."""
    return torch.special.ndtri(u)


def sobol_uniforms(dv, start, n, seeds=None, dtype=torch.float32, device=None):
    """Scrambled (or raw, if ``seeds`` is None) Sobol' uniforms [n, d]."""
    bits = sobol_bits(dv, start, n, device=device)
    if seeds is not None:
        bits = owen_scramble(bits, _words(seeds, bits.device))
    return uniforms_from_bits(bits, dtype=dtype)


def sobol_normals(dv, start, n, seeds=None, dtype=torch.float32, device=None):
    """Scrambled Sobol' standard normals [n, d]."""
    return normals_from_uniforms(sobol_uniforms(dv, start, n, seeds, dtype, device))
