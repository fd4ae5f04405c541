"""Philox4x32-10 and Box-Muller in plain PyTorch: the benchmark's own copy
of the counter-based stream that the program under test draws from.

A stream is named by a 64-bit key (the seed) and a four-word counter; a
call gives four uint32 words. The words map to normals by Box-Muller on
word pairs (w0, w1) and (w2, w3): the top 24 bits of each word, the first
word of a pair offset by half an ulp, f32 ``log``, ``sqrt``, ``cos`` and
``sin`` of 2 pi u2 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC11). uint32 words live in int64 tensors.
"""
import numpy as np
import torch

MASK32 = 0xFFFFFFFF
M0, M1 = 0xD2511F53, 0xCD9E8D57
W0, W1 = 0x9E3779B9, 0xBB67AE85
TWO_PI_F32 = float(np.float32(2.0 * np.pi))


def key_words(seed):
    """(low, high) uint32 words of a 64-bit seed."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return seed & MASK32, seed >> 32


def _mul_hi_lo(a, m):
    """(high, low) words of the 64-bit product of uint32 words ``a`` (int64
    tensor) and the constant ``m``, in 16-bit halves so that int64 holds it."""
    lo_part = a * (m & 0xFFFF)
    hi_part = a * (m >> 16)
    low = lo_part + ((hi_part & 0xFFFF) << 16)
    return (hi_part >> 16) + (low >> 32), low & MASK32


def philox(counter, key):
    """Ten rounds of Philox4x32 on four counter words (int64 tensors or
    ints) under a key of two uint32 words; returns the four output words."""
    c0, c1, c2, c3 = counter
    k0, k1 = key
    for rnd in range(10):
        if rnd:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mul_hi_lo(c0, M0)
        hi1, lo1 = _mul_hi_lo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def _sqrt_f32(a):
    """The correctly rounded f32 square root (through f64, which holds
    2 * 24 + 2 bits)."""
    return torch.sqrt(a.double()).float()


def box_muller(w_a, w_b):
    """(cosine branch, sine branch) f32 normals of a pair of words."""
    u1 = (w_a >> 8).float() * (1.0 / (1 << 24)) + (0.5 / (1 << 24))
    u2 = (w_b >> 8).float() * (1.0 / (1 << 24))
    radius = _sqrt_f32(-2.0 * torch.log(u1))
    angle = TWO_PI_F32 * u2
    return radius * torch.cos(angle), radius * torch.sin(angle)


def quad_normals(seed, level, start, n, device):
    """Normals of sample indices start .. start + n - 1 of ``level``: index
    i is slot i & 3 of the call with counter (q low, q high, level, 0),
    q = i >> 2; the slots are (cos, sin) of (w0, w1), then of (w2, w3)."""
    start, n = int(start), int(n)
    q = torch.arange(start >> 2, (start + n + 3) >> 2, dtype=torch.int64,
                     device=device)
    zero = torch.zeros_like(q)
    w = philox((q & MASK32, q >> 32, zero + int(level), zero), key_words(seed))
    z = torch.stack(box_muller(w[0], w[1]) + box_muller(w[2], w[3]), dim=1)
    return z.reshape(-1)[start & 3:(start & 3) + n]


def pair_normals(seed, level, indices, n_values):
    """``n_values`` normals per sample of ``indices`` (int64 tensor), first
    attempt: call j of sample i has counter (i low, i high, level, j) and
    gives the cosine branches of (w0, w1) and (w2, w3)."""
    key = key_words(seed)
    base = (indices & MASK32, indices >> 32, torch.full_like(indices, int(level)))
    out = []
    for j in range(-(-int(n_values) // 2)):
        w = philox(base + (torch.full_like(indices, j),), key)
        out += [box_muller(w[0], w[1])[0], box_muller(w[2], w[3])[0]]
    return torch.stack(out[:int(n_values)], dim=1)


#: bit 31 of the third counter word marks the per-sample wide streams
WIDE = 1 << 31
CALL_BITS = 20


def wide_normals(seed, level, indices, n_values, calls_per_block=1 << 22):
    """``n_values`` normals per sample (first attempt) from the wide stream:
    counter (i low, i high, WIDE | level, call), four normals per call
    (both branches of both pairs), for a sample of many numbers such as
    the white noise of a random field. Returns f32 [B, n_values]."""
    n_calls = -(-int(n_values) // 4)
    key = key_words(seed)
    calls = torch.arange(n_calls, dtype=torch.int64, device=indices.device)
    step = max(calls_per_block // n_calls, 1)
    parts = []
    for first in range(0, indices.shape[0], step):
        idx = indices[first:first + step, None]
        c3 = calls[None, :].expand(idx.shape[0], -1)
        w = philox(((idx & MASK32).expand_as(c3), (idx >> 32).expand_as(c3),
                    torch.full_like(c3, WIDE | int(level)), c3), key)
        z = torch.stack(box_muller(w[0], w[1]) + box_muller(w[2], w[3]), dim=-1)
        parts.append(z.reshape(idx.shape[0], -1)[:, :int(n_values)])
    return torch.cat(parts)
