"""Per-sample random numbers as a function of the sample's identity.

A simulation that needs many random numbers per sample (the phases of a
spectral force field, the white noise of a circulant embedding) draws them
from Philox4x32-10 with the pool's seed as key and the counter

    (index low word, index high word, WIDE | level, attempt << 20 | call)

``call`` numbers the sample's Philox calls (four 32-bit words each), so a
sample may take up to 2^20 calls = 2^22 numbers, on up to 2^12 attempts
(the attempt wraps past that). ``WIDE`` is bit 31 of the third word: the
other Philox streams of the port put the bare level there, so no counter
of this module equals one of theirs under the same seed, and two attempts
of one sample never share a counter. Those streams are the normals of
kernels A and B (``ops/cuda_kernels``: counter (q low word, q high word,
level, 0) for the quad q = index >> 2, four normals per call) and
``SynthSimulation.calculate_keyed_batch`` (counter (index low word, index
high word, level, attempt << 8 | j)); they share one counter per index q:
the synthetic simulation's call 0 of attempt 0 for sample q is kernel A's
call for samples 4q .. 4q + 3 of the same level.

The numbers depend on (seed, level, index, attempt) alone: how a level is
cut into batches does not change its samples. ``SampleKeys`` carries
that identity for a chunk of samples: it is what the drivers hand their
level functions in place of JAX's per-sample keys.
"""
from typing import NamedTuple

import torch

from mlmc_tpu_torch.ops.cuda_kernels import (
    MASK32, key_words, box_muller, philox4x32_10)

WIDE = 1 << 31
CALL_BITS = 20
ATTEMPT_MASK = (1 << (32 - CALL_BITS)) - 1
#: Philox calls evaluated at once (eight int64 temporaries of this size)
CALLS_PER_BLOCK = 1 << 24


def _word_blocks(seed, level_id, indices, attempts, n_calls, first_call=0):
    """Yield the Philox words [b, n_calls, 4] (int64 holding uint32) of
    consecutive blocks of samples, ``CALLS_PER_BLOCK`` calls at a time;
    the calls of a sample are ``first_call`` .. ``first_call + n_calls - 1``."""
    n_calls, first_call = int(n_calls), int(first_call)
    if not (1 <= n_calls and 0 <= first_call
            and first_call + n_calls <= 1 << CALL_BITS):
        raise ValueError("a sample takes 1 .. 2^%d Philox calls (numbered from "
                         "0), got %d from call %d" % (CALL_BITS, n_calls, first_call))
    key = key_words(seed)
    level_word = WIDE | (int(level_id) & (WIDE - 1))
    calls = torch.arange(first_call, first_call + n_calls, dtype=torch.int64,
                         device=indices.device)
    salt = (attempts & ATTEMPT_MASK) << CALL_BITS
    step = max(CALLS_PER_BLOCK // n_calls, 1)
    for start in range(0, indices.shape[0], step):
        idx = indices[start:start + step, None]
        c3 = salt[start:start + step, None] | calls[None, :]
        c0 = (idx & MASK32).expand_as(c3)
        c1 = (idx >> 32).expand_as(c3)
        c2 = torch.full_like(c3, level_word)
        yield torch.stack(philox4x32_10((c0, c1, c2, c3), key), dim=-1)


def _per_sample(blocks, convert, indices, n, dtype):
    """[B, n] numbers: ``convert`` applied block by block to the words."""
    parts = [convert(w).reshape(w.shape[0], -1)[:, :int(n)].to(dtype)
             for w in blocks]
    if not parts:
        return torch.empty(0, int(n), dtype=dtype, device=indices.device)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def keyed_words(seed, level_id, indices, attempts, n_calls, first_call=0):
    """The 4 * n_calls Philox words of each sample.

    :param indices: int64 tensor [B] of sample indices
    :param attempts: int64 tensor [B] of retry counts
    :param first_call: as in ``keyed_uniforms``
    :return: int64 tensor [B, 4 * n_calls] of uint32 words on the indices'
        device
    """
    return _per_sample(
        _word_blocks(seed, level_id, indices, attempts, n_calls, first_call),
        lambda w: w, indices, 4 * int(n_calls), torch.int64)


def _unit(bits):
    """Top 24 bits of uint32 words as float32 in [0, 1)."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def keyed_uniforms(seed, level_id, indices, attempts, n, dtype=torch.float32,
                   first_call=0):
    """``n`` uniforms in [0, 1) per sample: the top 24 bits of each word.

    :param first_call: the sample's first Philox call: draws of one sample
        that must not overlap take disjoint call ranges
    :return: tensor [B, n]
    """
    return _per_sample(
        _word_blocks(seed, level_id, indices, attempts, -(-int(n) // 4),
                     first_call),
        _unit, indices, n, dtype)


def _normal_pairs(words):
    """Box-Muller on word pairs [b, c, 4] -> [b, c, 2, 2] float32 normals
    (cosine and sine branch of each pair, ``ops/cuda_kernels.box_muller``)."""
    w = words.reshape(words.shape[0], -1, 2, 2)
    return torch.stack(box_muller(w[..., 0], w[..., 1]), dim=-1)


def keyed_normals(seed, level_id, indices, attempts, n, dtype=torch.float32,
                  first_call=0):
    """``n`` standard normals per sample: Box-Muller on word pairs, both
    the cosine and the sine branch (four normals per Philox call), computed
    in float32.

    :param first_call: as in ``keyed_uniforms``
    :return: tensor [B, n]
    """
    return _per_sample(
        _word_blocks(seed, level_id, indices, attempts, -(-int(n) // 4),
                     first_call),
        _normal_pairs, indices, n, dtype)


def keyed_call_normals(seed, level_id, indices, calls, dtype=torch.float32):
    """One normal per listed Philox call of each sample (first attempt):
    the first normal of call ``calls[j]`` (the cosine branch of its first
    word pair, as ``keyed_normals`` makes it).

    Calls run up to 2^32 - 1: a call at or past 2^20 takes the counter of
    a later attempt's call, so such long streams belong to samples that
    are never retried (the drivers' ``SampleKeys``, e.g. the inner draws of
    a nested expectation).

    :param calls: int64 tensor [n] of call numbers in [0, 2^32)
    :return: tensor [B, n]
    """
    calls = calls.to(device=indices.device, dtype=torch.int64)
    if calls.numel() and not (int(calls.min()) >= 0 and int(calls.max()) <= MASK32):
        raise ValueError("Philox calls are numbered 0 .. 2^32 - 1")
    c3 = calls[None, :].expand(indices.shape[0], -1)
    idx = indices[:, None].expand_as(c3)
    words = philox4x32_10((idx & MASK32, idx >> 32,
                           torch.full_like(c3, WIDE | (int(level_id) & (WIDE - 1))), c3),
                          key_words(seed))
    return box_muller(words[0], words[1])[0].to(dtype)


class SampleKeys(NamedTuple):
    """The identity of a chunk of samples (first attempts): the
    counterpart of JAX's keys ``fold_in(fold_in(key(seed), level), i)``.
    The indices' device is where the chunk runs."""

    seed: int
    level: int
    indices: torch.Tensor       # int64 [C]

    def normals(self, n, dtype=torch.float32):
        """``keyed_normals`` of the chunk's first attempts: [C, n]."""
        return keyed_normals(self.seed, self.level, self.indices,
                             torch.zeros_like(self.indices), n, dtype)
