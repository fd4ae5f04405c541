"""Nested-expectation MLMC: EVPPI and conditional-expectation functionals
(counterpart of ``mlmc_tpu/nested.py``).

Quantities ``theta = E_Y[ g( E_X[ f(X, Y) | Y ] ) ]`` take MLMC over the
inner sample count (Giles, "MLMC for nested expectations", 2018; Giles &
Goda, Stat. Comput. 29, 2019): level l gives each outer sample ``N_l = n0
2^l`` inner draws, and the antithetic correction

    ``Delta_l = g(mean of N_l) - (g(mean of first half)
                                  + g(mean of second half)) / 2``

uses the same inner draws in both terms. The functions follow the
``fn(level, keys) -> Delta_l [C]`` contract of ``UnbiasedMLMC`` (and the
value form ``f(alpha, keys)`` of a multi-index driver).

Contract: ``inner_fn(keys, offsets) -> [C, n]`` (or ``[C, n, D]`` for
several decisions), with ``keys`` a ``random.keyed.SampleKeys`` of the C
outer samples and ``offsets`` an int64 tensor [n]: the outer scenario
derives from the sample's identity, inner draw j from its keyed Philox
stream at call ``1 + offsets[j]`` (``keyed.keyed_call_normals``, calls up
to 2^32 - 1: the unbiased ladder's deep levels draw past 2^20 per sample),
so the same (sample, offset) reproduces the same draw. Above ``block`` inner
draws a level accumulates its half sums block by block; the block sums
add in float64, where ``mlmc_tpu`` compensates them (Kahan).
"""
from typing import Callable

import torch

from mlmc_tpu_torch.random.keyed import keyed_call_normals

__all__ = ["nested_level_fn", "nested_value_fn", "g_max0", "evppi_level_fn",
           "gaussian_information_fn", "evppi_gaussian_exact"]


def g_max0(m):
    """The EVPPI outer functional ``max(0, m)`` (elementwise)."""
    return torch.clamp(m, min=0.0)


def _half_means(inner_fn, keys, N, block):
    """(mean of all N, of the first half, of the second half) per outer
    sample, float64; ``[C, block]`` is the largest inner block evaluated."""
    device = keys.indices.device

    def block_sum(start, size):
        offs = torch.arange(start, start + size, dtype=torch.int64, device=device)
        return inner_fn(keys, offs).to(torch.float64).sum(dim=1)

    if N == 1:
        m = block_sum(0, 1)
        return m, m, m
    half = N // 2
    blk = min(block, half)
    if half % blk:
        blk = half                      # tiny levels: one block per half

    def half_sum(base):
        acc = block_sum(base, blk)
        for b in range(1, half // blk):
            acc = acc + block_sum(base + b * blk, blk)
        return acc

    sa, sb = half_sum(0), half_sum(half)
    return (sa + sb) / N, sa / half, sb / half


def nested_level_fn(inner_fn: Callable, g: Callable = g_max0, n0: int = 2,
                    block: int = 1024):
    """Antithetic nested-MLMC correction function.

    :param inner_fn: ``(keys, offsets) -> [C, n]`` (or ``[C, n, D]``; ``g``
        then maps the [C, D] decision means to [C])
    :param g: outer functional on the inner means (default :func:`g_max0`)
    :param n0: inner draws at level 0 (1 or even)
    :param block: inner draws evaluated at once
    :return: ``fn(level, keys) -> Delta_l [C]`` (float64)
    """
    n0 = int(n0)
    if n0 < 1:
        raise ValueError("need n0 >= 1")
    if n0 > 1 and n0 % 2:
        raise ValueError("n0 must be 1 or even (antithetic halves)")

    def fn(level, keys):
        m_all, m_a, m_b = _half_means(inner_fn, keys, n0 << level, block)
        if level == 0:
            return g(m_all)
        return g(m_all) - 0.5 * (g(m_a) + g(m_b))

    return fn


def nested_value_fn(inner_fn: Callable, g: Callable = g_max0, n0: int = 2,
                    block: int = 1024):
    """Prefix-coupled value form ``F_l = g(mean of the first n0 2^l inner
    draws)`` for drivers that difference values themselves.

    :return: ``f(alpha, keys) -> [C]`` (alpha a 1-tuple)
    """
    n0 = int(n0)
    if n0 < 1:
        raise ValueError("need n0 >= 1")

    def fn(alpha, keys):
        (level,) = tuple(alpha)
        m_all, _, _ = _half_means(inner_fn, keys, n0 << level, block)
        return g(m_all)

    return fn


def evppi_level_fn(inner_fn: Callable, n0: int = 2, block: int = 1024):
    """EVPPI correction function for multi-decision problems: ``inner_fn``
    returns [C, n, D], the outer functional is ``max_d`` of the D decision
    means (Giles & Goda 2019)."""

    def g(m):
        if m.dim() != 2:
            raise ValueError(
                "evppi_level_fn expects multi-decision inner values [C, n, D]; the "
                "inner_fn returned per-key means of rank %d — for a scalar decision "
                "use nested_level_fn(g=g_max0)" % m.dim())
        return m.max(dim=-1).values

    return nested_level_fn(inner_fn, g=g, n0=n0, block=block)


# ---------------------------------------------------------------------- #
# validation fixture: jointly Gaussian information problem
# ---------------------------------------------------------------------- #
def gaussian_information_fn(sigma_y=1.0, sigma_x=2.0, mu=0.0):
    """``f(X, Y) = mu + Y + X`` with ``Y ~ N(0, sigma_y^2)`` (the
    information, the first normal of the sample's Philox call 0) and
    ``X_j ~ N(0, sigma_x^2)`` (the first normal of call ``1 + offset_j``),
    so ``E[max(0, E[f|Y])]`` is :func:`evppi_gaussian_exact`.

    :return: inner_fn for :func:`nested_level_fn` (float32 draws, as
        ``keyed_normals`` makes them)
    """

    def inner_fn(keys, offsets):
        calls = torch.cat([torch.zeros(1, dtype=torch.int64, device=offsets.device),
                           1 + offsets])
        z = keyed_call_normals(keys.seed, keys.level, keys.indices, calls)
        return mu + sigma_y * z[:, :1] + sigma_x * z[:, 1:]

    return inner_fn


def evppi_gaussian_exact(sigma_y=1.0, mu=0.0):
    """``E[max(0, mu + Y)]`` for ``Y ~ N(0, sigma_y^2)``."""
    import scipy.stats as st

    z = mu / sigma_y
    return float(mu * st.norm.cdf(z) + sigma_y * st.norm.pdf(z))
