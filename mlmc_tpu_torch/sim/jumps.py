"""Jump-diffusion MLMC: compound-Poisson (Merton-style) jumps coupled
across levels (counterpart of ``mlmc_tpu/sim/jumps.py``).

Dynamics: a continuous SDE part integrated by Euler substeps plus
multiplicative lognormal jumps, ``S <- S exp(L_j)`` after each fine
substep with the substep's summed log jump
``L_j = N_j jump_mean + jump_std sqrt(N_j) Z_j``, ``N_j ~ Poisson(lam
h_f)``. The coarse path takes the sums of the fine Brownian increments
and log jumps, whose law is exactly the coarse-grid jump law, so fine and
coarse share every jump. :func:`merton` is the risk-neutral Merton (1976)
model, priced in closed form by :func:`merton_call_price`.

Draws of a sample (``_from_draws``): the Brownian normals ``[B, n_fine]``,
the jump counts ``[B, n_fine]`` and the jump normals ``[B, n_fine]``.
Departure from ``mlmc_tpu``: a count is the Poisson inversion of one
uniform, ``N = #{k : v <= P(N > k)}`` with ``v`` in (0, 1], on a table of
the Poisson tail cut where it falls below 1e-17 (a 53-bit ``v`` never
reaches past it): keyed by the sample's identity, where ``jax.random.
poisson`` draws from a key. Keyed layout per sample: Philox calls
[0, n_fine / 2) the 2 n_fine normals (Brownian, then jump), the next
n_fine / 2 calls the 2 n_fine words of the n_fine 53-bit uniforms.
"""
import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from mlmc_tpu_torch.random.keyed import keyed_normals, keyed_words
from mlmc_tpu_torch.sim.sde import (PathFunctionals, SDESimulation, _grid, _row_sum,
                                    black_scholes_call)
from mlmc_tpu_torch.sim.simulation import config_dtype

__all__ = ["JumpDiffusion", "merton", "coupled_jump_functionals",
           "JumpDiffusionSimulation", "merton_call_price", "poisson_tail_table",
           "poisson_from_uniforms"]

#: the Poisson tail below which the inversion table stops
POISSON_TAIL_CUT = 1e-17


@dataclasses.dataclass(frozen=True)
class JumpDiffusion:
    """Continuous SDE part (``drift``/``diffusion`` as in ``SDEModel``)
    plus multiplicative compound-Poisson lognormal jumps."""
    drift: Callable
    diffusion: Callable
    lam: float
    jump_mean: float
    jump_std: float
    s0: float

    @property
    def kappa(self):
        """Mean relative jump size ``E[e^Y] - 1``."""
        return float(np.expm1(self.jump_mean + 0.5 * self.jump_std ** 2))


def merton(mu=0.05, sigma=0.2, lam=0.5, jump_mean=-0.1, jump_std=0.15,
           s0=1.0):
    """Risk-neutral Merton jump-diffusion: GBM continuous part with the
    compensated drift ``mu - lam kappa``."""
    kappa = float(np.expm1(jump_mean + 0.5 * jump_std ** 2))
    drift_rate = mu - lam * kappa
    return JumpDiffusion(drift=lambda s, t: drift_rate * s,
                         diffusion=lambda s, t: sigma * s,
                         lam=lam, jump_mean=jump_mean,
                         jump_std=jump_std, s0=s0)


def merton_call_price(s0, strike, rate, sigma, lam, jump_mean,
                      jump_std, T, n_terms=60):
    """Merton (1976) closed-form European call: Poisson mixture of
    Black-Scholes prices conditioned on the jump count (host)."""
    m = jump_mean + 0.5 * jump_std ** 2        # log(1 + kappa)
    kappa = np.expm1(m)
    lam_bar = lam * (1.0 + kappa)
    if lam_bar * T == 0.0:
        n_terms = 1                            # only the k=0 term
    price, log_w = 0.0, -lam_bar * T
    for k in range(n_terms):
        sig_k = np.sqrt(sigma ** 2 + k * jump_std ** 2 / T)
        r_k = rate - lam * kappa + k * m / T
        price += np.exp(log_w) * black_scholes_call(s0, strike, r_k,
                                                    sig_k, T)
        if k + 1 < n_terms:
            log_w += np.log(lam_bar * T) - np.log1p(k)
    return float(price)


def poisson_tail_table(mean):
    """``P(N > k)`` for k = 0, 1, ... while it is at least
    ``POISSON_TAIL_CUT`` (host float64): the inversion table."""
    if not mean >= 0.0:
        raise ValueError("Poisson mean must be >= 0, got %r" % (mean,))
    if mean == 0.0:
        return np.zeros(0)
    # pmf far into the tail (below 1e-40 of the mode), summed from the
    # smallest term up so every tail keeps its relative accuracy
    J = int(np.ceil(mean + 40.0 * np.sqrt(mean) + 60.0))
    j = np.arange(J + 1)
    pmf = np.exp(-mean + j * np.log(mean) - np.array([math.lgamma(v + 1.0) for v in j]))
    sf = np.cumsum(pmf[::-1])[::-1][1:]            # P(N > k), k = 0 .. J-1
    tail = sf[:int(np.argmax(sf < POISSON_TAIL_CUT))]
    # the smallest uniform is 2^-53 > the cut: no draw reaches past it
    if not (POISSON_TAIL_CUT < 2.0 ** -53 and sf[-1] < POISSON_TAIL_CUT):
        raise RuntimeError("the Poisson table must end below its cut, and the cut "
                           "below 2^-53")
    return np.ascontiguousarray(tail)


def poisson_from_uniforms(v, mean):
    """Poisson(mean) counts by inversion of uniforms ``v`` in (0, 1]:
    ``N = #{k : v <= P(N > k)}`` (float64 comparisons)."""
    tail = torch.as_tensor(poisson_tail_table(mean), device=v.device)
    return (v.to(torch.float64)[..., None] <= tail).sum(dim=-1)


def _uniforms53(words):
    """53-bit uniforms in (0, 1] from word pairs [..., 2]."""
    hi, lo = words[..., 0], words[..., 1]
    return (((hi << 21) | (lo >> 11)) + 1).to(torch.float64) * 2.0 ** -53


def coupled_jump_functionals(config, draws):
    """Integrate a coupled (fine, coarse) jump-diffusion level batch.

    :param config: dict with ``model`` (:class:`JumpDiffusion`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0)
    :param draws: (Brownian normals, jump counts, jump normals), each
        [B, n_fine] in the batch's dtype
    :return: (fine, coarse | None) as ``PathFunctionals``
    """
    model = config["model"]
    if not isinstance(model, JumpDiffusion):
        raise ValueError("model must be a JumpDiffusion")
    T, n_f, n_c, is_l0, m, trips, dt_f, dt_c = _grid(config)
    zw, counts, zj = draws
    dtype, B = zw.dtype, zw.shape[0]
    dws = float(np.sqrt(dt_f)) * zw
    counts = counts.to(dtype)
    ljs = counts * model.jump_mean + model.jump_std * torch.sqrt(counts) * zj

    s0 = torch.full((B,), model.s0, dtype=dtype, device=zw.device)
    zero = torch.zeros_like(s0)
    init = (s0, zero, s0, s0)          # (state, sum of nodes, max, min)

    def substeps(st, dws, ljs, t0, dt, n_sub):
        s, sm, mx, mn = st
        for j in range(n_sub):
            t = t0 + j * dt
            s = s + model.drift(s, t) * dt + model.diffusion(s, t) * dws[:, j]
            s = s * torch.exp(ljs[:, j])
            sm = sm + s
            mx = torch.maximum(mx, s)
            mn = torch.minimum(mn, s)
        return (s, sm, mx, mn)

    fine = coarse = init
    for c in range(trips):
        dw, lj = dws[:, c * m:(c + 1) * m], ljs[:, c * m:(c + 1) * m]
        t0 = c * dt_c
        fine = substeps(fine, dw, lj, t0, dt_f, m)
        if not is_l0:
            coarse = substeps(coarse, _row_sum(dw)[:, None],
                              _row_sum(lj)[:, None], t0, dt_c, 1)

    def functionals(st, n_nodes):
        s, sm, mx, mn = st
        return PathFunctionals(terminal=s, average=(s0 + sm) / (n_nodes + 1),
                               maximum=mx, minimum=mn)

    return (functionals(fine, n_f),
            None if is_l0 else functionals(coarse, n_c))


class JumpDiffusionSimulation(SDESimulation):
    """Jump-diffusion MLMC under the Simulation contract (level parameters
    ``[h]``, shared Brownian and jump draws across the coupling). Config
    keys: ``model`` (:class:`JumpDiffusion`, default :func:`merton`),
    ``total_time``, ``payoff``, ``qoi``, ``dtype``; Euler only;
    ``antithetic``, ``path_extras`` and ``drift_shift`` are refused."""

    def __init__(self, config=None):
        config = dict(config or {})
        config.setdefault("model", merton())
        if not isinstance(config["model"], JumpDiffusion):
            raise ValueError("model must be a JumpDiffusion")
        if config.get("antithetic"):
            raise ValueError("antithetic twins assume continuous "
                             "dynamics; not supported with jumps")
        if config.get("path_extras"):
            raise ValueError("Brownian-bridge path extras are not "
                             "extended to jump dynamics")
        if config.get("drift_shift"):
            raise ValueError("drift_shift (Girsanov importance "
                             "sampling) is not implemented for "
                             "jump-diffusions; the jump-measure "
                             "likelihood ratio is missing")
        if config.get("scheme", "euler") != "euler":
            raise ValueError("jump-diffusions integrate with Euler "
                             "substeps")
        super().__init__(config)

    @staticmethod
    def _paths(config, draws):
        pf_f, pf_c = coupled_jump_functionals(config, draws)
        return pf_f, None, pf_c

    @staticmethod
    def _jump_mean(config):
        return config["model"].lam * float(config["total_time"]) / int(config["n_fine"])

    @classmethod
    def _sample_draws(cls, config, generator, n, device):
        n_f, dtype = int(config["n_fine"]), config_dtype(config)
        z = torch.randn((int(n), 2, n_f), generator=generator,
                        device=generator.device, dtype=dtype).to(device)
        v = 1.0 - torch.rand((int(n), n_f), generator=generator,
                             device=generator.device,
                             dtype=torch.float64).to(device)       # (0, 1]
        counts = poisson_from_uniforms(v, cls._jump_mean(config)).to(dtype)
        return z[:, 0], counts, z[:, 1]

    @classmethod
    def _keyed_draws(cls, config, seed, level_id, indices, attempts):
        n_f, dtype = int(config["n_fine"]), config_dtype(config)
        z = keyed_normals(seed, level_id, indices, attempts, 2 * n_f, dtype)
        n_calls = -(-2 * n_f // 4)
        words = keyed_words(seed, level_id, indices, attempts, n_calls,
                            first_call=n_calls)[:, :2 * n_f]
        v = _uniforms53(words.reshape(-1, n_f, 2))
        counts = poisson_from_uniforms(v, cls._jump_mean(config)).to(dtype)
        return z[:, :n_f], counts, z[:, n_f:]
