"""Bayesian optimal experimental design: expected information gain
(counterpart of ``mlmc_tpu/oed.py``).

The expected information gain of a design (Lindley 1956) is the expected
KL divergence from prior to posterior,

    EIG = E_{theta0, y ~ p(.|theta0)}[ -log E_{theta'}[ exp(
              ll(y|theta') - ll(y|theta0) ) ] ],

the inner average taken over likelihood ratios (<= O(1), the stable
nested-MC form). It is a nested expectation with outer functional
``g = -log``, so ``nested`` applies:

* :func:`eig_nmc`: the plain nested estimator at a fixed inner count
  (Ryan 2003), biased upward by O(1/N_inner), with an outer-CLT error;
* :func:`expected_information_gain`: MLMC over the inner count with
  antithetic corrections under randomized truncation (``UnbiasedMLMC``),
  an unbiased EIG with a purely statistical error.

Closed form for validation: the linear design ``y = G theta + noise``,
``theta ~ N(0, I)``, has ``EIG = 0.5 logdet(I + G G^T / noise^2)``
(:func:`linear_gaussian_eig`).

Forward contract: ``forward(theta [N, d]) -> obs [N, K]`` evaluates a
batch (``mcmc.make_darcy_inverse``'s ``forward`` at one grid). The draws
follow the nested (sample, offset) contract through
``keyed.keyed_call_normals``: outer sample i's scenario takes the first
normals of its Philox calls 0 .. d-1 (theta0) and 2^31 .. 2^31 + K - 1
(the noise), its inner draw j the calls (1 + j) d .. (2 + j) d - 1, so a
level's inner draws are a prefix of the next level's. Above ``block``
inner draws the nested tier evaluates in blocks, which bounds the forward
batch at ``C * block`` solves.
"""
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.nested import nested_level_fn, nested_value_fn
from mlmc_tpu_torch.random.keyed import SampleKeys, keyed_call_normals

__all__ = ["make_eig_inner", "eig_nmc", "expected_information_gain",
           "linear_gaussian_eig"]

#: the first Philox call of a scenario's observation noise
NOISE_CALL = 1 << 31


def linear_gaussian_eig(G, noise_std):
    """EIG of the linear design y = G theta + N(0, noise^2 I):
    0.5 logdet(I_K + G G^T / noise^2) nats."""
    G = np.asarray(G, dtype=np.float64)
    noise = np.broadcast_to(np.asarray(noise_std, np.float64), (G.shape[0],))
    S = G @ G.T / np.outer(noise, noise) + np.eye(G.shape[0])
    return 0.5 * float(np.linalg.slogdet(S)[1])


def _neg_log(m):
    return -torch.log(torch.clamp(m, min=torch.finfo(m.dtype).tiny))


def keyed_eig_draws(dtype=torch.float64):
    """The keyed draws of :func:`make_eig_inner`: ``draws(keys, kind, arg)``
    with kind "theta0" (arg d: [C, d]), "noise" (arg K: [C, K]) or
    "inner" (arg (offsets [n], d): [C, n, d])."""
    def draws(keys, kind, arg):
        device = keys.indices.device
        if kind == "theta0":
            calls = torch.arange(int(arg), device=device)
        elif kind == "noise":
            calls = NOISE_CALL + torch.arange(int(arg), device=device)
        else:
            offsets, d = arg
            calls = ((1 + offsets)[:, None] * d
                     + torch.arange(d, device=device)[None, :]).reshape(-1)
            if calls.numel() and int(calls.max()) >= NOISE_CALL:
                raise ValueError("inner draws past 2^31 / d per sample")
        z = keyed_call_normals(keys.seed, keys.level, keys.indices, calls, dtype)
        return z if kind != "inner" else z.reshape(z.shape[0], -1, arg[1])
    return draws


def make_eig_inner(forward: Callable, noise_std, d: int, draws=None):
    """Nested-tier inner function for the EIG of ``forward``.

    :param forward: ``theta [N, d] -> obs [N, K]``
    :param noise_std: observation noise sd (scalar or [K])
    :param draws: the scenario and inner draws in place of
        :func:`keyed_eig_draws`'s (same signature)
    :return: ``inner_fn(keys, offsets [n]) -> [C, n]`` of likelihood ratios
        ``exp(ll(y|theta') - ll(y|theta0))``
    """
    draws = draws or keyed_eig_draws()

    def inner_fn(keys, offsets):
        th0 = draws(keys, "theta0", d)
        y0 = forward(th0)                                   # [C, K]
        eps = draws(keys, "noise", y0.shape[1]).to(y0)
        noise = torch.as_tensor(noise_std, dtype=y0.dtype, device=y0.device)
        y = y0 + noise * eps
        ll0 = -0.5 * (eps * eps).sum(1)                     # ll(y|theta0) + const
        thp = draws(keys, "inner", (offsets, d)).to(th0)    # [C, n, d]
        C, n = thp.shape[:2]
        r = (y[:, None, :] - forward(thp.reshape(C * n, d)).reshape(C, n, -1)) / noise
        return torch.exp(-0.5 * (r * r).sum(-1) - ll0[:, None])

    return inner_fn


def eig_nmc(forward: Callable, noise_std, d: int, n_outer: int = 4096,
            n_inner: int = 512, seed: int = 0, block: int = 1024,
            chunk_size: int = 512, device=None, draws=None):
    """Nested-MC EIG at a fixed inner count: biased upward by O(1/n_inner)
    (Jensen on -log), with an outer CLT standard error; outer sample i is
    the identity (seed, 0, i). Use :func:`expected_information_gain` to
    remove the bias.

    :param block: inner draws evaluated at once: each forward call takes
        ``chunk_size * min(block, n_inner / 2)`` parameter rows
    :param device: where the chunks run; None = the current CUDA device
    :param draws: as in :func:`make_eig_inner`
    :return: dict with ``eig`` (nats), ``se``, ``n_forward``
    """
    if n_inner > 1 and n_inner % 2:
        raise ValueError("n_inner must be even")
    device = resolve_device(device)
    fn = nested_value_fn(make_eig_inner(forward, noise_std, d, draws), g=_neg_log,
                         n0=n_inner, block=block)
    parts = []
    for s in range(0, n_outer, chunk_size):
        c = min(chunk_size, n_outer - s)
        idx = torch.arange(s, s + c, dtype=torch.int64, device=device)
        parts.append(fn((0,), SampleKeys(int(seed), 0, idx)))
    vals = torch.cat(parts).to(torch.float64).cpu().numpy()   # one fetch
    return {"eig": float(vals.mean()),
            "se": float(vals.std(ddof=1) / np.sqrt(len(vals))),
            "n_forward": n_outer * (n_inner + 1)}


def expected_information_gain(forward: Callable, noise_std, d: int,
                              target_var: float = 1e-4, n0: int = 4,
                              r: float = 2.0 ** -1.25, seed: int = 0,
                              block: int = 1024,
                              chunk_size: Optional[Callable] = None,
                              max_rounds: int = 20, device=None, draws=None):
    """Unbiased EIG: MLMC over the inner count (level l uses ``n0 2^l``
    inner ratios, antithetic corrections) under randomized truncation; the
    estimate carries only a statistical error. The smooth ``-log`` gives
    correction variance decay beta ~ 2 against cost growth gamma = 1, so
    ``r = 2^-1.25`` sits inside the Rhee-Glynn band.

    :param device: where the chunks run; None = the current CUDA device
    :return: the ``UnbiasedMLMC`` estimate dict (``mean`` is the EIG in
        nats) plus ``se`` and ``n_forward``
    """
    from mlmc_tpu_torch.unbiased import GeometricLevels, UnbiasedMLMC

    lvl = nested_level_fn(make_eig_inner(forward, noise_std, d, draws), g=_neg_log,
                          n0=n0, block=block)
    mc = UnbiasedMLMC(lvl, GeometricLevels(r), seed=seed,
                      cost_fn=lambda lv: float(n0) * 2.0 ** lv,
                      chunk_size=chunk_size or (lambda lv: max(4096 >> lv, 64)),
                      device=device)
    out = mc.run(target_var=target_var, max_rounds=max_rounds)
    out["se"] = float(np.sqrt(out["var"]))
    out["n_forward"] = int(sum(
        n * (n0 * (1 << int(lv)) + 1)
        for lv, n in zip(out["levels"], out["n_samples"])))
    return out
