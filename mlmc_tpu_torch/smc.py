"""Tempered sequential Monte Carlo (counterpart of ``mlmc_tpu/smc.py``):
posterior sampling and model evidence.

An SMC sampler (Del Moral, Doucet & Jasra, "Sequential Monte Carlo
samplers", JRSS-B 68, 2006) anneals a particle population from the prior
N(0, I) to the posterior through tempered bridges ``prior * L^lambda``,
``lambda`` from 0 to 1, with adaptive tempering (each increment keeps the
effective sample size at a fixed fraction), systematic resampling and pCN
rejuvenation moves. Each stage's mean incremental weight estimates
``Z_lambda'/Z_lambda``, so ``log Z = sum_stages logmeanexp((lambda' -
lambda) ll)``. The hierarchical variant anneals early stages on coarse
models; at a model switch the importance bridge reweights by ``lambda
(ll_fine - ll_coarse)``, so the evidence stays the fine model's.

**Batch contract.** ``loglik_qoi(theta [B, d]) -> (loglik [B], qoi [B,
q])`` evaluates the population at once (``mcmc``'s contract). A stage is a
Python loop on the device: resampling, then ``n_moves`` pCN sweeps whose
step size adapts by Robbins-Monro on the device after every sweep. The
next temperature is found on the host by bisection on the closed-form ESS
curve (float64 numpy), from one bundled fetch per stage.

**Draws.** Particle b's draws are chain b's of ``mcmc.KeyedChainDraws``
with fan-out ``(n_moves,)``: the initial state, at path ``(stage,)`` the
resampling uniform (island i takes the ``u`` of its first particle), at
``(stage, move)`` the innovation ``xi`` and the acceptance uniform ``u``.
``draws=`` takes any object with ``init()`` and a call per path in its
place (a test hands in JAX's).
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.mcmc import KeyedChainDraws

__all__ = ["smc_tempering", "hierarchical_smc"]

N_ISLANDS = 8


def _ess_fraction(log_w):
    """ESS/N of normalized-able log weights (host numpy)."""
    w = np.exp(log_w - log_w.max())
    return float((w.sum() ** 2) / (len(w) * (w * w).sum()))


def _next_lambda(lam, ll, target_frac):
    """Largest lambda' in (lam, 1] whose increment keeps
    ESS(incremental weights) >= target_frac * N, by bisection — the
    ESS of ``(lam'-lam) ll`` is continuous and decreasing in lam'."""
    if _ess_fraction((1.0 - lam) * ll) >= target_frac:
        return 1.0
    lo, hi = lam, 1.0
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if _ess_fraction((mid - lam) * ll) >= target_frac:
            lo = mid
        else:
            hi = mid
    return lo


def _logmeanexp(x):
    m = np.max(x)
    return float(m + np.log(np.mean(np.exp(x - m))))


def _tree_sum(x):
    """Sum over the last axis in a fixed pairwise order (halving, with a
    zero pad on odd lengths): the same bits for any number of rows and on
    any device, where a library reduction may split its work by shape."""
    while x.shape[-1] > 1:
        if x.shape[-1] % 2:
            x = torch.cat([x, torch.zeros_like(x[..., :1])], dim=-1)
        half = x.shape[-1] // 2
        x = x[..., :half] + x[..., half:]
    return x[..., 0]


def _scan(x):
    """Inclusive prefix sum over the last axis in a fixed order
    (Hillis-Steele doubling), independent of the number of rows."""
    k, n = 1, x.shape[-1]
    while k < n:
        x = torch.cat([x[..., :k], x[..., k:] + x[..., :-k]], dim=-1)
        k *= 2
    return x


def _softmax(log_w):
    """Softmax over the last axis with :func:`_tree_sum`'s order."""
    e = torch.exp(log_w - log_w.max(dim=-1, keepdim=True).values)
    return e / _tree_sum(e)[..., None]


def _searchsorted(cum, u, m):
    """First index whose cumulative weight reaches u (``side='left'``),
    row by row, clipped to ``m - 1``."""
    return torch.searchsorted(cum.contiguous(), u.contiguous(), right=False).clamp(0, m - 1)


def _systematic_resample(log_w, u01, m):
    """Per-island systematic resampling; log_w [I, m], u01 [I, 1]
    uniforms -> idx [I, m]."""
    cum = _scan(_softmax(log_w))
    u = (u01 + torch.arange(m, dtype=log_w.dtype, device=log_w.device)[None, :]) / m
    return _searchsorted(cum, u, m)


def _pcn(theta, xi, beta):
    return torch.sqrt(1.0 - beta * beta) * theta + beta * xi


def _stage(flat_ll, theta, ll, log_w, lam, beta, draws, stage_i, n_moves,
           acc_target=0.234, rm_gain=0.5):
    """One SMC stage: systematic resampling at the log-weights ``log_w``
    [I, m], then ``n_moves`` pCN sweeps at the tempered target ``lam * ll``.
    beta adapts on the device after every sweep (Robbins-Monro on
    logit(beta) toward ``acc_target``; the acceptance signal is an
    N-particle mean, nearly noiseless, so a large gain is safe).

    :return: (theta [I, m, d], ll [I, m], mean acceptance, adapted beta)
    """
    I, m, d = theta.shape
    dtype = theta.dtype
    _, u, _ = draws((stage_i,))
    u01 = u.to(theta.device, dtype).reshape(I, m)[:, :1]
    idx = _systematic_resample(log_w, u01, m)
    theta = torch.take_along_dim(theta, idx[:, :, None], dim=1)
    ll = torch.take_along_dim(ll, idx, dim=1)
    acc = torch.zeros((), dtype=dtype, device=theta.device)
    for j in range(n_moves):
        xi, u, _ = draws((stage_i, j))
        prop = _pcn(theta.reshape(I * m, d), xi.to(theta.device, dtype),
                    beta).reshape(I, m, d)
        ll_p = flat_ll(prop)
        accept = torch.log(u.to(theta.device, dtype)).reshape(I, m) < lam * (ll_p - ll)
        theta = torch.where(accept[:, :, None], prop, theta)
        ll = torch.where(accept, ll_p, ll)
        a = accept.to(dtype).mean()
        logit = torch.log(beta) - torch.log1p(-beta)
        beta = torch.sigmoid(logit + rm_gain * (a - acc_target))
        acc = acc + a
    return theta, ll, acc / n_moves, beta


def _result_dict(theta, qoi, log_z_island, lambdas, acc_rates, beta_c,
                 wall, n_particles, d, n_islands, extra=None):
    """Assemble the common result payload (island CLT errors)."""
    qoi_np = np.asarray(qoi, dtype=np.float64)
    island_means = qoi_np.mean(axis=1)                   # [I, q]
    out = {"theta": np.asarray(theta).reshape(n_particles, d),
           "qoi": qoi_np.reshape(n_particles, -1),
           "mean": qoi_np.reshape(n_particles, -1).mean(axis=0),
           "se": island_means.std(axis=0, ddof=1) / np.sqrt(n_islands),
           "log_evidence": float(np.mean(log_z_island)),
           "log_evidence_se": float(log_z_island.std(ddof=1)
                                    / np.sqrt(n_islands)),
           "lambdas": lambdas, "acc_rates": acc_rates,
           "beta": beta_c, "wall_s": wall}
    out.update(extra or {})
    return out


def _setup(n_particles, d, n_moves, seed, theta0, dtype, device, draws):
    if n_particles % N_ISLANDS:
        raise ValueError("n_particles must be divisible by 8 (islands)")
    device = resolve_device(device, like=theta0)
    draws = draws or KeyedChainDraws(seed, n_particles, d, dtype, device,
                                     fanout=(n_moves,))
    if theta0 is None:
        theta0 = draws.init()
    m = n_particles // N_ISLANDS
    theta = torch.as_tensor(theta0).to(device, dtype).reshape(N_ISLANDS, m, d)
    return theta, m, device, draws


def _batch_ll(fn, theta):
    """``fn`` on the [I, m, d] population -> (ll [I, m], qoi [I, m, q])."""
    I, m, d = theta.shape
    ll, qoi = fn(theta.reshape(I * m, d))
    return ll.reshape(I, m), qoi.reshape(I, m, -1)


def smc_tempering(loglik_qoi: Callable, d: int, n_particles: int = 256,
                  n_moves: int = 5, beta: float = 0.3,
                  ess_target: float = 0.5, seed: int = 0,
                  max_stages: int = 200, theta0=None, dtype=torch.float64,
                  device=None, draws=None):
    """Anneal ``n_particles`` from the prior N(0, I_d) to the posterior.

    :param loglik_qoi: ``theta [B, d] -> (loglik [B], qoi [B, q])``
    :param n_moves: pCN rejuvenation steps per stage (at the tempered
        target ``lambda * loglik``); beta adapts on the device after every
        sweep toward 0.234 acceptance and carries across stages
    :param ess_target: ESS fraction kept by each tempering increment
    :param device: where the population runs; None = ``theta0``'s device,
        else the current CUDA device
    :param draws: ``init()`` and a call per path in place of
        ``KeyedChainDraws(seed, n_particles, d, ..., fanout=(n_moves,))``
    :return: dict with ``theta`` [N, d] posterior particles (equally
        weighted), ``qoi`` [N, q], ``mean``/``se`` (``se`` and
        ``log_evidence_se`` across 8 independent islands: resampling
        couples particles within an island), ``log_evidence``,
        ``lambdas`` (the adaptive schedule), ``acc_rates``, ``beta``,
        ``n_forward``, ``wall_s``
    """
    theta, m, device, draws = _setup(n_particles, d, n_moves, seed, theta0,
                                     dtype, device, draws)
    flat_ll = lambda th: _batch_ll(loglik_qoi, th)[0]

    t0 = time.perf_counter()
    ll, _ = _batch_ll(loglik_qoi, theta)
    ll_h = ll.cpu().numpy().astype(np.float64)
    lam = 0.0
    lambdas, acc_rates = [0.0], []
    log_z_island = np.zeros(N_ISLANDS)
    beta_c = float(beta)
    for stage_i in range(max_stages):
        lam_next = _next_lambda(lam, ll_h.ravel(), ess_target)
        for i in range(N_ISLANDS):
            log_z_island[i] += _logmeanexp((lam_next - lam) * ll_h[i])
        theta, ll, acc, beta_d = _stage(
            flat_ll, theta, ll, (lam_next - lam) * ll, lam_next,
            torch.tensor(beta_c, dtype=dtype, device=device), draws,
            stage_i, n_moves)
        # one bundled fetch: ll for the next temperature decision, the
        # acceptance diagnostic and the adapted beta
        fetched = torch.cat([ll.reshape(-1), torch.stack([acc, beta_d])]).cpu().numpy()
        ll_h = fetched[:-2].reshape(N_ISLANDS, m).astype(np.float64)
        acc, beta_c = float(fetched[-2]), float(fetched[-1])
        acc_rates.append(acc)
        lam = lam_next
        lambdas.append(lam)
        if lam >= 1.0:
            break
    else:
        raise RuntimeError("tempering did not reach lambda=1 within "
                           f"{max_stages} stages")
    _, qoi = _batch_ll(loglik_qoi, theta)
    theta_np, qoi_np = theta.cpu().numpy(), qoi.cpu().numpy()
    wall = time.perf_counter() - t0
    return _result_dict(
        theta_np, qoi_np, log_z_island, lambdas, acc_rates, beta_c,
        wall, n_particles, d, N_ISLANDS,
        extra={"n_forward": (len(acc_rates) * n_moves + 2) * n_particles})


def hierarchical_smc(loglik_qoi_fns: Sequence[Callable], d: int,
                     switch_lambdas: Optional[Sequence[float]] = None,
                     **kwargs):
    """Tempered SMC over a model hierarchy: anneal on the coarse model
    first, switch models mid-schedule with an importance bridge.

    The temper path visits ``(model l, lambda)`` pairs; at a model switch
    the incremental weight is ``lambda * (ll_{l+1} - ll_l)``, an exact
    importance step, so the final particles target the fine posterior and
    ``log_evidence`` estimates the fine model's evidence (only the
    variance depends on how close the models are).

    :param switch_lambdas: temperatures at which to hand over to the next
        model (length L-1, increasing; default: equally spaced)
    :param kwargs: :func:`smc_tempering`'s; for L == 1 this is exactly
        :func:`smc_tempering`
    """
    L = len(loglik_qoi_fns)
    if L == 1:
        return smc_tempering(loglik_qoi_fns[0], d, **kwargs)
    if switch_lambdas is None:
        switch_lambdas = [(l + 1) / L for l in range(L - 1)]
    if len(switch_lambdas) != L - 1 or \
            any(b <= a for a, b in zip(switch_lambdas, switch_lambdas[1:])) \
            or switch_lambdas[0] <= 0 or switch_lambdas[-1] >= 1:
        raise ValueError("switch_lambdas must be increasing in (0, 1), "
                         "one per model handover")
    return _hier_smc_impl(loglik_qoi_fns, d, list(switch_lambdas), **kwargs)


def _hier_smc_impl(fns, d, switches, n_particles=256, n_moves=5,
                   beta=0.3, ess_target=0.5, seed=0, max_stages=200,
                   theta0=None, dtype=torch.float64, device=None, draws=None):
    theta, m, device, draws = _setup(n_particles, d, n_moves, seed, theta0,
                                     dtype, device, draws)
    t0 = time.perf_counter()
    lvl = 0
    ll, _ = _batch_ll(fns[0], theta)
    ll_h = ll.cpu().numpy().astype(np.float64)
    lam = 0.0
    lambdas, acc_rates, levels = [0.0], [], [0]
    log_z_island = np.zeros(N_ISLANDS)
    beta_c = float(beta)
    n_fwd = [0] * len(fns)
    n_fwd[0] += n_particles
    for stage_i in range(max_stages):
        bound = switches[lvl] if lvl < len(switches) else 1.0
        lam_next = min(_next_lambda(lam, ll_h.ravel(), ess_target), bound)
        log_w_h = (lam_next - lam) * ll_h
        switching = lam_next >= bound and lvl < len(switches)
        if switching:
            # importance bridge to the next model at temperature lam_next
            ll_new, _ = _batch_ll(fns[lvl + 1], theta)
            ll_new_h = ll_new.cpu().numpy().astype(np.float64)
            n_fwd[lvl + 1] += n_particles
            log_w_h = log_w_h + lam_next * (ll_new_h - ll_h)
        for i in range(N_ISLANDS):
            log_z_island[i] += _logmeanexp(log_w_h[i])
        if switching:
            lvl += 1
            ll_h = ll_new_h
            ll = torch.as_tensor(ll_new_h).to(device, dtype)
        fn = fns[lvl]
        theta, ll, acc, beta_d = _stage(
            lambda th: _batch_ll(fn, th)[0], theta, ll,
            torch.as_tensor(log_w_h).to(device, dtype), lam_next,
            torch.tensor(beta_c, dtype=dtype, device=device), draws,
            stage_i, n_moves)
        n_fwd[lvl] += n_particles * n_moves
        fetched = torch.cat([ll.reshape(-1), torch.stack([acc, beta_d])]).cpu().numpy()
        ll_h = fetched[:-2].reshape(N_ISLANDS, m).astype(np.float64)
        acc, beta_c = float(fetched[-2]), float(fetched[-1])
        acc_rates.append(acc)
        lam = lam_next
        lambdas.append(lam)
        levels.append(lvl)
        if lam >= 1.0:
            break
    else:
        raise RuntimeError("tempering did not reach lambda=1 within "
                           f"{max_stages} stages")
    _, qoi = _batch_ll(fns[-1], theta)
    n_fwd[-1] += n_particles
    theta_np, qoi_np = theta.cpu().numpy(), qoi.cpu().numpy()
    wall = time.perf_counter() - t0
    return _result_dict(
        theta_np, qoi_np, log_z_island, lambdas, acc_rates, beta_c,
        wall, n_particles, d, N_ISLANDS,
        extra={"levels": levels, "n_forward": n_fwd})
