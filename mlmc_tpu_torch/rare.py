"""Rare-event probabilities (counterpart of ``mlmc_tpu/rare.py``): subset
simulation and cross-entropy importance sampling.

Subset simulation (Au & Beck, Prob. Eng. Mech. 16, 2001) factors a tail
probability ``P[g(theta) > gamma]`` of a N(0, I) input through an adaptive
ladder of intermediate thresholds, ``prod_j P[g > gamma_{j+1} | g >
gamma_j]``, each factor ~``p0`` estimated from a population kept in the
conditional law by conditional pCN moves (the pCN proposal preserves the
prior, so the accept is ``g(proposal) > gamma_j``; Papaioannou et al.
2015). The cross-entropy method (Rubinstein 1999) tilts a Gaussian
proposal toward the failure domain and finishes with one importance
sampling stage.

**Batch contract.** ``g_fn(theta [N, d]) -> [N]`` and ``qoi_fn(theta [N,
d]) -> [N, q]`` evaluate a population at once. The population is [islands,
m, d] on the device; each subset stage resamples the exceeders and runs
the moves as a Python loop there, and the ladder (per-island quantiles,
which islands are done) is float64 numpy on the host, from one fetch per
stage. Error bars are across-island CLT errors.

**Draws.** Subset simulation: particle b's draws are chain b's of
``mcmc.KeyedChainDraws`` with fan-out ``(n_moves,)`` (initial state; at
``(stage,)`` the resampling uniform of its island's first particle; at
``(stage, move)`` the innovation). Cross-entropy: stage s's sample i is
chain i's normals at step s of stream 1 (the final stage at step 10000).
``draws=`` replaces either (a test hands in JAX's).
"""
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.mcmc import KeyedChainDraws
from mlmc_tpu_torch.random.keyed import SampleKeys
from mlmc_tpu_torch.smc import _searchsorted

__all__ = ["subset_simulation", "cross_entropy_is"]

#: the cross-entropy method's final stage counter
FINAL_STAGE = 10_000


def subset_simulation(g_fn: Callable, gamma: float, d: int,
                      n_particles: int = 2048, p0: float = 0.1,
                      n_moves: int = 6, beta: float = 0.5, seed: int = 0,
                      max_stages: int = 60, prior_sampler=None,
                      qoi_fn: Optional[Callable] = None,
                      dtype=torch.float64, n_islands: int = 8,
                      device=None, draws=None):
    """Estimate ``P[g_fn(theta) > gamma]`` under a N(0, I_d) prior.

    :param g_fn: ``theta [N, d] -> [N]`` response. For a non-Gaussian
        prior, absorb the transform into ``g_fn``: the conditional pCN
        kernel is exact only for the standard normal
    :param gamma: the rare threshold
    :param p0: per-stage conditional probability level (the ladder steps
        at the per-island (1-p0) population quantile)
    :param n_moves: conditional pCN sweeps per stage; ``beta`` adapts on
        the device after every sweep toward 0.44 acceptance and carries
        across rungs
    :param prior_sampler: optional ``keys -> theta [N, d]`` initial
        population from the particles' ``SampleKeys`` (seed, 0, b)
        (must still be N(0, I))
    :param qoi_fn: optional ``theta [N, d] -> [N, q]``; the result then
        carries ``E[qoi | g > gamma]`` with island errors
    :param device: where the population runs; None = the current CUDA
        device
    :param draws: ``init()`` and a call per path in place of
        ``KeyedChainDraws(seed, n_particles, d, ..., fanout=(n_moves,))``
    :return: dict with ``p``, ``log_p``, ``log_p_se`` (across-island CLT
        error of log p), ``p_lo``/``p_hi`` (1-sigma band), ``thresholds``,
        ``acc_rates``, ``n_stages``, ``beta``, ``n_forward``,
        ``cond_qoi``/``cond_qoi_se`` (with ``qoi_fn``), ``theta`` [N, d]
        final conditional population, ``wall_s``
    """
    if n_particles % n_islands:
        raise ValueError(f"n_particles must be divisible by {n_islands} "
                         "(islands)")
    if not 0.0 < p0 < 1.0:
        raise ValueError("p0 must be in (0, 1)")
    m = n_particles // n_islands
    if int(np.ceil((1.0 - p0) * m)) >= m:
        raise ValueError("p0 too small for the island size: need "
                         f"p0 * {m} >= 1 exceeder per island")
    device = resolve_device(device)
    draws = draws or KeyedChainDraws(seed, n_particles, d, dtype, device,
                                     fanout=(n_moves,))
    if prior_sampler is not None:
        theta0 = prior_sampler(SampleKeys(int(seed), 0, torch.arange(
            n_particles, dtype=torch.int64, device=device)))
    else:
        theta0 = draws.init()
    theta = torch.as_tensor(theta0).to(device, dtype).reshape(n_islands, m, d)
    ar = torch.arange(m, dtype=dtype, device=device)[None, :]

    def flat_g(theta):
        return g_fn(theta.reshape(n_islands * m, d)).reshape(n_islands, m)

    def stage(theta, g, thr, beta_c, stage_i):
        """One subset stage at per-island thresholds thr [I]: resample the
        exceeders (uniform weights on {g > thr}), then n_moves conditional
        pCN sweeps (accept iff the proposal still exceeds)."""
        _, u, _ = draws((stage_i,))
        u01 = u.to(device, dtype).reshape(n_islands, m)[:, :1]
        w = (g > thr[:, None]).to(dtype)
        w = w / w.sum(1, keepdim=True)
        idx = _searchsorted(torch.cumsum(w, 1), (u01 + ar) / m, m)
        theta = torch.take_along_dim(theta, idx[:, :, None], dim=1)
        g = torch.take_along_dim(g, idx, dim=1)
        acc = torch.zeros((), dtype=dtype, device=device)
        for j in range(n_moves):
            xi, _, _ = draws((stage_i, j))
            xi = xi.to(device, dtype).reshape(n_islands, m, d)
            prop = torch.sqrt(1.0 - beta_c * beta_c) * theta + beta_c * xi
            g_p = flat_g(prop)
            accept = g_p > thr[:, None]
            theta = torch.where(accept[:, :, None], prop, theta)
            g = torch.where(accept, g_p, g)
            a = accept.to(dtype).mean()
            logit = torch.log(beta_c) - torch.log1p(-beta_c)
            beta_c = torch.sigmoid(logit + 0.5 * (a - 0.44))
            acc = acc + a
        return theta, g, acc / n_moves, beta_c

    t0 = time.perf_counter()
    g = flat_g(theta)
    g_h = g.cpu().numpy().astype(np.float64)
    log_p_island = np.zeros(n_islands)
    done = np.zeros(n_islands, dtype=bool)
    thresholds, acc_rates = [], []
    beta_c = float(beta)
    n_fwd = n_particles
    for stage_i in range(max_stages):
        # per-island ladder step: the (1-p0) quantile, capped at gamma
        thr = np.minimum(np.quantile(g_h, 1.0 - p0, axis=1), gamma)
        frac = np.mean(g_h > thr[:, None], axis=1)
        reached = thr >= gamma
        newly = reached & ~done
        if np.any(frac[newly] <= 0):
            # quantile >= gamma yet no strict exceeders: the response ties
            # at gamma (e.g. clipped at the threshold); the conditional
            # kernel and the final refresh would divide by zero
            raise RuntimeError(
                "an island reached gamma with zero strict exceeders — "
                "the response ties at the threshold (clipped?); use a "
                "strictly smaller gamma or perturb the response")
        # islands finishing this stage: final conditional factor
        log_p_island[newly] += np.log(frac[newly])
        done |= reached
        if done.all():
            thresholds.append(float(gamma))
            break
        if np.any(frac[~done] <= 0):
            raise RuntimeError(
                "an island lost all exceeders — increase n_particles or "
                "p0 (per-island quantile produced an empty subset)")
        # continuing islands accumulate their ~p0 factor; finished
        # islands keep moving at gamma (their estimate is frozen, the
        # moves only enrich the conditional population)
        log_p_island[~done] += np.log(frac[~done])
        thr[done] = gamma
        thresholds.append(float(np.median(thr)))
        theta, g, acc, beta_d = stage(
            theta, g, torch.as_tensor(thr).to(device, dtype),
            torch.tensor(beta_c, dtype=dtype, device=device), stage_i)
        n_fwd += n_particles * n_moves
        # one bundled fetch: responses for the next rung decision plus
        # the diagnostics and the adapted beta
        fetched = torch.cat([g.reshape(-1), torch.stack([acc, beta_d])]).cpu().numpy()
        g_h = fetched[:-2].reshape(n_islands, m).astype(np.float64)
        acc, beta_c = float(fetched[-2]), float(fetched[-1])
        acc_rates.append(acc)
    else:
        raise RuntimeError(
            f"threshold ladder did not reach gamma={gamma} within "
            f"{max_stages} stages (last ladder rung {thresholds[-1]:.4g})"
            " — the response may be bounded below gamma")

    # one final refresh at gamma: islands finishing on the last rung carry
    # populations conditioned on the previous rung; resample the
    # gamma-exceeders and move so theta/qoi are conditional on the event
    theta, g, _, _ = stage(theta, g, torch.full((n_islands,), float(gamma),
                                                dtype=dtype, device=device),
                           torch.tensor(beta_c, dtype=dtype, device=device),
                           max_stages + 1)
    n_fwd += n_particles * n_moves

    wall = time.perf_counter() - t0
    log_p_se = float(log_p_island.std(ddof=1) / np.sqrt(n_islands))
    log_p = float(np.mean(log_p_island))
    out = {"p": float(np.exp(log_p)), "log_p": log_p,
           "log_p_se": log_p_se,
           "p_lo": float(np.exp(log_p - log_p_se)),
           "p_hi": float(np.exp(log_p + log_p_se)),
           "thresholds": thresholds, "acc_rates": acc_rates,
           "n_stages": len(acc_rates) + 1, "beta": beta_c,
           "n_forward": n_fwd, "wall_s": wall,
           "theta": theta.reshape(n_particles, d).cpu().numpy()}
    if qoi_fn is not None:
        q = qoi_fn(theta.reshape(n_islands * m, d))
        q_np = q.cpu().numpy().astype(np.float64).reshape(n_islands, m, -1)
        island_means = q_np.mean(axis=1)
        out["cond_qoi"] = island_means.mean(axis=0)
        out["cond_qoi_se"] = (island_means.std(axis=0, ddof=1)
                              / np.sqrt(n_islands))
    return out


class CrossEntropyDraws:
    """The standard normals [n, d] of cross-entropy stage ``s``: the
    normals of chains 0 .. n-1 at step s of stream 1."""

    def __init__(self, seed, d, dtype=torch.float64, device=None):
        self.seed, self.d, self.dtype = int(seed), int(d), dtype
        self.device = resolve_device(device)

    def __call__(self, s, n):
        k = KeyedChainDraws(self.seed, n, self.d, self.dtype, self.device, stream=1)
        return k._normals(k._words(1, int(s), 1, k._calls)[0])


def cross_entropy_is(g_fn: Callable, gamma: float, d: int,
                     n_per_stage: int = 4096, n_final: int = 1 << 15,
                     rho: float = 0.1, seed: int = 0, max_stages: int = 30,
                     tilt: str = "mean",
                     qoi_fn: Optional[Callable] = None,
                     dtype=torch.float64, device=None, draws=None):
    """Estimate ``P[g_fn(theta) > gamma]`` under a N(0, I_d) prior by the
    cross-entropy method (Rubinstein 1999; de Boer et al., Ann. OR 134,
    2005): adaptively tilt a Gaussian proposal toward the failure domain
    (each stage fits the tilt to the elite top-``rho`` fraction with
    likelihood-ratio weights referring the fit back to the prior) and
    raise the working threshold to the elite quantile until it clears
    ``gamma``; then one large importance-sampling stage estimates
    ``p = E_q[1{g > gamma} N(theta; 0, I) / q(theta)]`` with the
    likelihood-ratio CLT standard error.

    ``tilt="mean"`` shifts the mean only (``N(mu, I)``): the weight stays
    bounded on light-tailed problems. ``tilt="full"`` also fits a
    diagonal sigma, floored at 1 (a sigma below 1 makes the weight
    unbounded along that axis).

    :param draws: ``draws(s, n) -> [n, d]`` standard normals of stage s
        (the final stage is s = 10000) in place of
        :class:`CrossEntropyDraws` (seed, d)
    :return: dict with ``p``, ``log_p``, ``p_se``, ``weight_ess`` (ESS
        fraction of the final IS weights in the failure region),
        ``thresholds``, ``mu``/``sigma`` (final tilt), ``n_forward``,
        ``cond_qoi`` (importance-weighted conditional mean of ``qoi_fn``
        given failure, if provided), ``wall_s``
    """
    if not 0.0 < rho < 1.0:
        raise ValueError("rho must be in (0, 1)")
    if tilt not in ("mean", "full"):
        raise ValueError("tilt must be 'mean' or 'full'")
    device = resolve_device(device)
    draws = draws or CrossEntropyDraws(seed, d, dtype, device)

    def sample(mu, sigma, s, n):
        xi = draws(s, n).to(device, dtype)
        theta = mu[None, :] + sigma[None, :] * xi
        g = g_fn(theta)
        # log prior/proposal ratio (diagonal Gaussian tilt)
        logw = (-0.5 * (theta * theta).sum(1) + 0.5 * (xi * xi).sum(1)
                + torch.log(sigma).sum())
        return theta, g, logw

    mu = torch.zeros(d, dtype=dtype, device=device)
    sigma = torch.ones(d, dtype=dtype, device=device)
    thresholds = []
    n_forward = 0
    t0 = time.perf_counter()
    for it in range(max_stages):
        theta, g, logw = sample(mu, sigma, it, n_per_stage)
        n_forward += n_per_stage
        g_h = g.cpu().numpy().astype(np.float64)
        thr = min(float(np.quantile(g_h, 1.0 - rho)), float(gamma))
        thresholds.append(thr)
        elite = torch.as_tensor(g_h >= thr, device=device)
        # CE update: likelihood-ratio-weighted elite moments (the weighted
        # fit targets prior|{g > thr}, not proposal|elite)
        lw = torch.where(elite, logw, -torch.inf)
        w = torch.exp(lw - lw.max())
        wsum = torch.clamp(w.sum(), min=1e-300)
        mu = (w[:, None] * theta).sum(0) / wsum
        if tilt == "full":
            var = (w[:, None] * (theta - mu[None, :]) ** 2).sum(0) / wsum
            # floor at 1: the tilt may widen, never narrow below the prior
            sigma = torch.clamp(torch.sqrt(var), min=1.0)
        if thr >= gamma:
            break
    else:
        raise RuntimeError(
            f"cross-entropy tilt did not reach gamma={gamma} within "
            f"{max_stages} stages (reached {thresholds[-1]:.4g}) — "
            "raise max_stages/n_per_stage, or use subset_simulation "
            "for irregular failure domains")

    theta, g, logw = sample(mu, sigma, FINAL_STAGE, n_final)
    n_forward += n_final
    g_h = g.cpu().numpy().astype(np.float64)
    logw_h = logw.cpu().numpy().astype(np.float64)
    fail = g_h > gamma
    lw = np.where(fail, logw_h, -np.inf)
    mx = lw.max()
    if not np.isfinite(mx):
        raise RuntimeError(
            "no failure samples in the final IS stage — the CE tilt "
            "collapsed; use subset_simulation")
    w = np.exp(lw - mx)
    p = float(np.mean(w) * np.exp(mx))
    se = float(np.std(w, ddof=1) / np.sqrt(n_final) * np.exp(mx))
    wsum = w.sum()
    ess = float(wsum ** 2 / max((w ** 2).sum(), 1e-300) / n_final)
    out = {"p": p, "log_p": float(np.log(max(p, 1e-300))),
           "p_se": se, "weight_ess": ess,
           "thresholds": thresholds,
           "mu": mu.cpu().numpy().astype(np.float64),
           "sigma": sigma.cpu().numpy().astype(np.float64),
           "n_forward": n_forward,
           "wall_s": time.perf_counter() - t0}
    if qoi_fn is not None:
        q = qoi_fn(theta).cpu().numpy().astype(np.float64)
        out["cond_qoi"] = (w[:, None] * q).sum(0) / max(wsum, 1e-300)
    return out
