"""Multifidelity Monte Carlo (counterpart of ``mlmc_tpu/multifidelity.py``).

MFMC (Peherstorfer, Willcox & Gunzburger, "Optimal model management for
multifidelity Monte Carlo estimation", SIAM J. Sci. Comput. 38(5), 2016)
takes arbitrary surrogates as control variates of the high-fidelity
model 0, all evaluated on nested prefixes of one common input stream
(``m_0 <= m_1 <= ... <= m_K``):

    ``s = ybar_0(m_0) + sum_k alpha_k (ybar_k(m_k) - ybar_k(m_{k-1}))``

unbiased for ``E[f_0]`` for any coefficients and any surrogate bias. With
``alpha_k = rho_k sigma_0 / sigma_k`` and ``r_k = m_k/m_0 =
sqrt(w_0 (rho_k^2 - rho_{k+1}^2) / (w_k (1 - rho_1^2)))`` the variance at
a cost budget ``p = sum_k w_k m_k`` is optimal over allocations and over
model subsets (ibid. Thm. 3.4).

The pilot evaluates every model on one shared chunk of sample identities
and accumulates the ``[K+1, K+1]`` cross-moment matrix as a float64
product ``V V^T`` per chunk (one host fetch); the main stage sums each
model over an interval of stream positions (a masked chunk loop). Sums are
float64 where ``mlmc_tpu`` keeps Kahan-compensated float32. Model subsets
are enumerated on the host with the closed-form variance.

Contract: ``model(keys) -> values [C]`` with ``keys`` a
``random.keyed.SampleKeys``; the same identities give every model the same
random input (the coupling). Stream position ``i`` is the identity
(seed, 0, i) (JAX: ``fold_in(key(seed), i)``). Model 0 is the
high-fidelity target.
"""
import time
from itertools import combinations
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.random.keyed import SampleKeys, keyed_call_normals

__all__ = ["MFMC", "synth_fidelity_models"]


class MFMC:
    """Multifidelity Monte Carlo estimator with optimal model selection.

    :param models: ``[f_0, f_1, ..., f_K]`` batch callables
        (``f(keys) -> [C]``); f_0 is the high-fidelity model
    :param costs: per-evaluation relative costs ``[w_0, ..., w_K]``;
        measured pilot wall time per sample is used if omitted
    :param seed: the seed of the stream's identities; pilot and main stage
        take disjoint position ranges
    :param chunk_size: samples per loop step
    :param dtype: accumulation dtype
    :param device: where the chunks run; None = the current CUDA device
    """

    def __init__(self, models: Sequence[Callable],
                 costs: Optional[Sequence[float]] = None, seed: int = 0,
                 chunk_size: int = 1 << 12, dtype=torch.float64, device=None):
        self._models = list(models)
        if len(self._models) < 2:
            raise ValueError("need the high-fidelity model plus at least "
                             "one surrogate")
        self.K = len(self._models) - 1
        if costs is not None:
            costs = np.asarray(costs, dtype=float)
            if costs.shape != (self.K + 1,) or np.any(costs <= 0):
                raise ValueError("costs must be %d positive numbers"
                                 % (self.K + 1))
        self._given_costs = costs
        self._chunk = int(chunk_size)
        self._dtype = dtype
        self._device = resolve_device(device)
        self._seed = int(seed)
        self._pilot_stats = None
        self._pilot_n = 0

    def _keys(self, c):
        idx = c * self._chunk + torch.arange(self._chunk, dtype=torch.int64,
                                             device=self._device)
        return SampleKeys(self._seed, 0, idx)

    # -------------------------------------------------------------- #
    # pilot: joint moments of all models on a shared stream
    # -------------------------------------------------------------- #
    def reseed(self, seed: int):
        """Fresh input stream (clears the pilot statistics)."""
        self._seed = int(seed)
        self._pilot_stats = None
        self._pilot_n = 0

    def pilot(self, n_pilot: int = 4096):
        """Estimate model variances, correlations with f_0 and (if not
        given) per-sample costs from ``n_pilot`` shared-input evaluations
        of every model, at stream positions [0, n_pilot) rounded up to
        whole chunks (at least two); the main stage continues after them.

        :return: dict(sigma, rho, costs, n_pilot, mean)
        """
        n_chunks = max(-(-int(n_pilot) // self._chunk), 2)
        Kp1 = self.K + 1
        t0 = time.perf_counter()
        s = torch.zeros(Kp1, dtype=torch.float64, device=self._device)
        xx = torch.zeros(Kp1, Kp1, dtype=torch.float64, device=self._device)
        for c in range(n_chunks):
            keys = self._keys(c)
            v = torch.stack([m(keys).to(self._dtype) for m in self._models]).double()
            s = s + v.sum(1)
            xx = xx + v @ v.T
        flat = torch.cat([s, xx.reshape(-1)]).cpu().numpy()
        elapsed = time.perf_counter() - t0
        n = n_chunks * self._chunk
        if not np.all(np.isfinite(flat)):
            raise FloatingPointError("pilot produced non-finite moments")
        s = flat[:Kp1]
        xx = flat[Kp1:].reshape(Kp1, Kp1)
        mean = s / n
        cov = xx / n - np.outer(mean, mean)
        cov *= n / (n - 1)
        sigma = np.sqrt(np.maximum(np.diag(cov), 1e-300))
        rho = cov[0] / (sigma[0] * sigma)
        rho[0] = 1.0
        if self._given_costs is not None:
            costs = self._given_costs.astype(float)
        else:
            # one shared-timing pilot cannot split per-model costs:
            # spread the measured wall equally unless told otherwise
            costs = np.full(Kp1, elapsed / (n * Kp1))
        self._pilot_stats = dict(sigma=sigma, rho=rho, costs=costs,
                                 n_pilot=n, mean=mean)
        self._pilot_n = n
        return dict(self._pilot_stats)

    # -------------------------------------------------------------- #
    # allocation and model selection (host, closed forms)
    # -------------------------------------------------------------- #
    @staticmethod
    def _subset_variance(sigma, rho, costs, budget, subset):
        """Closed-form optimal variance of the estimator restricted to a
        model subset (always containing 0), or (None, None) if the subset
        violates the admissibility ordering (ibid. Lemma 3.3)."""
        idx = list(subset)
        r2 = rho[idx] ** 2                     # rho_0 = 1 by construction
        w = costs[idx]
        if np.any(np.diff(r2) >= 0):           # need strictly decreasing
            return None, None
        denom = 1.0 - r2[1] if len(idx) > 1 else 1.0
        if denom <= 0 or not np.isfinite(denom):
            return None, None
        r2_next = np.append(r2[1:], 0.0)
        r = np.sqrt(w[0] * (r2 - r2_next) / (w * denom))   # r_0 = 1 exactly
        if np.any(np.diff(r) <= 0):            # cost-ratio admissibility
            return None, None
        m0 = budget / float(np.dot(w, r))
        m = m0 * r
        # Var = sigma0^2/m0 - sum_k (1/m_{k-1} - 1/m_k) rho_k^2 sigma0^2
        var = sigma[0] ** 2 / m0
        for k in range(1, len(idx)):
            var -= (1.0 / m[k - 1] - 1.0 / m[k]) * r2[k] * sigma[0] ** 2
        return float(var), m

    def select_models(self, budget: float = 1.0):
        """The variance-optimal admissible model subset for ``budget``,
        with its allocation and the plain-MC variance at the same cost.

        :return: dict(subset, m, var, var_mc, alpha)
        """
        st = self._require_pilot()
        sigma, rho, costs = st["sigma"], st["rho"], st["costs"]
        best = None
        for size in range(0, self.K + 1):
            for combo in combinations(range(1, self.K + 1), size):
                subset = (0,) + combo
                var, m = self._subset_variance(sigma, rho, costs,
                                               float(budget), subset)
                if var is None:
                    continue
                if best is None or var < best[0]:
                    best = (var, subset, m)
        if best is None:
            raise RuntimeError("no admissible model subset (pilot "
                               "correlations degenerate?)")
        var, subset, m = best
        idx = list(subset)
        alpha = rho[idx] * sigma[0] / np.maximum(sigma[idx], 1e-300)
        var_mc = sigma[0] ** 2 * costs[0] / float(budget)
        return dict(subset=subset, m=m, var=var, var_mc=var_mc, alpha=alpha)

    def _require_pilot(self):
        if self._pilot_stats is None:
            raise ValueError("run pilot() first")
        return self._pilot_stats

    # -------------------------------------------------------------- #
    # main stage
    # -------------------------------------------------------------- #
    def _interval_mean(self, model_idx, start, stop):
        """(mean, mean of squares, n) of model ``model_idx`` over stream
        positions [start, stop)."""
        if stop <= start:
            return 0.0, 0.0, 0
        fn = self._models[model_idx]
        acc = torch.zeros(2, dtype=torch.float64, device=self._device)
        for c in range(start // self._chunk, -(-stop // self._chunk)):
            keys = self._keys(c)
            d = fn(keys).to(self._dtype).double()
            d = torch.where((keys.indices >= start) & (keys.indices < stop), d, 0.0)
            acc = acc + torch.stack([d.sum(), (d * d).sum()])
        s, s2 = acc.cpu().numpy()
        if not (np.isfinite(s) and np.isfinite(s2)):
            raise FloatingPointError("model %d produced non-finite values"
                                     % model_idx)
        n = int(stop - start)
        return s / n, s2 / n, n

    def estimate(self, budget: float, n_pilot: int = 4096):
        """Pilot -> model selection -> optimal allocation -> the
        prefix-coupled estimate. ``budget`` is in cost units (``sum_k w_k
        m_k``); the pilot's cost is not deducted. Main-stage samples start
        at the stream position after the pilot.

        :return: dict(mean, var, m, subset, alpha, var_mc, speedup)
        """
        if self._pilot_stats is None:
            self.pilot(n_pilot)
        sel = self.select_models(budget)
        subset, alpha = sel["subset"], sel["alpha"]
        m = np.maximum(np.ceil(sel["m"]).astype(np.int64), 2)
        base = self._pilot_n
        mean0, _, _ = self._interval_mean(subset[0], base, base + int(m[0]))
        total = mean0
        for k in range(1, len(subset)):
            mu_full, _, _ = self._interval_mean(subset[k], base, base + int(m[k]))
            mu_prev, _, _ = self._interval_mean(subset[k], base, base + int(m[k - 1]))
            total += float(alpha[k]) * (mu_full - mu_prev)
        return dict(mean=float(total), var=sel["var"], m=m, subset=subset,
                    alpha=alpha, var_mc=sel["var_mc"],
                    speedup=sel["var_mc"] / max(sel["var"], 1e-300))


# ---------------------------------------------------------------------- #
# synthetic fixture
# ---------------------------------------------------------------------- #
def synth_fidelity_models(mean=1.0, sigma0=1.0, rhos=(0.95, 0.8),
                          biases=(0.3, -0.5), dtype=torch.float64):
    """Model family with exact correlations: with Z (the first normal of
    the sample's Philox call 0) and U_k (of call k + 1) independent
    standard normals,

        ``f_0 = mean + sigma0 Z``
        ``f_k = bias_k + rho_k Z + sqrt(1 - rho_k^2) U_k``

    so ``corr(f_0, f_k) = rho_k``, ``Var f_k = 1``, and the surrogate biases
    must not leak into the estimate.

    :return: list of model callables for :class:`MFMC`
    """
    rhos = [float(r) for r in rhos]
    biases = [float(b) for b in biases]
    if len(biases) != len(rhos):
        raise ValueError("need one bias per surrogate")

    def normals(keys, calls):
        c = torch.tensor(calls, dtype=torch.int64, device=keys.indices.device)
        return keyed_call_normals(keys.seed, keys.level, keys.indices, c, dtype)

    def hi(keys):
        return mean + sigma0 * normals(keys, [0])[:, 0]

    models = [hi]
    for j, (r, b) in enumerate(zip(rhos, biases)):
        def surrogate(keys, r=r, b=b, j=j):
            z, u = normals(keys, [0, j + 1]).unbind(1)
            return b + r * z + np.sqrt(1.0 - r * r) * u

        models.append(surrogate)
    return models
