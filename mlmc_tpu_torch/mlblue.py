"""Multilevel best linear unbiased estimators (counterpart of
``mlmc_tpu/mlblue.py``).

Schaden & Ullmann ("On multilevel best linear unbiased estimators",
SIAM/ASA JUQ 8, 2020): given M coupled models with unknown mean vector
``m`` (model 0 the high-fidelity target), draw independent sample groups
(group k evaluates the model subset ``S_k`` on ``n_k`` shared identities)
and form the generalized-least-squares estimate

    m_hat = Psi^{-1} sum_k n_k R_k^T C_k^{-1} ybar_k,
    Psi   = sum_k n_k R_k^T C_k^{-1} R_k,

``ybar_k`` group k's sample-mean vector, ``C_k`` the model covariance
restricted to ``S_k``, ``R_k`` the coordinate selector. ``m_hat[0]`` is the
minimum-variance linear unbiased combination of the group means, with
``Var = [Psi^{-1}]_00`` in closed form for any allocation.

Each group streams chunks of its shared identities through its member
models and adds the per-model sums and the ``[|g|, |g|]`` cross products
(a float64 product per chunk) to float64 accumulators, where
``mlmc_tpu`` keeps Kahan-compensated float32; the last chunk masks its
tail so the counts are exact. The pilot is the all-models group; the
M x M algebra (GLS solve, allocation by mirror descent) runs on the host
in numpy. Group ``k`` draws sample ``i`` as the identity (seed, 10000 + k,
i) (JAX: ``fold_in(fold_in(key(seed), 10000 + k), i)``); the pilot group
is ``k = len(groups) + 1``.

Caveats: ``C_k`` comes from the pilot (plug-in BLUE), and the allocation
is optimal on the continuous relaxation, rounded up.
"""
import itertools
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["mlblue", "default_groups", "blue_variance"]

#: the keyed level id of group k is GROUP_STREAM + k
GROUP_STREAM = 10_000


def default_groups(n_models: int):
    """Singletons, adjacent pairs (the MLMC couplings) and the full set
    (the pilot-style group)."""
    groups = [(i,) for i in range(n_models)]
    groups += [(i, i + 1) for i in range(n_models - 1)]
    if n_models > 2:
        groups.append(tuple(range(n_models)))
    return groups


def _psi(groups, C, n):
    M = C.shape[0]
    psi = np.zeros((M, M))
    for k, g in enumerate(groups):
        if n[k] <= 0:
            continue
        idx = np.asarray(g)
        Ck_inv = np.linalg.inv(C[np.ix_(idx, idx)])
        psi[np.ix_(idx, idx)] += n[k] * Ck_inv
    return psi


def blue_variance(groups, C, n, hifi: int = 0):
    """Model-predicted BLUE variance ``[Psi(n)^{-1}]_hifi,hifi`` of an
    allocation (the allocation objective)."""
    psi = _psi(groups, C, np.asarray(n, float))
    e = np.zeros(C.shape[0])
    e[hifi] = 1.0
    return float(e @ np.linalg.solve(psi, e))


def _allocate(groups, C, costs, budget, hifi, n_iter=400):
    """Continuous allocation: minimize [Psi(n)^{-1}]_00 over the cost
    simplex ``sum_k n_k c_k = budget`` by exponentiated (mirror) gradient
    descent; the objective is convex in n (Schaden-Ullmann Thm. 3.4) and
    the multiplicative update stays feasible."""
    K = len(groups)
    gc = np.array([sum(costs[i] for i in g) for g in groups])
    n = np.full(K, budget / K) / gc          # equal cost share start
    M = C.shape[0]
    e = np.zeros(M)
    e[hifi] = 1.0
    best_n, best_v = n.copy(), np.inf
    for it in range(n_iter):
        psi = _psi(groups, C, n)
        try:
            v = np.linalg.solve(psi, e)
        except np.linalg.LinAlgError:
            break
        var = float(e @ v)
        if var < best_v:
            best_v, best_n = var, n.copy()
        # d var / d n_k = -(v_k)^T C_k^{-1} v_k (restricted to group k)
        grad = np.empty(K)
        for k, g in enumerate(groups):
            idx = np.asarray(g)
            vk = v[idx]
            grad[k] = -float(vk @ np.linalg.solve(C[np.ix_(idx, idx)], vk))
        # mirror step on the cost simplex
        step = 0.5 / (1.0 + it / 40.0)
        w = n * gc / budget
        scores = -grad * n / np.maximum(w, 1e-300)  # per unit cost
        scores = scores / max(scores.max(), 1e-300)
        w = w * np.exp(step * scores)
        w = w / w.sum()
        n = w * budget / gc
    return best_n, best_v


def mlblue(model_fns: Sequence[Callable], costs: Sequence[float],
           budget: Optional[float] = None,
           target_var: Optional[float] = None,
           groups: Optional[Sequence] = None, hifi: int = 0,
           n_pilot: int = 1 << 12, seed: int = 0,
           chunk_size: int = 1 << 12, min_group: int = 32,
           dtype=torch.float64, device=None):
    """BLUE of the high-fidelity mean from coupled model groups.

    :param model_fns: ``model(keys) -> [C]`` batch callables, one per model,
        coupled by the shared identities (the contract of
        :class:`~mlmc_tpu_torch.multifidelity.MFMC`)
    :param costs: relative cost per evaluation of each model
    :param budget: total cost to spend (exclusive with target_var)
    :param target_var: variance target: the optimal shape is scaled until
        the model-predicted variance meets it
    :param groups: model-index subsets to sample (default
        :func:`default_groups`); every model must appear in some group
    :param min_group: at least this many samples in every group with a
        positive allocation
    :param dtype: the models' evaluation dtype (sums are float64)
    :param device: where the chunks run; None = the current CUDA device
    :return: dict with ``mean`` (BLUE of model ``hifi``), ``var``
        (plug-in [Psi^{-1}]_00), ``means`` [M], ``n_per_group``, ``groups``,
        ``pilot_cov``, ``mlmc_var`` / ``efficiency_vs_mlmc`` (the
        same-budget telescope when the pair groups are there),
        ``n_evaluations``, ``cost_spent``, ``wall_s``
    """
    M = len(model_fns)
    if M < 2:
        raise ValueError("need at least two models")
    if len(costs) != M:
        raise ValueError("need one cost per model")
    if (budget is None) == (target_var is None):
        raise ValueError("pass exactly one of budget / target_var")
    groups = ([tuple(sorted(g)) for g in groups] if groups is not None
              else default_groups(M))
    covered = set(itertools.chain.from_iterable(groups))
    if covered != set(range(M)):
        raise ValueError(f"groups must cover every model 0..{M - 1}; "
                         f"missing {sorted(set(range(M)) - covered)}")
    if not 0 <= hifi < M:
        raise ValueError("hifi out of range")
    costs = np.asarray(costs, float)
    device = resolve_device(device)
    t0 = time.perf_counter()

    def group_sums(gi, g, n_total):
        """Sums of each member model and their cross products over the
        group's first ``n_total`` identities, float64 numpy."""
        s = torch.zeros(len(g), dtype=torch.float64, device=device)
        xp = torch.zeros(len(g), len(g), dtype=torch.float64, device=device)
        for c in range(-(-int(n_total) // chunk_size)):
            idx = c * chunk_size + torch.arange(chunk_size, dtype=torch.int64,
                                                device=device)
            keys = SampleKeys(int(seed), GROUP_STREAM + gi, idx)
            vals = torch.stack([model_fns[i](keys).to(dtype) for i in g]).double()
            vals = torch.where((idx < n_total)[None, :], vals, 0.0)
            s = s + vals.sum(1)
            xp = xp + vals @ vals.T
        return s.cpu().numpy(), xp.cpu().numpy()

    # ---- pilot: the all-models group estimates the covariance ------ #
    n_p = max(int(n_pilot), 2 * M + 2)
    s, xp = group_sums(len(groups) + 1, tuple(range(M)), n_p)
    mu_p = s / n_p
    C = (xp / n_p - np.outer(mu_p, mu_p)) * n_p / (n_p - 1)
    # SPD guard for near-deterministic surrogates
    C = C + 1e-12 * np.trace(C) / M * np.eye(M)

    # ---- allocation -------------------------------------------------- #
    if budget is None:
        n1, v1 = _allocate(groups, C, costs, 1.0, hifi)
        n_opt = n1 * (v1 / target_var)          # var scales as 1/n
    else:
        n_opt, _ = _allocate(groups, C, costs, float(budget), hifi)
    n_int = np.zeros(len(groups), dtype=np.int64)
    for k, nk in enumerate(n_opt):
        if nk >= 0.5:
            n_int[k] = max(int(np.ceil(nk)), min_group)
    # identifiability: Psi is singular unless every model sits in some
    # positive group; bump its cheapest covering group
    for i in range(M):
        if not any(n_int[k] > 0 and i in g for k, g in enumerate(groups)):
            k_min = min((k for k, g in enumerate(groups) if i in g),
                        key=lambda k: sum(costs[j] for j in groups[k]))
            n_int[k_min] = max(n_int[k_min], min_group)

    # ---- evaluate the groups ---------------------------------------- #
    ybars = []
    n_eval = n_p * M
    for k, g in enumerate(groups):
        if n_int[k] == 0:
            ybars.append(None)
            continue
        s, _ = group_sums(k, g, int(n_int[k]))
        ybars.append(s / n_int[k])
        n_eval += int(n_int[k]) * len(g)

    # ---- GLS solve --------------------------------------------------- #
    psi = _psi(groups, C, n_int.astype(float))
    rhs = np.zeros(M)
    for k, g in enumerate(groups):
        if ybars[k] is None:
            continue
        idx = np.asarray(g)
        rhs[idx] += n_int[k] * np.linalg.solve(C[np.ix_(idx, idx)], ybars[k])
    m_hat = np.linalg.solve(psi, rhs)
    e = np.zeros(M)
    e[hifi] = 1.0
    var = float(e @ np.linalg.solve(psi, e))

    # same-budget MLMC comparison on the pair-telescope groups
    mlmc_var = None
    spent = float(np.sum([n_int[k] * sum(costs[i] for i in g)
                          for k, g in enumerate(groups)]))
    if all((i, i + 1) in groups for i in range(M - 1)):
        # m_0 = E[f_{M-1}] + sum (E[f_i] - E[f_{i+1}]): the variances of
        # the pair differences and of the coarsest model
        dvar = np.array([C[i, i] + C[i + 1, i + 1] - 2 * C[i, i + 1]
                         for i in range(M - 1)] + [C[M - 1, M - 1]])
        dcost = np.array([costs[i] + costs[i + 1]
                          for i in range(M - 1)] + [costs[M - 1]])
        lam = np.sum(np.sqrt(dvar * dcost))
        mlmc_var = float(lam ** 2 / max(spent, 1e-300))
    out = {"mean": float(m_hat[hifi]), "var": var, "means": m_hat,
           "n_per_group": n_int, "groups": groups, "pilot_cov": C,
           "n_evaluations": int(n_eval), "cost_spent": spent,
           "wall_s": time.perf_counter() - t0}
    if mlmc_var is not None:
        out["mlmc_var"] = mlmc_var
        out["efficiency_vs_mlmc"] = mlmc_var / max(var, 1e-300)
    return out
