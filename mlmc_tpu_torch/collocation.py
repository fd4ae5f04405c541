"""Sparse-grid stochastic collocation (counterpart of
``mlmc_tpu/collocation.py``).

For QoIs that are smooth in the random parameters, a Smolyak sparse
quadrature (Smolyak 1963; Novak & Ritter 1996; Gerstner & Griebel 1998)
converges spectrally in the number of model evaluations:

    E[f(theta)]  ~  A(w, d) f = sum_{|i| <= d+w} c_i (Q_{i_1} x ... x Q_{i_d}) f

* **Rules**: probabilists' Gauss-Hermite (N(0,1) inputs, m(i) = i),
  nested Clenshaw-Curtis (uniform inputs on [-1,1], m(i) = 2^(i-1)+1),
  Gauss-Legendre.
* **Combination technique**: only multi-indices in the Smolyak band
  ``q-d+1 <= |i| <= q`` contribute, with coefficients
  ``(-1)^(q-|i|) C(d-1, q-|i|)``.
* **Dimension-adaptive** index sets (Gerstner & Griebel, Computing 71,
  2003) grown greedily by the hierarchical surplus.
* **Multilevel collocation** (Teckentrup-Jantsch-Webster-Gunzburger 2015):
  high sparse-grid levels on coarse models, low levels on fine corrections.

Grid construction is host numpy, as in ``mlmc_tpu`` (including the
14-digit rounding of nodes that merges duplicates). **Batch contract.**
``fn(theta [N, d]) -> [N]`` or ``[N, q]``; the device sees one call per
chunk of nodes followed by a weight contraction. The adaptive grid
evaluates each batch of new nodes as it is, in chunks of ``chunk_size``
(``mlmc_tpu`` pads them to powers of two to limit recompiles).
"""
import itertools
import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device

__all__ = ["SparseGrid", "AdaptiveSparseGrid", "multilevel_collocation"]


def _gauss_hermite_1d(n):
    """Probabilists' Gauss-Hermite: exact for N(0,1) moments < 2n.
    hermegauss weights sum to sqrt(2 pi); normalize to probability."""
    x, w = np.polynomial.hermite_e.hermegauss(n)
    return x, w / w.sum()


def _gauss_legendre_1d(n):
    """Gauss-Legendre on [-1, 1] with the UNIFORM probability weight."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w / 2.0


def _clenshaw_curtis_1d(n):
    """Clenshaw-Curtis nodes/weights on [-1, 1], uniform probability
    weight (weights sum to 1). n = 1 gives the midpoint rule."""
    if n == 1:
        return np.zeros(1), np.ones(1)
    j = np.arange(n)
    x = np.cos(np.pi * j / (n - 1))[::-1]
    # exact CC weights by cosine-moment summation
    w = np.zeros(n)
    for k in range(n):
        s = 1.0
        for m in range(1, (n - 1) // 2 + 1):
            term = 2.0 / (1.0 - 4.0 * m * m) * np.cos(
                2.0 * m * np.pi * k / (n - 1))
            if 2 * m == n - 1:
                term *= 0.5
            s += term
        w[k] = 2.0 * s / (n - 1)
    w[0] *= 0.5
    w[-1] *= 0.5
    return x, (w / 2.0)[::-1]


_RULES = {
    "gauss-hermite": (_gauss_hermite_1d, lambda i: i),
    "gauss-legendre": (_gauss_legendre_1d, lambda i: i),
    "clenshaw-curtis": (_clenshaw_curtis_1d,
                        lambda i: 1 if i == 1 else 2 ** (i - 1) + 1),
}


def _values(fn, x):
    """``fn`` on a node batch as [N, q] (a scalar QoI is q = 1)."""
    v = fn(x)
    return v.reshape(x.shape[0], -1)


class SparseGrid:
    """Smolyak sparse quadrature over d i.i.d. inputs.

    :param d: input dimension.
    :param level: Smolyak level w >= 0 (w = 0 is the single-node rule).
    :param rule: "gauss-hermite" (N(0,1) inputs), "clenshaw-curtis" or
        "gauss-legendre" (uniform on [-1, 1]).

    Attributes: ``nodes`` [N, d], ``weights`` [N] (sum to 1 within
    roundoff; individual weights may be negative — Smolyak is not a
    positive rule), ``n_nodes``, ``n_tensor`` (the full-tensor count the
    sparse construction avoided).
    """

    def __init__(self, d: int, level: int, rule: str = "gauss-hermite"):
        if rule not in _RULES:
            raise ValueError(f"unknown rule {rule!r}; "
                             f"choose from {sorted(_RULES)}")
        if d < 1 or level < 0:
            raise ValueError("need d >= 1 and level >= 0")
        self.d, self.level, self.rule = d, level, rule
        make_1d, growth = _RULES[rule]
        cache = {}

        def rule_1d(i):
            if i not in cache:
                cache[i] = make_1d(growth(i))
            return cache[i]

        q = d + level
        acc = {}
        # Smolyak band: q-d+1 <= |i| <= q, i_k >= 1
        for excess in range(min(level, q - d) + 1):
            s = q - excess                       # |i|
            coeff = (-1.0) ** excess * math.comb(d - 1, excess)
            for comp in _compositions(s, d):
                xs, ws = zip(*(rule_1d(i) for i in comp))
                for idx in itertools.product(*(range(len(x))
                                               for x in xs)):
                    node = tuple(round(float(xs[k][idx[k]]), 14)
                                 for k in range(d))
                    wgt = coeff
                    for k in range(d):
                        wgt *= ws[k][idx[k]]
                    acc[node] = acc.get(node, 0.0) + wgt
        nodes = np.array(sorted(acc), dtype=np.float64)
        self.nodes = nodes.reshape(len(acc), d)
        self.weights = np.array([acc[tuple(n)] for n in
                                 self.nodes.tolist()])
        self.n_nodes = len(self.weights)
        self.n_tensor = growth(level + 1) ** d

    def integrate(self, fn: Callable, chunk_size: int = 1 << 14,
                  dtype=torch.float64, device=None):
        """``E[fn(theta)]``: ``fn(theta [C, d]) -> [C]`` or ``[C, q]`` on
        chunks of the nodes, weight-reduced on the device (float64 sum
        over the chunks). Returns a numpy scalar/vector.

        :param device: where the nodes are evaluated (None: the current
            CUDA device)
        """
        device = resolve_device(device)
        nodes = torch.as_tensor(self.nodes).to(device, dtype)
        w = torch.as_tensor(self.weights).to(device, dtype)
        total = None
        for s in range(0, self.n_nodes, chunk_size):
            part = torch.tensordot(w[s:s + chunk_size], fn(nodes[s:s + chunk_size]),
                                   dims=1).to(torch.float64)
            total = part if total is None else total + part
        return total.cpu().numpy()

    def mean_and_var(self, fn: Callable, **kw):
        """(E[f], Var[f]) through one pass integrating (f, f^2).
        Var can come out slightly negative for an under-resolved grid
        (Smolyak weights are signed) — clipped at 0."""
        def f2(theta):
            v = _values(fn, theta)
            return torch.cat([v, v * v], dim=1)
        both = self.integrate(f2, **kw)
        q = both.shape[0] // 2
        mean, second = both[:q], both[q:]
        return mean, np.maximum(second - mean ** 2, 0.0)


class AdaptiveSparseGrid:
    """Dimension-adaptive sparse quadrature (Gerstner & Griebel,
    "Dimension-adaptive tensor-product quadrature", Computing 71, 2003).

    Grows a downward-closed multi-index set greedily by the hierarchical
    surplus indicator,

        Delta_i f = (x)_k (Q_{i_k} - Q_{i_k - 1}) f
                  = sum_{z subset supp(i > 1)} (-1)^{|z|} Q_{i - z} f,

    accepting the active index with the largest |surplus| and opening its
    admissible forward neighbors, until the summed indicator of the
    active frontier drops below ``tol`` or the evaluation budget runs
    out. The running estimate is the sum of all computed surpluses (old +
    active), the combination-technique value of the final index set.

    The index bookkeeping is host integer work; model evaluations run in
    deduplicated batches of new nodes, and node values are cached across
    tensor products, so nested rules never pay for a point twice.
    """

    def __init__(self, d: int, rule: str = "gauss-hermite"):
        if rule not in _RULES:
            raise ValueError(f"unknown rule {rule!r}; "
                             f"choose from {sorted(_RULES)}")
        if d < 1:
            raise ValueError("need d >= 1")
        self.d, self.rule = d, rule
        self._make_1d, self._growth = _RULES[rule]
        self._rule_cache = {}

    def _rule_1d(self, i):
        if i not in self._rule_cache:
            self._rule_cache[i] = self._make_1d(self._growth(i))
        return self._rule_cache[i]

    def integrate(self, fn: Callable, tol: float = 1e-8,
                  max_evals: int = 1 << 14, chunk_size: int = 1 << 11,
                  indicator: str = "surplus", min_level: int = 1,
                  dtype=torch.float64, device=None):
        """Adaptively integrate ``E[fn(theta)]``, theta ~ rule measure.

        :param fn: ``theta [C, d] -> [C]`` or ``[C, q]`` (vector QoIs share
            the node set; the indicator is the max-abs component).
        :param tol: stop when the summed active-frontier indicator
            drops below this (an estimate of the remaining error).
        :param max_evals: hard budget of model evaluations.
        :param indicator: "surplus" (Gerstner-Griebel g_i = |Delta_i|)
            or "surplus_per_eval" (|Delta_i| divided by the new
            evaluations the index cost — favors cheap directions).
        :param min_level: seed the index set with the full isotropic
            Smolyak band ``|i| <= d + min_level`` before going greedy. An
            index whose own surplus is exactly zero (symmetric integrands
            against the 1-node root rule annihilate mixed terms, e.g.
            ``E[x0^2 x1^2]``) is never accepted, hiding its nonzero
            descendants; ``min_level=2`` probes every pairwise mixed index
            once.
        :param device: where the nodes are evaluated (None: the current
            CUDA device)
        :return: dict with ``mean`` (np scalar/[q]), ``error_est``
            (summed active indicator), ``n_evals``, ``indices``
            (downward-closed, sorted), ``converged``, ``history``
            (accepted index, its indicator, cumulative evals).
        """
        device = resolve_device(device)
        if indicator not in ("surplus", "surplus_per_eval"):
            raise ValueError("indicator must be 'surplus' or "
                             "'surplus_per_eval'")
        d = self.d
        node_vals = {}                     # node tuple -> np [q] value
        tensor_vals = {}                   # comp tuple -> np [q] value
        state = {"n_evals": 0}

        def evaluator(nodes):
            """fn on new nodes [n, d], chunk by chunk -> numpy [n, q]."""
            out = []
            for s in range(0, len(nodes), chunk_size):
                x = torch.as_tensor(nodes[s:s + chunk_size]).to(device, dtype)
                out.append(_values(fn, x).cpu().numpy().astype(np.float64))
            return np.concatenate(out, axis=0)

        def tensor_nodes(comp):
            """Tensor-grid nodes/weights of Q_comp as python lists."""
            xs, ws = zip(*(self._rule_1d(i) for i in comp))
            nodes, wgts = [], []
            for idx in itertools.product(*(range(len(x)) for x in xs)):
                node = tuple(round(float(xs[k][idx[k]]), 14)
                             for k in range(d))
                w = 1.0
                for k in range(d):
                    w *= ws[k][idx[k]]
                nodes.append(node)
                wgts.append(w)
            return nodes, wgts

        def tensor_value(comp):
            """Q_comp f, filling the node cache in one batched call."""
            if comp in tensor_vals:
                return tensor_vals[comp]
            nodes, wgts = tensor_nodes(comp)
            missing = [n for n in nodes if n not in node_vals]
            if missing:
                vals = evaluator(np.array(missing, np.float64))
                state["n_evals"] += len(missing)
                for n, v in zip(missing, vals):
                    node_vals[n] = v
            out = sum(w * node_vals[n] for n, w in zip(nodes, wgts))
            tensor_vals[comp] = out
            return out

        def surplus(index):
            """Delta_index f by the difference combination, and the
            evaluations it newly spent."""
            before = state["n_evals"]
            big = [k for k in range(d) if index[k] > 1]
            total = None
            for r in range(len(big) + 1):
                for sub in itertools.combinations(big, r):
                    comp = tuple(index[k] - (1 if k in sub else 0)
                                 for k in range(d))
                    term = ((-1.0) ** r) * tensor_value(comp)
                    total = term if total is None else total + term
            return total, state["n_evals"] - before

        if min_level < 1:
            raise ValueError("min_level must be >= 1")
        est = None
        active, old = {}, set()
        history = []
        converged = False
        # isotropic seed band |i| <= d + min_level: interior accepted,
        # the |i| = d + min_level shell forms the initial frontier
        for s in range(d, d + min_level + 1):
            for comp in _compositions(s, d):
                delta, cost = surplus(comp)
                dlt = np.asarray(delta, np.float64)
                est = dlt if est is None else est + dlt
                g = (float(np.max(np.abs(dlt))), max(cost, 1))
                if s < d + min_level:
                    old.add(comp)
                    history.append((comp, g[0], state["n_evals"]))
                else:
                    active[comp] = g
        while active:
            def score(item):
                g, c = item[1]
                return g / c if indicator == "surplus_per_eval" else g
            err = sum(g for g, _ in active.values())
            # never trust the indicator before the root is expanded: a
            # symmetric integrand gives the 1-node root a ZERO surplus
            # while its neighbors are not (f(0) vs E[f])
            if err <= tol and old:
                converged = True
                break
            if state["n_evals"] >= max_evals:
                break
            best = max(active.items(), key=score)
            idx = best[0]
            old.add(idx)
            history.append((idx, best[1][0], state["n_evals"]))
            del active[idx]
            for k in range(d):
                fwd = tuple(idx[j] + (j == k) for j in range(d))
                admissible = all(
                    fwd[j] == 1
                    or tuple(fwd[m] - (m == j) for m in range(d)) in old
                    for j in range(d))
                if admissible and fwd not in active:
                    dlt, cst = surplus(fwd)
                    est = est + np.asarray(dlt, np.float64)
                    active[fwd] = (float(np.max(np.abs(dlt))),
                                   max(cst, 1))
        err = sum(g for g, _ in active.values())
        indices = sorted(old | set(active))
        mean = est if est.shape[0] > 1 else float(est[0])
        return {"mean": mean, "error_est": float(err),
                "n_evals": state["n_evals"],
                "n_indices": len(indices), "indices": indices,
                "converged": converged or err <= tol,
                "history": history}


def _compositions(total, parts):
    """All tuples of `parts` positive ints summing to `total`."""
    if parts == 1:
        yield (total,)
        return
    for first in range(1, total - parts + 2):
        for rest in _compositions(total - first, parts - 1):
            yield (first,) + rest


def multilevel_collocation(fns: Sequence[Callable], d: int,
                           levels: Optional[Sequence[int]] = None,
                           rule: str = "gauss-hermite",
                           chunk_size: int = 1 << 14,
                           dtype=torch.float64, device=None):
    """Multilevel stochastic collocation: sparse-grid level w_l on the
    MLMC correction ``f_l - f_{l-1}`` (Teckentrup et al. 2015) — the
    smoother and smaller the correction, the cruder its grid.

    :param fns: per-discretization-level ``theta [C, d] -> [C]`` or
        ``[C, q]``, coarsest first, all over the same parametrization (the
        coupling is by shared collocation nodes — exact, no statistical
        error).
    :param levels: sparse-grid level per MLMC level, defaults to
        ``[L-1+base, ..., base]`` decreasing to base=1.
    :param device: where the nodes are evaluated (None: the current CUDA
        device)
    :return: dict with ``mean``, per-level ``corrections``, ``n_nodes``
        per level, ``n_nodes_total`` and the single-level equivalent
        count ``n_nodes_single`` (finest model at the richest grid).
    """
    L = len(fns)
    if levels is None:
        levels = [L - lvl for lvl in range(L)]
    if len(levels) != L:
        raise ValueError("need one sparse-grid level per model level")
    corrections, n_nodes = [], []
    grids = {w: SparseGrid(d, w, rule=rule) for w in set(levels)}
    for lvl, (fn, w) in enumerate(zip(fns, levels)):
        grid = grids[w]
        if lvl == 0:
            contrib = grid.integrate(lambda th, fn=fn: _values(fn, th),
                                     chunk_size=chunk_size, dtype=dtype, device=device)
        else:
            prev = fns[lvl - 1]
            contrib = grid.integrate(
                lambda th, fn=fn, prev=prev: _values(fn, th) - _values(prev, th),
                chunk_size=chunk_size, dtype=dtype, device=device)
        corrections.append(contrib)
        n_nodes.append(grid.n_nodes)
    return {"mean": sum(corrections), "corrections": corrections,
            "n_nodes": n_nodes, "n_nodes_total": int(np.sum(n_nodes)),
            "n_nodes_single": grids[max(levels)].n_nodes,
            "levels": list(levels)}
