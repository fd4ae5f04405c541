"""Legendre moments of multilevel differences and the MLMC estimate, in
plain PyTorch and NumPy.

A value x maps onto the reference interval by t = (x - shift) * scale +
offset; a sample is valid when every t it has lies in [lo, hi]; an invalid
sample gives a zero row. Rows are the Legendre polynomials P_0 .. P_{R-1}
of t by the three-term recurrence. A level's accumulators are the sums of
d = P(t_fine) - P(t_coarse) (d = P(t_fine) on level 0), of d^2, and the
Gram matrices of the fine and coarse rows.

Two precisions: ``values``, the dtype of t and the rows, and ``acc``, the
dtype of the sums and of the estimate's arithmetic.
"""
import numpy as np
import torch

CHUNK = 1 << 21
FIELDS = ("sums", "sums2", "cov_fine", "cov_coarse")


def as_value(x, dtype):
    """A Python number rounded to ``dtype`` and back, as a constant of
    that precision enters the arithmetic."""
    return float(torch.tensor(float(x), dtype=torch.float64).to(dtype).double())


def transform(domain, values, ref_domain=(-1.0, 1.0), symmetric=False):
    """(scale, shift, offset, lo, hi) of t = (x - shift) * scale + offset,
    each rounded to ``values``: x = a maps onto lo, or, ``symmetric``, the
    midpoint of the domain onto 0 (offset 0)."""
    a, b = float(domain[0]), float(domain[1])
    lo, hi = float(ref_domain[0]), float(ref_domain[1])
    shift, offset = ((a + b) / 2.0, 0.0) if symmetric else (a, lo)
    return tuple(as_value(c, values)
                 for c in ((hi - lo) / (b - a), shift, offset, lo, hi))


def legendre_rows(t, valid, n_moments):
    """[n, R] rows P_k(t) in t's dtype; invalid samples give zero rows.
    The division by k is by a 0-d tensor (a correctly rounded quotient)."""
    t = torch.where(valid, t, torch.zeros_like(t))
    rows = [valid.to(t.dtype)]
    if n_moments > 1:
        rows.append(t)
    denoms = torch.arange(n_moments, dtype=t.dtype, device=t.device)
    p2, p1 = rows[0], t
    for k in range(2, n_moments):
        cur = ((2 * k - 1) * t * p1 - (k - 1) * p2) / denoms[k]
        rows.append(cur)
        p2, p1 = p1, cur
    return torch.stack(rows, dim=1)


def empty_sums(n_moments, acc, device):
    R = int(n_moments)
    return {"n_valid": 0, "sums": torch.zeros(R, dtype=acc, device=device),
            "sums2": torch.zeros(R, dtype=acc, device=device),
            "cov_fine": torch.zeros(R, R, dtype=acc, device=device),
            "cov_coarse": torch.zeros(R, R, dtype=acc, device=device)}


def add_rows(total, t_fine, t_coarse, valid, n_moments, acc):
    """Add one chunk of mapped values to a level's accumulators."""
    pf = legendre_rows(t_fine, valid, n_moments).to(acc)
    d = pf
    if t_coarse is not None:
        pc = legendre_rows(t_coarse, valid, n_moments).to(acc)
        d = pf - pc
        total["cov_coarse"] += pc.T @ pc
    total["sums"] += d.sum(0)
    total["sums2"] += (d * d).sum(0)
    total["cov_fine"] += pf.T @ pf
    total["n_valid"] += int(valid.sum())


def map_values(x, consts, values):
    """t of values ``x`` in the ``values`` dtype, and its validity."""
    scale, shift, offset, lo, hi = consts
    t = (x.to(values) - shift) * scale + offset
    return t, (t >= lo) & (t <= hi)


def stream_sums(fine, coarse, domain, n_moments, values, acc, valid=None):
    """Accumulators of one stored stream (coarse None on level 0). An
    optional ``valid`` mask further restricts the samples (structured
    quantities share validity across components)."""
    consts = transform(domain, values)
    total = empty_sums(n_moments, acc, fine.device)
    for s in range(0, fine.shape[0], CHUNK):
        sl = slice(s, s + CHUNK)
        t_f, ok = map_values(fine[sl], consts, values)
        t_c = None
        if coarse is not None:
            t_c, ok_c = map_values(coarse[sl], consts, values)
            ok = ok & ok_c
        if valid is not None:
            ok = ok & valid[sl]
        add_rows(total, t_f, t_c, ok, n_moments, acc)
    return total


def to_host(total, acc):
    """Accumulators as numpy arrays of the accumulation precision."""
    np_acc = np.float64 if acc == torch.float64 else np.float32
    return {k: (np_acc(v) if k == "n_valid" else v.cpu().numpy().astype(np_acc))
            for k, v in total.items()}


def estimate(levels):
    """The telescoped MLMC estimate of host accumulators (one dict per
    level): level means and variances, mean, estimator variance and the
    moment covariance, in the accumulators' precision."""
    dt = levels[0]["sums"].dtype
    l_means, l_vars, covs, ns = [], [], [], []
    for lvl, a in enumerate(levels):
        n = dt.type(a["n_valid"])
        one = dt.type(1)
        safe = max(n, one)
        s, s2 = a["sums"], a["sums2"]
        mean = s / safe
        var = ((s2 - s * s / safe) / (n - one) if n > 1
               else np.full_like(s, np.inf))
        l_means.append(mean)
        l_vars.append(var)
        covs.append(a["cov_fine"] / safe - (a["cov_coarse"] / safe if lvl else 0))
        ns.append(n)
    l_means, l_vars, ns = np.stack(l_means), np.stack(l_vars), np.asarray(ns, dtype=dt)
    return {"l_means": l_means, "l_vars": l_vars, "n": ns,
            "mean": l_means.sum(0), "var": (l_vars / np.maximum(ns, 1)[:, None]).sum(0),
            "cov": np.sum(covs, axis=0)}
