"""The allocation of a round of an adaptive run, in plain NumPy (GeoMop/MLMC
``estimator.py``: ``estimate_diff_vars_regression`` and
``estimate_n_samples_for_target_variance``).

* Each moment's level variances V_l, l >= 1, are smoothed by the least
  squares fit log V_l = a + b log h_l + c (log h_l)^2 over the levels whose
  V_l is finite and positive (at least three of them; else V is kept), and
  replaced by the fit on every level l >= 1. Level 0 keeps its V_0. A
  moment whose finite variances are all zero keeps zeros.
* The counts for a target variance T and per-sample costs C_l: for each
  moment, n_l = round(sqrt(V_l / C_l) sum_k sqrt(V_k C_k) / T) as an
  integer, at most V_l L / T and at least 2; a level takes the largest n_l
  over the moments, cast to an integer.
"""
import numpy as np


def regressed(raw, steps):
    """Smoothed level variances [L, R] of raw ones [L, R] on steps [L]."""
    raw = np.asarray(raw, dtype=np.float64)
    out = raw.copy()
    L = raw.shape[0]
    if L < 3:
        return out
    log_h = np.log(np.asarray(steps, dtype=np.float64)[1:])
    design = np.stack([np.ones_like(log_h), log_h, log_h * log_h], axis=1)
    for m in range(raw.shape[1]):
        col = raw[:, m]
        finite = np.isfinite(col)
        if not np.any(col[finite] != 0.0):
            out[:, m] = np.where(finite, col, 0.0)
            continue
        fit = np.isfinite(col[1:]) & (col[1:] > 0.0)
        if fit.sum() < 3:
            continue
        coef = np.linalg.lstsq(design[fit], np.log(col[1:][fit]), rcond=None)[0]
        out[1:, m] = np.exp(design @ coef)
    return out


def counts(target, variances, costs):
    """Sample counts [L] that meet ``target`` for level variances [L, R] and
    per-sample costs [L]."""
    v = np.asarray(variances, dtype=np.float64)
    c = np.asarray(costs, dtype=np.float64)[:, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        total = np.sqrt(v * c).sum(axis=0)
        # cast to integers before the limits, as upstream does: a count
        # that is not a number casts to the most negative integer, and so
        # ends at the least count, 2
        n = np.round(np.sqrt(v / c) * total / target).astype(np.int64)
        n = np.maximum(np.minimum(n, v * v.shape[0] / target), 2.0)
    return n.max(axis=1).astype(np.int64)
