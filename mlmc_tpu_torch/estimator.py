"""Sample-allocation helpers (counterpart of the free functions of
``mlmc_tpu/estimator.py``). Host numpy; the ``Estimate`` class over stored
samples has no counterpart yet.
"""
import numpy as np


def estimate_n_samples_for_target_variance(target_variance, prescribe_vars, n_ops, n_levels):
    """Variance-optimal level allocation n_l ∝ sqrt(V_l / C_l).

    :param prescribe_vars: [L, R] level variances per moment
    :param n_ops: per-level cost C_l
    :return: [L] optimal sample counts (max over moments)
    """
    vars = np.asarray(prescribe_vars, dtype=float)
    n_ops = np.asarray(n_ops, dtype=float)
    sqrt_var_n = np.sqrt(vars.T * n_ops)  # moments in rows, levels in cols
    total = np.sum(sqrt_var_n, axis=1)
    n_samples_estimate = np.round((sqrt_var_n / n_ops).T * total / target_variance).astype(int)
    n_samples_estimate_safe = np.maximum(
        np.minimum(n_samples_estimate, vars * n_levels / target_variance), 2
    )
    return np.max(n_samples_estimate_safe, axis=1).astype(int)


def calc_level_params(step_range, n_levels):
    """Geometric ladder of simulation steps from coarsest to finest.
    A single level runs at the finest step."""
    coarse, fine = step_range
    assert coarse > fine
    if n_levels == 1:
        return [[float(fine)]]
    return [[float(s)] for s in np.geomspace(coarse, fine, n_levels)]


def determine_level_parameters(n_levels, step_range):
    """Geometric interpolation of simulation steps."""
    return calc_level_params(step_range, n_levels)


def determine_n_samples(n_levels, n_samples=None):
    """Per-level target counts: an explicit full vector passes through, a
    [n0] or [n0, nL] prescription expands geometrically (nL defaults to 3)."""
    spec = [100, 3] if n_samples is None else list(np.atleast_1d(n_samples))
    if len(spec) == 1:
        spec.append(3)
    if len(spec) > 2:
        return np.asarray(spec, dtype=int)
    return np.rint(np.geomspace(spec[0], spec[1], n_levels)).astype(int)
