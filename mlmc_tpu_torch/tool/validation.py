"""Statistical validation harness for MLMC estimators (counterpart of
``mlmc_tpu/tool/validation.py``, over this package's ``Estimate``).

A working re-design of the reference's statistical test fixture
(test/fixtures/mlmc_test_run.py:148-201, class MLMCTest), which documents
the intent — t-test/chi2-based asserts of estimator correctness, variance
regression RMS, variance-of-variance vs the log-chi2 model — but imports a
module (mlmc.archive.estimate) that no longer exists and cannot run.

These checks are tolerance-banded hypothesis tests: a correct estimator
fails each with the configured false-positive probability.
"""
import numpy as np
import scipy.stats as st

import mlmc_tpu_torch.quantity.quantity_estimate as qe
from mlmc_tpu_torch.ops.precision import _np as _host
from mlmc_tpu_torch.tool.stats_tests import chi2_test, anova


def validate_moment_means(estimator, moments_fn, exact_moments,
                          max_p_val=1e-4):
    """Each estimated moment mean is consistent with its exact value.

    Uses the estimator's own variance estimate: z = (est - exact)/std must
    be standard normal; two-tailed test per moment with Bonferroni-style
    conservative max_p_val.
    """
    means, variances = estimator.estimate_moments(moments_fn)
    means = np.asarray(means)
    variances = np.asarray(variances)
    exact_moments = np.asarray(exact_moments)
    failures = []
    for i in range(1, len(means)):
        std = np.sqrt(max(variances[i], 1e-300))
        z = (means[i] - exact_moments[i]) / std
        p = 2 * (1 - st.norm.cdf(abs(z)))
        if p < max_p_val:
            failures.append((i, float(means[i]), float(exact_moments[i]),
                             float(z)))
    assert not failures, \
        "moment means inconsistent with exact values: {}".format(failures)
    return means, variances


def validate_variance_regression(estimator, n_created_samples,
                                 moments_fn=None, max_rel_rms=2.0):
    """The log-variance regression reproduces raw level variances.

    RMS of log(reg/raw) over levels 1.. and moments 1.. must stay within
    max_rel_rms (the reference fixture's 'regression RMS' check intent).
    """
    raw_vars, n_samples = estimator.estimate_diff_vars(moments_fn)
    reg_vars, _ = estimator.estimate_diff_vars_regression(
        n_created_samples, moments_fn, raw_vars=raw_vars)
    raw = np.asarray(raw_vars)[1:, 1:]
    reg = np.asarray(reg_vars)[1:, 1:]
    mask = (raw > 0) & (reg > 0)
    if not np.any(mask):
        return 0.0
    log_ratio = np.log(reg[mask] / raw[mask])
    rms = float(np.sqrt(np.mean(log_ratio ** 2)))
    assert rms < max_rel_rms, \
        "variance regression deviates from raw variances (rms {})".format(rms)
    return rms


def validate_variance_of_variance(estimator, n_samples=None, n_moments=None):
    """Variance of the log level-variance estimate matches the chi2 model.

    For n samples, log(V_est/V) has the variance of log(chi2_{n-1}/(n-1));
    the estimator's quadrature values must be positive, finite and decrease
    with n (sanity of reference estimator.py:136-169 analogue).
    """
    if n_samples is None:
        # standalone default: the collected per-level counts (the private
        # _n_created_samples fallback only exists after a regression call)
        n_samples = np.asarray(
            estimator._sample_storage.get_n_collected(), dtype=int)
        n_samples = n_samples[n_samples > 1]
    var_var = estimator._variance_of_variance(n_samples=n_samples)
    var_var = np.asarray(var_var)
    assert np.all(np.isfinite(var_var)) and np.all(var_var > 0)
    if len(var_var) > 1 and n_samples is not None:
        order = np.argsort(np.asarray(n_samples))
        assert np.all(np.diff(var_var[order]) <= 1e-12), \
            "var-of-var must decrease with sample count"
    # cross-check one value against direct MC of log chi2
    if n_samples is not None:
        n = int(np.asarray(n_samples).ravel()[0])
        if n > 2:
            mc = np.var(np.log(st.chi2.rvs(df=n - 1, size=20000,
                                           random_state=0) / (n - 1)))
            assert abs(var_var[0] - mc) < 0.5 * max(var_var[0], mc) + 1e-3
    return var_var


def validate_level_means_anova(estimator, moments_fn=None, alpha=1e-4):
    """ANOVA: level diff means DIFFER across levels (each level estimates a
    different telescoping correction), asserted per moment column at
    significance ``alpha`` — skipped for single-level runs and for moment
    columns whose corrections are genuinely indistinguishable at the
    collected counts (p-value must simply not be degenerate)."""
    moments_mean = qe.estimate_mean(
        qe.moments(estimator.quantity, estimator._moments_fn
                   if moments_fn is None else moments_fn))
    mfn = estimator._moments_fn if moments_fn is None else moments_fn
    n_levels = estimator._sample_storage.get_n_levels()
    groups = []
    for lvl in range(n_levels):
        chunk = _host(estimator.get_level_samples(lvl, n_samples=2000))
        fine = chunk[0, :, 0]
        diffs = np.asarray(mfn.eval_all_np(fine))[:, 1]
        if chunk.shape[2] > 1:
            coarse = chunk[0, :, 1]
            diffs = diffs - np.asarray(mfn.eval_all_np(coarse))[:, 1]
        groups.append(diffs[~np.isnan(diffs)])
    if len(groups) > 1:
        equal_means = anova(groups, alpha=alpha)
        assert not equal_means, (
            "level diff means are statistically indistinguishable — the "
            "telescoping corrections should differ across levels")
    return moments_mean.l_means


def validate_total_variance(repeated_means, claimed_var, max_p_val=1e-4):
    """Repeated independent estimates must scatter like the claimed
    variance (chi2 test on each moment column)."""
    repeated_means = _host(repeated_means)  # [n_rep, R]
    claimed_var = _host(claimed_var)
    for i in range(1, repeated_means.shape[1]):
        if claimed_var[i] <= 0:
            continue
        chi2_test(claimed_var[i], repeated_means[:, i]
                  - repeated_means[:, i].mean() + 0.0,
                  max_p_val=max_p_val, tag="moment {}".format(i))
