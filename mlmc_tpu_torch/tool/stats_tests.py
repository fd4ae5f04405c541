"""Statistical test helpers (counterpart of ``mlmc_tpu/tool/stats_tests.py``;
reference mlmc/tool/stats_tests.py:5-54). Samples may be numpy arrays or
tensors on any device.

Note: the reference's ``t_test`` asserts ``p_val < max_p_val`` which rejects
CORRECT samples with probability 1 - max_p_val (an upstream bug — its
docstring describes the opposite). Here the assertions implement the
documented semantics: a correct hypothesis fails with probability
``max_p_val``.
"""
import numpy as np
import scipy.stats as st

from mlmc_tpu_torch.ops.precision import _np as _host


def t_test(mu_0, samples, max_p_val=0.01):
    """Two-tailed one-sample t-test that mean(samples) == mu_0.

    Asserts; false failure probability is max_p_val.
    """
    T, p_val = st.ttest_1samp(_host(samples), mu_0)
    assert p_val > max_p_val, \
        "t-test rejected mean {} (p={:.2g})".format(mu_0, p_val)


def chi2_test(var_0, samples, max_p_val=0.01, tag=""):
    """Two-tailed chi^2 test that var(samples) == var_0. Asserts."""
    samples = _host(samples)
    N = len(samples)
    var = np.var(samples)
    T = var * N / var_0
    pst = st.chi2.cdf(T, df=N - 1)
    p_val = 2 * min(pst, 1 - pst)
    assert p_val > max_p_val, \
        "{} chi2 rejected var {} (sample var {}, p={:.2g})".format(
            tag, var_0, var, p_val)


def anova(level_moments, alpha=0.05):
    """One-way ANOVA across level moment values.

    :return: True if H0 (equal means) cannot be rejected.
    """
    f_value, p_value = st.f_oneway(*(_host(m) for m in level_moments))
    return p_value > alpha
