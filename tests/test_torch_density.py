"""Maxent density reconstruction: mlmc_tpu_torch against mlmc_tpu.

Both sides start from the same covariance and moment means (numpy, f64).
The orthogonalization is host numpy on both sides (tolerance 1e-10); the
Newton solve runs in f64 torch here and in f64 JAX (``solver_backend=
"jax"``) there, so multipliers and density agree to rtol 1e-8.
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import mlmc_tpu.moments as jm
import mlmc_tpu.tool.simple_distribution as jsd

import mlmc_tpu_torch.moments as tm
import mlmc_tpu_torch.tool.simple_distribution as tsd

torch.set_num_threads(1)

DOMAIN = (-4.0, 4.0)


def _cov_and_mean(R, seed=0, n=200_000):
    """Sampled covariance and means of a Legendre basis under a skewed
    two-component density."""
    rng = np.random.default_rng(seed)
    x = np.where(rng.uniform(size=n) < 0.7, rng.normal(-0.5, 0.8, n),
                 rng.normal(1.5, 0.6, n))
    x = x[(x > DOMAIN[0]) & (x < DOMAIN[1])]
    phi = np.asarray(jm.Legendre(R, DOMAIN).eval_all_np(x))
    return phi.T @ phi / len(x), phi.mean(axis=0)


@pytest.mark.parametrize("tol", [1e-7, None])
def test_construct_ortogonal_moments_matches_jax(tol):
    cov, _ = _cov_and_mean(10)
    j_orto, (j_ev, j_cut, j_L) = jsd.construct_ortogonal_moments(
        jm.Legendre(10, DOMAIN), cov, tol=tol)
    t_orto, (t_ev, t_cut, t_L) = tsd.construct_ortogonal_moments(
        tm.Legendre(10, DOMAIN), cov, tol=tol)
    assert t_cut == j_cut and t_orto.size == j_orto.size
    np.testing.assert_allclose(t_ev, j_ev, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(t_L, j_L, rtol=1e-10, atol=1e-12)
    x = np.linspace(-3.9, 3.9, 50)
    np.testing.assert_allclose(t_orto.eval_all_np(x), j_orto.eval_all_np(x),
                               rtol=1e-10, atol=1e-10)
    assert isinstance(t_orto, tm.TransformedMoments)


def _solve(pkg_sd, pkg_m, backend, R=8):
    cov, mean = _cov_and_mean(R, seed=1)
    orto, info = pkg_sd.construct_ortogonal_moments(pkg_m.Legendre(R, DOMAIN),
                                                    cov, tol=1e-7)
    mu = info[2] @ mean
    data = np.stack((mu, np.ones(orto.size)), axis=1)
    host = {"device": "cpu"} if pkg_sd is tsd else {}
    d = pkg_sd.SimpleDistribution(orto, data, domain=DOMAIN,
                                  solver_backend=backend, **host)
    return d, d.estimate_density_minimize(tol=1e-9)


def test_simple_distribution_matches_jax_solver():
    jd, jres = _solve(jsd, jm, "jax")
    td, tres = _solve(tsd, tm, "torch")
    assert jres.success and tres.success
    np.testing.assert_allclose(td.multipliers, jd.multipliers, rtol=1e-8,
                               atol=1e-10)
    x = np.linspace(-3.95, 3.95, 200)
    np.testing.assert_allclose(td.density(x), jd.density(x), rtol=1e-8)
    np.testing.assert_allclose(td.cdf(x), jd.cdf(x), rtol=1e-8, atol=1e-12)


def test_density_log_matches_jax():
    """log rho on identical multipliers (those of the JAX solve handed to
    both): f64, 1e-10 relative; and exp of it is the unclamped density."""
    jd, _ = _solve(jsd, jm, "jax")
    td, _ = _solve(tsd, tm, "torch")
    td.multipliers = np.array(jd.multipliers)
    x = np.linspace(-3.95, 3.95, 200)
    np.testing.assert_allclose(td.density_log(x), jd.density_log(x),
                               rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(np.exp(td.density_log(x)), td.density(x),
                               rtol=1e-12)


def test_torch_and_numpy_backends_agree():
    nd, nres = _solve(tsd, tm, "numpy")
    td, tres = _solve(tsd, tm, "torch")
    assert nres.success and tres.success
    np.testing.assert_allclose(td.multipliers, nd.multipliers, rtol=1e-8,
                               atol=1e-10)


def test_newton_solve_matches_numpy_mirror():
    rng = np.random.default_rng(4)
    pts, wts = tsd.panels_to_quadrature(np.linspace(-1.0, 1.0, 9))
    q = np.polynomial.legendre.legvander(pts, 5)
    target = rng.normal(0.0, 0.3, size=6)
    mu = q.T @ (np.exp(-(q @ target)) * wts)
    lam0 = np.zeros(6)
    got = tsd._newton_solve(q, wts, mu, lam0, 1e-12)
    want = tsd._newton_solve_np(q, wts, mu, lam0, 1e-12)
    assert got[1] <= 1e-12 and want[1] <= 1e-12
    np.testing.assert_allclose(got[0], want[0], rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(got[0], target, rtol=1e-7, atol=1e-9)


def test_adaptive_panels_match_jax():
    f = lambda x: np.exp(-x * x) * np.abs(np.cos(3 * x))
    jb, ji = jsd.adaptive_panels(f, -4.0, 4.0, tol=1e-11)
    tb, ti = tsd.adaptive_panels(f, -4.0, 4.0, tol=1e-11)
    np.testing.assert_array_equal(tb, jb)
    assert ti == ji


def test_kl_and_l2_match_jax():
    p = st.norm(0, 1).pdf
    q = st.norm(0.2, 1.1).pdf
    assert tsd.KL_divergence(p, q, -5, 5) == pytest.approx(
        jsd.KL_divergence(p, q, -5, 5), rel=1e-12)
    assert tsd.L2_distance(p, q, -5, 5) == pytest.approx(
        jsd.L2_distance(p, q, -5, 5), rel=1e-12)


def test_detect_threshold_matches_jax():
    spectrum = np.sort(np.concatenate([np.logspace(-14, -11, 4),
                                       np.logspace(-6, 0, 8)]))
    t_cut, t_rep = tsd.detect_treshold_slope_change(spectrum)
    j_cut, j_rep = jsd.detect_treshold_slope_change(spectrum)
    assert t_cut == j_cut
    np.testing.assert_allclose(t_rep, j_rep, rtol=1e-12)


def test_lsq_reconstruct_matches_jax():
    cov, _ = _cov_and_mean(4, seed=2)
    vals, vecs = np.linalg.eigh(cov)
    got = tsd.lsq_reconstruct(cov, vals, vecs, 2)
    want = jsd.lsq_reconstruct(cov, vals, vecs, 2)
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-12)
    np.testing.assert_array_equal(got[:, :2], vecs[:, :2])


# --------------------------------------------------------------------- #
# BASELINE config 3: the two-Gaussian target from exact moments
# --------------------------------------------------------------------- #
def _two_gaussians():
    comps = (st.norm(-1.5, 0.6), st.norm(2.0, 1.0))
    pdf = lambda x: sum(0.5 * c.pdf(x) for c in comps)
    lo = min(c.ppf(1e-8) for c in comps)
    hi = max(c.ppf(1 - 1e-8) for c in comps)
    return pdf, lo, hi


def _maxent_from_exact_moments(sd, Legendre, R, **kw):
    """bench_extra.py's config-3 workload: semiexact covariance and
    moments, orthogonalize, solve, KL against the exact pdf, residual."""
    pdf, lo, hi = _two_gaussians()
    mfn = Legendre(R, (lo, hi))
    cov = sd.compute_semiexact_cov(mfn, pdf)
    orto, _ = sd.construct_ortogonal_moments(mfn, cov, tol=1e-13)
    mu = sd.compute_semiexact_moments(orto, pdf)
    d = sd.SimpleDistribution(orto, np.stack((mu, np.ones(orto.size)), axis=1),
                              domain=mfn.domain, **kw)
    result = d.estimate_density_minimize(tol=1e-10)
    kl = sd.KL_divergence(pdf, d.density, lo, hi)
    residual = float(np.linalg.norm(sd.compute_semiexact_moments(orto, d.density) - mu))
    return result, float(kl), residual, orto.size


def test_exact_and_semiexact_helpers_match_jax():
    """The four compute_* helpers on the same density: 1e-10."""
    pdf, lo, hi = _two_gaussians()
    jmf, tmf = jm.Legendre(6, (lo, hi)), tm.Legendre(6, (lo, hi))
    for name in ("compute_exact_moments", "compute_semiexact_moments",
                 "compute_exact_cov", "compute_semiexact_cov"):
        got, want = getattr(tsd, name)(tmf, pdf), getattr(jsd, name)(jmf, pdf)
        np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10, err_msg=name)
    # semiexact == exact to the quadrature's tolerance; moment 0 is the mass
    np.testing.assert_allclose(tsd.compute_semiexact_moments(tmf, pdf),
                               tsd.compute_exact_moments(tmf, pdf), atol=1e-9)
    np.testing.assert_allclose(tsd.compute_semiexact_cov(tmf, pdf),
                               tsd.compute_exact_cov(tmf, pdf), atol=1e-9)
    assert abs(tsd.compute_exact_moments(tmf, pdf)[0] - 1.0) < 1e-7


def test_config3_at_15_moments_matches_jax():
    """KL and moment residual within 1% of mlmc_tpu's (the residual, which
    sits at the quadrature's error, also within 1e-10 absolute)."""
    j_res, j_kl, j_resid, j_n = _maxent_from_exact_moments(jsd, jm.Legendre, 15)
    t_res, t_kl, t_resid, t_n = _maxent_from_exact_moments(tsd, tm.Legendre, 15,
                                                           device="cpu")
    assert j_res.success and t_res.success and j_n == t_n == 15
    assert t_kl == pytest.approx(j_kl, rel=1e-2)
    assert t_resid == pytest.approx(j_resid, rel=1e-2, abs=1e-10)


def test_config3_reference_numbers_of_the_chip_script():
    """chip_smoke.py holds the card's 35-moment result to 10x what
    mlmc_tpu gives on the CPU in f64; this measures those two numbers and
    holds the script's constants to them (5%)."""
    import chip_smoke

    res, kl, resid, n = _maxent_from_exact_moments(jsd, jm.Legendre, 35)
    assert res.success and n == 35
    assert chip_smoke.MAXENT35_JAX_KL == pytest.approx(kl, rel=0.05)
    assert chip_smoke.MAXENT35_JAX_RESIDUAL == pytest.approx(resid, rel=0.05)
