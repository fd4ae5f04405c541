"""mlmc_tpu_torch.moments against mlmc_tpu.moments on identical inputs.

Both packages evaluate the same values in float64 (x64 is on in the test
harness); the tolerance is rtol 1e-12, and NaN lanes (safe_eval clipping)
must sit at the same positions.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu.moments as jm
import mlmc_tpu_torch.moments as tm

torch.set_num_threads(1)

RTOL = 1e-12


def _bases(pkg):
    leg = pkg.Legendre(7, (-3.0, 5.0))
    return {
        "legendre": leg,
        "monomial": pkg.Monomial(6, (0.0, 10.0)),
        "fourier": pkg.Fourier(7, (0.0, 10.0)),
        "transformed": pkg.TransformedMoments(
            leg, np.random.default_rng(3).normal(size=(5, 7))),
        "legendre_log": pkg.Legendre(5, (0.5, 20.0), log=True),
        "legendre_noclip": pkg.Legendre(6, (-3.0, 5.0), safe_eval=False),
    }


NAMES = list(_bases(tm))


def _values():
    rng = np.random.default_rng(11)
    # inside and outside every domain: exercises the NaN clipping
    return np.concatenate([rng.uniform(0.6, 4.9, size=40),
                           rng.uniform(-8.0, 25.0, size=24)])


def _close(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    assert np.array_equal(np.isnan(a), np.isnan(b))
    np.testing.assert_allclose(np.nan_to_num(a), np.nan_to_num(b),
                               rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_eval_all_matches_jax(name):
    x = _values()
    want = np.asarray(_bases(jm)[name].eval_all(x))
    got = _bases(tm)[name].eval_all(torch.from_numpy(x))
    assert got.dtype == torch.float64
    _close(got.numpy(), want)


@pytest.mark.parametrize("name", NAMES)
def test_eval_all_np_matches_jax(name):
    x = _values()
    _close(_bases(tm)[name].eval_all_np(x), _bases(jm)[name].eval_all_np(x))


@pytest.mark.parametrize("name", NAMES)
def test_eval_all_sizes_and_scalars(name):
    """A smaller ``size``, scalar input and numpy input take the same path."""
    jb, tb = _bases(jm)[name], _bases(tm)[name]
    x = _values()
    _close(tb.eval_all(x, 3).numpy(), np.asarray(jb.eval_all(x, 3)))
    _close(tb.eval_all(1.5).numpy(), np.asarray(jb.eval_all(1.5)))
    if name != "fourier":  # mlmc_tpu's Fourier.eval keeps a reference quirk
        _close(tb.eval(2, x).numpy(), np.asarray(jb.eval(2, x)))


@pytest.mark.parametrize("name", ["legendre", "monomial", "fourier",
                                  "legendre_log"])
def test_transform_and_clip_match_jax(name):
    jb, tb = _bases(jm)[name], _bases(tm)[name]
    x = _values()
    _close(tb.transform(torch.from_numpy(x)).numpy(), np.asarray(jb.transform(x)))
    _close(tb.transform_np(x), jb.transform_np(x))
    t = np.linspace(-2.0, 8.0, 41)
    _close(tb.clip(torch.from_numpy(t)).numpy(), np.asarray(jb.clip(t)))
    _close(tb.inv_transform(torch.tensor(np.asarray(jb.transform(x)))).numpy(),
           np.asarray(jb.inv_transform(jb.transform(x))))


@pytest.mark.parametrize("name", ["legendre", "monomial", "fourier"])
def test_change_size_and_eq_match_jax(name):
    jb, tb = _bases(jm)[name], _bases(tm)[name]
    jc, tc = jb.change_size(4), tb.change_size(4)
    assert tc.size == jc.size == 4
    assert tuple(tc.ref_domain) == tuple(jc.ref_domain)
    assert tc == tb.change_size(4) and tc != tb
    x = _values()
    _close(tc.eval_all(x).numpy(), np.asarray(jc.eval_all(x)))


def test_custom_ref_domain_survives_change_size():
    jb = jm.Monomial(4, (0.0, 10.0), ref_domain=(0.0, 2.0))
    tb = tm.Monomial(4, (0.0, 10.0), ref_domain=(0.0, 2.0)).change_size(6)
    assert tb.ref_domain == (0.0, 2.0)
    x = _values()
    _close(tb.eval_all(x).numpy(), np.asarray(jb.change_size(6).eval_all(x)))


def test_eval_all_keeps_float32_and_device():
    x = torch.linspace(-2.0, 4.0, 9, dtype=torch.float32)
    out = tm.Legendre(5, (-3.0, 5.0)).eval_all(x)
    assert out.dtype == torch.float32 and out.device == x.device
    assert out.shape == (9, 5)


# --------------------------------------------------------------------- #
# derivatives and single-moment evaluation (f64, 1e-10 relative)
# --------------------------------------------------------------------- #
DER_RTOL = 1e-10


def _der_close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(np.nan_to_num(got), np.nan_to_num(want),
                               rtol=DER_RTOL, atol=1e-12)


@pytest.mark.parametrize("name", NAMES)
def test_call_is_eval_all(name):
    x = _values()
    basis = _bases(tm)[name]
    assert torch.equal(torch.nan_to_num(basis(torch.from_numpy(x))),
                       torch.nan_to_num(basis.eval_all(torch.from_numpy(x))))
    _der_close(basis(x).numpy(), np.asarray(_bases(jm)[name](x)))


@pytest.mark.parametrize("size", [1, 2, 6, 25])
def test_legendre_diff_mat_matches_jax(size):
    np.testing.assert_array_equal(tm.legendre_diff_mat(size),
                                  jm.legendre_diff_mat(size))
    leg_t, leg_j = tm.Legendre(size, (-1, 1)), jm.Legendre(size, (-1, 1))
    np.testing.assert_array_equal(leg_t.diff_mat, leg_j.diff_mat)
    np.testing.assert_array_equal(leg_t.diff2_mat, leg_j.diff2_mat)


@pytest.mark.parametrize("name", ["legendre", "legendre_log",
                                  "legendre_noclip", "transformed"])
@pytest.mark.parametrize("method,kwargs", [
    ("eval_diff", {}), ("eval_diff2", {}), ("eval_diff", dict(size=3)),
    ("eval_all_der", dict(degree=1)), ("eval_all_der", dict(degree=2)),
    ("eval_all_der", dict(size=4, degree=3))])
def test_derivatives_match_jax(name, method, kwargs):
    x = _values()
    want = np.asarray(getattr(_bases(jm)[name], method)(x, **kwargs))
    got = getattr(_bases(tm)[name], method)(torch.from_numpy(x), **kwargs)
    assert got.dtype == torch.float64
    _der_close(got.numpy(), want)


def test_eval_diff_is_the_legendre_derivative():
    """vander @ diff_mat equals the derivative of the Legendre polynomials
    (numpy's legder), first and second degree."""
    size = 6
    basis = tm.Legendre(size, (-1.0, 1.0), safe_eval=False)
    x = np.linspace(-0.9, 0.9, 7)
    for degree, got in ((1, basis.eval_diff(x)), (2, basis.eval_all_der(x, degree=2)),
                        (2, basis.eval_diff2(x))):
        ref = np.empty((len(x), size))
        for s in range(size):
            coef = np.zeros(s + 1)
            coef[-1] = 1
            ref[:, s] = np.polynomial.legendre.legval(
                x, np.polynomial.legendre.legder(coef, degree))
        np.testing.assert_allclose(got.numpy(), ref, rtol=DER_RTOL, atol=1e-10)


@pytest.mark.parametrize("name", ["monomial", "fourier", "legendre"])
@pytest.mark.parametrize("i", [0, 1, 2, 5])
def test_single_moment_eval_matches_jax(name, i):
    x = _values()
    want = np.asarray(_bases(jm)[name].eval(i, x))
    got = _bases(tm)[name].eval(i, torch.from_numpy(x))
    _der_close(got.numpy(), want)


def test_bases_without_derivatives_raise_alike():
    for pkg in (jm, tm):
        with pytest.raises(AttributeError):
            pkg.Monomial(4, (0, 1)).eval_diff(np.array([0.5]))
