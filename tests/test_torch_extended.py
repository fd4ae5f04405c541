"""The f64 tier's summation order and its derived error bound.

Kernel D (``csrc/samples_mlmc.cu`` on ``csrc/moment_gram.cuh``) cannot run
without a GPU, so its summation order is modelled here in numpy on the
f64 rows of its plain version (the strict reference's rows: the symmetric
transform and the Legendre recurrence in f64):

* a block takes ``SAMPLES_SPAN`` samples of a stream; its 4 warps take
  interleaved 32-sample chunks;
* a warp's Gram accumulators chain 64 products (two chunks) and are then
  flushed by a plain add into the warp's totals;
* sum(d) and sum(d^2) chain, per lane, the 16 samples of a flush period
  whose index within the chunk is the lane's (mod 4), are flushed into the
  lane's totals, and the 4 lanes combine as (t0 + t1) + (t2 + t3);
* the block adds its warps' totals in warp order;
* a stream's blocks are summed in block order with Kahan compensation.

The model rounds each product before it adds it (the tensor cores fuse the
two), so it makes no fewer roundings than the kernel. It is held against a
summation in extended precision (numpy ``longdouble``, 64-bit mantissa on
x86: at most n * 2^-64 * S_abs off the exact sum, 2.7e-15 * S_abs at the
largest count here) within ``extended_error_bound(S_abs)``, S_abs being the
sum of the absolute terms, with no floor under S_abs.
"""
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.ops import precision as port_precision

torch.set_num_threads(1)

DOMAIN = (-4.0, 4.0)
WARPS, CHUNK, FLUSH = 4, 32, 64
FIELDS = ["sums", "sums2", "cov_fine", "cov_coarse"]


def _rows(x32, valid, R):
    """The plain version's f64 Legendre rows [n, R] of f32 QoIs."""
    scale, shift, offset, _lo, _hi = ck.transform_constants(
        DOMAIN, f64=True, symmetric=True)
    t = (torch.from_numpy(x32).to(torch.float64) - shift) * scale + offset
    return ck._basis_rows_plain(t, torch.from_numpy(valid), R).numpy()


def _stream(n, R, has_coarse, seed, spread=0.05):
    """(pf, pc) f64 rows of one stream of n f32 QoIs, with NaNs and
    out-of-domain values dropped as the kernel drops them."""
    rng = np.random.default_rng(seed)
    fine = (rng.normal(size=n) * 1.6).astype(np.float32)
    coarse = (fine + rng.normal(size=n) * spread).astype(np.float32)
    fine[5::97] = np.nan
    coarse[7::89] = 7.5
    ok = lambda x: np.abs(x.astype(np.float64) * 0.25) <= 1.0   # NaN fails
    valid = ok(fine) & ok(coarse) if has_coarse else ok(fine)
    pf = _rows(fine, valid, R)
    return pf, (_rows(coarse, valid, R) if has_coarse else None)


def _kahan_over_blocks(partials):
    """gram_reduce's sum of per-block partials [n_blk, ...] in block order."""
    s = np.zeros_like(partials[0])
    comp = np.zeros_like(s)
    for p in partials:
        y = p - comp
        t = s + y
        comp = (t - s) - y
        s = t
    return s - comp


def _in_warp_order(per_warp):
    """A block's sum of its warps' totals [n_blk, WARPS, ...], from 0."""
    total = np.zeros_like(per_warp[:, 0])
    for w in range(WARPS):
        total = total + per_warp[:, w]
    return total


def _tile_order_sums(pf, pc, span):
    """Kernel D's five sums of rows pf, pc [n, R] in the kernel's order."""
    n, R = pf.shape
    n_blk = max(-(-n // span), 1)
    q = span // (WARPS * FLUSH)            # flushes of one warp per block

    def deal(x):
        """[n_blk, warp, flush, position in the 64-sample chain, R]; rows
        beyond n are zero, as the kernel's out-of-range rows are."""
        full = np.zeros((n_blk * span, R))
        full[:n] = x
        x = full.reshape(n_blk, q, FLUSH // CHUNK, WARPS, CHUNK, R)
        return x.transpose(0, 3, 1, 2, 4, 5).reshape(n_blk, WARPS, q, FLUSH, R)

    def flushes(chains):
        """Plain adds of a warp's (or lane's) flushes [.., q, ...] in order."""
        total = np.zeros_like(chains[:, :, 0])
        for i in range(q):
            total = total + chains[:, :, i]
        return total

    def gram(x):
        acc = np.zeros(x.shape[:3] + (R, R))
        for j in range(FLUSH):
            acc = acc + x[..., j, :, None] * x[..., j, None, :]
        return _kahan_over_blocks(_in_warp_order(flushes(acc)))

    xf = deal(pf)
    xc = deal(pc) if pc is not None else None
    d = xf - xc if xc is not None else xf
    # position j of a chain is sample 4 k + t of the flush period: lane t
    lanes = d.reshape(d.shape[:3] + (FLUSH // 4, 4, R))
    sd = np.zeros(d.shape[:3] + (4, R))
    sd2 = np.zeros_like(sd)
    for k in range(FLUSH // 4):
        sd = sd + lanes[..., k, :, :]
        sd2 = sd2 + lanes[..., k, :, :] * lanes[..., k, :, :]
    out = {}
    for name, chains in (("sums", sd), ("sums2", sd2)):
        td = flushes(chains)                             # [n_blk, W, 4, R]
        warp = (td[..., 0, :] + td[..., 1, :]) + (td[..., 2, :] + td[..., 3, :])
        out[name] = _kahan_over_blocks(_in_warp_order(warp))
    out["cov_fine"] = gram(xf)
    out["cov_coarse"] = gram(xc) if xc is not None else np.zeros((R, R))
    return out


def _extended_precision_sums(pf, pc):
    """(sums, S_abs) in longdouble; see the module's note on its error."""
    ld = np.longdouble
    assert np.finfo(ld).eps < 1e-18, "longdouble is no wider than double here"
    f = pf.astype(ld)
    c = np.zeros_like(f) if pc is None else pc.astype(ld)
    # the kernel sums its own f64 differences, as the strict reference does
    d = (pf - pc if pc is not None else pf).astype(ld)
    def gram(x):   # einsum runs numpy's longdouble loop ~8x faster than @
        return np.einsum("ni,nj->ij", x, x)

    sums = dict(sums=d.sum(0), sums2=(d * d).sum(0), cov_fine=gram(f),
                cov_coarse=gram(c))
    # S_abs only scales the bound: f64 is enough for the absolute Grams
    af = np.abs(pf)
    ac = np.zeros_like(af) if pc is None else np.abs(pc)
    s_abs = dict(sums=np.abs(d).sum(0), sums2=(d * d).sum(0),
                 cov_fine=af.T @ af, cov_coarse=ac.T @ ac)
    return sums, s_abs


def _assert_within_bound(pf, pc, span=None):
    span = ck.SAMPLES_SPAN if span is None else span
    got = _tile_order_sums(pf, pc, span)
    want, s_abs = _extended_precision_sums(pf, pc)
    for name in FIELDS:
        err = np.abs(got[name].astype(np.longdouble) - want[name])
        bound = port_precision.extended_error_bound(s_abs[name].astype(np.float64))
        assert np.all(err <= bound), (name, float(np.max(err - bound)))


@pytest.mark.parametrize("has_coarse", [True, False])
@pytest.mark.parametrize("n", [1, 63, 65, (1 << 14) + 1, 3 << 14])
@pytest.mark.parametrize("R", [1, 8, 25, 32])
def test_tile_summation_order_within_extended_bound(R, n, has_coarse):
    pf, pc = _stream(n, R, has_coarse, seed=R + n % 1000)
    _assert_within_bound(pf, pc)


def test_tile_summation_order_under_cancellation():
    """phi_f ~ phi_c: sum(d) and sum(d^2) are sums of small differences and
    are held to their own (small) S_abs, which a sum derived from the
    Grams' first columns would miss."""
    pf, pc = _stream((1 << 14) + 777, 25, True, seed=5, spread=1e-6)
    d_abs = np.abs(pf - pc).sum(0)
    assert np.all(d_abs[1:] < 1e-3 * np.abs(pf).sum(0)[1:])
    _assert_within_bound(pf, pc)


def test_tile_order_model_matches_plain_version():
    """The model and the plain version sum the same terms: they agree
    within the f64 tier's contract, and exactly in the valid count's row
    (sums of ones are exact)."""
    n, R = 5000, 12
    pf, pc = _stream(n, R, True, seed=2)
    got = _tile_order_sums(pf, pc, ck.SAMPLES_SPAN)
    want = ck._row_sums(torch.from_numpy(pf), torch.from_numpy(pc))
    s_abs = ck._row_sums(torch.from_numpy(pf), torch.from_numpy(pc),
                         absolute=True)
    for name, w, a in zip(FIELDS, want, s_abs):
        assert np.all(np.abs(got[name] - w.numpy())
                      <= 1e-12 * np.maximum(a.numpy(), 1.0)), name
    assert got["cov_fine"][0, 0] == float(pf[:, 0].sum())


@pytest.mark.parametrize("span", [1 << 12, 1 << 14, 1 << 16])
def test_extended_bound_follows_the_span(span, monkeypatch):
    """The constant counts the flushes of one warp per block, so it moves
    with the span, and the bound reads the kernel's span when it is
    called; at every span tried it stays inside the 1e-12 contract, and a
    model run at that span stays inside it."""
    base = port_precision.extended_bound_constant(span)
    assert port_precision.extended_bound_constant(2 * span) - base \
        == 4 * span // (WARPS * FLUSH)
    monkeypatch.setattr(ck, "SAMPLES_SPAN", span)
    assert port_precision.extended_bound_constant() == base
    bound = float(port_precision.extended_error_bound(1.0))
    assert bound == port_precision.EPS64 * base
    assert bound < 1e-12
    pf, pc = _stream(span + 300, 8, True, seed=span % 97)
    _assert_within_bound(pf, pc, span)


def test_extended_bound_at_the_kernel_span():
    """4 * (64 recurrence + 64 chain + 64 flushes + 4 warps + 2 Kahan)."""
    assert ck.SAMPLES_SPAN == 1 << 14
    assert port_precision.extended_bound_constant() == 4 * 198
    assert 1.7e-13 < float(port_precision.extended_error_bound(1.0)) < 1.8e-13


# --------------------------------------------------------------------- #
# the recurrences' division by n (csrc/moment_gram.cuh, div_small)
# --------------------------------------------------------------------- #
def _rn(x, dtype):
    """The Fraction x rounded to ``dtype``'s precision, ties to even (exact
    above the subnormal range)."""
    if x == 0:
        return dtype(0.0)
    p = np.finfo(dtype).nmant + 1
    e = math.frexp(float(x))[1] - p            # close; the loops settle it
    while abs(x) >= Fraction(2) ** (e + p):
        e += 1
    while abs(x) < Fraction(2) ** (e + p - 1):
        e -= 1
    scaled = x / Fraction(2) ** e              # 2^(p-1) <= |scaled| < 2^p
    m = round(scaled)                          # Python rounds ties to even
    return dtype(np.ldexp(float(m), e))        # exact: m has at most p + 1 bits


def _div_small_model(a, n):
    """The kernels' a / n in a's type: q = RN(a y), r = fma(-n, q, a),
    RN(q + r y) with y = RN(1 / n); each fma is the exact rational result
    rounded once."""
    dtype = type(a)
    y = dtype(1.0) / dtype(n)
    q = a * y
    exact_r = Fraction(float(a)) - n * Fraction(float(q))
    r = _rn(exact_r, dtype)
    assert Fraction(float(r)) == exact_r                    # r is exact
    return _rn(Fraction(float(q)) + exact_r * Fraction(float(y)), dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n", range(2, 32))
def test_reciprocal_division_is_the_ieee_quotient(n, dtype):
    """Random dividends over many binades, the recurrence's own numerators,
    and dividends a step or two from a multiple of n or of n/2 ulp (the
    quotients nearest to a representable value or to a midpoint)."""
    rng = np.random.default_rng(n)
    p = np.finfo(dtype).nmant
    a = rng.standard_normal(1000) * 2.0 ** rng.integers(-40, 40, size=1000)
    t = rng.uniform(-1, 1, size=1000).astype(dtype)
    p1, p2 = rng.uniform(-1, 1, size=(2, 1000)).astype(dtype)
    numerators = dtype(2 * n - 1) * t * p1 - dtype(n - 1) * p2
    near = (rng.integers(1, 1 << p, size=200) * n).astype(dtype)
    near = np.concatenate([np.nextafter(near, dtype(np.inf)),
                           np.nextafter(near, dtype(0)), near,
                           near / dtype(2) + rng.integers(-2, 3, size=200).astype(dtype)])
    cases = np.concatenate([a.astype(dtype), numerators, near, np.asarray(
        [0.0, 1.0, -1.0, n, 1e-30, -3e25], dtype=dtype)])
    assert cases.dtype == dtype
    with np.errstate(over="ignore"):
        for value in cases:
            assert _div_small_model(value, n) == value / dtype(n), (value, n)
