"""f64 host references + derived error bounds of the kernels' two tiers.

Counterpart of ``mlmc_tpu/ops/precision.py``. Its double-float bound
(``df_error_bound``) has no counterpart: the GPU has native f64, and the
f64 tier carries the bound of ``extended_error_bound`` below. The
Pallas kernels compute per-sample values in f32 and accumulate in f32 with
Kahan compensation. The CUDA kernels of this package compute the same f32
per-sample values and accumulate in f64, so they sit far inside the bound
below; it stays the contract that both implementations are held to: how
far may a kernel's sums drift from an EXACT (f64) summation of the same f32
per-sample values?

Error model (standard compensated-summation analysis):

* per-sample Legendre values differ from the host's by rounding inside the
  three-term recurrence — at most ``K_REC`` roundings of magnitude
  ``eps32 * |phi|`` each (the recurrence is stable for |t| <= 1, values
  bounded by 1);
* each within-chunk reduction contributes ~``log2(chunk)`` roundings of the
  running partial (tree reduce) — bounded by ``eps32 * K_SUM * sum|term|``;
* Kahan across chunks leaves ONE rounding of the final value instead of
  O(n_chunks) — this is what makes the bound independent of sample count.

Together:  |pallas - f64_ref|  <=  eps32 * C_BOUND * S_abs
with S_abs = sum of |terms| and C_BOUND a conservative constant covering
recurrence depth (R <= 32), reduction trees and margin. The bound is
asserted by the kernel tests and checked on the GPU by chip_smoke.py.
"""
import numpy as np
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck

EPS32 = np.float32(np.finfo(np.float32).eps)  # 1.19e-7
# recurrence (<=2 roundings x 32 steps) + reduction tree (log2 32768 = 15)
# + Kahan residual + 4x margin
C_BOUND = 4 * (2 * 32 + 15 + 2)
# Covariance shares this bound: the Pallas kernel's split self-product
# (mlmc_tpu/ops/pallas_kernels.py:_cov_self_product) carries
# ~(2^-17 + 2^-18) * abs of per-product error, ~3.4x below
# eps32 * C_BOUND; the CUDA kernels' f64 outer products carry ~2^-52.


def f64_reference_moments(noise, n_moments, *, fine_step, coarse_step,
                          domain, is_level0=False, chunk=262144,
                          include_cov=True):
    """Exact-summation reference for the synth noise-input kernel.

    Per-sample values are computed in f32 (matching the kernel's value
    path), sums in f64. Returns the accumulators plus the absolute-value
    sums S_abs that scale the error bound. ``include_cov=False`` skips the
    covariance matmuls (the host-side cost driver) — used by bench.py's
    >=1e7 check where the unit tests already cover covariance.

    :return: dict(sums, sums2, cov_fine, cov_coarse, n_valid,
                  abs_sums, abs_sums2, abs_cov_fine, abs_cov_coarse)
    """
    noise = np.asarray(noise, dtype=np.float32)
    n = noise.shape[0]
    R = n_moments
    a, b = domain
    t_scale = np.float32(2.0 / (b - a))
    t_shift = np.float32((a + b) / 2.0)
    f_step = np.float32(fine_step)
    c_step = np.float32(coarse_step)

    sums = np.zeros(R)
    sums2 = np.zeros(R)
    cov_f = np.zeros((R, R))
    cov_c = np.zeros((R, R))
    abs_sums = np.zeros(R)
    abs_sums2 = np.zeros(R)
    abs_cov_f = np.zeros((R, R))
    abs_cov_c = np.zeros((R, R))
    n_valid = 0

    def legendre_f32(t, valid):
        """f32 three-term recurrence, invalid columns zeroed like the kernel."""
        t = np.where(valid, t, np.float32(0.0)).astype(np.float32)
        phi = np.zeros((R, t.shape[0]), dtype=np.float32)
        phi[0] = valid.astype(np.float32)
        if R > 1:
            phi[1] = t
        for k in range(2, R):
            phi[k] = ((np.float32(2 * k - 1) * t * phi[k - 1]
                       - np.float32(k - 1) * phi[k - 2]) / np.float32(k))
        return phi

    for start in range(0, n, chunk):
        x = noise[start:start + chunk]
        err = np.sqrt(np.float32(1e-4) + np.abs(x), dtype=np.float32)
        fine = (x + f_step * err).astype(np.float32)
        coarse = (x + c_step * err).astype(np.float32)
        t_f = ((fine - t_shift) * t_scale).astype(np.float32)
        t_c = ((coarse - t_shift) * t_scale).astype(np.float32)
        valid = (t_f >= -1) & (t_f <= 1)
        if not is_level0:
            valid &= (t_c >= -1) & (t_c <= 1)

        pf32 = legendre_f32(t_f, valid)
        if is_level0:
            pc32 = None
            dphi = pf32.astype(np.float64)
        else:
            pc32 = legendre_f32(t_c, valid)
            # the kernel subtracts in f32; difference of exact f32 values
            # is itself computed here in f64 of those f32 values
            dphi = pf32.astype(np.float64) - pc32.astype(np.float64)

        sums += dphi.sum(axis=1)
        sq = (dphi * dphi).sum(axis=1)
        sums2 += sq
        abs_sums += np.abs(dphi).sum(axis=1)
        abs_sums2 += sq  # squares are nonnegative: |terms| == terms
        if include_cov:
            pf = pf32.astype(np.float64)
            cov_f += pf @ pf.T
            abs_cov_f += np.abs(pf) @ np.abs(pf).T
            if pc32 is not None:
                pc = pc32.astype(np.float64)
                cov_c += pc @ pc.T
                abs_cov_c += np.abs(pc) @ np.abs(pc).T
        n_valid += int(valid.sum())

    return dict(sums=sums, sums2=sums2, cov_fine=cov_f, cov_coarse=cov_c,
                n_valid=n_valid, abs_sums=abs_sums, abs_sums2=abs_sums2,
                abs_cov_fine=abs_cov_f, abs_cov_coarse=abs_cov_c)


def accumulation_error_bound(abs_sums):
    """Derived bound on |f32-Kahan kernel - f64 reference| (see module doc)."""
    return float(EPS32) * C_BOUND * np.asarray(abs_sums)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_against_f64(result, ref, include_cov=True):
    """Assert the kernel result against the f64 reference + derived bound.

    :param result: SynthMomentResult (tensors on any device, or arrays)
    :param ref: dict from f64_reference_moments
    :return: dict of measured max deviations (for reporting)
    """
    if int(result.n_valid) != ref["n_valid"]:
        raise AssertionError("n_valid %d != reference %d"
                             % (int(result.n_valid), ref["n_valid"]))
    report = {}
    pairs = [("sums", "abs_sums"), ("sums2", "abs_sums2")]
    if include_cov:
        pairs += [("cov_fine", "abs_cov_fine"),
                  ("cov_coarse", "abs_cov_coarse")]
    for name, abs_name in pairs:
        got = _np(getattr(result, name)).astype(np.float64)
        want = ref[name]
        bound = accumulation_error_bound(ref[abs_name])
        err = np.abs(got - want)
        scale = np.maximum(ref[abs_name], 1.0)
        report[name] = float(np.max(err / scale))
        if not np.all(err <= bound + 1e-12):
            worst = np.unravel_index(np.argmax(err - bound), err.shape)
            raise AssertionError(
                "%s exceeds derived f32 bound at %s: err=%.3g bound=%.3g"
                % (name, worst, err[worst], bound[worst]))
    return report


# ------------------------------------------------------------------ #
# f64 tier (kernel D): strict all-f64 reference + derived bound
# ------------------------------------------------------------------ #
EPS64 = float(np.finfo(np.float64).eps)  # 2.2e-16
#: samples between two flushes of a warp's DMMA accumulators, and warps per
#: block (csrc/moment_gram.cuh: kChunk * kFlushChunks, kWarps)
FLUSH_SAMPLES = 64
BLOCK_WARPS = 4
# Kernel D computes the transform and the rows in f64 with the same IEEE
# operations in the same order as the reference (no contraction:
# --fmad=false; its division by n is a reciprocal multiplication with two
# corrections that gives the IEEE quotient: csrc/moment_gram.cuh,
# div_small), so Legendre and monomial values agree bit for bit; only
# Fourier's cos/sin seeds may differ by an ulp, which the angle-addition
# recurrence carries along at most ~2 roundings per step: 2 x 32.
# A term of a sum then passes through these additions, in the kernel's
# order (csrc/moment_gram.cuh), each one rounding of the running value:
# * the DMMA accumulator's chain between two flushes: FLUSH_SAMPLES products
#   (an m16n8k8 instruction adds 8 of them in an order the hardware does
#   not state: counted as 8 roundings);
# * the plain adds of a warp's flushes into its totals: a block's span of
#   SAMPLES_SPAN samples is dealt to BLOCK_WARPS warps in interleaved
#   chunks, so a warp flushes SAMPLES_SPAN / (BLOCK_WARPS * FLUSH_SAMPLES)
#   times;
# * the block's warps in order: BLOCK_WARPS adds;
# * Kahan across a stream's blocks: one rounding of the result, and the
#   compensation's second-order residue, counted as 2.
# sum(d) and sum(d^2) take shorter chains (16 terms per lane and flush, two
# shuffle adds across the 4 lanes of a row) and the same flushes, warps and
# blocks, so the Grams' count covers them. With the module's 4x margin:
def extended_bound_constant(span=None):
    """Roundings counted in the f64 tier's bound for blocks of ``span``
    samples (default: kernel D's ``cuda_kernels.SAMPLES_SPAN``, read at the
    call): 4 * 198 = 792 at a span of 2^14."""
    span = ck.SAMPLES_SPAN if span is None else int(span)
    return 4 * (2 * 32 + FLUSH_SAMPLES
                + -(-span // (BLOCK_WARPS * FLUSH_SAMPLES))
                + BLOCK_WARPS + 2)


def extended_error_bound(abs_sums):
    """Derived bound on |f64 kernel - all-f64 reference| (~1.8e-13 * S_abs
    at kernel D's span of 2^14 samples per block), inside the f64 tier's
    contract of 1e-12 * S_abs."""
    return EPS64 * extended_bound_constant() * np.asarray(abs_sums)


def f64_reference_moments_strict(noise=None, n_moments=None, *,
                                 fine_step=None, coarse_step=None, domain,
                                 is_level0=False, chunk=262144,
                                 include_cov=True, fine32=None,
                                 coarse32=None):
    """All-f64 Legendre reference for the f64 tier on identical f32 QoIs:
    the QoIs are f32 (what a store holds), then the domain transform
    t = (x - (a + b)/2) * 2/(b - a), the recurrence and every sum run in
    f64.

    Pass either ``noise`` + steps (the synth QoIs are recomputed in numpy
    f32) or the QoI arrays ``fine32``/``coarse32`` themselves.

    :return: dict(sums, sums2, cov_fine, cov_coarse, n_valid, abs_*)
    """
    if fine32 is None:
        noise = np.asarray(noise, dtype=np.float32)
        err = np.sqrt(np.float32(1e-4) + np.abs(noise), dtype=np.float32)
        fine32 = (noise + np.float32(fine_step) * err).astype(np.float32)
        coarse32 = (noise + np.float32(coarse_step) * err).astype(
            np.float32)
    else:
        fine32 = np.asarray(fine32, dtype=np.float32)
        coarse32 = (np.zeros_like(fine32) if coarse32 is None
                    else np.asarray(coarse32, dtype=np.float32))
    R = n_moments
    a, b = (np.float64(domain[0]), np.float64(domain[1]))
    t_scale = 2.0 / (b - a)
    t_shift = (a + b) / 2.0

    sums = np.zeros(R)
    sums2 = np.zeros(R)
    cov_f = np.zeros((R, R))
    cov_c = np.zeros((R, R))
    abs_sums = np.zeros(R)
    abs_sums2 = np.zeros(R)
    abs_cov_f = np.zeros((R, R))
    abs_cov_c = np.zeros((R, R))
    n_valid = 0

    def legendre_f64(t, valid):
        t = np.where(valid, t, 0.0)
        phi = np.zeros((R, t.shape[0]))
        phi[0] = valid.astype(np.float64)
        if R > 1:
            phi[1] = t
        for k in range(2, R):
            phi[k] = ((2 * k - 1) * t * phi[k - 1]
                      - (k - 1) * phi[k - 2]) / k
        return phi

    n = fine32.shape[0]
    for start in range(0, n, chunk):
        t_f = (fine32[start:start + chunk].astype(np.float64)
               - t_shift) * t_scale
        t_c = (coarse32[start:start + chunk].astype(np.float64)
               - t_shift) * t_scale
        valid = (t_f >= -1) & (t_f <= 1)
        if not is_level0:
            valid &= (t_c >= -1) & (t_c <= 1)

        pf = legendre_f64(t_f, valid)
        if is_level0:
            dphi = pf
        else:
            pc = legendre_f64(t_c, valid)
            dphi = pf - pc

        sums += dphi.sum(axis=1)
        sq = (dphi * dphi).sum(axis=1)
        sums2 += sq
        abs_sums += np.abs(dphi).sum(axis=1)
        abs_sums2 += sq
        if include_cov:
            cov_f += pf @ pf.T
            abs_cov_f += np.abs(pf) @ np.abs(pf).T
            if not is_level0:
                cov_c += pc @ pc.T
                abs_cov_c += np.abs(pc) @ np.abs(pc).T
        n_valid += int(valid.sum())

    return dict(sums=sums, sums2=sums2, cov_fine=cov_f, cov_coarse=cov_c,
                n_valid=n_valid, abs_sums=abs_sums, abs_sums2=abs_sums2,
                abs_cov_fine=abs_cov_f, abs_cov_coarse=abs_cov_c)


def check_extended_against_f64(result, ref, include_cov=True):
    """Assert an f64-tier result against the strict reference and
    ``extended_error_bound`` (every field, covariance included).

    :param result: ExtendedMomentResult or SynthMomentResult
    :param ref: dict from f64_reference_moments_strict
    :return: dict of measured max deviations / max(S_abs, 1)
    """
    if int(result.n_valid) != ref["n_valid"]:
        raise AssertionError("n_valid %d != reference %d"
                             % (int(result.n_valid), ref["n_valid"]))
    report = {}
    names = ["sums", "sums2"] + (["cov_fine", "cov_coarse"] if include_cov
                                 else [])
    for name in names:
        got = _np(getattr(result, name)).astype(np.float64)
        scale = np.maximum(ref["abs_" + name], 1.0)
        err = np.abs(got - ref[name])
        report[name] = float(np.max(err / scale))
        if not np.all(err <= extended_error_bound(scale)):
            worst = np.unravel_index(np.argmax(err / scale), err.shape)
            raise AssertionError(
                "extended %s exceeds the f64 bound at %s: err=%.3g bound=%.3g"
                % (name, worst, err[worst],
                   extended_error_bound(scale)[worst]))
    return report
