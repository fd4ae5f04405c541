"""Kernels C and D (stored samples -> moment accumulators): the plain
versions against mlmc_tpu, and (on a machine with a GPU) the CUDA kernels
against the plain versions.

mlmc_tpu is imported inside the tests that compare with it, so the
``cuda`` tests also run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_samples_kernels.py -m cuda``.

Tolerances, on identical f32 QoIs made with numpy:
* kernel C's plain version against mlmc_tpu's Pallas kernels in interpret
  mode (f32 sums with Kahan): n_valid exact, the rest within the derived
  f32 bound ``accumulation_error_bound(S_abs)``; for Legendre and
  monomial also within 1e-12 * S_abs of an exact f64 summation of the
  same f32 per-sample values (computed here in numpy);
* kernel D's plain version within 1e-12 * S_abs of mlmc_tpu's strict
  all-f64 reference, and within the double-float bound of mlmc_tpu's
  double-float kernel in interpret mode (``df_error_bound`` for the sums,
  1e-9 relative for the covariance);
* on the card, each kernel against its plain version: n_valid equal;
  kernel C within 1e-12 * S_abs (Fourier: the f32 bound, since the
  kernel's cosf/sinf and PyTorch's may differ in the last bit); kernel D
  within ``extended_error_bound(S_abs)`` (1.8e-13 * S_abs, derived for its
  summation order in ``ops/precision.py``) of its plain version and of the
  strict all-f64 reference. ``tests/test_torch_extended.py`` holds a numpy
  model of that summation order against the same bound on the CPU.
"""
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.ops import cuda_extended as cx
from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.ops import precision as port_precision

torch.set_num_threads(1)

DOMAIN = (-4.0, 4.0)
REF = {"legendre": (-1.0, 1.0), "monomial": (0.0, 1.0),
       "fourier": (0.0, 2 * np.pi)}
FIELDS = ["sums", "sums2", "cov_fine", "cov_coarse"]


def _qoi(n, seed):
    """f32 fine/coarse QoIs with NaNs and out-of-domain values."""
    rng = np.random.default_rng(seed)
    fine = (rng.normal(size=n) * 1.6).astype(np.float32)
    coarse = (fine + rng.normal(size=n) * 0.05).astype(np.float32)
    fine[::97] = np.nan
    coarse[::89] = np.nan
    fine[3::101] = 7.5
    coarse[5::103] = -6.0
    return fine, coarse


def _f32_rows_f64_sums(fine, coarse, R, basis, has_coarse):
    """Exact f64 summation of the f32 per-sample values of kernel C
    (numpy f32 arithmetic in the kernel's operation order)."""
    lo, hi = (np.float32(v) for v in REF[basis])
    scale = np.float32((REF[basis][1] - REF[basis][0]) / (DOMAIN[1] - DOMAIN[0]))
    a = np.float32(DOMAIN[0])

    def transform(x):
        return ((x - a) * scale + lo).astype(np.float32)

    t_f = transform(fine)
    valid = (t_f >= lo) & (t_f <= hi)
    if has_coarse:
        t_c = transform(coarse)
        valid &= (t_c >= lo) & (t_c <= hi)

    def rows(t):
        t = np.where(valid, t, np.float32(0.0)).astype(np.float32)
        v = valid.astype(np.float32)
        out = [v]
        if basis == "legendre":
            out.append(t)
            for n in range(2, R):
                out.append((np.float32(2 * n - 1) * t * out[-1]
                            - np.float32(n - 1) * out[-2]) / np.float32(n))
        else:
            for _ in range(1, R):
                out.append(out[-1] * t)
        return np.stack(out[:R], axis=1).astype(np.float64)

    pf = rows(t_f)
    pc = rows(t_c) if has_coarse else np.zeros_like(pf)
    d = pf - pc
    return dict(sums=d.sum(0), sums2=(d * d).sum(0), cov_fine=pf.T @ pf,
                cov_coarse=pc.T @ pc, n_valid=int(valid.sum()),
                abs_sums=np.abs(d).sum(0), abs_sums2=(d * d).sum(0),
                abs_cov_fine=np.abs(pf).T @ np.abs(pf),
                abs_cov_coarse=np.abs(pc).T @ np.abs(pc))


def _s_abs(fine, coarse, R, basis, has_coarse, f64=False):
    """S_abs of one stream from the plain version (absolute terms)."""
    streams = ck.pack_streams([torch.from_numpy(fine)],
                              [torch.from_numpy(coarse) if has_coarse else None],
                              [has_coarse])
    consts = ck.transform_constants(DOMAIN, REF[basis], f64=f64)
    out = ck.samples_plain(streams, R, basis=basis, consts=consts, f64=f64,
                           absolute=True)
    return {f: getattr(out, f)[0].numpy() for f in FIELDS}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------- #
# kernel C's plain version vs mlmc_tpu
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("is_level0", [True, False])
@pytest.mark.parametrize("basis", ["legendre", "monomial", "fourier"])
def test_kernel_c_plain_vs_pallas(basis, is_level0):
    from mlmc_tpu.ops.pallas_kernels import moment_pipeline_from_samples
    from mlmc_tpu.ops.precision import accumulation_error_bound

    R = 7
    fine, coarse = _qoi(3000, seed=len(basis) + is_level0)
    got = ck.moment_pipeline_from_samples(
        fine, coarse, R, domain=DOMAIN, ref_domain=REF[basis], basis=basis,
        is_level0=is_level0, device="cpu")
    want = moment_pipeline_from_samples(
        fine, coarse, R, domain=DOMAIN, ref_domain=REF[basis], basis=basis,
        chunk=4096, is_level0=is_level0, interpret=True)
    assert got.sums.dtype == torch.float64 and got.n_valid.dtype == torch.int64
    assert int(got.n_valid) == int(want.n_valid)
    s_abs = _s_abs(fine, coarse, R, basis, not is_level0)
    for name in FIELDS:
        err = np.abs(getattr(got, name).numpy() - np.asarray(getattr(want, name)))
        assert np.all(err <= accumulation_error_bound(s_abs[name]) + 1e-12), name
    if is_level0:
        assert not torch.any(got.cov_coarse != 0)


@pytest.mark.parametrize("is_level0", [True, False])
@pytest.mark.parametrize("basis", ["legendre", "monomial"])
def test_kernel_c_plain_vs_exact_f64_summation(basis, is_level0):
    R = 12
    fine, coarse = _qoi(5000, seed=7 + is_level0)
    got = ck.moment_pipeline_from_samples(
        fine, coarse, R, domain=DOMAIN, ref_domain=REF[basis], basis=basis,
        is_level0=is_level0, device="cpu")
    ref = _f32_rows_f64_sums(fine, coarse, R, basis, not is_level0)
    assert int(got.n_valid) == ref["n_valid"]
    for name in FIELDS:
        err = np.abs(getattr(got, name).numpy() - ref[name])
        assert np.all(err <= 1e-12 * np.maximum(ref["abs_" + name], 1.0)), name


def test_all_streams_in_one_call_vs_pallas():
    """Per-stream has_coarse, a zero-sample stream and an empty trailing
    level through the packed multi-stream entry point, against mlmc_tpu's
    one-launch kernel; the packing matches mlmc_tpu's byte for byte."""
    from mlmc_tpu.ops.pallas_kernels import (
        mlmc_moment_pipeline_from_samples, pack_level_samples)

    R, chunk = 6, 2048
    parts = [_qoi(n, seed=20 + i) for i, n in enumerate([2500, 0, 1500, 700])]
    parts.append((np.zeros(0, np.float32), np.zeros(0, np.float32)))
    fine_l = [f for f, _ in parts]
    coarse_l = [None] + [c for _, c in parts[1:]]
    hasc = (0, 1, 0, 1, 1)
    jf, jc, counts = pack_level_samples(fine_l, coarse_l, chunk=chunk)
    tf, tc, t_counts = ck.pack_level_samples(fine_l, coarse_l, chunk=chunk)
    assert t_counts == counts == (2500, 0, 1500, 700, 0)
    np.testing.assert_array_equal(tf, np.asarray(jf))
    np.testing.assert_array_equal(tc, np.asarray(jc))
    want = mlmc_moment_pipeline_from_samples(
        jf, jc, counts, R, domain=DOMAIN, chunk=chunk, interpret=True,
        has_coarse=hasc)
    got = ck.mlmc_moment_pipeline_from_samples(
        tf, tc, counts, R, domain=DOMAIN, chunk=chunk, has_coarse=hasc,
        device="cpu")
    from mlmc_tpu.ops.precision import accumulation_error_bound

    for s, (g, w) in enumerate(zip(got, want)):
        assert int(g.n_valid) == int(w.n_valid), s
        if counts[s] == 0:
            assert all(not torch.any(f != 0) for f in g), s
            continue
        s_abs = _s_abs(parts[s][0], parts[s][1], R, "legendre", bool(hasc[s]))
        for name in FIELDS:
            err = np.abs(getattr(g, name).numpy() - np.asarray(getattr(w, name)))
            assert np.all(err <= accumulation_error_bound(s_abs[name]) + 1e-12), (s, name)


def test_single_stream_is_an_l1_call():
    fine, coarse = _qoi(4000, seed=3)
    single = ck.moment_pipeline_from_samples(fine, coarse, 9, domain=DOMAIN,
                                             device="cpu")
    f, c, counts = ck.pack_level_samples([fine[:0], fine], [None, coarse])
    multi = ck.mlmc_moment_pipeline_from_samples(f, c, counts, 9,
                                                 domain=DOMAIN, device="cpu")
    for a, b in zip(single, multi[1]):
        assert torch.equal(a, b)
    assert int(multi[0].n_valid) == 0


def test_guards_raise():
    fine, coarse = _qoi(100, seed=1)
    with pytest.raises(ValueError):
        ck.moment_pipeline_from_samples(fine, coarse, 5, domain=DOMAIN,
                                        basis="hermite", device="cpu")
    with pytest.raises(ValueError):
        ck.moment_pipeline_from_samples(fine, coarse, ck.R_PAD + 1,
                                        domain=DOMAIN, device="cpu")
    f, c, counts = ck.pack_level_samples([fine], [coarse])
    with pytest.raises(ValueError):
        ck.mlmc_moment_pipeline_from_samples(f, c, counts, 5, domain=DOMAIN,
                                             has_coarse=(1, 0), device="cpu")
    with pytest.raises(ValueError):
        ck.mlmc_moment_pipeline_from_samples(f[:-1], c[:-1], counts, 5,
                                             domain=DOMAIN, device="cpu")


# --------------------------------------------------------------------- #
# kernel D's plain version vs mlmc_tpu
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("is_level0", [True, False])
def test_kernel_d_plain_vs_strict_f64(is_level0):
    from mlmc_tpu.ops.precision import f64_reference_moments_strict

    fine, coarse = _qoi(6000, seed=11 + is_level0)
    got = cx.moment_pipeline_from_samples_extended(
        fine, coarse, 25, domain=DOMAIN, is_level0=is_level0, symmetric=True,
        device="cpu")
    ref = f64_reference_moments_strict(n_moments=25, domain=DOMAIN,
                                       fine32=fine, coarse32=coarse,
                                       is_level0=is_level0)
    assert got.n_valid == ref["n_valid"]
    for name in FIELDS:
        err = np.abs(getattr(got, name) - ref[name])
        assert np.all(err <= 1e-12 * np.maximum(ref["abs_" + name], 1.0)), name
    # the port's own check and copy of the reference agree
    port_precision.check_extended_against_f64(got, ref)
    port_ref = port_precision.f64_reference_moments_strict(
        n_moments=25, domain=DOMAIN, fine32=fine, coarse32=coarse,
        is_level0=is_level0)
    for key in ref:
        np.testing.assert_array_equal(port_ref[key], ref[key])


@pytest.mark.parametrize("basis", ["legendre", "monomial", "fourier"])
def test_kernel_d_plain_vs_pallas_extended(basis):
    from mlmc_tpu.ops.pallas_extended import (
        moment_pipeline_from_samples_extended)
    from mlmc_tpu.ops.precision import df_error_bound

    R, n = 5, 1000
    fine, coarse = _qoi(n, seed=30 + len(basis))
    got = cx.moment_pipeline_from_samples_extended(
        fine, coarse, R, domain=DOMAIN, ref_domain=REF[basis], basis=basis,
        device="cpu")
    want = moment_pipeline_from_samples_extended(
        fine, coarse, R, domain=DOMAIN, ref_domain=REF[basis], basis=basis,
        chunk=1024, interpret=True)
    assert got.n_valid == want.n_valid
    s_abs = _s_abs(fine, coarse, R, basis, True, f64=True)
    for name in ("sums", "sums2"):
        err = np.abs(getattr(got, name) - getattr(want, name))
        assert np.all(err <= df_error_bound(s_abs[name], n, chunk=1024)
                      + 1e-13), name
    for name in ("cov_fine", "cov_coarse"):
        dev = np.abs(getattr(got, name) - getattr(want, name))
        assert np.all(dev <= 1e-9 * np.maximum(s_abs[name], 1.0)), name


def test_synth_noise_extended_vs_strict():
    from mlmc_tpu.ops.precision import f64_reference_moments_strict

    x = np.random.default_rng(4).normal(size=5000).astype(np.float32)
    got = cx.synth_moment_pipeline_from_noise_extended(
        x, 13, fine_step=0.25, coarse_step=0.5, domain=DOMAIN, device="cpu")
    ref = f64_reference_moments_strict(x, 13, fine_step=0.25, coarse_step=0.5,
                                       domain=DOMAIN)
    report = port_precision.check_extended_against_f64(got, ref)
    assert max(report.values()) <= 1e-12


def test_extended_bound_is_inside_the_contract():
    assert port_precision.extended_error_bound(1.0) < 1e-12


# --------------------------------------------------------------------- #
# CUDA kernels vs their plain versions (run on a machine with a GPU)
# --------------------------------------------------------------------- #
def _device_streams(device, sizes=(1 << 17, 100_003, 0, 7, 40_000),
                    first_valid=False):
    """Packed streams on ``device``, every odd one with a coarse part;
    ``first_valid`` replaces each stream's first sample (NaN in ``_qoi``)
    with a valid one, so a one-sample stream counts one."""
    fine, coarse, hasc = [], [], []
    for i, n in enumerate(sizes):
        f, c = _qoi(n, seed=50 + i)
        if first_valid and n:
            f[0], c[0] = 0.3, 0.31
        fine.append(torch.from_numpy(f).to(device))
        coarse.append(torch.from_numpy(c).to(device) if i % 2 else None)
        hasc.append(i % 2 == 1)
    return ck.pack_streams(fine, coarse, hasc)


#: kernel C's streams: fine-only (even) next to coarse (odd) streams, one
#: or several 32-sample chunks and 64-sample flushes, a zero-sample stream,
#: a single sample, and more than one block (2^14 samples per block)
C_SIZES = ((1 << 14) + 1, 65, 0, 63, 1, 1 << 17)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 8, 24, 25, 32])
@pytest.mark.parametrize("basis", ["legendre", "monomial", "fourier"])
def test_cuda_kernel_c_vs_plain(cuda_device, basis, R):
    streams = _device_streams(cuda_device, sizes=C_SIZES, first_valid=True)
    consts = ck.transform_constants(DOMAIN, REF[basis])
    before = ck.samples_mlmc_cuda.launches
    got = ck.samples_moments(streams, R, domain=DOMAIN, ref_domain=REF[basis],
                             basis=basis)
    assert ck.samples_mlmc_cuda.launches == before + 1
    plain, s_abs = (ck.samples_mlmc_plain(streams, R, basis=basis, consts=consts,
                                          absolute=a) for a in (False, True))
    assert torch.equal(got.n_valid, plain.n_valid)
    rtol = 1e-12 if basis != "fourier" else float(
        port_precision.accumulation_error_bound(1.0))
    for name in FIELDS:
        err = (getattr(got, name) - getattr(plain, name)).abs()
        assert bool(torch.all(err <= rtol * getattr(s_abs, name).clamp(min=1.0))), name
    assert not torch.any(got.cov_coarse[0] != 0)   # no coarse part
    assert all(not torch.any(f[2] != 0) for f in got)   # zero-sample stream
    again = ck.samples_moments(streams, R, domain=DOMAIN, ref_domain=REF[basis],
                               basis=basis)
    for a, b in zip(got, again):
        assert torch.equal(a, b)                    # bit-identical launches


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 2, 8, 24, 25, 32])
@pytest.mark.parametrize("basis", ["legendre", "monomial", "fourier"])
def test_cuda_kernel_d_vs_plain(cuda_device, basis, R):
    """Kernel D on kernel C's streams (``C_SIZES``; NaN and out-of-domain
    samples of ``_qoi`` dropped) within the f64 tier's derived bound of its
    plain version."""
    streams = _device_streams(cuda_device, sizes=C_SIZES, first_valid=True)
    consts = ck.transform_constants(DOMAIN, REF[basis], f64=True)
    before = cx.samples_ext_cuda.launches
    got = ck.samples_moments(streams, R, domain=DOMAIN, ref_domain=REF[basis],
                             basis=basis, f64=True)
    assert cx.samples_ext_cuda.launches == before + 1
    plain, s_abs = (cx.samples_ext_plain(streams, R, basis=basis, consts=consts,
                                         absolute=a) for a in (False, True))
    assert torch.equal(got.n_valid, plain.n_valid)
    assert 0 < int(got.n_valid[0]) < C_SIZES[0]     # some samples dropped
    assert int(got.n_valid[4]) == 1                 # the one-sample stream
    for name in FIELDS:
        err = (getattr(got, name) - getattr(plain, name)).abs().cpu().numpy()
        bound = port_precision.extended_error_bound(
            getattr(s_abs, name).clamp(min=1.0).cpu().numpy())
        assert np.all(err <= bound), name
    assert not torch.any(got.cov_coarse[0] != 0)   # no coarse part
    assert all(not torch.any(f[2] != 0) for f in got)   # zero-sample stream
    again = ck.samples_moments(streams, R, domain=DOMAIN, ref_domain=REF[basis],
                               basis=basis, f64=True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)                    # bit-identical launches


@pytest.mark.cuda
@pytest.mark.parametrize("is_level0", [False, True])
@pytest.mark.parametrize("n", [1, 63, 65, (1 << 14) + 1, 200_000])
@pytest.mark.parametrize("R", [1, 2, 8, 24, 25, 32])
def test_cuda_kernel_d_vs_strict_reference(cuda_device, R, n, is_level0):
    fine, coarse = _qoi(n, seed=9)
    fine[0], coarse[0] = 0.3, 0.31                  # NaN in ``_qoi``
    got = cx.moment_pipeline_from_samples_extended(
        torch.from_numpy(fine).to(cuda_device), torch.from_numpy(coarse),
        R, domain=DOMAIN, symmetric=True, is_level0=is_level0)
    ref = port_precision.f64_reference_moments_strict(
        n_moments=R, domain=DOMAIN, fine32=fine, coarse32=coarse,
        is_level0=is_level0)
    assert got.n_valid == ref["n_valid"] > 0
    port_precision.check_extended_against_f64(got, ref)
    if is_level0:
        assert not np.any(got.cov_coarse != 0)
