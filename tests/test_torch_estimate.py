"""``Estimate`` over stored samples, mlmc_tpu_torch against mlmc_tpu on
identical samples (both packages' ``Memory`` filled with the same numpy
data; the port evaluates on the CPU, where kernels C and D run as their
plain versions).

Tolerances:
* fast tier (f32 values): n_valid exact; accumulators within mlmc_tpu's
  derived f32 bound ``accumulation_error_bound(S_abs)``, since mlmc_tpu
  sums in f32 with Kahan and the port in f64;
* f64 tier on f32-valued samples: within 1e-10 of mlmc_tpu's double-float
  tier and of its all-f64 generic tier;
* generic tier and its maxent density: rtol 1e-10 and 1e-8 (f64 on both
  sides).
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.ops import cuda_kernels as ck

from test_torch_quantity import STEPS, twin_storages

torch.set_num_threads(1)

DOMAIN = (-4.0, 4.0)


def _pair(seed=0, counts=(900, 300, 120), f32_values=False):
    """(mlmc_tpu root, port root on the CPU) over identical samples."""
    from mlmc_tpu import SynthSimulation as JSynth
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root

    jst, tst = twin_storages(seed, counts, f32_values=f32_values)
    return (jst, j_root(jst, JSynth().result_format()), tst,
            mt.make_root_quantity(tst, mt.SynthSimulation().result_format(),
                                  device="cpu"))


def _estimates(select, mfn_args=(6, DOMAIN), **kw):
    import mlmc_tpu.moments as jm
    from mlmc_tpu.estimator import Estimate as JEstimate

    jst, jr, tst, tr = _pair(**kw)
    je = JEstimate(select(jr), jst, jm.Legendre(*mfn_args))
    te = mt.Estimate(select(tr), tst, mt.Legendre(*mfn_args))
    return je, te


def _bound_per_stream(te, components):
    """accumulation_error_bound(S_abs) of each packed stream (plain
    version with absolute terms)."""
    from mlmc_tpu.ops.precision import accumulation_error_bound

    mfn = te._moments_fn
    streams = te._packed_streams(mfn, components)
    s_abs = ck.samples_mlmc_plain(streams, mfn.size, basis="legendre",
                                  consts=ck.transform_constants(mfn.domain, mfn.ref_domain),
                                  absolute=True)
    return [{f: accumulation_error_bound(getattr(s_abs, f)[s].numpy()) + 1e-12
             for f in ("sums", "sums2", "cov_fine", "cov_coarse")}
            for s in range(len(streams.counts))]


@pytest.mark.parametrize("structured", [False, True])
def test_fast_tier_accumulators_match_jax(structured):
    select = (lambda r: r["length"][1]) if structured else \
        (lambda r: r["length"][1]["10"][0, 0])
    je, te = _estimates(select)
    comps = list(range(4 if structured else 1))
    got = te._stream_results(te._moments_fn, comps)       # [level, component, ...]
    want = je._fast_results_packed(je._moments_fn, comps)
    bounds = _bound_per_stream(te, comps)
    for i, m in enumerate(comps):
        for lvl, w in enumerate(want[m]):
            assert int(got.n_valid[lvl, i]) == int(w.n_valid), (m, lvl)
            for f, bound in bounds[i * len(STEPS) + lvl].items():
                err = np.abs(getattr(got, f)[lvl, i] - np.asarray(getattr(w, f)))
                assert np.all(err <= bound), (m, lvl, f)
    # the public views combine the same accumulators
    for fn in ("estimate_moments_fast", "estimate_covariance_fast"):
        for a, b in zip(getattr(te, fn)(), getattr(je, fn)()):
            np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=2e-4)


def test_structured_diff_vars_shared_validity():
    """A narrow domain clips components differently, yet every stream
    reports the generic tier's per-level count (shared validity), as in
    mlmc_tpu."""
    import mlmc_tpu.quantity.quantity_estimate as jqe

    import mlmc_tpu_torch.quantity.quantity_estimate as tqe

    je, te = _estimates(lambda r: r["length"][1]["10"], mfn_args=(5, (-1.5, 1.5)),
                        counts=(600, 200))
    dag = tqe.estimate_mean(tqe.moments(te.quantity, te._moments_fn))
    jdag = jqe.estimate_mean(jqe.moments(je.quantity, je._moments_fn))
    raw, ns = te.estimate_diff_vars_fast()
    jraw, jns = je.estimate_diff_vars_fast()
    assert ns.tolist() == jns.tolist() == np.asarray(dag.n_samples).astype(int).tolist()
    assert np.array_equal(dag.n_samples, jdag.n_samples)
    # the clipping does differ between components
    single = [int(te._stream_results(te._moments_fn, [m]).n_valid[0, 0])
              for m in range(2)]
    assert len(set(single)) > 1 and min(single) > ns[0]
    assert raw.shape == np.asarray(jraw).shape == (2, 2 * 5)
    np.testing.assert_allclose(raw, np.asarray(dag.l_vars).reshape(raw.shape),
                               rtol=1e-3, atol=1e-7)
    np.testing.assert_allclose(raw, jraw, rtol=1e-3, atol=1e-7)


def test_diff_vars_regression_matches_jax():
    je, te = _estimates(lambda r: r["length"][2]["20"][1])
    raw, ns = te.estimate_diff_vars_fast()
    jraw, jns = je.estimate_diff_vars_fast()
    assert ns.tolist() == jns.tolist()
    np.testing.assert_allclose(raw, jraw, rtol=1e-4, atol=1e-9)
    got, n_ops = te.estimate_diff_vars_regression(ns, raw_vars=raw)
    want, j_ops = je.estimate_diff_vars_regression(ns, raw_vars=raw)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    assert n_ops == j_ops
    g_dag, _ = te.estimate_diff_vars_regression(ns)    # generic tier
    w_dag, _ = je.estimate_diff_vars_regression(ns)
    np.testing.assert_allclose(g_dag, w_dag, rtol=1e-10)


def test_extended_tier_matches_jax_double_float_kernel():
    """f64 tier on f32-valued samples against mlmc_tpu's double-float
    kernel on a level stream (what its estimate_moments_extended runs)."""
    from mlmc_tpu.ops.pallas_extended import (
        moment_pipeline_from_samples_extended)

    je, te = _estimates(lambda r: r["length"][1]["10"][0, 0],
                        counts=(700, 200), f32_values=True)
    got = mt.ExtendedMomentResult(*(
        f[1, 0] for f in te._stream_results(te._moments_fn, [0], f64=True)))
    q = je._gather_level_qoi()[1]
    want = moment_pipeline_from_samples_extended(
        q[0, :, 0], q[0, :, 1], 6, domain=DOMAIN, chunk=1024, interpret=True)
    assert got.n_valid == want.n_valid
    for f in ("sums", "sums2"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-10, atol=1e-10, err_msg=f)
    # mlmc_tpu's double-float covariance holds 1e-9 * S_abs (S_abs <= n)
    for f in ("cov_fine", "cov_coarse"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f), rtol=0,
                                   atol=1e-9 * got.n_valid, err_msg=f)


def test_extended_tier_matches_jax_f64_generic_tier():
    """f64 tier on f32-valued samples against mlmc_tpu's all-f64 generic
    tier on the same (f32-representable) values."""
    je, te = _estimates(lambda r: r["length"][1]["10"][0, 0],
                        counts=(700, 200), f32_values=True)
    mean, var = te.estimate_moments_extended()
    g_mean, g_var = je.estimate_moments()
    np.testing.assert_allclose(mean, g_mean, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(var, g_var, rtol=1e-8, atol=1e-14)
    cov, c_mean = te.estimate_covariance_extended()
    g_cov, _ = je.estimate_covariance()
    np.testing.assert_allclose(cov, g_cov, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(c_mean, mean, rtol=1e-14, atol=1e-15)


def test_generic_tier_matches_jax():
    je, te = _estimates(lambda r: r["width"][1]["30"][0, 0], mfn_args=(8, (-4.0, 6.0)))
    for fn in ("estimate_moments", "estimate_covariance"):
        for a, b in zip(getattr(te, fn)(), getattr(je, fn)()):
            np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


def test_density_matches_jax():
    je, te = _estimates(lambda r: r["width"][1]["30"][0, 0], mfn_args=(8, (-4.0, 6.0)))
    td, t_info, t_res, _ = te.construct_density(tol=1e-8)
    jd, j_info, j_res, _ = je.construct_density(tol=1e-8)
    assert t_res.success and j_res.success
    np.testing.assert_allclose(t_info[2], j_info[2], rtol=1e-10, atol=1e-12)
    x = np.linspace(-3.9, 5.9, 120)
    np.testing.assert_allclose(td.density(x), jd.density(x), rtol=1e-8)


def test_fast_density_matches_jax():
    """Fast-tier maxent: the f32 fast tiers of both packages agree to
    their accumulation bound, so the densities agree to ~1e-4."""
    je, te = _estimates(lambda r: r["width"][1]["30"][0, 0], mfn_args=(8, (-4.0, 6.0)))
    fd, _, f_res, _ = te.construct_density_fast(tol=1e-8)
    jfd, _, jf_res, _ = je.construct_density_fast(tol=1e-8)
    assert f_res.success and jf_res.success
    x = np.linspace(-3.9, 5.9, 120)
    np.testing.assert_allclose(fd.density(x), jfd.density(x), rtol=1e-3, atol=1e-6)


def test_fast_basis_guards_raise():
    _, te = _estimates(lambda r: r["length"][1]["10"][0])
    mfn = mt.Legendre(5, (-3, 3))
    for bad in (mt.TransformedMoments(mfn, np.eye(5)),
                mt.Legendre(5, (0.1, 3), log=True),
                mt.Legendre(5, (-3, 3), safe_eval=False)):
        with pytest.raises(NotImplementedError):
            te.estimate_moments_fast(bad)
        with pytest.raises(NotImplementedError):
            te.estimate_moments_extended(bad)


def _run_with_empty_trailing_level(counts):
    """Estimate over a stored 5-level synthetic run of ``counts`` samples
    per level, the last level scheduled but empty."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = mt.DeviceMemory(device="cpu")
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(seed=41, min_bucket=64,
                                                     device_results=True,
                                                     device="cpu"),
                         sim, [[0.5], [0.25], [0.125], [0.0625], [0.03125]])
    sampler.set_initial_n_samples(list(counts))
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    storage.save_scheduled_samples(4, ["L04_S0000000"])
    assert storage.get_n_levels() == 5 and storage.get_n_collected()[4] == 0
    root = mt.make_root_quantity(storage, sim.result_format())
    return mt.Estimate(root["length"][1]["10"][0, 0], storage,
                       mt.Legendre(5, (-4.0, 4.0)))


def test_fast_tier_with_empty_trailing_level():
    """A scheduled-but-empty level flows through the packed fast tier as an
    empty stream (inf diff-var, zero count)."""
    est = _run_with_empty_trailing_level([200, 120, 80, 60, 0])
    raw, ns = est.estimate_diff_vars_fast()
    assert raw.shape[0] == 5 and ns.tolist() == [200, 120, 80, 60, 0]
    assert np.all(np.isinf(raw[4]))
    means, _ = est.estimate_moments_fast()
    assert means[0] == 1.0 and np.all(np.isfinite(means))
    e_means, _ = est.estimate_moments_extended()
    np.testing.assert_allclose(e_means, means, rtol=1e-5, atol=1e-6)
    vars_, _ = est.estimate_diff_vars_regression([200, 120, 80, 60, 0], raw_vars=raw)
    assert np.all(np.isfinite(vars_))


def _level_estimates(est, tier):
    """(l_means, l_vars, n_samples) of a stored run's levels by one tier:
    kernel C, kernel D, or kernel C's accumulators through the fused
    drivers' ``accumulators_to_estimates``."""
    if tier == "fused":
        acc = est._stream_results(est._moments_fn, [0])
        out = mt.accumulators_to_estimates(
            [ck.SynthMomentResult(*(f[lvl, 0] for f in acc))
             for lvl in range(acc.n_valid.shape[0])])
    else:
        out = est._telescoped(est._moments_fn, f64=tier == "extended")
    return out["l_means"], out["l_vars"], out["n_samples"]


@pytest.mark.parametrize("tier", ["fast", "extended", "fused"])
def test_one_rule_for_empty_and_one_sample_levels(tier):
    """Every tier telescopes by one rule: a level with no sample has mean
    0 and variance inf, a level of one valid sample variance inf, and each
    such inf reaches the estimator variance."""
    est = _run_with_empty_trailing_level([200, 120, 80, 1, 0])
    l_means, l_vars, ns = _level_estimates(est, tier)
    assert ns.tolist() == [200, 120, 80, 1, 0]
    assert np.array_equal(np.isinf(l_vars), np.repeat([[0], [0], [0], [1], [1]], 5, axis=1))
    assert np.all(l_means[4] == 0) and np.all(l_means[3, 1:] != 0)
    assert np.all(np.isfinite(l_means))
    if tier != "fused":
        mean, var = getattr(est, "estimate_moments_" + tier)()
        assert np.all(np.isinf(var)) and mean[0] == 1.0
        np.testing.assert_array_equal(mean, l_means.sum(axis=0))


@pytest.mark.parametrize("tier", ["fast", "extended"])
def test_covariance_means_equal_moment_means(tier):
    """A tier's covariance call returns its moment call's means, bit for
    bit, on scalar and structured quantities."""
    _, _, tst, tr = _pair(seed=3, f32_values=True)
    for q in (tr["length"][1]["10"][0, 0], tr["length"][1]):
        est = mt.Estimate(q, tst, mt.Legendre(6, DOMAIN))
        mean, _ = getattr(est, "estimate_moments_" + tier)()
        cov, c_mean = getattr(est, "estimate_covariance_" + tier)()
        np.testing.assert_array_equal(c_mean, mean)
        assert cov.shape == mean.shape + mean.shape[-1:]


def test_fused_driver_and_fast_tier_build_one_density():
    """``FusedMLMC.construct_density`` over a stored run's kernel C
    accumulators and ``construct_density_fast`` over the run give the same
    density (one function builds it from (cov, mean))."""
    from mlmc_tpu_torch.fused_driver import FusedMLMC

    _, _, tst, tr = _pair(seed=4, counts=(4000, 1000, 300))
    mfn = mt.Legendre(8, DOMAIN)
    est = mt.Estimate(tr["length"][1]["10"][0, 0], tst, mfn)
    acc = est._stream_results(mfn, [0])
    driver = FusedMLMC([None] * 3, mfn, device="cpu")
    driver._accs = [ck.SynthMomentResult(*(f[lvl, 0] for f in acc)) for lvl in range(3)]
    d_fused, info_fused, res_fused, _ = driver.construct_density(tol=1e-8,
                                                                 orth_moments_tol=1e-4)
    d_fast, info_fast, res_fast, _ = est.construct_density_fast(
        tol=1e-8, reg_param=0.01, orth_moments_tol=1e-4)
    assert res_fused.success and res_fast.success
    np.testing.assert_array_equal(info_fused[2], info_fast[2])
    np.testing.assert_array_equal(d_fused.multipliers, d_fast.multipliers)
    x = np.linspace(-3.9, 3.9, 50)
    np.testing.assert_array_equal(d_fused.density(x), d_fast.density(x))


def test_device_memory_fast_tier_equals_memory():
    """The same f32 samples in a DeviceMemory and a host Memory give
    bit-identical fast-tier accumulators (kernel C reads f32 either way)."""
    _, _, tst, tr = _pair(seed=5, f32_values=True)
    dev = mt.DeviceMemory(device="cpu")
    dev.save_global_data(result_format=tst.load_result_format(),
                         level_parameters=tst.get_level_parameters())
    for lvl, pairs in enumerate(tst.sample_pairs()):
        pairs = np.asarray(pairs)
        fine = pairs[:, :, 0].T.astype(np.float32)
        coarse = (pairs[:, :, 1].T if pairs.shape[2] > 1 else np.zeros_like(fine.T).T)
        dev.save_samples_bulk(lvl, list(range(fine.shape[0])), fine,
                              coarse.astype(np.float32))
    dr = mt.make_root_quantity(dev, mt.SynthSimulation().result_format())
    mfn = mt.Legendre(7, DOMAIN)
    a = mt.Estimate(tr["length"][1], tst, mfn)._stream_results(mfn, [0, 1])
    b = mt.Estimate(dr["length"][1], dev, mfn)._stream_results(mfn, [0, 1])
    for fa, fb in zip(a, b):
        np.testing.assert_array_equal(fa, fb)


def test_estimate_domain_and_level_samples_match_jax():
    from mlmc_tpu.estimator import estimate_domain as j_domain

    jst, jr, tst, tr = _pair(seed=6)
    assert mt.estimate_domain(tr["length"][1]["10"][0], tst) == pytest.approx(
        j_domain(jr["length"][1]["10"][0], jst), rel=1e-14)
    te = mt.Estimate(tr["length"][1]["10"], tst, mt.Legendre(3, DOMAIN))
    got = te.get_level_samples(1, n_samples=50)
    assert isinstance(got, torch.Tensor) and got.shape == (2, 50, 2)
