"""Drive mlmc_tpu_torch's two MLMC main paths once on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. builds every CUDA source of mlmc_tpu_torch/csrc with nvcc (one process
   per source, all started together);
2. checks kernel A (fused sample -> moment reduction) in memory mode
   against its plain PyTorch version on the card and an exact f64
   summation, at 2^20 samples on each of 5 levels;
3. the storage-free path, with the launch counters reset just before it:
   the 5-level synthetic estimate at 1e8 samples and 25 Legendre moments
   in one kernel A launch, the f32-vs-f64 precision guard (memory mode,
   1e7 samples), the normal-stream quality check (kernel B, 1e7 normals),
   the maxent density, and a short adaptive FusedMLMC run on the card;
   fails unless kernels A and B were launched;
4. the stored-samples path (Sampler -> DeviceBatchPool -> DeviceMemory ->
   Quantity -> Estimate), with the counters reset just before it:
   a. the adaptive loop to target_var=2e-8 (5 levels, 25 Legendre moments,
      about 1e7 stored samples of 24 f32 components, fine and coarse), with
      kernel C estimating the level variances each round, then the fast
      maxent density;
   b. the structured fast tier (12 components in one kernel C launch),
      which must report one valid count per level for all components;
   c. the f64 tier (kernel D) on the same storage: the scalar quantity,
      then its largest launch, the structured quantity's 12 x 5 streams in
      one launch, held against the fast tier of the same estimate;
   d. the Quantity DAG of BASELINE config 4 on 2.75e6 samples: the generic
      tier and the packed tier (kernel C) agree within the f32 bound;
   fails unless kernels C and D were launched;
5. holds each kernel's outputs at its path's shapes against its plain
   version (kernel C at the e2e, config-4 and structured streams; kernel D
   at the e2e and structured streams, also against an exact f64 summation,
   and two launches of it bit for bit against each other);
6. times each kernel and its plain version at those shapes and computes
   each kernel's bound from this run's inputs; kernels C and D also at
   their largest launch, the structured tier's 12 x 5 streams.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout. The last line is {"ok": true, "device": {...}}; the line before
it lists the kernels with their launch counts, errors, times and bounds.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

SEED = 2024
N_MOMENTS = 25
DOMAIN = (-4.0, 4.0)
LEVEL_STEPS = [0.5, 0.25, 0.125, 0.0625, 0.03125]
N_PER_LEVEL = [64_000_000, 24_000_000, 8_000_000, 3_000_000, 1_000_000]
N_CHECK = 1 << 20          # normals per level for the memory-mode check
N_PRECISION = 10_010_624   # precision guard samples (>= 1e7)
N_NORMALS = 10_000_000     # normal-stream quality check
TARGET_VAR = 1e-5          # FusedMLMC's target
E2E_TARGET_VAR = 2e-8      # the stored path's adaptive target
C4_LEVELS = [[0.1], [0.01], [0.001]]
C4_N0 = 1 << 21            # config 4: 2^21 + 2^19 + 2^17 samples

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the FP64 rate of
# the tensor cores (the fastest f64 unit); the int32 rate is 64 lanes per
# SM per clock at the card's maximum SM clock (read from nvidia-smi)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12
INT32_LANES_PER_SM = 64
PHILOX_INT32_OPS = 104     # 10 rounds x (4 multiplies, 4 xors, 2 key adds) + counter


def _fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def _require(cond, msg):
    if not cond:
        _fail(msg)


def _smi(query):
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + query,
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else "nvidia-smi: " + out.stderr.strip()


def _time_ms(torch, fn, reps=5):
    """Median over ``reps`` warm calls, timed with CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _bound(bytes_moved, ops, ops_per_s):
    """(least time in ms, what bounds it): the larger of the bytes over the
    memory rate and the operations over the peak rate of their type."""
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _fma_per_sample(R, has_coarse):
    """f64 multiply-adds of one valid sample: sums and sums of squares of
    the R differences, and one (fine only) or two R(R+1)/2 outer products."""
    return 2 * R + (R * (R + 1) if has_coarse else R * (R + 1) // 2)


class Phase:
    """Prints a phase's wall time (host clock, after a device sync)."""

    def __init__(self, torch, name):
        self.torch, self.name = torch, name

    def __enter__(self):
        self.torch.cuda.synchronize()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            self.torch.cuda.synchronize()
            self.seconds = time.perf_counter() - self.t0
            print("phase %s: %.3f s" % (self.name, self.seconds))


def _qoi_inverse(q, h):
    """x with x + h*sqrt(1e-4 + |x|) = q (the QoI is increasing in x)."""
    from scipy.optimize import brentq

    return brentq(lambda x: x + h * np.sqrt(1e-4 + abs(x)) - q, -10.0, 10.0)


def _exact_mlmc_moment(mfn_raw, k):
    """What the telescoped estimate of moment k converges to for x ~ N(0, 1):
    sum over levels of E[phi_k(Q_l) - phi_k(Q_{l-1}) | the sample is valid],
    where level l keeps a sample whose fine and coarse QoIs both lie in the
    domain (level 0: its fine QoI). Quadrature over x."""
    import scipy.integrate as integrate
    import scipy.stats as st

    def phi(q):
        return mfn_raw.eval_all_np(np.array([q]))[0, k]

    total = 0.0
    for lvl, h in enumerate(LEVEL_STEPS):
        steps = [h] if lvl == 0 else [h, LEVEL_STEPS[lvl - 1]]
        lo = max(_qoi_inverse(DOMAIN[0], s) for s in steps)
        hi = min(_qoi_inverse(DOMAIN[1], s) for s in steps)
        qoi = lambda x, s: x + s * np.sqrt(1e-4 + abs(x))
        if lvl == 0:
            f = lambda x: phi(qoi(x, h)) * st.norm.pdf(x)
        else:
            f = lambda x, c=steps[1]: (phi(qoi(x, h)) - phi(qoi(x, c))) * st.norm.pdf(x)
        total += integrate.quad(f, lo, hi, limit=200)[0] / (
            st.norm.cdf(hi) - st.norm.cdf(lo))
    return total


def _exact_cdf(q, h):
    """P(QoI_h <= q | QoI in domain) for x ~ N(0, 1)."""
    import scipy.stats as st

    lo, hi = (st.norm.cdf(_qoi_inverse(b, h)) for b in DOMAIN)
    return (st.norm.cdf(_qoi_inverse(q, h)) - lo) / (hi - lo)


def _compare(torch, got, plain, s_abs, what, rtol=1e-12):
    """n_valid equal and |kernel - plain| <= rtol * max(S_abs, 1) for
    stacked results; returns (max |kernel - plain|, max of it / S_abs)."""
    _require(torch.equal(got.n_valid.cpu(), plain.n_valid.cpu()),
             "%s n_valid: kernel %s plain %s" % (what, got.n_valid.tolist(),
                                                 plain.n_valid.tolist()))
    err, rel = 0.0, 0.0
    for name in ("sums", "sums2", "cov_fine", "cov_coarse"):
        diff = (getattr(got, name) - getattr(plain, name)).abs()
        scale = getattr(s_abs, name).clamp(min=1.0)
        err = max(err, float(diff.max()))
        rel = max(rel, float((diff / scale).max()))
        _require(bool(torch.all(diff <= rtol * scale)),
                 "%s %s: |kernel - plain| > %g*S_abs" % (what, name, rtol))
    return err, rel


# ------------------------------------------------------------------------ #
# the storage-free path: kernels A and B
# ------------------------------------------------------------------------ #
def storage_free_path(torch, dev):
    import scipy.stats as st

    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
    from mlmc_tpu_torch.ops.precision import (
        accumulation_error_bound, check_against_f64, f64_reference_moments)
    import mlmc_tpu_torch.tool.simple_distribution as sd

    fine, coarse, has_coarse = ck._ladder(LEVEL_STEPS)
    fields = [("sums", "abs_sums"), ("sums2", "abs_sums2"),
              ("cov_fine", "abs_cov_fine"), ("cov_coarse", "abs_cov_coarse")]

    # ---- kernel A, memory mode, vs plain on the card and vs f64 -------- #
    with Phase(torch, "kernel A memory-mode check"):
        rng = np.random.default_rng(SEED)
        xs_np = [rng.normal(size=N_CHECK).astype(np.float32) for _ in LEVEL_STEPS]
        xs = [torch.from_numpy(x).to(dev) for x in xs_np]
        got = ck.synth_mlmc_pipeline_from_noise(xs, N_MOMENTS, LEVEL_STEPS,
                                                domain=DOMAIN)
        plain = ck.synth_mlmc_plain(xs, 0, [N_CHECK] * 5, fine, coarse, has_coarse,
                                    N_MOMENTS, domain=DOMAIN, device=dev)
        torch.cuda.synchronize()
        for lvl in range(len(LEVEL_STEPS)):
            ref = f64_reference_moments(
                xs_np[lvl], N_MOMENTS, fine_step=fine[lvl], coarse_step=coarse[lvl],
                domain=DOMAIN, is_level0=not has_coarse[lvl])
            g = got[lvl]
            _require(int(g.n_valid) == int(plain.n_valid[lvl]) == ref["n_valid"],
                     "memory mode n_valid level %d: kernel %d plain %d ref %d" % (
                         lvl, int(g.n_valid), int(plain.n_valid[lvl]), ref["n_valid"]))
            rel = 0.0
            for name, abs_name in fields:
                diff = (getattr(g, name) - getattr(plain, name)[lvl]).abs().cpu().numpy()
                scale = np.maximum(ref[abs_name], 1.0)
                rel = max(rel, float((diff / scale).max()))
                _require(np.all(diff <= 1e-12 * scale),
                         "memory mode %s level %d: |kernel - plain| > 1e-12*S_abs" % (name, lvl))
            report = check_against_f64(g, ref)  # raises beyond the f32 bound
            print("kernel A memory mode, level %d: n_valid %d equal; max |kernel-plain|/S_abs "
                  "%.3g (tol 1e-12); max dev vs f64 reference / S_abs %.3g (tol "
                  "accumulation_error_bound = %.3g*S_abs)" % (
                      lvl, int(g.n_valid), rel, max(report.values()),
                      float(accumulation_error_bound(1.0))))

    # ---- the storage-free main path, counted -------------------------- #
    ck.reset_launch_counts()
    with Phase(torch, "storage-free path"):
        t0 = time.perf_counter()
        accs = mt.synth_mlmc_pipeline(SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS,
                                      domain=DOMAIN, device=dev)
        est = accumulators_to_estimates(accs)
        headline_s = time.perf_counter() - t0
        n_valid = [int(a.n_valid) for a in accs]
        print("headline: 1e8 samples, 5 levels, R=25 in %.4f s (first call, host "
              "clock, incl. sync); n_valid per level %s" % (headline_s, n_valid))
        _require(est["mean"][0] == 1.0, "mean[0] = %r != 1" % est["mean"][0])
        _require(all(np.all(np.isfinite(est[k])) for k in ("mean", "var", "cov")),
                 "non-finite estimates")
        _require(est["mean"].shape == (N_MOMENTS,) and est["cov"].shape == (N_MOMENTS,) * 2,
                 "estimate shapes")
        _require(all(n > 0.999 * m for n, m in zip(n_valid, N_PER_LEVEL)),
                 "too few valid samples")
        mfn_raw = mt.Legendre(N_MOMENTS, DOMAIN, safe_eval=False)
        for k in range(1, 6):
            exact = _exact_mlmc_moment(mfn_raw, k)
            tol = 6 * np.sqrt(est["var"][k]) + 1e-6
            _require(abs(est["mean"][k] - exact) < tol,
                     "mean[%d] = %.6g vs exact %.6g (tol %.3g)" % (k, est["mean"][k], exact, tol))
        print("headline estimate: mean[0] == 1, mean[1:6] = %s within 6 sigma + 1e-6 of "
              "quadrature" % np.round(est["mean"][1:6], 6).tolist())

        # precision guard: memory mode vs exact f64 summation of the same values
        x = np.random.default_rng(99).normal(size=N_PRECISION).astype(np.float32)
        r = mt.synth_moment_pipeline_from_noise(torch.from_numpy(x).to(dev), N_MOMENTS,
                                                fine_step=0.25, coarse_step=0.5,
                                                domain=DOMAIN)
        ref = f64_reference_moments(x, N_MOMENTS, fine_step=0.25, coarse_step=0.5,
                                    domain=DOMAIN, include_cov=True)
        report = check_against_f64(r, ref)
        print("precision guard at %d: max deviation / S_abs vs f64 %.3g (bound %.3g)"
              % (N_PRECISION, max(report.values()), float(accumulation_error_bound(1.0))))

        # normal-stream quality on kernel B's output
        z = mt.synth_normals(SEED + 1, N_NORMALS, device=dev)
        zq = z.double()
        mean_z, var_z = float(zq.mean()), float(zq.var())
        ks = st.kstest(zq.cpu().numpy(), "norm")
        _require(abs(mean_z) < 5 / np.sqrt(N_NORMALS), "normal mean %.3g" % mean_z)
        _require(abs(var_z - 1) < 5 * np.sqrt(2 / N_NORMALS), "normal variance %.6g" % var_z)
        _require(ks.pvalue > 1e-3, "KS p-value %.3g" % ks.pvalue)
        print("normals: mean %.3g, variance %.6f, KS p-value %.3g over %d"
              % (mean_z, var_z, ks.pvalue, N_NORMALS))

        # maxent density from the headline estimate
        t0 = time.perf_counter()
        orto, info = sd.construct_ortogonal_moments(mt.Legendre(N_MOMENTS, DOMAIN),
                                                    est["cov"], tol=1e-7)
        mu = info[2] @ est["mean"]
        data = np.stack((mu, np.ones(orto.size)), axis=1)
        dist = sd.SimpleDistribution(orto, data, domain=DOMAIN, device=dev)
        res = dist.estimate_density_minimize(1e-8)
        maxent_s = time.perf_counter() - t0
        _require(res.success, "maxent solve: %s" % res.message)
        qg = np.linspace(-3.0, 3.0, 13)
        cdf_err = float(np.max(np.abs(dist.cdf(qg) - np.array(
            [_exact_cdf(q, LEVEL_STEPS[-1]) for q in qg]))))
        _require(cdf_err < 5e-3, "maxent CDF vs exact: %.3g" % cdf_err)
        print("maxent: %d orthogonal moments, converged (|grad| %.3g, %d Newton "
              "iterations) in %.3f s; max |CDF - exact CDF| on [-3, 3] %.3g (tol 5e-3)"
              % (orto.size, res.fun_norm, res.nit, maxent_s, cdf_err))

        # adaptive FusedMLMC on the card
        fns = [mt.SynthSimulation.scalar_batch_fn(h, c, mt.Norm())
               for h, c in zip(fine, coarse)]
        t0 = time.perf_counter()
        driver = mt.FusedMLMC(fns, mt.Legendre(N_MOMENTS, DOMAIN), seed=SEED,
                              device=dev)
        fest = driver.run(target_var=TARGET_VAR, initial_n=(2_000, 200))
        fused_s = time.perf_counter() - t0
        _require(float(np.max(fest["var"][1:])) <= TARGET_VAR, "FusedMLMC missed its target")
        _require(fest["mean"][0] == 1.0, "FusedMLMC mean[0]")
        print("FusedMLMC: target var %.0e met (max var %.3g) in %d rounds, n %s, %.2f s"
              % (TARGET_VAR, float(np.max(fest["var"][1:])), len(fest["history"]),
                 fest["n_samples"].astype(int).tolist(), fused_s))

    counts = ck.launch_counts()
    print("storage-free path: kernel launches %s" % counts)
    for name in ("synth_mlmc", "normals_dump"):
        _require(counts[name] > 0, "kernel %s was not launched by its path" % name)

    # ---- the path's kernel outputs vs the plain versions --------------- #
    with Phase(torch, "kernels A/B vs plain"):
        plain, s_abs = (ck.synth_mlmc_plain(
            None, SEED, N_PER_LEVEL, fine, coarse, has_coarse, N_MOMENTS,
            domain=DOMAIN, device=dev, absolute=a) for a in (False, True))
        stack = ck.SynthMomentResult(*(torch.stack([getattr(a, f) for a in accs])
                                       for f in ck.SynthMomentResult._fields))
        err_a, rel_a = _compare(torch, stack, plain, s_abs, "headline")
        print("kernel A at the headline vs plain: n_valid equal on all levels; max "
              "|kernel-plain| %.3g, / S_abs %.3g (tol 1e-12)" % (err_a, rel_a))
        err_b = float((z - ck.philox_normals(SEED + 1, 0, 0, N_NORMALS,
                                             device=dev)).abs().max())
        _require(err_b <= 1e-5, "normals |kernel - plain| = %.3g > 1e-5" % err_b)
        print("kernel B at the path's 1e7 normals vs plain: max |dz| %.3g "
              "(tol 1e-5)" % err_b)

    # ---- times and bounds at the path's shapes ------------------------ #
    a_ms = _time_ms(torch, lambda: ck.synth_mlmc_pipeline(
        SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS, domain=DOMAIN, device=dev))
    a_plain_ms = _time_ms(torch, lambda: ck.synth_mlmc_plain(
        None, SEED, N_PER_LEVEL, fine, coarse, has_coarse, N_MOMENTS,
        domain=DOMAIN, device=dev), reps=3)
    b_ms = _time_ms(torch, lambda: ck.synth_normals(SEED + 1, N_NORMALS, device=dev))
    b_plain_ms = _time_ms(torch, lambda: ck.philox_normals(SEED + 1, 0, 0, N_NORMALS,
                                                           device=dev))
    a_fma = sum(n * _fma_per_sample(N_MOMENTS, h) for n, h in zip(n_valid, has_coarse))
    a_bound = _bound(5 * (2 * N_MOMENTS + 2 * N_MOMENTS ** 2 + 1) * 8, 2 * a_fma,
                     FP64_FLOP_PER_S)
    sm_mhz = float(_smi("clocks.max.sm").split()[0])
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    b_bound = _bound(4 * N_NORMALS, PHILOX_INT32_OPS * N_NORMALS,
                     n_sm * INT32_LANES_PER_SM * sm_mhz * 1e6)
    print("times (CUDA events, median): kernel A %.3f ms vs plain %.3f ms at 1e8 "
          "samples (5 levels, R=25, RNG mode; bound %.3f ms, %s: %.4g f64 FMAs); "
          "kernel B %.3f ms vs plain %.3f ms at 1e7 normals (bound %.4f ms, %s: "
          "%d SMs x %d int32 lanes at %.0f MHz)"
          % (a_ms, a_plain_ms, a_bound[0], a_bound[1], a_fma, b_ms, b_plain_ms,
             b_bound[0], b_bound[1], n_sm, INT32_LANES_PER_SM, sm_mhz))
    return [
        {"name": "synth_mlmc", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/synth_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:605",
         "launches": counts["synth_mlmc"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound[0],
         "bound_by": a_bound[1], "library_ms": None},
        {"name": "normals_dump", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/synth_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:1013",
         "launches": counts["normals_dump"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound[0],
         "bound_by": b_bound[1], "library_ms": None},
    ]


# ------------------------------------------------------------------------ #
# the stored-samples path: kernels C and D
# ------------------------------------------------------------------------ #
def _stream_work(streams, n_valid, R, n_outputs):
    """(bytes, f64 flop) of one kernel C/D call over ``streams``: each f32
    input read once (coarse only where a stream has one), the outputs
    written once, and the multiply-adds of each valid sample."""
    bytes_in = sum(n * (8 if h else 4) for n, h in zip(streams.counts, streams.has_coarse))
    flop = 2 * sum(int(v) * _fma_per_sample(R, h)
                   for v, h in zip(n_valid, streams.has_coarse))
    return bytes_in + n_outputs * (2 * R + 2 * R * R + 1) * 8, flop


def e2e_adaptive(torch, dev, mt):
    """The adaptive loop of bench_extra.py's e2e workload on the port."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = mt.DeviceMemory(device=dev)
    pool = mt.DeviceBatchPool(seed=17, device_results=True, min_bucket=1 << 20,
                              max_batch=1 << 20, device=dev)
    sampler = mt.Sampler(storage, pool, sim, [[h] for h in LEVEL_STEPS])
    sampler.set_initial_n_samples([200_000, 2_000])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    root = mt.make_root_quantity(storage, sim.result_format())
    est = mt.Estimate(root["length"][1]["10"][0, 0], storage,
                      mt.Legendre(N_MOMENTS, DOMAIN))
    alloc_target, var = E2E_TARGET_VAR, np.inf
    for rounds in range(40):
        raw, ns = est.estimate_diff_vars_fast()        # one kernel C launch
        var = float(np.max((raw[:, 1:] / ns[:, None]).sum(axis=0)))
        if var <= E2E_TARGET_VAR:
            break
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw)
        n_est = mt.estimate_n_samples_for_target_variance(
            alloc_target, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            # allocation reached but not the target: the regressed
            # variances run low, so aim the allocation below the target
            alloc_target *= 0.95 * E2E_TARGET_VAR / var
    _require(var <= E2E_TARGET_VAR, "e2e loop missed its target: %.4g" % var)
    mean, mvar = est.estimate_moments_fast()
    _require(mean[0] == 1.0, "e2e mean[0] = %r" % mean[0])
    _require(float(np.max(mvar[1:])) <= E2E_TARGET_VAR, "e2e estimate variance")
    _dist, _info, result, orto = est.construct_density_fast(tol=1e-8)
    _require(result.success, "e2e density did not converge: %s" % result.message)
    # one fast-tier estimate (evaluate, harmonize, pack, kernel C, fetch):
    # what a per-storage-state result memo would save on a repeat call
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        est.estimate_diff_vars_fast()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    print("one fast-tier estimate at %d samples: %.3f ms (host clock, median of 3)"
          % (sum(storage.get_n_collected()), 1e3 * float(np.median(times))))
    print("e2e adaptive: target var %.0e met (max var %.4g) after %d rounds; "
          "n per level %s (%d samples x 24 f32 components, fine and coarse); "
          "pool: %d dispatches, %d blocking fetches; density converged "
          "(|grad| %.3g, %d orthogonal moments)"
          % (E2E_TARGET_VAR, var, rounds, storage.get_n_collected(),
             sum(storage.get_n_collected()), pool.n_dispatches,
             pool.n_blocking_fetches, result.fun_norm, orto.size))
    return sim, storage, root, est


def config4(dev, mt):
    """The Quantity DAG of bench_extra.py's config-4 workload."""
    import mlmc_tpu_torch.quantity.quantity_estimate as qe
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.precision import accumulation_error_bound

    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = mt.DeviceMemory(device=dev)
    sampler = mt.Sampler(storage, mt.DeviceBatchPool(
        seed=3, device_results=True, max_batch=1 << 20, min_bucket=1 << 18,
        device=dev), sim, C4_LEVELS)
    sampler.set_initial_n_samples([C4_N0, C4_N0 // 4, C4_N0 // 16])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    root = mt.make_root_quantity(storage, sim.result_format())
    expr = np.sin(root["length"][1]["10"]) * 2.0 + root["width"][2]["30"] / 3.0
    sel = expr.mask(expr < 10.0)
    mfn = mt.Legendre(8, (-10, 10))
    generic = qe.estimate_mean(qe.moments(sel, mfn))
    est = mt.Estimate(sel, storage, mfn)
    packed = est._fast_results_packed(mfn, [0, 1])
    # S_abs of each packed stream scales the f32 bound of the comparison
    s_abs = ck.samples_mlmc_plain(est._packed_streams(mfn, [0, 1]), 8,
                                  basis="legendre", absolute=True,
                                  consts=ck.transform_constants(mfn.domain))
    n_gen = np.asarray(generic.n_samples)
    gen_means = np.asarray(generic.l_means).reshape(len(C4_LEVELS), 2, 8)
    worst = 0.0
    for m in range(2):
        for lvl, r in enumerate(packed[m]):
            n = int(r.n_valid)
            _require(n == int(n_gen[lvl]), "config 4 n_valid level %d: packed "
                     "%d generic %d" % (lvl, n, n_gen[lvl]))
            diff = np.abs(r.sums / n - gen_means[lvl, m])
            tol = accumulation_error_bound(
                s_abs.sums[m * len(C4_LEVELS) + lvl].cpu().numpy()) / n + 1e-12
            worst = max(worst, float(diff.max()))
            _require(np.all(diff <= tol), "config 4 generic vs packed means, "
                     "component %d level %d: %.3g" % (m, lvl, diff.max()))
    print("config 4: %d samples; generic tier and packed tier agree: n_valid "
          "%s, max |mean diff| per level %.3g (within accumulation_error_bound"
          "(S_abs) / n)" % (sum(storage.get_n_collected()), n_gen.tolist(), worst))
    return est, mfn


def stored_path(torch, dev):
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.precision import (
        accumulation_error_bound, check_extended_against_f64,
        extended_bound_constant, extended_error_bound,
        f64_reference_moments_strict)

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    with Phase(torch, "stored path") as whole:
        with Phase(torch, "stored: e2e adaptive loop + fast density"):
            sim, storage, root, est = e2e_adaptive(torch, dev, mt)
        with Phase(torch, "stored: structured fast tier (M=12)"):
            mfn = mt.Legendre(N_MOMENTS, DOMAIN)
            est12 = mt.Estimate(root["length"], storage, mfn)
            before = ck.samples_mlmc_cuda.launches
            mean12, var12 = est12.estimate_moments_fast()
            _require(ck.samples_mlmc_cuda.launches == before + 1,
                     "structured fast tier took more than one launch")
            _require(mean12.shape == (12, N_MOMENTS) and np.all(mean12[:, 0] == 1.0)
                     and np.all(np.isfinite(var12)), "structured fast-tier estimate")
            raw12, ns12 = est12.estimate_diff_vars_fast()
            packed12 = est12._fast_results_packed(mfn, list(range(12)))
            per_comp = np.array([[int(r.n_valid) for r in packed12[m]] for m in range(12)])
            _require(np.all(per_comp == per_comp[0]) and per_comp[0].tolist() == ns12.tolist(),
                     "structured streams disagree in n_valid: %s" % per_comp.tolist())
            print("structured fast tier: 12 components x 5 levels in one launch; "
                  "n_valid per level %s on every component" % ns12.tolist())
        with Phase(torch, "stored: f64 tier (kernel D)"):
            ext_mean, ext_var = est.estimate_moments_extended()
            fast_mean, _ = est.estimate_moments_fast()
            _require(ext_mean[0] == 1.0 and np.all(np.isfinite(ext_var)),
                     "extended estimate")
            print("f64 tier: max |extended - fast| mean %.3g"
                  % float(np.max(np.abs(ext_mean - fast_mean))))
            # kernel D's largest launch: every stream of the structured quantity
            before = cx.samples_ext_cuda.launches
            ext_mean12, ext_var12 = est12.estimate_moments_extended()
            _require(cx.samples_ext_cuda.launches == before + 1,
                     "structured f64 tier took more than one launch")
            _require(ext_mean12.shape == (12, N_MOMENTS) and np.all(ext_mean12[:, 0] == 1.0)
                     and np.all(np.isfinite(ext_var12)), "structured f64-tier estimate")
            # f32 rows against f64 rows: per level at most the f32 tier's
            # bound of S_abs / n <= 2 (|phi_f - phi_c| <= 2 for Legendre)
            tol12 = len(LEVEL_STEPS) * float(accumulation_error_bound(2.0))
            diff12 = float(np.max(np.abs(ext_mean12 - mean12)))
            _require(diff12 <= tol12, "structured f64 tier vs fast tier: max |mean "
                     "diff| %.3g > %.3g" % (diff12, tol12))
            ext12 = est12._extended_results(mfn, list(range(12)))
            per_comp = np.array([[r.n_valid for r in ext12[m]] for m in range(12)])
            _require(np.all(per_comp == per_comp[0]) and per_comp[0].tolist() == ns12.tolist(),
                     "structured f64 streams disagree in n_valid: %s" % per_comp.tolist())
            print("structured f64 tier: 12 components x 5 levels in one kernel D launch; "
                  "n_valid per level %s on every component, as the fast tier's; max "
                  "|extended - fast| mean %.3g (tol %.3g: the f32 tier's bound per level)"
                  % (per_comp[0].tolist(), diff12, tol12))
        with Phase(torch, "stored: config 4 DAG"):
            c4_est, c4_mfn = config4(dev, mt)
    counts = {**ck.launch_counts(), **cx.launch_counts()}
    print("stored path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, torch.cuda.max_memory_allocated(dev) / 1e9))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by its path" % name)

    # ---- the path's kernel outputs vs the plain versions --------------- #
    with Phase(torch, "kernels C/D vs plain"):
        streams = est._packed_streams(est._moments_fn, [0])
        c4_streams = c4_est._packed_streams(c4_mfn, [0, 1])
        streams12 = est12._packed_streams(mfn, list(range(12)))
        c_consts = ck.transform_constants(DOMAIN)
        err_c, got_c = 0.0, []
        for what, st_, R, consts in (
                ("kernel C at the e2e streams", streams, N_MOMENTS, c_consts),
                ("kernel C at the config-4 streams", c4_streams, 8,
                 ck.transform_constants(c4_mfn.domain)),
                ("kernel C at the structured streams", streams12, N_MOMENTS,
                 c_consts)):
            got = ck.samples_mlmc_cuda(st_, R, basis="legendre", consts=consts, device=dev)
            plain, s_abs = (ck.samples_mlmc_plain(st_, R, basis="legendre", consts=consts,
                                                  absolute=a) for a in (False, True))
            err, rel = _compare(torch, got, plain, s_abs, what)
            err_c = max(err_c, err)
            got_c.append(got)
            print("%s vs plain: n_valid %s equal; max |kernel-plain| %.3g, / S_abs "
                  "%.3g (tol 1e-12)" % (what, got.n_valid.tolist(), err, rel))
        d_consts = ck.transform_constants(DOMAIN, f64=True)
        err_d, got_d = 0.0, []
        for what, st_ in (("kernel D at the e2e streams", streams),
                          ("kernel D at the structured streams", streams12)):
            got, again = (cx.samples_ext_cuda(st_, N_MOMENTS, basis="legendre",
                                              consts=d_consts, device=dev) for _ in range(2))
            _require(all(torch.equal(a, b) for a, b in zip(got, again)),
                     "%s: two launches differ" % what)
            plain, s_abs = (cx.samples_ext_plain(st_, N_MOMENTS, basis="legendre",
                                                 consts=d_consts, absolute=a)
                            for a in (False, True))
            err, rel = _compare(torch, got, plain, s_abs, what)
            err_d = max(err_d, err)
            got_d.append(got)
            print("%s vs plain: n_valid equal; two launches bit-identical; max "
                  "|kernel-plain| %.3g, / S_abs %.3g (tol 1e-12)" % (what, err, rel))
        # exact f64 summation on the host, with the strict reference's transform
        sym = cx.samples_ext_cuda(streams, N_MOMENTS, basis="legendre",
                                  consts=ck.transform_constants(DOMAIN, f64=True,
                                                                symmetric=True),
                                  device=dev)
        worst = 0.0
        for s, (off, n, h) in enumerate(zip(streams.offsets, streams.counts,
                                            streams.has_coarse)):
            ref = f64_reference_moments_strict(
                n_moments=N_MOMENTS, domain=DOMAIN, is_level0=not h,
                fine32=streams.fine[off:off + n].cpu().numpy(),
                coarse32=streams.coarse[off:off + n].cpu().numpy() if h else None)
            report = check_extended_against_f64(cx.to_host(sym, s), ref)
            worst = max(worst, max(report.values()))
        print("kernel D vs the exact f64 summation (strict reference) on the e2e "
              "streams: max deviation / S_abs %.3g (bound extended_error_bound = "
              "%.3g*S_abs = %d roundings x eps64)"
              % (worst, float(extended_error_bound(1.0)), extended_bound_constant()))

    # ---- times and bounds at the path's shapes ------------------------ #
    c_ms = _time_ms(torch, lambda: ck.samples_mlmc_cuda(
        streams, N_MOMENTS, basis="legendre", consts=c_consts, device=dev))
    c12_ms = _time_ms(torch, lambda: ck.samples_mlmc_cuda(
        streams12, N_MOMENTS, basis="legendre", consts=c_consts, device=dev))
    c_plain_ms = _time_ms(torch, lambda: ck.samples_mlmc_plain(
        streams, N_MOMENTS, basis="legendre", consts=c_consts), reps=3)
    d_ms = _time_ms(torch, lambda: cx.samples_ext_cuda(
        streams, N_MOMENTS, basis="legendre", consts=d_consts, device=dev))
    d12_ms = _time_ms(torch, lambda: cx.samples_ext_cuda(
        streams12, N_MOMENTS, basis="legendre", consts=d_consts, device=dev))
    d_plain_ms = _time_ms(torch, lambda: cx.samples_ext_plain(
        streams, N_MOMENTS, basis="legendre", consts=d_consts), reps=3)
    n_out = len(streams.counts)
    c_bytes, c_flop = _stream_work(streams, got_c[0].n_valid.tolist(), N_MOMENTS, n_out)
    d_bytes, d_flop = _stream_work(streams, got_d[0].n_valid.tolist(), N_MOMENTS, n_out)
    d12_bytes, d12_flop = _stream_work(streams12, got_d[1].n_valid.tolist(), N_MOMENTS,
                                       len(streams12.counts))
    c12_bytes, c12_flop = _stream_work(streams12, got_c[2].n_valid.tolist(), N_MOMENTS,
                                       len(streams12.counts))
    c_bound = _bound(c_bytes, c_flop, FP64_FLOP_PER_S)
    c12_bound = _bound(c12_bytes, c12_flop, FP64_FLOP_PER_S)
    d_bound = _bound(d_bytes, d_flop, FP64_FLOP_PER_S)
    d12_bound = _bound(d12_bytes, d12_flop, FP64_FLOP_PER_S)
    print("times (CUDA events, median) at the e2e streams (%d samples, 5 levels, "
          "R=25): kernel C %.3f ms vs plain %.3f ms (bound %.4f ms, %s: %.4g bytes, "
          "%.4g f64 flop); kernel D %.3f ms vs plain %.3f ms (bound %.4f ms, %s)"
          % (sum(streams.counts), c_ms, c_plain_ms, c_bound[0], c_bound[1], c_bytes,
             c_flop, d_ms, d_plain_ms, d_bound[0], d_bound[1]))
    print("kernels C and D at their largest launch, the structured streams (%d samples, "
          "12 x 5 streams, R=25): kernel C %.3f ms (bound %.4f ms, %s: %.4g bytes, %.4g "
          "f64 flop), beside %.3f ms at the e2e streams; kernel D %.3f ms (bound %.4f "
          "ms, %s), beside %.3f ms at the e2e streams"
          % (sum(streams12.counts), c12_ms, c12_bound[0], c12_bound[1], c12_bytes,
             c12_flop, c_ms, d12_ms, d12_bound[0], d12_bound[1], d_ms))
    return [
        {"name": "samples_mlmc", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/samples_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:815",
         "launches": counts["samples_mlmc"], "max_abs_err": err_c,
         "ms": c_ms, "plain_ms": c_plain_ms, "bound_ms": c_bound[0],
         "bound_by": c_bound[1], "library_ms": None},
        {"name": "samples_ext", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/samples_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_extended.py:269",
         "launches": counts["samples_ext"], "max_abs_err": err_d,
         "ms": d_ms, "plain_ms": d_plain_ms, "bound_ms": d_bound[0],
         "bound_by": d_bound[1], "library_ms": None},
    ]


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is false)")
    csrc = os.path.join(HERE, "mlmc_tpu_torch", "csrc")
    if not all(os.path.isfile(os.path.join(csrc, f))
               for f in ("synth_mlmc.cu", "samples_mlmc.cu", "moment_gram.cuh")):
        _fail("run from the root of a checkout: mlmc_tpu_torch/csrc is missing")
    sys.path.insert(0, HERE)
    from mlmc_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_smi("name,power.limit"))
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    with Phase(torch, "kernel build (parallel nvcc) + load"):
        for name in _build.build_all():
            _build.load_library(name)

    kernels = storage_free_path(torch, dev) + stored_path(torch, dev)
    print(_smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
