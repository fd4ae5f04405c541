"""Drive mlmc_tpu_torch's storage-free MLMC main path once on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. builds the CUDA kernels of mlmc_tpu_torch/csrc with nvcc;
2. checks kernel A (fused sample -> moment reduction) in memory mode
   against its plain PyTorch version on the card and an exact f64
   summation, at 2^20 samples on each of 5 levels;
3. drives the main path with the launch counters reset: the 5-level
   synthetic estimate at 1e8 samples and 25 Legendre moments in one
   kernel A launch, the f32-vs-f64 precision guard (memory mode, 1e7
   samples), the normal-stream quality check (kernel B, 1e7 normals), the
   maxent density, and a short adaptive FusedMLMC run on the card; then
   fails unless every kernel of the path was launched;
4. holds the main path's kernel outputs (the headline accumulators, the
   1e7 normals) against the plain versions at the same shapes and seeds;
5. times each kernel and its plain version at the main path's shapes.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout. The last line is {"ok": true, "device": {...}}; the line before
it lists the kernels with their launch counts, errors and times.
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


def _fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def _require(cond, msg):
    if not cond:
        _fail(msg)


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


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is false)")
    if not os.path.isfile(os.path.join(HERE, "mlmc_tpu_torch", "csrc",
                                       "synth_mlmc.cu")):
        _fail("run from the root of a checkout: mlmc_tpu_torch/csrc is missing")
    sys.path.insert(0, HERE)
    import scipy.stats as st

    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import _build
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
    from mlmc_tpu_torch.ops.precision import (
        accumulation_error_bound, check_against_f64, f64_reference_moments)
    import mlmc_tpu_torch.tool.simple_distribution as sd

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else "nvidia-smi: " + smi.stderr.strip())
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))

    t0 = time.perf_counter()
    _build.load_library()
    print("kernel build + load: %.2f s" % (time.perf_counter() - t0))

    fine, coarse, has_coarse = ck._ladder(LEVEL_STEPS)
    fields = [("sums", "abs_sums"), ("sums2", "abs_sums2"),
              ("cov_fine", "abs_cov_fine"), ("cov_coarse", "abs_cov_coarse")]

    # ---- kernel A, memory mode, vs plain on the card and vs f64 -------- #
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

    # ---- the main path, counted --------------------------------------- #
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t_path = time.perf_counter()

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

    torch.cuda.synchronize()
    counts = ck.launch_counts()
    print("main path: %.2f s; kernel launches %s" % (time.perf_counter() - t_path, counts))
    for name, n in counts.items():
        _require(n > 0, "kernel %s was not launched by the main path" % name)

    # ---- the main path's kernel outputs vs the plain versions ---------- #
    plain, s_abs = (ck.synth_mlmc_plain(
        None, SEED, N_PER_LEVEL, fine, coarse, has_coarse, N_MOMENTS,
        domain=DOMAIN, device=dev, absolute=a) for a in (False, True))
    err_a, rel_a = 0.0, 0.0
    for lvl, g in enumerate(accs):
        _require(int(g.n_valid) == int(plain.n_valid[lvl]),
                 "headline n_valid level %d: kernel %d plain %d" % (
                     lvl, int(g.n_valid), int(plain.n_valid[lvl])))
        for name, _ in fields:
            diff = (getattr(g, name) - getattr(plain, name)[lvl]).abs()
            scale = getattr(s_abs, name)[lvl].clamp(min=1.0)
            err_a = max(err_a, float(diff.max()))
            rel_a = max(rel_a, float((diff / scale).max()))
            _require(bool(torch.all(diff <= 1e-12 * scale)),
                     "headline %s level %d: |kernel - plain| > 1e-12*S_abs" % (name, lvl))
    print("kernel A at the headline vs plain: n_valid equal on all levels; max "
          "|kernel-plain| %.3g, / S_abs %.3g (tol 1e-12)" % (err_a, rel_a))
    err_b = float((z - ck.philox_normals(SEED + 1, 0, 0, N_NORMALS,
                                         device=dev)).abs().max())
    _require(err_b <= 1e-5, "normals |kernel - plain| = %.3g > 1e-5" % err_b)
    print("kernel B at the main path's 1e7 normals vs plain: max |dz| %.3g "
          "(tol 1e-5)" % err_b)

    # ---- times at the main path's shapes ------------------------------- #
    a_ms = _time_ms(torch, lambda: ck.synth_mlmc_pipeline(
        SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS, domain=DOMAIN, device=dev))
    a_plain_ms = _time_ms(torch, lambda: ck.synth_mlmc_plain(
        None, SEED, N_PER_LEVEL, fine, coarse, has_coarse, N_MOMENTS,
        domain=DOMAIN, device=dev), reps=3)
    b_ms = _time_ms(torch, lambda: ck.synth_normals(SEED + 1, N_NORMALS, device=dev))
    b_plain_ms = _time_ms(torch, lambda: ck.philox_normals(SEED + 1, 0, 0, N_NORMALS,
                                                           device=dev))
    print("times (CUDA events, median): kernel A %.3f ms vs plain %.3f ms at 1e8 "
          "samples (5 levels, R=25, RNG mode); kernel B %.3f ms vs plain %.3f ms at "
          "1e7 normals" % (a_ms, a_plain_ms, b_ms, b_plain_ms))

    kernels = [
        {"name": "synth_mlmc", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/synth_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:605",
         "launches": counts["synth_mlmc"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain_ms},
        {"name": "normals_dump", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/synth_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:1013",
         "launches": counts["normals_dump"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
