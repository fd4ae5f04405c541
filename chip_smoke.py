"""Drive mlmc_tpu_torch's MLMC main paths once on one GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. builds every CUDA source of mlmc_tpu_torch/csrc with nvcc (one process
   per source, all started together);
2. checks kernel A (fused sample -> moment reduction) in memory mode
   against its plain PyTorch version on the card and an exact f64
   summation, at 2^20 samples on each of 5 levels;
3. the storage-free path, with the launch counters reset just before it:
   the 5-level synthetic estimate at 1e8 samples and 25 Legendre moments
   in one kernel A launch, the f32-vs-f64 precision guard (memory mode,
   1e7 samples), the normal-stream quality check (kernel B, 1e7 normals:
   mean, variance, KS test, and the KS test of each of the four slots of a
   Philox call), the maxent density, and a short adaptive FusedMLMC run on
   the card; fails unless kernels A and B were launched; then kernel A at
   the headline and at levels that start inside a quad, and kernel B from
   aligned and misaligned first indices, against their plain versions (B
   bit for bit);
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
5. the simulations path, with the counters reset just before it: the
   three BASELINE configurations whose samples are real simulations,
   a. config 2, the shooting ODE (1D, 256 modes, 200 and 1000 Euler steps):
      batches of 8192 coupled samples, the one-matmul route against the
      generic route, then the 2-level MLMC run with the variance-optimal
      allocation, the fast tier (kernel C) against the f64 tier (kernel D),
      the L=1 entry of kernel C, and the bootstrap in its three schemes;
   b. config 3, the maxent density from 35 exact moments of a two-Gaussian
      target;
   c. config 5, the Darcy flow with a circulant-embedding GRF: batches of
      1024 coupled 64^2 / 16^2 samples, the homogeneous limit, the field's
      covariance, then bench_e2e_darcy's adaptive 3-level loop for
      target_var=1e-6 (it ends when the allocation is scheduled; the
      variance the finished run then shows is printed beside the target)
      with kernel C estimating the level variances each round and kernel D
      the final mean flux;
   fails unless kernels C and D were launched, and holds them against
   their plain versions at this path's streams;
6. the persisted path, with the counters reset just before it: a run that
   outlives its process, at config 4's size (2^21 + 2^19 + 2^17 samples of
   24 components, 384 bytes per sample in the file's f64 records),
   a. Sampler -> DeviceBatchPool(device_results=False) -> SampleStorageBin:
      the first half of every level, close, everything dropped; the
      directory reopened by a new storage, pool and sampler, which must find
      the first half finished and nothing unfinished, and schedule the rest;
   b. the directory reopened once more and estimated on the card: the
      generic tier chunk by chunk, the fast tier (kernel C), the f64 tier
      (kernel D);
   c. held against the same run kept on the card (DeviceMemory): payloads
      bit for bit, the kernels' n_valid equal and their sums within
      1e-12 * S_abs, the generic tier's means to 1e-12 (against the resident
      payload widened to f64, as the file holds it); kernels C and D
      against their plain versions at these streams;
   d. a-c again through SampleStorageHDF where h5py is installed (it says
      which); the binary log's library is built from its source by one g++
      call and is never optional;
   fails unless kernels C and D were launched by each pass;
7. the sharded path (the sample mesh), with the counters reset just before
   it, each part held against its one-device run:
   a. the headline (1e8 samples) over SampleMesh([dev, dev]), kernel A once
      per shard on its index range of every level, and over SampleMesh([dev])
      inside a one-rank NCCL process group (FileStore in a temporary
      directory), kernel A once, the accumulators all-reduced by NCCL:
      counts exact, sums within 1e-13 * S_abs;
   b. the noise pipeline over two shards at 2^20 normals per level, kernel
      C once per shard, against one kernel C launch and the plain version;
   c. DeviceBatchPool(sharding=...) on config 5's Darcy (batches of 1024 at
      64^2 / 16^2) and on the synthetic simulation: payloads within 1e-10
      and bit for bit;
   d. est_bootstrap_fast(replace="poisson", mesh=...) at config 2's stored
      run (B = 100): within 1e-10 relative;
   e. FusedMLMC, sharded_mlmc_step and the four drivers (MultilevelCDF,
      cmlmc, ml2r, UnbiasedMLMC) over the mesh: counts and decisions equal,
      estimates within 1e-12 relative;
   fails unless kernel A ran 2 + 1 times and kernel C 2 times; one JSON
   line with each part's host time and the warm kernel times;
8. the darcy3d path, with the counters reset just before it (the set-ups
   of bench_extra.py and examples/darcy3d_workflow.py, nothing cut):
   a. the 3-D Darcy batch (256 samples, 32^3 + 16^3, spectral CG), the 3-D
      fractured batch (64, 24 discs, contrast 1e3, MG-CG) and the 2-D
      fractured batch (1024, 64^2 + 16^2, circulant, 24 fractures, MG-CG):
      samples/s, CG iterations, device events and idle share, peak memory;
      the homogeneous 3-D flux equals k0, batch rows equal per-sample
      solves, the coupling and the fluxes hold;
   b. the adaptive 3-D run (8^3 / 16^3 / 32^3 from [512, 128, 32] to
      target_var=2e-5, kernel C each round, kernel D, the maxent density):
      within 1.1x of the target, E[K_eff] within 0.12 of exp(1/6);
   c. ProcessBase over DiffusionSimulation3D on the card: run --clean,
      process, renew (SampleStorageBin where h5py is absent); process's
      moments equal an Estimate over the reopened storage;
   d. FlowSim with mock gmsh and flow123d scripts, 4 + 2 samples through
      OneProcessPool; the native gmsh parser must parse the meshes;
   fails unless kernels C and D were launched; holds them against their
   plain versions at the 3-D run's streams; one JSON line;
9. the sde_qmc path, with the counters reset just before it (the sizes of
   bench_extra.py's bench_lattice, bench_qmc(_compact), bench_sde,
   bench_importance, bench_heston's SDE half, bench_merton, bench_vg,
   bench_rbergomi and bench_unbiased):
   a. Sobol' bits of d=256 at 2^20 points, raw and Owen-scrambled, equal bit
      for bit to the same calls on the CPU; the d=8 CBC lattice (n=2^12,
      R=16) within 6 se of two closed forms;
   b. MLQMC: the 5-level synthetic QoI to 1e-12 on Sobol' and on the
      lattice, and again over SampleMesh([dev, dev]) (sums equal to one
      device bit for bit); the shooting ODE (256 phase dims) to 1e-8;
   c. SDE batches: GBM Milstein 256+64 at 2^16 (samples/s, device events,
      idle share; keyed rows equal to the same indices in two halves), the
      deep-OTM Girsanov call, Heston (3 levels), Merton and variance gamma
      (4 levels, keyed draws: inversion Poisson, boosted Marsaglia-Tsang
      gamma) and rBergomi (4 levels, the eta=0 limit), each price within
      its bound of its closed form;
   d. the MLQMC GBM call to 1e-9 (gain > 5 on every level) and the
      Rhee-Glynn coupled-sum call to 1e-8 (its deepest level printed);
   e. the stored SDE run: GBM path functionals over 4 levels through
      Sampler -> DeviceBatchPool -> DeviceMemory, one allocation round, the
      call in the Quantity algebra against Black-Scholes, Legendre(10)
      moments of the terminal value by kernels C and D;
   fails unless kernels C and D were launched; holds them against their
   plain versions at the stored run's streams; one JSON line;
10. the e2 path, with the counters reset just before it (the sizes of
   bench_extra.py's bench_spde, bench_reactions, bench_transport,
   bench_american, bench_heston's Bermudan half, bench_bsde,
   bench_sensitivity and bench_nested), each phase under torch.profiler
   for its host wall time, device events and idle share:
   a. the stochastic heat SPDE telescope (2^13 keyed fields, levels (32,
      16), (64, 64 | 32, 16), (128, 256 | 64, 64)) within 6 se of the
      discrete law, with the level variance ratios;
   b. the dimerization tau-leap telescope (2^15 keyed lanes, 5 levels) within
      6 sigma + 1.5 of the exact SSA (2^13 lanes, 512 events, no overrun);
   c. transport at 64^2 + 16^2 (1024 coupled samples), the pool over
      SampleMesh([dev, dev]) equal to one device bit for bit, its 40 QoI x 2
      levels through Estimate (kernel C variances, kernel D means), a MUSCL
      batch of 256 whose QoI are finite;
   d. the Bermudan put (50 dates, 2 x 2^18 paths) bracketed by the CRR tree
      and the dual bound of a degree-7 surface; the Heston bracket; the
      float64 run over SampleMesh([dev, dev]) against one device, at most 16
      paths flipping their exercise decision;
   e. the BSDE measure-change driver and the nonlinear anchor against their
      closed forms;
   f. Ishigami's Sobol' indices (2^17 x 16) against the closed forms, and an
      active subspace;
   g. unbiased nested EVPPI to 1e-7 within 6 se of the closed form;
   h. the stored SPDE run (Sampler -> DeviceBatchPool -> DeviceMemory), one
      allocation round, the energy's mean against the discrete law,
      Legendre(10) moments by kernels C and D;
   fails unless kernels C and D were launched; holds them against their
   plain versions at the transport and the stored SPDE streams; one JSON
   line;
11. the e3 path, with the counters reset just before it (the sizes of
   bench_extra.py's bench_mimc, bench_mimc_darcy, bench_mfmc, bench_mlblue,
   bench_risk, bench_mcmc and bench_oed, cut in depth or batching where
   E3 says), each phase with its host wall and its main batch's device
   events and idle share:
   a. MIMC on the heat equation (total degree 4) to 1e-9, the same run over
      SampleMesh([dev, dev]) equal bit for bit, the work ratio against
      diagonal MLMC, the synthetic model within 6 se of its telescope;
   b. MIMC on the anisotropic Darcy problem, float64, adaptive to 1e-8;
   c. MFMC on the heat fidelities, the synthetic family against its law;
   d. MLBLUE on the same family, within 6 se of MFMC;
   e. GBM VaR/CVaR at 0.95 within 6 se of the lognormal forms, and the
      CVaR-optimal put hedge no worse than unhedged (on risk.adam);
   f. MLMCMC on the Darcy inverse problem (16/32/64, 256 chains): the
      posterior-mean misfit below a tenth of the prior's, acceptance rates
      in (0, 1); the CRN fixed point exactly zero; MLDA and unbiased pairs;
   g. OED: the spread and cluster designs by nested-MC EIG; a linear design
      against its closed form by eig_nmc and the unbiased EIG;
   h. the stored MCMC series in a DeviceMemory: kernel C's variances and
      kernel D's means, D's level means equal to MLMCMC's to 1e-12;
   fails unless kernels C and D were launched; holds them against their
   plain versions at the MCMC streams (D also within its derived bound);
   one JSON line;
12. the e45 path, with the counters reset just before it (the sizes of
   bench_extra.py's bench_bayes_compact, bench_bayes, bench_rare,
   bench_filter, bench_particle, bench_collocation and bench_pce rows, and
   of tests/test_pod.py and tests/test_gp.py, as E45 says), each phase with
   its host wall and its main batch's device events and idle share:
   a. ES-MDA on the 3-d linear problem within 0.1 of the conjugate
      posterior mean; hierarchical ES-MDA on the 16/32/64 Darcy inverse
      problem, its misfit falling;
   b. tempered SMC's log-evidence within 6 se of the closed form;
      hierarchical SMC on the Darcy hierarchy (stages, solves/s, evidence);
   c. Phi(-4) by subset simulation (within 6 se in log p) and by
      cross-entropy IS (within 6 se); the Darcy flux tail on 32^2;
   d. ETKF on Lorenz-96 at J = 64 / 256 / 1024 (RMSE below the noise at
      J >= 256); enkf against kalman_filter; the MLEnKF fixed point exactly
      zero;
   e. the bootstrap PF on stochastic volatility (RMSE below the prior
      sd); the 4-level Euler-OU MLPF, its corrections decaying, and the
      same over SampleMesh([dev, dev]) equal bit for bit;
   f. POD at n = 32, rank 24: energy > 0.99, held-out rho > 0.97, MFMC
      with the surrogate (speedup > 1.2, calibrated within 6 se);
   g. Gauss-Hermite collocation w = 2..4 of the 8-d flux (the ladder's
      deltas falling), multilevel collocation, the adaptive grid;
   h. a degree-3 PCE (165 terms), its Sobol' indices, the PCE in MFMC and
      as a control variate;
   i. bayes_opt on Branin (y_best < 0.397887 + 0.25), MultilevelGP on
      Forrester, all on risk.adam;
   j. the stored POD-surrogate series in a DeviceMemory (2^16 POD values,
      2^12 (full, POD) pairs): kernel C's variances and kernel D's means,
      D's level means equal to direct float64 means to 1e-12;
   fails unless kernels C and D were launched; holds them against their
   plain versions at the POD streams (D also within its derived bound);
   one JSON line;
13. holds each kernel's outputs at its path's shapes against its plain
   version (kernel C at the e2e, config-4 and structured streams; kernel D
   at the e2e and structured streams, also against an exact f64 summation,
   and two launches of it bit for bit against each other);
14. times each kernel and its plain version at those shapes and computes
   each kernel's bound from this run's inputs (kernel A also in memory
   mode, at the precision guard's launch); kernels C and D and their plain
   versions also at their largest launch, the structured tier's 12 x 5
   streams; kernel B's library time is torch.randn's at its 1e7 normals;
   kernel B and torch.randn are also timed queued, the device alone
   (tool/timing.py: "device_ms", "library_device_ms"); kernel B's bound
   counts per Philox call (four normals) the integer-pipe and f32-pipe
   instructions of one turn of its loop in its SASS, on the path that
   issues the fewest (tool/kernel_sass.py), and 16 bytes written; kernels A's and B's registers and local loads and
   stores are read from their SASS.

Exits non-zero, printing no result, without a CUDA device or outside a
checkout. The last line is {"ok": true, "device": {...}}; the line before
it lists the kernels with their launch counts (of all the paths, and by
path under "launches_by_path"), errors, times and bounds; each
configuration of the simulations path, and the persisted, sharded,
darcy3d, sde_qmc, e2, e3 and e45 paths, print one JSON line of their own.
"""
import json
import os
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

# config 3: what mlmc_tpu gives for the 35-moment two-Gaussian target on the
# CPU in f64 (tests/test_torch_density.py measures both and holds these
# constants to them); the card's result may be at most 10 x each
MAXENT35_JAX_KL = 1.4919e-05
MAXENT35_JAX_RESIDUAL = 4.985e-09
DARCY_TARGET_VAR = 1e-6
DARCY_TARGET_SLACK = 1.1   # the finished run's variance may sit this far above
# the sharded path: config 5's Darcy batch, the synthetic pool, config 2's
# stored run, and the drivers at the sizes of mlmc_tpu's mesh tests
SHARDED_DARCY_N = [1024, 1024]
SHARDED_SYNTH_N = [1 << 17, 1 << 15]
C2_N = [1 << 17, 1 << 15]
# cmlmc's and ml2r's depth: their work grows as 1/eps^2 and 1/target (45 s
# of the script at 2e-3 and 1e-7; cut to keep the script near 250 s)
SHARDED_CMLMC_EPS = 4e-3
SHARDED_ML2R_TARGET = 4e-7

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and the FP64 rate of
# the tensor cores (the fastest f64 unit); the int32 rate is 64 lanes per
# SM per clock at the card's maximum SM clock (read from nvidia-smi)
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12
INT32_LANES_PER_SM = 64
ISSUE_LANES_PER_SM = 128   # 4 schedulers x one 32-thread instruction per clock
#: kernel B from misaligned first indices: inside the first quad, and across
#: the high word of the Philox call number (the call 2^32 holds index 2^34)
B_STARTS = (77, (1 << 34) - 5)
#: kernel A in RNG mode from levels that start inside a quad (as a shard of
#: a sample mesh may): the per-level first indices and counts
A_STARTS = [1, 2, 3, 77, 1 << 20 | 1]
A_STARTS_N = [(1 << 20) + 3, 1 << 18, (1 << 16) + 7, 99_999, 4_097]


def _fail(msg):
    raise SystemExit("chip_smoke: FAILED: " + msg)


def _require(cond, msg):
    if not cond:
        _fail(msg)


def _time_ms(torch, fn, reps=5):
    """Median over ``reps`` warm single calls, each between two CUDA
    events (tool/timing.event_ms)."""
    from mlmc_tpu_torch.tool.timing import event_ms

    return event_ms(fn, reps)


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
        # the four slots of a Philox call (both branches of two pairs)
        slot_p = [st.kstest(zq[j::4].cpu().numpy(), "norm").pvalue for j in range(4)]
        _require(min(slot_p) > 1e-3, "KS p-value per slot %s" % slot_p)
        print("normals: mean %.3g, variance %.6f, KS p-value %.3g over %d; per slot of "
              "a Philox call %s" % (mean_z, var_z, ks.pvalue, N_NORMALS,
                                    ["%.3g" % p for p in slot_p]))

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
        _require(err_b == 0, "normals |kernel - plain| = %.3g != 0" % err_b)
        for start in B_STARTS:
            zs = ck.synth_normals(SEED + 1, N_NORMALS, level=3, start=start, device=dev)
            dz = float((zs - ck.philox_normals(SEED + 1, 3, start, N_NORMALS,
                                               device=dev)).abs().max())
            _require(dz == 0, "normals from %d: |kernel - plain| = %.3g != 0"
                     % (start, dz))
        print("kernel B at the path's 1e7 normals vs plain: max |dz| %.3g, and from "
              "first indices %s: 0 (tol 0, bit for bit)" % (err_b, list(B_STARTS)))
        # kernel A's RNG mode from levels that start inside a quad
        lv = len(A_STARTS_N)
        got = ck.synth_mlmc_pipeline(SEED, N_MOMENTS, A_STARTS_N, LEVEL_STEPS[:lv],
                                     domain=DOMAIN, device=dev, starts=A_STARTS)
        again = ck.synth_mlmc_pipeline(SEED, N_MOMENTS, A_STARTS_N, LEVEL_STEPS[:lv],
                                       domain=DOMAIN, device=dev, starts=A_STARTS)
        _require(all(torch.equal(a, b) for ga, gb in zip(got, again)
                     for a, b in zip(ga, gb)), "kernel A: two launches differ")
        plain_s, s_abs_s = (ck.synth_mlmc_plain(
            None, SEED, A_STARTS_N, *ck._ladder(LEVEL_STEPS[:lv]), N_MOMENTS,
            domain=DOMAIN, device=dev, absolute=a, starts=A_STARTS) for a in (False, True))
        got = ck.SynthMomentResult(*(torch.stack([getattr(a, f) for a in got])
                                     for f in ck.SynthMomentResult._fields))
        err_s, rel_s = _compare(torch, got, plain_s, s_abs_s, "levels from %s" % A_STARTS)
        err_a = max(err_a, err_s)
        print("kernel A from first indices %s (counts %s) vs plain: n_valid equal, max "
              "|kernel-plain| / S_abs %.3g (tol 1e-12); two launches bit for bit"
              % (A_STARTS, A_STARTS_N, rel_s))

    # ---- times and bounds at the path's shapes ------------------------ #
    a_ms = _time_ms(torch, lambda: ck.synth_mlmc_pipeline(
        SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS, domain=DOMAIN, device=dev))
    a_plain_ms = _time_ms(torch, lambda: ck.synth_mlmc_plain(
        None, SEED, N_PER_LEVEL, fine, coarse, has_coarse, N_MOMENTS,
        domain=DOMAIN, device=dev), reps=3)
    # kernel B's call is a few tens of microseconds of device time, no more
    # than the host's launch path, which single calls between two events
    # hold: its calls (and torch.randn's) are also queued behind a spin
    # kernel and timed back to back, the device alone
    from mlmc_tpu_torch.tool.timing import queued_ms

    def b_call():
        return ck.synth_normals(SEED + 1, N_NORMALS, device=dev)

    b_ms, b_device_ms = _time_ms(torch, b_call), queued_ms(b_call)
    b_plain_ms = _time_ms(torch, lambda: ck.philox_normals(SEED + 1, 0, 0, N_NORMALS,
                                                           device=dev))
    # the library call drawing the same law (standard normals, float32) from
    # torch's own Philox stream; timed here only, the port never calls it
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)

    def lib_call():
        return torch.randn(N_NORMALS, device=dev, generator=gen)

    b_lib_ms, b_lib_device_ms = _time_ms(torch, lib_call), queued_ms(lib_call)
    a_fma = sum(n * _fma_per_sample(N_MOMENTS, h) for n, h in zip(n_valid, has_coarse))
    a_bound = _bound(5 * (2 * N_MOMENTS + 2 * N_MOMENTS ** 2 + 1) * 8, 2 * a_fma,
                     FP64_FLOP_PER_S)
    # kernel A's memory mode (the precision guard's launch): one level of
    # N_PRECISION stored f32 normals, fine 0.25 / coarse 0.5
    x_guard = torch.from_numpy(np.random.default_rng(99).normal(
        size=N_PRECISION).astype(np.float32)).to(dev)
    m_ms = _time_ms(torch, lambda: ck.synth_moment_pipeline_from_noise(
        x_guard, N_MOMENTS, fine_step=0.25, coarse_step=0.5, domain=DOMAIN))
    m_plain_ms = _time_ms(torch, lambda: ck.synth_mlmc_plain(
        [x_guard], 0, [N_PRECISION], [0.25], [0.5], [True], N_MOMENTS, domain=DOMAIN,
        device=dev), reps=3)
    m_bound = _bound(4 * N_PRECISION + (2 * N_MOMENTS + 2 * N_MOMENTS ** 2 + 1) * 8,
                     2 * N_PRECISION * _fma_per_sample(N_MOMENTS, True), FP64_FLOP_PER_S)
    print("kernel A memory mode (the precision guard's launch, %d stored f32 normals, "
          "R=25): %.3f ms vs plain %.3f ms (bound %.3f ms, %s)"
          % (N_PRECISION, m_ms, m_plain_ms, m_bound[0], m_bound[1]))
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    # kernel B: per Philox call (four normals), the instructions of one turn
    # of its loop in its SASS on the path that issues the fewest (the vector
    # store; no trig slow path, no special-case call): the integer-pipe ones
    # on 64 lanes per SM, and those with the f32-pipe ones issued at 128 per
    # SM per clock; 16 bytes written
    from mlmc_tpu_torch.ops import _build
    from mlmc_tpu_torch.tool import kernel_sass
    from mlmc_tpu_torch.tool.timing import smi

    sm_mhz = float(smi("clocks.max.sm").split()[0])
    sass = kernel_sass.summary(_build.library_path("synth_mlmc"))
    _require(sorted(sass) == ["A NB=1", "A NB=2", "A NB=3", "A NB=4", "B"],
             "SASS: expected kernel A x 4 and kernel B, found %s" % sorted(sass))
    b_int, b_f32 = sass["B"]["LOOP_INT"], sass["B"]["LOOP_F32"]
    _require(b_int > 0 and b_f32 > 0, "SASS: kernel B's loop not found: %s" % sass["B"])
    b_calls = -(-N_NORMALS // 4)
    t_int = b_int * b_calls / (n_sm * INT32_LANES_PER_SM * sm_mhz * 1e6)
    t_issue = (b_int + b_f32) * b_calls / (n_sm * ISSUE_LANES_PER_SM * sm_mhz * 1e6)
    b_bound = _bound(4 * N_NORMALS, max(t_int, t_issue), 1.0)
    print("SASS (tool/kernel_sass.py): %s" % json.dumps(sass))
    print("times (CUDA events, median): kernel A %.3f ms vs plain %.3f ms at 1e8 "
          "samples (5 levels, R=25, RNG mode; bound %.3f ms, %s: %.4g f64 FMAs); "
          "kernel B %.4f ms (single calls; %.4f ms queued, the device alone) vs plain "
          "%.3f ms vs torch.randn %.4f ms (single calls; %.4f ms queued) at 1e7 "
          "normals (bound %.4f ms, %s: %d Philox calls; int32 %.4f ms for %d "
          "integer-pipe instructions a call on %d SMs x %d lanes at %.0f MHz; issue "
          "%.4f ms for %d + %d f32-pipe instructions a call at %d a clock per SM; "
          "bytes %.4f ms)"
          % (a_ms, a_plain_ms, a_bound[0], a_bound[1], a_fma, b_ms, b_device_ms,
             b_plain_ms, b_lib_ms, b_lib_device_ms, b_bound[0], b_bound[1], b_calls,
             t_int * 1e3, b_int, n_sm, INT32_LANES_PER_SM, sm_mhz, t_issue * 1e3,
             b_int, b_f32, ISSUE_LANES_PER_SM, 4 * N_NORMALS / HBM_BYTES_PER_S * 1e3))
    a_extra = {"sass": {k: v for k, v in sass.items() if k != "B"}}
    b_extra = {"device_ms": b_device_ms, "library_device_ms": b_lib_device_ms,
               "sass": sass["B"], "bound_parts_ms": {
                   "int32": t_int * 1e3, "issue": t_issue * 1e3,
                   "bytes": 4 * N_NORMALS / HBM_BYTES_PER_S * 1e3}}
    return [
        {"name": "synth_mlmc", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/synth_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:605",
         "launches": counts["synth_mlmc"], "max_abs_err": err_a,
         "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound[0],
         "bound_by": a_bound[1], "library_ms": None,
         "memory_mode": {"samples": N_PRECISION, "ms": m_ms, "plain_ms": m_plain_ms,
                         "bound_ms": m_bound[0], "bound_by": m_bound[1]}, **a_extra},
        {"name": "normals_dump", "route": "cuda",
         "source": "mlmc_tpu_torch/csrc/synth_mlmc.cu",
         "replaces": "mlmc_tpu/ops/pallas_kernels.py:1013",
         "launches": counts["normals_dump"], "max_abs_err": err_b,
         "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound[0],
         "bound_by": b_bound[1], "library_ms": b_lib_ms, **b_extra},
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
    packed = est._stream_results(mfn, [0, 1])           # [level, component, ...]
    # S_abs of each packed stream scales the f32 bound of the comparison
    s_abs = ck.samples_mlmc_plain(est._packed_streams(mfn, [0, 1]), 8,
                                  basis="legendre", absolute=True,
                                  consts=ck.transform_constants(mfn.domain))
    n_gen = np.asarray(generic.n_samples)
    gen_means = np.asarray(generic.l_means).reshape(len(C4_LEVELS), 2, 8)
    worst = 0.0
    for m in range(2):
        for lvl in range(len(C4_LEVELS)):
            n = int(packed.n_valid[lvl, m])
            _require(n == int(n_gen[lvl]), "config 4 n_valid level %d: packed "
                     "%d generic %d" % (lvl, n, n_gen[lvl]))
            diff = np.abs(packed.sums[lvl, m] / n - gen_means[lvl, m])
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
            per_comp = est12._stream_results(mfn, list(range(12))).n_valid.T
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
            per_comp = est12._stream_results(mfn, list(range(12)), f64=True).n_valid.T
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
    c12_plain_ms = _time_ms(torch, lambda: ck.samples_mlmc_plain(
        streams12, N_MOMENTS, basis="legendre", consts=c_consts), reps=3)
    d12_plain_ms = _time_ms(torch, lambda: cx.samples_ext_plain(
        streams12, N_MOMENTS, basis="legendre", consts=d_consts), reps=3)
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
          "12 x 5 streams, R=25): kernel C %.3f ms vs plain %.3f ms (bound %.4f ms, %s: "
          "%.4g bytes, %.4g f64 flop), beside %.3f ms at the e2e streams; kernel D %.3f "
          "ms vs plain %.3f ms (bound %.4f ms, %s), beside %.3f ms at the e2e streams"
          % (sum(streams12.counts), c12_ms, c12_plain_ms, c12_bound[0], c12_bound[1],
             c12_bytes, c12_flop, c_ms, d12_ms, d12_plain_ms, d12_bound[0], d12_bound[1],
             d_ms))
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


# ------------------------------------------------------------------------ #
# the simulations path: BASELINE configs 2, 3 and 5 (kernels C and D)
# ------------------------------------------------------------------------ #
def _streams_vs_plain(torch, dev, est, what, components=(0,)):
    """Kernels C and D at an estimate's streams (of ``components``) against
    their plain versions (1e-12 * S_abs); returns the two max errors."""
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    mfn = est._moments_fn
    streams = est._packed_streams(mfn, list(components))
    errs = []
    for name, launch, plain_fn, consts in (
            ("C", ck.samples_mlmc_cuda, ck.samples_mlmc_plain,
             ck.transform_constants(mfn.domain)),
            ("D", cx.samples_ext_cuda, cx.samples_ext_plain,
             ck.transform_constants(mfn.domain, f64=True))):
        got = launch(streams, mfn.size, basis="legendre", consts=consts, device=dev)
        plain, s_abs = (plain_fn(streams, mfn.size, basis="legendre", consts=consts,
                                 absolute=a) for a in (False, True))
        err, rel = _compare(torch, got, plain, s_abs, "kernel %s at %s" % (name, what))
        errs.append(err)
        print("kernel %s at %s (%s samples, R=%d) vs plain: n_valid %s equal; max "
              "|kernel-plain| %.3g, / S_abs %.3g (tol 1e-12)"
              % (name, what, list(streams.counts), mfn.size, got.n_valid.tolist(),
                 err, rel))
    return errs


def config2_shooting(torch, dev, mt):
    """BASELINE config 2 at bench_extra.py's size."""
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.precision import accumulation_error_bound

    Sim = mt.ShootingSimulation1D
    borders = (-100.0, 200.0, -300.0, 400.0)
    sim = Sim(dict(
        start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
        area_borders=borders, max_time=10.0, complexity=20.0, n_modes=256,
        fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5, log=False)))
    out = {"config": 2, "workload": "shooting 1D, 1000+200 Euler steps, 256 modes"}

    # ---- (a) coupled batches of 8192 ---------------------------------- #
    with Phase(torch, "config 2: shooting batches"):
        cfg = sim.level_instance([0.02], [0.1]).config_dict
        gen = torch.Generator(device=dev).manual_seed(SEED)
        B = 8192
        ms = _time_ms(torch, lambda: Sim.calculate_batch(cfg, gen, B), reps=16)
        fine, coarse, failed = Sim.calculate_batch(cfg, gen, B)
        _require(fine.shape == (B, 1) and fine.device == dev and not bool(failed.any()),
                 "shooting batch shape/device")
        nan_frac = float(torch.isnan(fine).float().mean())
        mean_fine = float(fine[~torch.isnan(fine)].double().mean())
        _require(np.isfinite(mean_fine) and nan_frac < 0.5, "shooting batch values")
        # the one-matmul route against the generic route on the same draws
        trig = Sim._phase_trig(cfg, gen, B, dev, torch.float32)
        a = Sim._calculate_level(cfg, trig, "fine")[:, 0]
        b = Sim._calculate_level(cfg, trig, "fine", generic=True)[:, 0]
        # distance of each trajectory from the borders, in f64
        cfg64 = dict(cfg, dtype="float64", _cache={})
        trig64 = tuple(t.double() for t in trig)
        n = cfg["fine"]["n_elements"]
        times = torch.linspace(0.0, cfg["max_time"], n, dtype=torch.float64, device=dev)
        dt = cfg["max_time"] / n
        acc = dt * dt * torch.matmul(Sim._euler_weights(n, torch.float64, dev),
                                     Sim._force_field_batch(cfg64, trig64, times))
        j_dt = dt * torch.arange(1, n + 1, dtype=torch.float64, device=dev)
        X = (torch.tensor(cfg["start_position"], dtype=torch.float64, device=dev)
             + j_dt[None, :, None] * torch.tensor(cfg["start_velocity"],
                                                  dtype=torch.float64, device=dev) + acc)
        margin = torch.stack([X[..., 0] - borders[0], borders[1] - X[..., 0],
                              X[..., 1] - borders[2], borders[3] - X[..., 1]]
                             ).amin(dim=(0, 2))
        differ = torch.isnan(a) != torch.isnan(b)
        _require(bool((margin[differ].abs() < 1e-3).all()),
                 "shooting routes disagree on a sample away from the borders")
        both = ~torch.isnan(a) & ~torch.isnan(b)
        route_rel = float(((a - b).abs() / b.abs().clamp(min=1.0))[both].max())
        _require(route_rel <= 1e-4, "shooting routes differ: %.3g" % route_rel)
        out.update(batch=B, batch_ms=ms, samples_per_s=B / ms * 1e3,
                   mean_fine=mean_fine, nan_fraction=nan_frac,
                   routes_max_rel_diff=route_rel, routes_mask_mismatches=int(differ.sum()))
        print("config 2 batches: %d coupled samples in %.3f ms (CUDA events, median "
              "of 16): %.4g samples/s; mean finite fine %.4f, NaN fraction %.4f; "
              "log=False route vs generic route: max rel diff %.3g (tol 1e-4), %d NaN "
              "masks differ (all within 1e-3 of a border)"
              % (B, ms, out["samples_per_s"], mean_fine, nan_frac, route_rel,
                 int(differ.sum())))

    # ---- (b) the 2-level MLMC run -------------------------------------- #
    with Phase(torch, "config 2: 2-level MLMC run, allocation, tiers"):
        storage = mt.DeviceMemory(device=dev)
        pool = mt.DeviceBatchPool(seed=9, device_results=True, device=dev)
        sampler = mt.Sampler(storage, pool, sim, [[0.1], [0.02]])
        sampler.set_initial_n_samples([1 << 17, 1 << 15])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        _require(storage.get_n_collected() == [1 << 17, 1 << 15],
                 "shooting run: NaN results must be stored, got %s"
                 % storage.get_n_collected())
        q = mt.make_root_quantity(storage, sim.result_format())["target"][10]["0"][0]
        domain = mt.estimate_domain(q, storage, quantile=0.01)
        mfn = mt.Legendre(5, domain)
        est = mt.Estimate(q, storage, mfn)
        raw, ns = est.estimate_diff_vars_fast()               # kernel C
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw)
        n_est = mt.estimate_n_samples_for_target_variance(
            1e-3, variances, n_ops, n_levels=2)
        _require(n_est[0] >= n_est[1] >= 2, "shooting allocation %s" % n_est.tolist())
        fast_mean, fast_var = est.estimate_moments_fast()     # kernel C
        ext_mean, ext_var = est.estimate_moments_extended()   # kernel D
        tol = 2 * float(accumulation_error_bound(2.0))
        tier_diff = float(np.max(np.abs(fast_mean - ext_mean)))
        _require(fast_mean[0] == 1.0 and ext_mean[0] == 1.0 and tier_diff <= tol
                 and np.all(np.isfinite(ext_var)),
                 "shooting fast tier vs f64 tier: %.3g > %.3g" % (tier_diff, tol))
        # row 5 of the kernel table: the L=1 entry of kernel C on level 0
        before = ck.samples_mlmc_cuda.launches
        pairs0 = storage.sample_pairs()[0]                    # [1, N, 1]
        one = mt.moment_pipeline_from_samples(pairs0[0, :, 0], None, 5, domain=domain,
                                              is_level0=True)
        l1_launches = ck.samples_mlmc_cuda.launches - before
        _require(l1_launches == 1, "moment_pipeline_from_samples launched %d times"
                 % l1_launches)
        packed0 = ck.SynthMomentResult(*(f[0, 0] for f in est._stream_results(mfn, [0])))
        _require(int(one.n_valid) == int(packed0.n_valid) and all(
            np.array_equal(getattr(one, f).cpu().numpy(), getattr(packed0, f))
            for f in ("sums", "sums2", "cov_fine")),
            "the L=1 entry differs from the packed launch's level 0")
        # the coupling: a shared force field makes the level variance small
        pairs1 = storage.sample_pairs()[1][0]                 # [N, 2]
        ok = ~torch.isnan(pairs1).any(dim=1)
        v_diff = float((pairs1[ok, 0] - pairs1[ok, 1]).double().var())
        v_fine = float(pairs1[ok, 0].double().var())
        _require(v_diff < 0.5 * v_fine, "shooting coupling: %.3g vs %.3g" % (v_diff, v_fine))
        out.update(n_collected=storage.get_n_collected(), domain=list(domain),
                   n_valid=ns.tolist(), n_estimated=n_est.tolist(),
                   tiers_max_mean_diff=tier_diff, v_diff=v_diff, v_fine=v_fine,
                   l1_entry_launches=l1_launches)
        print("config 2 MLMC: n %s (n_valid %s), domain (%.3f, %.3f); allocation for "
              "1e-3: %s; fast vs f64 tier max |mean diff| %.3g (tol %.3g); the L=1 "
              "entry of kernel C equals the packed launch's level 0 bit for bit; "
              "v_diff %.4g < 0.5 * v_fine %.4g"
              % (storage.get_n_collected(), ns.tolist(), domain[0], domain[1],
                 n_est.tolist(), tier_diff, tol, v_diff, v_fine))

    # ---- bootstrap CIs, three schemes ---------------------------------- #
    with Phase(torch, "config 2: bootstrap, three schemes"):
        means, boot_s = {}, {}
        for replace in (False, True, "poisson"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.est_bootstrap_fast(n_subsamples=100, sample_vector=[1 << 16, 1 << 14],
                                   seed=SEED, replace=replace)
            torch.cuda.synchronize()
            boot_s[str(replace)] = time.perf_counter() - t0
            _require(est.var_bs_mean[0] == 0.0 and np.all(est.var_bs_mean >= 0),
                     "bootstrap %r: var_bs_mean %s" % (replace, est.var_bs_mean))
            _require(est.mean_bs_l_vars.shape == (2, 5), "bootstrap attribute shapes")
            means[str(replace)] = (est.mean_bs_mean.copy(), est.var_bs_mean.copy())
        ref_mean, ref_var = means["False"]
        for name, (m, v) in means.items():
            tol_b = 6 * np.sqrt(np.maximum(v, ref_var) / 100) + 1e-6
            _require(np.all(np.abs(m - ref_mean) <= tol_b),
                     "bootstrap scheme %s disagrees: %s vs %s" % (name, m, ref_mean))
        out.update(bootstrap_s=boot_s, bootstrap_ci_halfwidth=(
            1.96 * np.sqrt(ref_var)).tolist())
        print("config 2 bootstrap (B=100, n_sub [65536, 16384]): %s s (host clock, "
              "first call each); var_bs_mean[0] == 0, the three schemes' means agree "
              "within 6 sqrt(var/100) + 1e-6"
              % {k: round(v, 3) for k, v in boot_s.items()})
    print(json.dumps(out))
    return est


def config3_maxent35(torch, dev):
    """BASELINE config 3 as bench_extra.py's bench_maxent35."""
    import scipy.stats as stats

    import mlmc_tpu_torch as mt
    import mlmc_tpu_torch.tool.simple_distribution as sd

    with Phase(torch, "config 3: maxent from 35 moments"):
        comps = (stats.norm(-1.5, 0.6), stats.norm(2.0, 1.0))
        pdf = lambda x: sum(0.5 * c.pdf(x) for c in comps)
        lo = min(c.ppf(1e-8) for c in comps)
        hi = max(c.ppf(1 - 1e-8) for c in comps)
        mfn = mt.Legendre(35, (lo, hi))
        cov = sd.compute_semiexact_cov(mfn, pdf)
        orto, _ = sd.construct_ortogonal_moments(mfn, cov, tol=1e-13)
        mu = sd.compute_semiexact_moments(orto, pdf)
        data = np.stack((mu, np.ones(orto.size)), axis=1)
        solve_s = []
        for _ in range(2):  # first call and a warm one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            d = sd.SimpleDistribution(orto, data, domain=mfn.domain, device=dev)
            result = d.estimate_density_minimize(tol=1e-10)
            torch.cuda.synchronize()
            solve_s.append(time.perf_counter() - t0)
        _require(result.success, "maxent35 did not converge: %s" % result.message)
        kl = float(sd.KL_divergence(pdf, d.density, lo, hi))
        residual = float(np.linalg.norm(sd.compute_semiexact_moments(orto, d.density) - mu))
        _require(kl <= 10 * MAXENT35_JAX_KL, "maxent35 KL %.3g > 10 x %.3g"
                 % (kl, MAXENT35_JAX_KL))
        _require(residual <= 10 * MAXENT35_JAX_RESIDUAL, "maxent35 residual %.3g > 10 x "
                 "%.3g" % (residual, MAXENT35_JAX_RESIDUAL))
    out = {"config": 3, "workload": "maxent 35 moments, two-Gaussian mixture, tol 1e-10",
           "solve_s_first": solve_s[0], "solve_s": solve_s[1], "kl_vs_exact": kl,
           "moment_residual": residual, "n_orto_moments": int(orto.size),
           "newton_iterations": int(result.nit), "converged": bool(result.success)}
    print("config 3: %d orthogonal moments, converged in %d Newton iterations, %.3f s "
          "(first call %.3f s, host clock); KL vs exact %.4g (mlmc_tpu on the CPU "
          "%.4g), moment residual %.3g (%.3g)"
          % (orto.size, result.nit, solve_s[1], solve_s[0], kl, MAXENT35_JAX_KL,
             residual, MAXENT35_JAX_RESIDUAL))
    print(json.dumps(out))


def config5_darcy(torch, dev, mt):
    """BASELINE config 5 as bench_extra.py's bench_diffusion and
    bench_e2e_darcy."""
    import mlmc_tpu_torch.quantity.quantity_estimate as qe
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    Sim = mt.DiffusionSimulation
    sim = Sim(dict(sigma=1.0, corr_length=0.3, field_method="circulant"))
    out = {"config": 5, "workload": "Darcy, circulant-embedding GRF, CG solve"}

    # ---- (a) coupled batches of 1024 at 64^2 / 16^2 -------------------- #
    with Phase(torch, "config 5: Darcy batches, homogeneous limit, covariance"):
        cfg = sim.level_instance([1 / 64], [1 / 16]).config_dict
        gen = torch.Generator(device=dev).manual_seed(SEED)
        B = 1024
        ms = _time_ms(torch, lambda: Sim.calculate_batch(cfg, gen, B), reps=8)
        fines = []
        for _ in range(8):
            fine, coarse, failed = Sim.calculate_batch(cfg, gen, B)
            fines.append(fine[:, 0].double())
        fines = torch.cat(fines)
        nan_frac = float(torch.isnan(fines).double().mean())
        _require(nan_frac == 0.0 and not bool(failed.any()) and fine.shape == (B, 1),
                 "Darcy batch: NaN fraction %g" % nan_frac)
        batch_mean = float(fines.mean())
        batch_se = float(fines.std() / np.sqrt(fines.numel()))
        noise = torch.randn((B, 2, 128, 128), generator=gen, device=dev)
        _, _, it_f, it_c = Sim._calculate(cfg, noise=(noise[:, 0], noise[:, 1]))
        max_it = (int(it_f.max()), int(it_c.max()))
        # the homogeneous limit: K = k0 gives flux k0
        K = torch.full((4, 64, 64), 2.5, device=dev)
        p, it_h = Sim._solve_pressure(cfg, K)
        hom = float(Sim._flux(K, p).double().sub(2.5).abs().max())
        _require(hom < 2.5e-4, "homogeneous limit: |flux - k0| = %.3g" % hom)
        # the field's covariance over 4096 samples, at a few lags
        N = 4096
        w = torch.randn((N, 2, 128, 128), generator=gen, device=dev)
        g = Sim._circulant_field(cfg, w[:, 0], w[:, 1]).double()
        field = mt.CirculantEmbeddingField(
            corr_exp="gauss", dim=2, corr_length=0.3, grid_shape=(64, 64),
            grid_step=1 / 64, device=dev, dtype=torch.float32)
        one = field._sample_from(w[0, 0], w[0, 1]).reshape(64, 64)
        _require(float((one.double() - g[0]).abs().max()) < 1e-4,
                 "the simulation's field differs from CirculantEmbeddingField's")
        cov_dev = 0.0
        for di, dj in ((0, 0), (0, 5), (7, 0), (10, 10), (0, 25)):
            prod = g[:, 0, 0] * g[:, di, dj]
            want = np.exp(-((di * di + dj * dj) / 64.0 ** 2) / 0.3 ** 2)
            dev_sigma = abs(float(prod.mean()) - want) / float(prod.std() / np.sqrt(N))
            cov_dev = max(cov_dev, dev_sigma)
            _require(dev_sigma < 5, "field covariance at lag (%d, %d): %.3g vs %.3g "
                     "(%.1f sigma)" % (di, dj, float(prod.mean()), want, dev_sigma))
        del w, g, noise
        out.update(batch=B, batch_ms=ms, samples_per_s=B / ms * 1e3, mean_flux_batches=batch_mean,
                   nan_fraction=nan_frac, max_cg_iterations_fine=max_it[0],
                   max_cg_iterations_coarse=max_it[1], homogeneous_abs_err=hom,
                   covariance_max_sigma=cov_dev)
        print("config 5 batches: %d coupled 64^2/16^2 samples in %.3f ms (CUDA events, "
              "median of 8): %.4g samples/s; mean flux %.4f +- %.4f, NaN fraction 0; max "
              "CG iterations %d (64^2), %d (16^2); homogeneous limit |flux - k0| %.3g; "
              "field covariance over 4096 samples within %.2f sigma of exp(-(r/L)^2) "
              "at 5 lags (tol 5)"
              % (B, ms, out["samples_per_s"], batch_mean, batch_se, max_it[0], max_it[1],
                 hom, cov_dev))

    # ---- (b) the adaptive 3-level loop --------------------------------- #
    with Phase(torch, "config 5: adaptive Darcy MLMC loop") as loop:
        t_start = time.perf_counter()
        storage = mt.DeviceMemory(device=dev)
        pool = mt.DeviceBatchPool(seed=23, device_results=True, min_bucket=1 << 12,
                                  max_batch=1 << 14, device=dev)
        sampler = mt.Sampler(storage, pool, sim, [[1 / 16], [1 / 32], [1 / 64]])
        sampler.set_initial_n_samples([2000, 500, 100])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        q = mt.make_root_quantity(storage, sim.result_format())["flux"][0]["outflow"][0]
        mfn = mt.Legendre(15, (0.05, 8.0))
        est = mt.Estimate(q, storage, mfn)
        torch.cuda.synchronize()
        clock = {"sampling": time.perf_counter() - t_start, "kernel_c_estimate": 0.0,
                 "host": 0.0}
        # bench_e2e_darcy's loop as it stands: it ends when a round has
        # scheduled the whole allocation for the regressed variances
        rounds, reached = 0, False
        while rounds < 12:
            t0 = time.perf_counter()
            raw, _ns = est.estimate_diff_vars_fast()          # one kernel C launch
            t1 = time.perf_counter()
            variances, n_ops = est.estimate_diff_vars_regression(
                sampler._n_scheduled_samples, raw_vars=raw)
            n_est = mt.estimate_n_samples_for_target_variance(
                DARCY_TARGET_VAR, variances, n_ops, n_levels=sampler.n_levels)
            t2 = time.perf_counter()
            reached = sampler.process_adding_samples(n_est, 0, 0.3)
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            clock["kernel_c_estimate"] += t1 - t0
            clock["host"] += t2 - t1
            clock["sampling"] += t3 - t2
            if reached:
                break
            rounds += 1
        _require(reached, "Darcy loop: the allocation for target %.0e was not reached "
                 "in %d rounds" % (DARCY_TARGET_VAR, rounds))
        m = qe.estimate_mean(q)
        rates = mt.estimate_convergence_rates(
            m.l_means, m.l_vars, storage.get_level_parameters(), storage.get_n_ops())
        wall = time.perf_counter() - t_start
        n_at_loop_end = [int(v) for v in storage.get_n_collected()]
    _require(rates["beta"] > 0, "Darcy variance rate beta = %r" % rates["beta"])
    # what the finished run's samples say of the target, once the last
    # round's samples are in the storage too: the estimate's variance by
    # moment from kernel C's level variances as they are, and from the
    # regressed ones, which the allocation was made for
    sampler.ask_sampling_pool_for_samples()
    raw, ns = est.estimate_diff_vars_fast()
    regressed, _ = est.estimate_diff_vars_regression(
        sampler._n_scheduled_samples, raw_vars=raw)
    var = float(np.max((raw[:, 1:] / ns[:, None]).sum(axis=0)))
    var_regressed = float(np.max((regressed[:, 1:] / ns[:, None]).sum(axis=0)))
    # the allocation was made from level variances estimated a round
    # earlier, so the finished run sits at the target up to their noise
    _require(var <= DARCY_TARGET_SLACK * DARCY_TARGET_VAR,
             "Darcy loop: max var %.4g after the allocation for %.0e (slack %.2f)"
             % (var, DARCY_TARGET_VAR, DARCY_TARGET_SLACK))
    # the mean flux on the f64 tier: Legendre's moment 1 is the mean of the
    # transformed value, which maps back linearly
    ext_mean, ext_var = est.estimate_moments_extended()       # kernel D
    half = (mfn.domain[1] - mfn.domain[0]) / 2.0
    flux_d = mfn.domain[0] + (ext_mean[1] + 1.0) * half
    flux_d_se = float(np.sqrt(ext_var[1]) * half)
    flux_generic = float(np.ravel(m.mean)[0])
    tol = 6 * float(np.hypot(flux_d_se, batch_se))
    _require(ext_mean[0] == 1.0 and abs(flux_d - batch_mean) <= tol,
             "Darcy MLMC mean flux %.5f vs the batches' %.5f (tol %.3g)"
             % (flux_d, batch_mean, tol))
    out.update(loop_wall_s=wall, rounds=rounds, target_var=DARCY_TARGET_VAR,
               target_met=var <= DARCY_TARGET_VAR, max_var=var, max_var_regressed=var_regressed,
               n_per_level=[int(v) for v in storage.get_n_collected()],
               n_per_level_at_loop_end=n_at_loop_end,
               n_valid=ns.tolist(), dispatches=int(pool.n_dispatches),
               blocking_fetches=int(pool.n_blocking_fetches),
               mean_flux=flux_generic, mean_flux_f64_tier=float(flux_d),
               mean_flux_f64_tier_se=flux_d_se,
               alpha=rates["alpha"], beta=rates["beta"], gamma=rates.get("gamma"),
               clock_s=clock, n_ops=[float(c) for c in storage.get_n_ops()])
    print("config 5 adaptive loop: the allocation for target var %.0e reached (max var "
          "over the moments %.4g by the raw level variances, %.4g by the regressed) "
          "after %d rounds in %.2f s (host clock: sampling %.2f s, kernel C estimates %.3f s, "
          "regression and allocation %.3f s); n per level %s; pool: %d dispatches, %d "
          "blocking fetches; mean flux %.5f (generic tier), %.5f +- %.5f (f64 tier, "
          "kernel D) vs the batches' %.5f +- %.5f; alpha %.3f, beta %.3f, gamma %.3f"
          % (DARCY_TARGET_VAR, var, var_regressed, rounds, wall, clock["sampling"],
             clock["kernel_c_estimate"], clock["host"], out["n_per_level"],
             pool.n_dispatches, pool.n_blocking_fetches, flux_generic, flux_d, flux_d_se,
             batch_mean, batch_se, rates["alpha"], rates["beta"],
             rates.get("gamma", float("nan"))))
    print(json.dumps(out))
    return est


def simulations_path(torch, dev):
    """BASELINE configs 2, 3 and 5; returns the path's launch counts."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    with Phase(torch, "simulations path") as whole:
        shoot_est = config2_shooting(torch, dev, mt)
        config3_maxent35(torch, dev)
        darcy_est = config5_darcy(torch, dev, mt)
    counts = {**ck.launch_counts(), **cx.launch_counts()}
    print("simulations path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, torch.cuda.max_memory_allocated(dev) / 1e9))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by its path" % name)
    with Phase(torch, "kernels C/D vs plain at the simulations' streams"):
        errs = (_streams_vs_plain(torch, dev, shoot_est, "the shooting streams")
                + _streams_vs_plain(torch, dev, darcy_est, "the Darcy streams"))
    return counts, {"samples_mlmc": max(errs[0::2]), "samples_ext": max(errs[1::2])}


# ------------------------------------------------------------------------ #
# the persisted path: card -> host -> file -> card (kernels C and D)
# ------------------------------------------------------------------------ #
def _persisted_stage(dev, mt, make_storage, counts, expect_before):
    """One stage of a persisted run, what one process does: open the storage, make a new
    pool and sampler, require what the file already holds, schedule up to
    ``counts``, collect, close. Everything is dropped on return."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = make_storage()
    # batches of 2^18 under a budget of 64 MiB of un-fetched payload: level
    # 0 then has, beside its two timing probes, deferred batches that cross
    # the budget, so the early drain of a host-bound wave runs on the card
    pool = mt.DeviceBatchPool(seed=3, device_results=False, max_batch=1 << 18,
                              inflight_bytes=1 << 26, device=dev)
    sampler = mt.Sampler(storage, pool, sim, C4_LEVELS)
    if expect_before is not None:
        got = ([int(n) for n in storage.n_finished()],
               [int(n) for n in storage.get_n_collected()],
               [int(n) for n in sampler._n_scheduled_samples])
        _require(got == (expect_before,) * 3, "reopened run: finished, collected, "
                 "scheduled %s, expected %s" % (got, expect_before))
        left = storage.unfinished_ids()
        _require(len(left) == 0, "reopened run: %d unfinished ids" % len(left))
    sampler.set_initial_n_samples(counts)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    _require([int(n) for n in storage.get_n_collected()] == counts,
             "persisted run collected %s of %s" % (storage.get_n_collected(), counts))
    storage.close()
    return pool.n_dispatches, pool.n_blocking_fetches


def _persisted_estimates(torch, mt, storage, sim, dev):
    """The three tiers over ``storage``, through the entry points a user
    calls; returns (estimate, {tier: (means, vars)}, {tier: seconds})."""
    mfn = mt.Legendre(8, (-10, 10))
    root = mt.make_root_quantity(storage, sim.result_format(), device=dev)
    est = mt.Estimate(root["length"][1]["10"][0, 0], storage, mfn)
    results, seconds = {}, {}
    for tier, call in (("generic", lambda: est.estimate_moments(mfn)),
                       ("fast", est.estimate_moments_fast),
                       ("f64", est.estimate_moments_extended)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results[tier] = tuple(np.asarray(x, dtype=np.float64) for x in call())
        torch.cuda.synchronize()
        seconds[tier] = time.perf_counter() - t0
        _require(results[tier][0][0] == 1.0 and np.all(np.isfinite(results[tier][1])),
                 "persisted %s tier estimate" % tier)
    return est, results, seconds


def _persisted_run_and_estimate(torch, dev, mt, kind, make_storage, directory):
    """Steps a and b of the persisted path through one file storage: the
    run in two stages, then the three tiers over the reopened file.
    Returns the pass's record and its open storage and estimate."""
    full = [C4_N0, C4_N0 // 4, C4_N0 // 16]
    half = [n // 2 for n in full]
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    m = sum(int(np.prod(q.shape)) * len(q.times) * len(q.locations)
            for q in sim.result_format())
    record_bytes = sum(full) * 2 * m * 8

    # a. run, stop, resume
    with Phase(torch, "persisted %s: run, stop, resume" % kind) as writing:
        first = _persisted_stage(dev, mt, make_storage, half, None)
        second = _persisted_stage(dev, mt, make_storage, full, half)
    on_disk = sum(os.path.getsize(os.path.join(root_, f))
                  for root_, _, files in os.walk(directory) for f in files)
    write_gbs = record_bytes / writing.seconds / 1e9
    print("persisted %s: %d samples x %d f64 values x 2 = %.4g bytes of records "
          "(%.4g bytes on disk) written in two stages in %.3f s: %.3f GB/s card -> "
          "host -> file; pool dispatches %d + %d, blocking fetches %d + %d"
          % (kind, sum(full), m, record_bytes, on_disk, writing.seconds, write_gbs,
             first[0], second[0], first[1], second[1]))

    # b. estimate from the file
    storage = make_storage()
    n_chunks = sum(1 for _ in storage.chunks())
    with Phase(torch, "persisted %s: estimate from the file" % kind):
        est, results, seconds = _persisted_estimates(torch, mt, storage, sim, dev)
    read_gbs = {tier: record_bytes / t / 1e9 for tier, t in seconds.items()}
    print("persisted %s: file -> host -> card -> estimate over %d chunks: generic "
          "tier %.3f s (%.3f GB/s), fast tier (kernel C) %.3f s (%.3f GB/s), f64 tier "
          "(kernel D) %.3f s (%.3f GB/s)"
          % (kind, n_chunks, seconds["generic"], read_gbs["generic"], seconds["fast"],
             read_gbs["fast"], seconds["f64"], read_gbs["f64"]))
    record = {"storage": kind, "samples": sum(full), "values_per_sample": 2 * m,
              "record_bytes": record_bytes, "bytes_on_disk": on_disk,
              "write_s": writing.seconds, "write_GBps": write_gbs,
              "dispatches": [first[0], second[0]],
              "blocking_fetches": [first[1], second[1]], "chunks": n_chunks,
              "estimate_s": seconds, "estimate_GBps": read_gbs}
    return record, storage, est, results


def _persisted_compare(torch, dev, mt, record, storage, est, results, resident):
    """Step c: one file storage's payload, kernel sums and estimates
    against the resident run's, and kernels C and D against their plain
    versions at the file's streams. Adds to ``record``; returns the two
    kernels' errors against their plain versions."""
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    kind = record["storage"]
    full = [C4_N0, C4_N0 // 4, C4_N0 // 16]
    res_storage, res_est, res_results = resident
    with Phase(torch, "persisted %s: file against the resident run" % kind):
        for level_id in range(len(C4_LEVELS)):
            kept = res_storage.sample_pairs_level(
                mt.ChunkSpec(level_id=level_id))                  # [M, N, 1|2]
            start = 0
            for spec in storage.chunks(level_id=level_id):
                part = torch.from_numpy(storage.sample_pairs_level(spec)).to(
                    device=dev, dtype=kept.dtype)
                stop = start + part.shape[1]
                _require(torch.equal(part, kept[:, start:stop]), "persisted %s level "
                         "%d rows %d:%d differ from the resident run's"
                         % (kind, level_id, start, stop))
                start = stop
            _require(start == kept.shape[1] == full[level_id],
                     "persisted %s level %d holds %d rows" % (kind, level_id, start))
        mfn = est._moments_fn
        streams, res_streams = (e._packed_streams(mfn, [0]) for e in (est, res_est))
        identical = {}
        for name, launch, plain_fn, consts in (
                ("samples_mlmc", ck.samples_mlmc_cuda, ck.samples_mlmc_plain,
                 ck.transform_constants(mfn.domain)),
                ("samples_ext", cx.samples_ext_cuda, cx.samples_ext_plain,
                 ck.transform_constants(mfn.domain, f64=True))):
            got, want = (launch(st_, mfn.size, basis="legendre", consts=consts,
                                device=dev) for st_ in (streams, res_streams))
            s_abs = plain_fn(res_streams, mfn.size, basis="legendre", consts=consts,
                             absolute=True)
            _compare(torch, got, want, s_abs, "%s over the %s file against the "
                     "resident run" % (name, kind))
            identical[name] = all(torch.equal(a, b) for a, b in zip(got, want))
        generic_err = 0.0
        for got, want in zip(results["generic"], res_results["generic"]):
            # mean[0] is 1: relative to a scale of one
            generic_err = max(generic_err, float(np.max(np.abs(got - want))))
        _require(generic_err <= 1e-12, "persisted %s generic tier differs from the "
                 "resident run's by %.3g" % (kind, generic_err))
        tier_err = {tier: float(max(np.max(np.abs(g - w)) for g, w in
                                    zip(results[tier], res_results[tier])))
                    for tier in ("fast", "f64")}
        _require(max(tier_err.values()) <= 1e-12, "persisted %s kernel tiers differ "
                 "from the resident run's: %s" % (kind, tier_err))
        errs = _streams_vs_plain(torch, dev, est, "the persisted %s streams" % kind)
    print("persisted %s: every level's payload equals the resident run's bit for bit; "
          "n_valid of kernels C and D equal; sums bit-identical: %s; generic tier max "
          "|diff| %.3g (tol 1e-12), fast tier %.3g, f64 tier %.3g"
          % (kind, identical, generic_err, tier_err["fast"], tier_err["f64"]))
    storage.close()
    record.update({"sums_bit_identical": identical,
                   "generic_max_abs_diff": generic_err,
                   "fast_max_abs_diff": tier_err["fast"],
                   "f64_max_abs_diff": tier_err["f64"],
                   "kernel_vs_plain_max_abs_err": {"samples_mlmc": errs[0],
                                                   "samples_ext": errs[1]}})
    return errs


def persisted_path(torch, dev):
    """A run that outlives its process, at BASELINE config 4's size: card ->
    host -> file in two stages, file -> host -> card -> the three tiers,
    held against the same run kept on the card. The binary log always; the
    HDF5 file where ``h5py`` is installed. Returns the path's launch counts
    and the kernels' errors against their plain versions at its streams."""
    import shutil
    import tempfile

    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch import native
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    try:
        import h5py
        print("hdf5: h5py %s" % h5py.__version__)
    except ImportError:
        h5py = None
        print("hdf5: h5py not installed on this machine, not run")
    with Phase(torch, "sample-log library build (one g++ call) + load"):
        _require(native.available(), "the binary sample log's library did not "
                 "build:\n%s" % native.build_error())
    print("sample-log library: %s" % os.path.relpath(native.library_path(), HERE))

    torch.cuda.reset_peak_memory_stats(dev)
    directory = tempfile.mkdtemp(prefix="mlmc_persisted_")
    passes = [("binary log", lambda: mt.SampleStorageBin(
        os.path.join(directory, "binlog")), os.path.join(directory, "binlog"))]
    if h5py is not None:
        os.mkdir(os.path.join(directory, "hdf5"))
        passes.append(("hdf5", lambda: mt.SampleStorageHDF(
            os.path.join(directory, "hdf5", "run.hdf5")),
            os.path.join(directory, "hdf5")))
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    try:
        with Phase(torch, "persisted path") as whole:
            done = []
            for kind, make_storage, where in passes:
                before = {**ck.launch_counts(), **cx.launch_counts()}
                done.append(_persisted_run_and_estimate(torch, dev, mt, kind,
                                                        make_storage, where))
                after = {**ck.launch_counts(), **cx.launch_counts()}
                for name in ("samples_mlmc", "samples_ext"):
                    _require(after[name] > before[name], "kernel %s was not launched "
                             "by the persisted %s pass" % (name, kind))
        counts = {**ck.launch_counts(), **cx.launch_counts()}
        print("persisted path: %.2f s; kernel launches %s; peak device memory %.3f GB"
              % (whole.seconds, counts, torch.cuda.max_memory_allocated(dev) / 1e9))
        # what the files are held against: the same seed, levels and counts,
        # uninterrupted, kept on the card (launches from here on compare)
        with Phase(torch, "persisted: the resident run"):
            sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
            res_storage = mt.DeviceMemory(device=dev)
            sampler = mt.Sampler(res_storage, mt.DeviceBatchPool(
                seed=3, device_results=True, max_batch=1 << 18, device=dev),
                sim, C4_LEVELS)
            sampler.set_initial_n_samples([C4_N0, C4_N0 // 4, C4_N0 // 16])
            sampler.schedule_samples()
            sampler.ask_sampling_pool_for_samples()
            res_est, res_results, res_seconds = _persisted_estimates(
                torch, mt, res_storage, sim, dev)
            # the generic tier computes in its payload's type: hold the
            # files' f64 records against the resident f32 payload widened
            # (exactly) to f64, so that only the chunking differs
            wide = mt.DeviceMemory(device=dev)
            wide.save_global_data(result_format=sim.result_format(),
                                  level_parameters=C4_LEVELS)
            for level_id in range(len(C4_LEVELS)):
                payload, n = res_storage.raw_level_payload(level_id)
                wide.save_samples_bulk(level_id, mt.tags.TagRange(level_id, 0, n),
                                       payload[:n, 0].double(), payload[:n, 1].double())
            mfn = res_est._moments_fn
            wide_root = mt.make_root_quantity(wide, sim.result_format(), device=dev)
            res_results["generic"] = tuple(
                np.asarray(x, dtype=np.float64) for x in mt.Estimate(
                    wide_root["length"][1]["10"][0, 0], wide, mfn).estimate_moments(mfn))
            del wide, wide_root
        print("resident run (DeviceMemory): generic tier %.3f s, fast tier %.3f s, "
              "f64 tier %.3f s" % tuple(res_seconds[t] for t in ("generic", "fast", "f64")))
        errs = [_persisted_compare(torch, dev, mt, *state,
                                   (res_storage, res_est, res_results))
                for state in done]
    finally:
        shutil.rmtree(directory, ignore_errors=True)
    print(json.dumps({"path": "persisted", "levels": C4_LEVELS,
                      "seconds": whole.seconds, "resident_estimate_s": res_seconds,
                      "passes": [state[0] for state in done]}))
    return counts, {"samples_mlmc": max(e[0] for e in errs),
                    "samples_ext": max(e[1] for e in errs)}


# ------------------------------------------------------------------------ #
# the sharded path: the sample mesh (kernels A and C per shard)
# ------------------------------------------------------------------------ #
def _keyed_pair(torch, h):
    """A coupled hierarchy over two keyed normals per sample (the drivers'
    level contract): E[Y_l] = 2 + 0.5 h_l + 0.3 h_l^2, correction noise
    ~ h^0.75."""
    def fn(level, keys):
        zz = keys.normals(2).double()
        z, zc = zz[:, 0], zz[:, 1]

        def y(hl):
            return 2.0 + 0.5 * hl + 0.3 * hl * hl + 0.2 * z + 0.3 * hl ** 0.75 * zc
        fine = y(h[level])
        coarse = y(h[level - 1]) if level else 0.0 * z
        return fine, coarse, torch.ones_like(z, dtype=torch.bool)
    return fn


def _gauss_keyed_pair(torch):
    def fn(level, keys):
        xy = keys.normals(2).double()
        x, y = xy[:, 0], xy[:, 1]
        fine = x + 0.5 * 2.0 ** (-level) * y
        coarse = x + 0.5 * 2.0 ** (1 - level) * y if level else 0.0 * x
        return fine, coarse, torch.ones_like(x, dtype=torch.bool)
    return fn


def _same_decisions(one, shard, keys, what, rtol=1e-12, atol=1e-15):
    """Integer results equal, floating ones within atol + rtol * |one|."""
    for k in keys:
        a, b = np.asarray(one[k]), np.asarray(shard[k])
        if a.dtype.kind in "iub":
            _require(a.tolist() == b.tolist(), "%s %s: %s vs %s" % (what, k, a, b))
        else:
            _require(np.all(np.abs(a - b) <= atol + rtol * np.abs(a)),
                     "%s %s: max |difference| %.3g" % (what, k,
                                                       float(np.max(np.abs(a - b)))))


def _sharded_headline(torch, dev, mesh, one, s_abs, what):
    """The 1e8-sample headline over ``mesh``: kernel A once per shard, held
    against the one-device run (counts exact, sums within 1e-13*S_abs)."""
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.parallel import sharded_synth_pipeline

    step = sharded_synth_pipeline(mesh, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS,
                                  domain=DOMAIN)
    before = ck.synth_mlmc_cuda.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = step(SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = ck.synth_mlmc_cuda.launches - before
    _require(launches == mesh.n_local, "%s: kernel A launched %d times for %d "
             "shards" % (what, launches, mesh.n_local))
    stack = ck.SynthMomentResult(*(torch.stack([getattr(r, f) for r in res])
                                   for f in ck.SynthMomentResult._fields))
    _, rel = _compare(torch, stack, one, s_abs, what, rtol=1e-13)
    print("%s: %d shards, kernel A launched %d times, %.4f s (host clock, first "
          "call, incl. sync); n_valid equal to the one-device run, max |sharded - "
          "one device| / S_abs %.3g (tol 1e-13)"
          % (what, mesh.n_devices, launches, seconds, rel))
    return stack, seconds


def sharded_path(torch, dev):
    """The sample mesh on the card: the headline over two shards and under
    a one-rank NCCL group, the noise pipeline over two shards (kernel C),
    config 5's Darcy pool and the synthetic pool over the mesh, the Poisson
    bootstrap over the mesh at config 2's stored run, FusedMLMC and the
    four drivers over the mesh; each held against its one-device run.
    Returns the path's launch counts and the kernels' errors against their
    plain versions at its shapes."""
    import shutil
    import tempfile

    import torch.distributed as dist

    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
    from mlmc_tpu_torch.parallel import (
        SampleMesh, sharded_mlmc_step, sharded_synth_pipeline,
        sharded_synth_pipeline_from_noise)
    from mlmc_tpu_torch.unbiased import synth_unbiased_level_fn

    fine, coarse, has_coarse = ck._ladder(LEVEL_STEPS)
    out = {"path": "sharded", "shards": 2}
    # ---- one-device references (outside the counted run) --------------- #
    with Phase(torch, "sharded: one-device references and plain versions"):
        one = ck.synth_mlmc_pipeline(SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS,
                                     domain=DOMAIN, device=dev)
        one = ck.SynthMomentResult(*(torch.stack([getattr(r, f) for r in one])
                                     for f in ck.SynthMomentResult._fields))
        plain_a, s_abs_a = (ck.synth_mlmc_plain(
            None, SEED, N_PER_LEVEL, fine, coarse, has_coarse, N_MOMENTS,
            domain=DOMAIN, device=dev, absolute=a) for a in (False, True))
        rng = np.random.default_rng(SEED + 7)
        noise = [torch.from_numpy(rng.normal(size=N_CHECK).astype(np.float32)).to(dev)
                 for _ in LEVEL_STEPS]
        one_mesh = SampleMesh([dev], group=False)
        one_c = sharded_synth_pipeline_from_noise(one_mesh, N_MOMENTS, LEVEL_STEPS,
                                                  domain=DOMAIN)(*noise)
        fine_l, coarse_l = [], []
        for lvl, x in enumerate(noise):
            qoi_f, qoi_c = ck.synth_qoi(x, LEVEL_STEPS[lvl],
                                        LEVEL_STEPS[lvl - 1] if lvl else 0.0)
            fine_l.append(qoi_f)
            coarse_l.append(qoi_c if lvl else None)
        streams = ck.pack_streams(fine_l, coarse_l, has_coarse)
        plain_c, s_abs_c = (ck.samples_mlmc_plain(
            streams, N_MOMENTS, basis="legendre",
            consts=ck.transform_constants(DOMAIN), absolute=a) for a in (False, True))
        stack = lambda res: ck.SynthMomentResult(*(
            torch.stack([getattr(r, f) for r in res]) for f in ck.SynthMomentResult._fields))
        one_c = stack(one_c)
        _compare(torch, one_c, plain_c, s_abs_c, "kernel C, one device, vs plain")

    ck.reset_launch_counts()
    cx.reset_launch_counts()
    mesh2 = SampleMesh([dev, dev], group=False)
    with Phase(torch, "sharded path") as whole:
        # ---- a. the headline over two shards, then under NCCL ---------- #
        res2, out["headline_2_shards_s"] = _sharded_headline(
            torch, dev, mesh2, one, s_abs_a, "sharded headline over [dev, dev]")
        tmp = tempfile.mkdtemp(prefix="mlmc_nccl_")
        try:
            torch.cuda.set_device(dev)
            dist.init_process_group("nccl", store=dist.FileStore(
                os.path.join(tmp, "store"), 1), rank=0, world_size=1)
            mesh_nccl = SampleMesh([dev])
            _require(mesh_nccl.group is not None and mesh_nccl.backend == "nccl"
                     and dist.get_backend(mesh_nccl.group) == "nccl",
                     "the one-rank mesh does not reduce over NCCL")
            res1, out["headline_nccl_s"] = _sharded_headline(
                torch, dev, mesh_nccl, one, s_abs_a,
                "sharded headline, one rank of an NCCL group")
            per_shard = [ck._per_level(res1)]
            reduce_s = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mesh_nccl.reduce(per_shard)
                torch.cuda.synchronize()
                reduce_s.append(time.perf_counter() - t0)
            n_values = 5 * (2 * N_MOMENTS + 2 * N_MOMENTS ** 2)
            buf = torch.zeros(n_values, dtype=torch.float64, device=dev)
            allreduce_ms = _time_ms(torch, lambda: dist.all_reduce(buf), reps=20)
            out.update(nccl_reduce_ms=float(np.median(reduce_s)) * 1e3,
                       nccl_all_reduce_ms=allreduce_ms, all_reduce_values=n_values)
            print("one-rank NCCL: mesh.reduce of the headline's accumulators %.3f ms "
                  "(host clock, median of 5); all_reduce of %d f64 values %.4f ms "
                  "(CUDA events, median of 20)"
                  % (out["nccl_reduce_ms"], n_values, allreduce_ms))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
            shutil.rmtree(tmp, ignore_errors=True)

        # ---- b. the noise pipeline over two shards (kernel C) ---------- #
        before = ck.samples_mlmc_cuda.launches
        t0 = time.perf_counter()
        res_c = stack(sharded_synth_pipeline_from_noise(
            mesh2, N_MOMENTS, LEVEL_STEPS, domain=DOMAIN)(*noise))
        torch.cuda.synchronize()
        out["noise_2_shards_s"] = time.perf_counter() - t0
        launches_c = ck.samples_mlmc_cuda.launches - before
        _require(launches_c == 2, "kernel C launched %d times for 2 shards" % launches_c)
        _, rel_c1 = _compare(torch, res_c, one_c, s_abs_c,
                             "sharded noise pipeline vs one kernel C launch", rtol=1e-13)
        err_c, rel_c = _compare(torch, res_c, plain_c, s_abs_c,
                                "sharded noise pipeline vs plain")
        print("sharded noise pipeline: 2 shards x %d normals per level, kernel C "
              "launched %d times; vs one unsharded launch: n_valid equal, max / S_abs "
              "%.3g (tol 1e-13); vs plain %.3g (tol 1e-12)"
              % (N_CHECK // 2, launches_c, rel_c1, rel_c))

        # ---- c. the pools over the mesh: config 5's Darcy, synthetic --- #
        def pool_run(sim, levels, counts, sharding, seed):
            storage = mt.DeviceMemory(device=dev)
            pool = mt.DeviceBatchPool(seed=seed, sharding=sharding, device_results=True,
                                      max_batch=1 << 20, device=dev)
            sampler = mt.Sampler(storage, pool, sim, levels)
            sampler.set_initial_n_samples(counts)
            sampler.schedule_samples()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sampler.ask_sampling_pool_for_samples()
            torch.cuda.synchronize()
            return (storage.sample_pairs(), time.perf_counter() - t0,
                    (pool.n_dispatches, pool.n_blocking_fetches))

        darcy = mt.DiffusionSimulation(dict(sigma=1.0, corr_length=0.3,
                                            field_method="circulant"))
        synth = mt.SynthSimulation(dict(distr="norm", complexity=2))
        pools = {}
        for name, sim, levels, counts, atol in (
                ("darcy", darcy, [[1 / 16], [1 / 64]], SHARDED_DARCY_N, 1e-10),
                ("synthetic", synth, [[0.1], [0.01]], SHARDED_SYNTH_N, 0.0)):
            ref, t_one, c_one = pool_run(sim, levels, counts, None, SEED)
            got, t_mesh, c_mesh = pool_run(sim, levels, counts, mesh2, SEED)
            dev_max = 0.0
            for a, b in zip(ref, got):
                _require(a.shape == b.shape, "%s pool payload shapes" % name)
                diff = (a.double() - b.double()).abs()
                same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
                dev_max = max(dev_max, float(torch.nan_to_num(diff).max()))
                _require(same_nan and dev_max <= atol, "%s pool over the mesh: max "
                         "|payload diff| %.3g > %g" % (name, dev_max, atol))
            pools[name] = dict(n=counts, one_device_s=t_one, mesh_s=t_mesh,
                               dispatches_fetches_one=c_one, dispatches_fetches_mesh=c_mesh,
                               max_abs_diff=dev_max)
            print("%s pool, %s samples: one device %.3f s (dispatches, blocking fetches "
                  "%s), over [dev, dev] %.3f s (%s); max |payload diff| %.3g (tol %g)"
                  % (name, counts, t_one, c_one, t_mesh, c_mesh, dev_max, atol))
        out["pools"] = pools

        # ---- d. the Poisson bootstrap over the mesh (config 2) --------- #
        shoot = mt.ShootingSimulation1D(dict(
            start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
            area_borders=(-100.0, 200.0, -300.0, 400.0), max_time=10.0,
            complexity=20.0, n_modes=256,
            fields_params=dict(model="gauss", corr_length=1.0, sigma=0.5, log=False)))
        storage = mt.DeviceMemory(device=dev)
        sampler = mt.Sampler(storage, mt.DeviceBatchPool(
            seed=9, device_results=True, device=dev), shoot, [[0.1], [0.02]])
        sampler.set_initial_n_samples(C2_N)
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        q = mt.make_root_quantity(storage, shoot.result_format())["target"][10]["0"][0]
        est = mt.Estimate(q, storage, mt.Legendre(5, mt.estimate_domain(q, storage, 0.01)))
        boot = {}
        for name, mesh in (("one_device", None), ("mesh", mesh2)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            est.est_bootstrap_fast(n_subsamples=100, sample_vector=[n // 2 for n in C2_N],
                                   seed=SEED, replace="poisson", mesh=mesh)
            torch.cuda.synchronize()
            boot[name] = (time.perf_counter() - t0,
                          {k: getattr(est, k).copy() for k in (
                              "mean_bs_mean", "var_bs_mean", "mean_bs_l_vars",
                              "var_bs_l_vars")})
        boot_dev = max(float(np.max(np.abs(boot["mesh"][1][k] - v)
                                    / np.maximum(np.abs(v), 1e-300)))
                       for k, v in boot["one_device"][1].items())
        _require(boot_dev <= 1e-10, "Poisson bootstrap over the mesh: relative "
                 "deviation %.3g > 1e-10" % boot_dev)
        out.update(bootstrap_one_device_s=boot["one_device"][0],
                   bootstrap_mesh_s=boot["mesh"][0], bootstrap_max_rel_dev=boot_dev)
        print("Poisson bootstrap (config 2, B=100): one device %.3f s, over [dev, dev] "
              "%.3f s (host clock); max relative deviation %.3g (tol 1e-10)"
              % (boot["one_device"][0], boot["mesh"][0], boot_dev))

        # ---- e. FusedMLMC, the fused step and the four drivers --------- #
        t0 = time.perf_counter()
        fns = [mt.SynthSimulation.scalar_batch_fn(h, c, mt.Norm())
               for h, c in zip(fine, coarse)]
        mfn = mt.Legendre(7, DOMAIN)
        fused = []
        for mesh in (None, mesh2):
            drv = mt.FusedMLMC(fns, mfn, seed=SEED, chunk_size=1 << 16, mesh=mesh,
                               device=dev)
            for lvl, n in enumerate((400_000, 150_000, 50_000, 20_000, 8_000)):
                drv._run_level(lvl, n)
                drv._run_level(lvl, n // 3)
            fused.append(drv.estimates())
        # 1e-13 * S_abs per sample: |phi| <= 1 on the domain, so S_abs / n <= 4
        _same_decisions(*fused, ("n_samples", "mean", "cov"), "FusedMLMC over the mesh",
                        rtol=0.0, atol=4e-13)
        step_fns = fns[:2]
        steps = [mt.fused_mlmc_moments(step_fns, mfn, 3, [4096, 1024], chunk_size=256,
                                       device=dev),
                 sharded_mlmc_step(mesh2, step_fns, mfn, [4096, 1024], chunk_size=256)(3)]
        _same_decisions(*(accumulators_to_estimates(s) for s in steps),
                        ("n_samples", "mean", "cov"), "sharded_mlmc_step",
                        rtol=0.0, atol=4e-13)
        out["fused_s"] = time.perf_counter() - t0

        drivers = {}
        h3 = [0.5, 0.25, 0.125]
        steps12 = [0.5 ** k for k in range(12)]
        runs = {
            "cdf": lambda mesh: _cdf_run(mt, _gauss_keyed_pair(torch), mesh, dev),
            "cmlmc": lambda mesh: mt.cmlmc(
                _keyed_pair(torch, steps12), steps12, eps=SHARDED_CMLMC_EPS, seed=6, n_stages=2,
                n_pilot=1 << 10, chunk_size=1 << 10, cost_fn=lambda lv: 2.0 ** lv,
                mesh=mesh, device=dev),
            "ml2r": lambda mesh: mt.ml2r(
                _keyed_pair(torch, h3), h3, target_var=SHARDED_ML2R_TARGET, alpha=1.0, seed=4,
                chunk_size=1 << 10, n_pilot=1 << 11, cost_fn=lambda lv: 2.0 ** lv,
                mesh=mesh, device=dev),
            "unbiased": lambda mesh: _unbiased_run(mt, synth_unbiased_level_fn, mesh, dev),
        }
        keys = {"cdf": ("n_samples", "cdf", "pdf"),
                "cmlmc": ("n_levels", "n_per_level", "mean", "level_means"),
                "ml2r": ("n_per_level", "rounds", "mean", "mean_mlmc"),
                "unbiased": ("levels", "n_samples", "mean", "var_per_draw")}
        for name, run in runs.items():
            t1 = time.perf_counter()
            a = run(None)
            t2 = time.perf_counter()
            b = run(mesh2)
            t3 = time.perf_counter()
            _same_decisions(a, b, keys[name], "%s over the mesh" % name)
            drivers[name] = dict(one_device_s=t2 - t1, mesh_s=t3 - t2)
        out["drivers"] = drivers
        print("FusedMLMC and sharded_mlmc_step over [dev, dev]: counts equal, estimates "
              "within 1e-12 relative (%.2f s); drivers over the mesh against one device, "
              "decisions equal and means within 1e-12 relative: %s"
              % (out["fused_s"], {k: {kk: round(vv, 3) for kk, vv in v.items()}
                                  for k, v in drivers.items()}))
    counts = {**ck.launch_counts(), **cx.launch_counts()}
    out.update(seconds=whole.seconds, launches=counts)
    _require(counts["synth_mlmc"] == 3 and counts["samples_mlmc"] == 2,
             "sharded path launches %s: kernel A must run once per shard (2 + 1), "
             "kernel C once per shard (2)" % counts)
    # ---- warm times, after the counted run (CUDA events, median of 5) -- #
    step2 = sharded_synth_pipeline(mesh2, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS,
                                   domain=DOMAIN)
    out.update(
        headline_one_device_ms=_time_ms(torch, lambda: ck.synth_mlmc_pipeline(
            SEED, N_MOMENTS, N_PER_LEVEL, LEVEL_STEPS, domain=DOMAIN, device=dev)),
        headline_2_shards_ms=_time_ms(torch, lambda: step2(SEED)),
        noise_one_device_ms=_time_ms(torch, lambda: sharded_synth_pipeline_from_noise(
            one_mesh, N_MOMENTS, LEVEL_STEPS, domain=DOMAIN)(*noise)),
        noise_2_shards_ms=_time_ms(torch, lambda: sharded_synth_pipeline_from_noise(
            mesh2, N_MOMENTS, LEVEL_STEPS, domain=DOMAIN)(*noise)))
    print("warm (CUDA events, median of 5): the headline on one device %.3f ms, over "
          "[dev, dev] %.3f ms; the noise pipeline (5 x 2^20 normals) on one device "
          "%.3f ms, over [dev, dev] %.3f ms"
          % (out["headline_one_device_ms"], out["headline_2_shards_ms"],
             out["noise_one_device_ms"], out["noise_2_shards_ms"]))
    err_a = 0.0
    for name in ("sums", "sums2", "cov_fine", "cov_coarse"):
        diff = (getattr(res2, name) - getattr(plain_a, name)).abs()
        err_a = max(err_a, float(diff.max()))
        _require(bool(torch.all(diff <= 1e-12 * getattr(s_abs_a, name).clamp(min=1.0))),
                 "sharded headline %s vs plain > 1e-12*S_abs" % name)
    print("sharded path: %.2f s; kernel launches %s" % (whole.seconds, counts))
    print(json.dumps(out))
    return counts, {"synth_mlmc": err_a, "samples_mlmc": err_c}


# ------------------------------------------------------------------------ #
# the 3-D and fractured Darcy path (kernels C and D), ProcessBase, FlowSim
# ------------------------------------------------------------------------ #
D3_LEVELS = [[1 / 8], [1 / 16], [1 / 32]]
D3_N0 = [512, 128, 32]
D3_TARGET_VAR = 2e-5
D3_MAX_ROUNDS = 8

_MOCK_GMSH = r"""#!/usr/bin/env python3
# Mock gmsh: writes a canned msh2 square; finer clscale => more triangles.
import sys
args = sys.argv[1:]
out = args[args.index("-o") + 1]
cl = float(args[args.index("-clscale") + 1])
head = ("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$PhysicalNames\n2\n"
        "2 1 \"ground\"\n1 2 \".bc_outflow\"\n$EndPhysicalNames\n")
if cl <= 0.3:  # fine: 4 triangles around the center node
    body = ("$Nodes\n5\n1 0 0 0\n2 1 0 0\n3 1 1 0\n4 0 1 0\n5 0.5 0.5 0\n$EndNodes\n"
            "$Elements\n5\n1 2 2 1 1 1 2 5\n2 2 2 1 1 2 3 5\n3 2 2 1 1 3 4 5\n"
            "4 2 2 1 1 4 1 5\n5 1 2 2 2 2 3\n$EndElements\n")
else:  # coarse: 2 triangles
    body = ("$Nodes\n4\n1 0 0 0\n2 1 0 0\n3 1 1 0\n4 0 1 0\n$EndNodes\n"
            "$Elements\n3\n1 2 2 1 1 1 2 3\n2 2 2 1 1 1 3 4\n3 1 2 2 2 2 3\n$EndElements\n")
open(out, "w").write(head + body)
"""

_MOCK_FLOW123D = r"""#!/usr/bin/env python3
# Mock flow123d: flux := -mean(conductivity) of the fields file; fails if
# the rendered YAML still contains placeholders.
import os, sys
args = sys.argv[1:]
indir = args[args.index("-i") + 1]
outdir = args[args.index("-o") + 1]
text = open(args[args.index("-s") + 1]).read()
assert "<mesh_file>" not in text and "<conductivity>" not in text, text
lines = iter(open(os.path.join(indir, "fields_sample.msh")).read().split("\n"))
for line in lines:
    if line.strip() == "$ElementData":
        break
strings = [next(lines) for _ in range(int(next(lines)))]
reals = [next(lines) for _ in range(int(next(lines)))]
ints = [int(next(lines)) for _ in range(int(next(lines)))]
values = [float(next(lines).split()[1]) for _ in range(ints[2])]
with open(os.path.join(outdir, "water_balance.yaml"), "w") as f:
    f.write("data:\n- {time: 0, region: .bc_outflow, data: [%r, 0.0]}\n"
            % (-sum(values) / len(values)))
"""


def _batch_figures(torch, dev, label, cls, cfg, B):
    """Time a batch of B (CUDA events), its CG iterations, device events and
    idle share (torch.profiler) and peak memory; returns (figures, fine,
    coarse, draws) of one more batch, drawn from the keyed stream."""
    from mlmc_tpu_torch.tool.profile_simulations import device_breakdown

    gen = torch.Generator(device=dev).manual_seed(SEED)
    with Phase(torch, "%s: first call and 3 timed" % label):
        ms = _time_ms(torch, lambda: cls.calculate_batch(cfg, gen, B), reps=3)
    with Phase(torch, "%s: one call under torch.profiler" % label):
        prof = device_breakdown(label, lambda: cls.calculate_batch(cfg, gen, B), 1, top=4)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    # the checked batch: samples (SEED, level 1, index 0 .. B-1), the same
    # in every run whatever the timing calls drew
    idx = torch.arange(B, device=dev)
    draws = cls._keyed_draws(cfg, SEED, 1, idx, torch.zeros_like(idx))
    fine, coarse, it_f, it_c = cls._calculate(cfg, **draws)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated(dev) - before) / 1e9
    figures = dict(batch=B, batch_ms=ms, samples_per_s=B / ms * 1e3,
                   cg_iterations_fine_max=int(it_f.max()),
                   cg_iterations_fine_mean=float(it_f.double().mean()),
                   cg_iterations_coarse_max=int(it_c.max()),
                   cg_iterations_coarse_mean=float(it_c.double().mean()),
                   device_events_per_batch=prof["events_per_call"],
                   device_idle_share=prof["idle_share"], peak_memory_gb=peak)
    print("%s: %d coupled samples in %.3f ms (CUDA events, median of 3): %.4g "
          "samples/s; CG iterations max %d mean %.2f (fine), max %d mean %.2f (coarse); "
          "%.0f device events per batch, device idle %.1f%%; peak device memory %.3f GB"
          % (label, B, ms, figures["samples_per_s"], figures["cg_iterations_fine_max"],
             figures["cg_iterations_fine_mean"], figures["cg_iterations_coarse_max"],
             figures["cg_iterations_coarse_mean"], figures["device_events_per_batch"],
             100 * figures["device_idle_share"], peak))
    return figures, fine[:, 0].double(), coarse[:, 0].double(), draws


def _darcy3d_batches(torch, dev, mt):
    """bench_extra.py's 3-D Darcy, 3-D fractured and 2-D fractured batches."""
    from mlmc_tpu_torch.random import frac_geom

    out = {}
    Sim = mt.DiffusionSimulation3D
    cfg = Sim(dict(sigma=1.0, corr_length=0.3)).level_instance([1 / 32], [1 / 16]).config_dict
    fig, fine, coarse, draws = _batch_figures(
        torch, dev, "3-D Darcy batch (32^3 + 16^3, spectral CG)", Sim, cfg, 256)
    _require(bool(torch.isfinite(fine).all() and torch.isfinite(coarse).all()),
             "3-D Darcy batch: non-finite fluxes")
    # the homogeneous limit: K = k0 gives flux k0
    K = torch.full((4, 32, 32, 32), 2.5, device=dev)
    p, _ = Sim._solve_pressure(cfg, K)
    hom = float(Sim._flux(K, p).double().sub(2.5).abs().max())
    _require(hom < 2.5e-4, "3-D homogeneous limit: |flux - k0| = %.3g" % hom)
    # batch rows against the same samples solved alone
    row_dev = 0.0
    for b in (0, 17, 255):
        one = Sim._calculate(cfg, phases=draws["phases"][b:b + 1])
        for got, want in ((one[0][0, 0], fine[b]), (one[1][0, 0], coarse[b])):
            row_dev = max(row_dev, abs(float(got) - float(want)) / abs(float(want)))
    _require(row_dev <= 1e-5, "3-D batch rows vs per-sample solves: %.3g > 1e-5" % row_dev)
    var_f, var_d = float(fine.var()), float((fine - coarse).var())
    _require(var_d < 2e-3 * var_f, "3-D coupling: Var(fine - coarse) %.3g >= 2e-3 x "
             "Var(fine) %.3g" % (var_d, var_f))
    fig.update(homogeneous_abs_err=hom, rows_vs_alone_max_rel=row_dev,
               var_fine=var_f, var_fine_minus_coarse=var_d, mean_flux=float(fine.mean()))
    print("3-D Darcy checks: homogeneous |flux - k0| %.3g (tol 2.5e-4); rows 0, 17, 255 "
          "against per-sample solves: max relative %.3g (tol 1e-5); Var(fine - coarse) / "
          "Var(fine) = %.3g (tol 2e-3); mean flux %.4f"
          % (hom, row_dev, var_d / var_f, fig["mean_flux"]))
    out["darcy3d_batch"] = fig

    F3 = frac_geom.FracturedDiffusionSimulation3D
    cfg = F3(dict(sigma=1.0, corr_length=0.3, n_fractures=24, frac_contrast=1e3)
             ).level_instance([1 / 32], [1 / 16]).config_dict
    fig, fine, coarse, _ = _batch_figures(
        torch, dev, "3-D fractured batch (32^3 + 16^3, 24 discs, contrast 1e3, MG-CG)",
        F3, cfg, 64)
    var_f, var_c = float(fine.var()), float(coarse.var())
    var_d = float((fine - coarse).var())
    _require(bool(torch.isfinite(fine).all() and (fine > 0.5).all()),
             "3-D fractured fluxes: min %.4g (must be finite and > 0.5)" % float(fine.min()))
    # the coupling: one network on both grids makes fine and coarse
    # positively correlated, Var(fine - coarse) < Var(fine) + Var(coarse)
    # (independent draws give equality). Var(fine - coarse) < Var(fine)
    # does not hold here: a coarse fracture is a coarse cell thick and
    # conducts twice a fine one (profile_simulations measures the ratio)
    _require(bool(torch.isfinite(coarse).all()) and var_d < var_f + var_c,
             "3-D fractured coupling: Var(fine - coarse) %.3g >= Var(fine) + Var(coarse) "
             "%.3g" % (var_d, var_f + var_c))
    fig.update(var_fine=var_f, var_coarse=var_c, var_fine_minus_coarse=var_d,
               min_flux=float(fine.min()), mean_flux=float(fine.mean()),
               mean_flux_coarse=float(coarse.mean()))
    print("3-D fractured checks: fluxes finite, min %.4f (> 0.5); Var(fine - coarse) %.4g < "
          "Var(fine) + Var(coarse) %.4g; Var(fine - coarse) / Var(fine) = %.3g; mean flux "
          "%.4f fine, %.4f coarse" % (fig["min_flux"], var_d, var_f + var_c, var_d / var_f,
                                      fig["mean_flux"], fig["mean_flux_coarse"]))
    out["fractured3d_batch"] = fig

    F2 = frac_geom.FracturedDiffusionSimulation
    cfg = F2(dict(sigma=1.0, corr_length=0.3, field_method="circulant", n_fractures=24,
                  frac_contrast=1e3)).level_instance([1 / 64], [1 / 16]).config_dict
    fig, fine, coarse, _ = _batch_figures(
        torch, dev, "2-D fractured batch (64^2 + 16^2, circulant, 24 fractures, MG-CG)",
        F2, cfg, 1024)
    var_f, var_d = float(fine.var()), float((fine - coarse).var())
    _require(bool(torch.isfinite(fine).all() and (fine > 0).all()
                  and torch.isfinite(coarse).all()), "2-D fractured fluxes not finite > 0")
    _require(var_d < var_f, "2-D fractured coupling: Var(fine - coarse) %.3g >= Var(fine) "
             "%.3g" % (var_d, var_f))
    fig.update(var_fine=var_f, var_fine_minus_coarse=var_d, mean_flux=float(fine.mean()))
    print("2-D fractured checks: fluxes finite and > 0; Var(fine - coarse) %.4g < Var(fine) "
          "%.4g" % (var_d, var_f))
    out["fractured2d_batch"] = fig
    return out


def _darcy3d_adaptive(torch, dev, mt):
    """examples/darcy3d_workflow.py's adaptive study: 8^3 / 16^3 / 32^3 to
    target_var=2e-5, kernel C each round, then the maxent density."""
    import mlmc_tpu_torch.quantity.quantity_estimate as qe

    sim = mt.DiffusionSimulation3D(dict(sigma=1.0, corr_length=0.3))
    t_start = time.perf_counter()
    storage = mt.DeviceMemory(device=dev)
    pool = mt.DeviceBatchPool(seed=11, device_results=True, max_batch=1 << 13, device=dev)
    sampler = mt.Sampler(storage, pool, sim, D3_LEVELS)
    sampler.set_initial_n_samples(D3_N0)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    q = mt.make_root_quantity(storage, sim.result_format())["flux"][0]["outflow"][0]
    mfn = mt.Legendre(10, (0.05, 6.0))
    est = mt.Estimate(q, storage, mfn)
    rounds, reached = 0, False
    while rounds < D3_MAX_ROUNDS:
        raw, _ns = est.estimate_diff_vars_fast()               # one kernel C launch
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw)
        n_est = mt.estimate_n_samples_for_target_variance(
            D3_TARGET_VAR, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            reached = True
            break
        rounds += 1
    _require(reached, "3-D adaptive run: the allocation for %.0e was not reached in %d "
             "rounds" % (D3_TARGET_VAR, D3_MAX_ROUNDS))
    m = qe.estimate_mean(q)
    rates = mt.estimate_convergence_rates(m.l_means, m.l_vars, storage.get_level_parameters(),
                                          storage.get_n_ops())
    k_eff = float(np.ravel(m.mean)[0])
    distr, _info, result, _mobj = est.construct_density_fast()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    sampler.ask_sampling_pool_for_samples()
    raw, ns = est.estimate_diff_vars_fast()
    var = float(np.max((raw[:, 1:] / ns[:, None]).sum(axis=0)))
    ext_mean, _ = est.estimate_moments_extended()               # kernel D
    fast_mean, _ = est.estimate_moments_fast()
    generic = qe.estimate_mean(qe.moments(q, mfn))
    n_generic = [int(v) for v in np.ravel(generic.n_samples)]
    _require(var <= DARCY_TARGET_SLACK * D3_TARGET_VAR,
             "3-D adaptive run: max var %.4g after the allocation for %.0e (slack %.2f)"
             % (var, D3_TARGET_VAR, DARCY_TARGET_SLACK))
    _require(np.exp(-0.5) < k_eff < np.exp(0.5) and abs(k_eff - np.exp(1 / 6)) < 0.12,
             "3-D E[K_eff] %.5f: outside the Wiener bounds or 0.12 from exp(1/6)" % k_eff)
    _require(ext_mean[0] == 1.0 and fast_mean[0] == 1.0, "3-D run: mean[0] != 1")
    _require([int(v) for v in ns] == n_generic, "3-D run: fast-tier valid counts %s vs "
             "the generic tier's %s" % (list(ns), n_generic))
    _require(bool(result.success), "3-D run: the maxent solve did not converge")
    out = dict(wall_s=wall, rounds=rounds, n_per_level=[int(v) for v in storage.get_n_collected()],
               target_var=D3_TARGET_VAR, max_var=var, k_eff=k_eff, matheron=float(np.exp(1 / 6)),
               alpha=rates["alpha"], beta=rates["beta"], gamma=rates.get("gamma"),
               maxent_converged=bool(result.success), dispatches=int(pool.n_dispatches))
    print("3-D adaptive run: the allocation for target var %.0e reached after %d rounds in "
          "%.2f s (host clock, with the density); n per level %s; max var over the moments "
          "%.4g (slack 1.1); E[K_eff] %.5f (Matheron exp(1/6) = %.5f, tol 0.12); alpha %.3f, "
          "beta %.3f; fast-tier valid counts equal the generic tier's; maxent converged"
          % (D3_TARGET_VAR, rounds, wall, out["n_per_level"], var, k_eff, np.exp(1 / 6),
             rates["alpha"], rates["beta"]))
    return out, est


def _darcy3d_process_base(torch, dev, mt):
    """ProcessBase over DiffusionSimulation3D on the card: run --clean,
    process, renew; SampleStorageBin in the work dir where h5py is absent."""
    import shutil
    import tempfile

    import mlmc_tpu_torch.quantity.quantity_estimate as qe
    from mlmc_tpu_torch.tool.process_base import ProcessBase

    try:
        import h5py  # noqa: F401
        hdf5 = True
    except ImportError:
        hdf5 = False

    class Darcy3DProcess(ProcessBase):
        def __init__(self, argv):
            self.step_range = (1 / 8, 1 / 32)
            self.n_levels = 3
            self.n_moments = 10
            self.device = dev
            self.storage = None
            super().__init__(argv)
            if self.storage is not None and hasattr(self.storage, "close"):
                self.storage.close()

        def create_simulation(self):
            return mt.DiffusionSimulation3D(dict(sigma=1.0, corr_length=0.3))

        def initial_n_samples(self):
            return [256, 64, 16]

        def target_var(self):
            return 1e-3

        def setup_config(self, n_levels, clean):
            if hdf5:
                sampler, sim = super().setup_config(n_levels, clean)
            else:
                log_dir = os.path.join(self.work_dir, "mlmc_%d.log" % n_levels)
                if clean:
                    shutil.rmtree(log_dir, ignore_errors=True)
                sim = self.create_simulation()
                sampler = mt.Sampler(
                    sample_storage=mt.SampleStorageBin(log_dir),
                    sampling_pool=mt.DeviceBatchPool(device=self.device),
                    sim_factory=sim, level_parameters=mt.determine_level_parameters(
                        n_levels, self.step_range))
            self.storage = sampler.sample_storage
            return sampler, sim

        def process(self):
            self.result = super().process()
            return self.result

    work = tempfile.mkdtemp(prefix="mlmc_process_base_")
    try:
        t0 = time.perf_counter()
        Darcy3DProcess(["run", work, "--clean"])
        t_run = time.perf_counter() - t0
        proc = Darcy3DProcess(["process", work])
        means, variances = proc.result
        t1 = time.perf_counter()
        Darcy3DProcess(["renew", work])
        t_renew = time.perf_counter() - t1
        # an Estimate built over the reopened storage gives process's moments
        again = Darcy3DProcess.__new__(Darcy3DProcess)
        again.__dict__.update(step_range=(1 / 8, 1 / 32), n_levels=3, n_moments=10,
                              device=dev, work_dir=work, debug=False, clean=False)
        sampler, sim = again.setup_config(3, False)
        storage = sampler.sample_storage
        q = again.scalar_quantity(again.get_quantity(storage, sim))
        mfn = again.create_moments_fn(q, storage)
        est = mt.Estimate(q, storage, mfn)
        e_means, e_vars = est.estimate_moments(mfn)
        n_coll = [int(v) for v in storage.get_n_collected()]
        _require(np.array_equal(np.asarray(e_means), np.asarray(means))
                 and np.array_equal(np.asarray(e_vars), np.asarray(variances)),
                 "ProcessBase.process's moments differ from an Estimate over the reopened "
                 "storage")
        _require(np.asarray(means)[0] == 1.0, "ProcessBase means[0] != 1")
        rates, extrap = again.analyze_convergence_rates(est)
        _require(all(np.isfinite(rates[k]) for k in ("alpha", "beta")) and np.isfinite(extrap),
                 "ProcessBase convergence rates not finite: %s" % rates)
        try:
            import matplotlib  # noqa: F401
            plots = True
        except ImportError:
            plots = False
        if plots:
            again.analyze_regression_of_variance(est, sampler, out_file=os.path.join(work, "r"))
            again.analyze_error_of_level_variances(est, sampler,
                                                   out_file=os.path.join(work, "l"))
            again.analyze_pdf_approx(est, out_file=os.path.join(work, "pdf"), tol=1e-6)
            _require(all(os.path.exists(os.path.join(work, f + ".pdf"))
                         for f in ("r", "l", "pdf")), "ProcessBase plots not written")
        if hasattr(storage, "close"):
            storage.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = dict(storage="hdf5" if hdf5 else "binary log", run_s=t_run, renew_s=t_renew,
               n_per_level=n_coll, alpha=rates["alpha"], beta=rates["beta"],
               matplotlib=plots)
    print("ProcessBase over DiffusionSimulation3D (%s storage): run --clean %.2f s, "
          "process, renew %.2f s; n per level %s; process's moments equal an Estimate over "
          "the reopened storage; alpha %.3f, beta %.3f; matplotlib %s, plot recipes %s"
          % (out["storage"], t_run, t_renew, n_coll, rates["alpha"], rates["beta"],
             "imports" if plots else "absent", "ran" if plots else "not run"))
    return out


def _flow_sim_mock(torch, dev, mt):
    """FlowSim with mock gmsh and flow123d: 2 levels, 4 + 2 samples through
    OneProcessPool on the card; the native gmsh parser must parse."""
    import shutil
    import tempfile

    from mlmc_tpu_torch import native

    _require(native.gmsh_available(), "the native gmsh parser did not build:\n%s"
             % native.gmsh_build_error())
    tmp = tempfile.mkdtemp(prefix="mlmc_flow_sim_")
    cwd = os.getcwd()            # a workspace sample changes directory
    try:
        paths = {}
        for name, text in (("gmsh", _MOCK_GMSH), ("flow123d", _MOCK_FLOW123D)):
            paths[name] = os.path.join(tmp, "mock_" + name)
            with open(paths[name], "w") as f:
                f.write(text)
            os.chmod(paths[name], 0o755)
        with open(os.path.join(tmp, "square.geo"), "w") as f:
            f.write("// geometry consumed by the mock\n")
        with open(os.path.join(tmp, "flow_input.yaml.tmpl"), "w") as f:
            f.write("mesh: <mesh_file>\ndt: <timestep_h1>\ncond: <conductivity>\n")
        before = dict(mt.FlowSim.parsers)
        sim = mt.FlowSim(dict(
            env={"gmsh": paths["gmsh"], "flow123d": paths["flow123d"], "gmsh_version": 2},
            fields_params=dict(model="fourier", corr_length=0.5, dim=2, log=True, sigma=1,
                               mode_no=64),
            yaml_file=os.path.join(tmp, "flow_input.yaml.tmpl"),
            geo_file=os.path.join(tmp, "square.geo"), work_dir=os.path.join(tmp, "work")),
            clean=True)
        storage = mt.Memory()
        t0 = time.perf_counter()
        sampler = mt.Sampler(storage, mt.OneProcessPool(work_dir=os.path.join(tmp, "out"),
                                                        device=dev),
                             sim, [[0.6], [0.2]])
        sampler.set_initial_n_samples([4, 2])
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples(sleep=0.01)
        seconds = time.perf_counter() - t0
        n_coll = [int(v) for v in storage.get_n_collected()]
        failed = sum(len(v) for v in storage.failed_samples().values())
        pairs = [np.asarray(p) for p in storage.sample_pairs()]
        cfg = sampler._level_sim_objects[1].config_dict
        r1 = mt.FlowSim.calculate(cfg, 123, device=dev)
        r2 = mt.FlowSim.calculate(cfg, 123, device=dev)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    parsed = {k: mt.FlowSim.parsers[k] - before[k] for k in before}
    _require(n_coll == [4, 2] and failed == 0, "FlowSim run: collected %s, %d failed"
             % (n_coll, failed))
    _require(all(np.all(p[..., 0] > 0) for p in pairs), "FlowSim fluxes not positive")
    _require(np.array_equal(r1[0], r2[0]) and np.array_equal(r1[1], r2[1]),
             "FlowSim: a renewed sample does not replay")
    _require(parsed["native"] > 0 and parsed["python"] == 0,
             "FlowSim meshes parsed by %s: the native parser must parse them" % parsed)
    print("FlowSim with mock gmsh/flow123d: 4 + 2 samples through OneProcessPool (fields "
          "on the card) in %.2f s, none failed; meshes parsed by the native parser %d "
          "times, by the Python reader %d times; a renewed sample replays bit for bit"
          % (seconds, parsed["native"], parsed["python"]))
    return dict(seconds=seconds, n_per_level=n_coll, parsed_by=parsed)


def darcy3d_path(torch, dev):
    """The 3-D and fractured Darcy batches, the adaptive 3-D run (kernels C
    and D), ProcessBase on the card and FlowSim with mock binaries; returns
    the path's launch counts and the kernels' errors at its streams."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    out = {"path": "darcy3d"}
    with Phase(torch, "darcy3d path") as whole:
        with Phase(torch, "darcy3d: 3-D, 3-D fractured and 2-D fractured batches"):
            out.update(_darcy3d_batches(torch, dev, mt))
        with Phase(torch, "darcy3d: the adaptive 3-D run"):
            out["adaptive"], est = _darcy3d_adaptive(torch, dev, mt)
        counts = {**ck.launch_counts(), **cx.launch_counts()}
        with Phase(torch, "darcy3d: ProcessBase on the card"):
            out["process_base"] = _darcy3d_process_base(torch, dev, mt)
        with Phase(torch, "darcy3d: FlowSim with mock binaries"):
            out["flow_sim"] = _flow_sim_mock(torch, dev, mt)
    out.update(seconds=whole.seconds, launches=counts,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print("darcy3d path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, out["peak_memory_gb"]))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by the darcy3d path" % name)
    with Phase(torch, "kernels C/D vs plain at the 3-D run's streams"):
        errs = _streams_vs_plain(torch, dev, est, "the 3-D Darcy streams")
    print(json.dumps(out))
    return counts, {"samples_mlmc": errs[0], "samples_ext": errs[1]}


# ------------------------------------------------------------------------ #
# the sde_qmc path: QMC point sets, MLQMC, the SDE family, the stored run
# ------------------------------------------------------------------------ #
# sizes of bench_extra.py's bench_lattice, bench_qmc(_compact), bench_sde,
# bench_importance, bench_heston, bench_merton, bench_vg, bench_rbergomi and
# bench_unbiased; the stored SDE run's levels and starting counts
SDE_QMC = dict(
    sobol_dim=256, sobol_points=1 << 20, sobol_chunk=1 << 16,
    lattice=(8, 1 << 12, 16),
    qmc_synth=dict(R=16, chunk=1 << 16, n_init=1 << 14, target=1e-12),
    qmc_shooting=dict(R=16, chunk=1 << 13, n_init=1 << 12, target=1e-8),
    gbm_batch=1 << 16, otm_batch=1 << 17, heston_batch=1 << 17,
    merton_batch=1 << 17, vg_batch=1 << 17, rbergomi_batch=1 << 15,
    qmc_sde=dict(R=12, chunk=1 << 11, n_init=1 << 11, target=1e-9),
    # bench_unbiased's target is 1e-8: ~1.7e6 draws, whose deepest levels
    # (8 * 4^l steps, a few kernel launches per step) cost minutes on the
    # card; 5e-8 keeps ~3.5e5 draws and the ladder at level 5 or 6
    unbiased=dict(chunk=1 << 13, min_chunk=256, warm=1 << 14,
                  n_init=1 << 15, target=5e-8),
    stored_levels=[1 / 8, 1 / 32, 1 / 128, 1 / 512],
    stored_n=[1 << 20, 1 << 18, 1 << 16, 1 << 14],
    stored_target=2e-8,
)
RATE, SIGMA = 0.05, 0.2


def _sde_telescope(torch, levels, batch_fn):
    """sum over levels of mean(fine - coarse) and its standard error, each
    level from its own batch; also the level variances."""
    total, var, lvars = 0.0, 0.0, []
    for nf, nc in levels:
        f, c = batch_fn(nf, nc)
        d = (f - c).double()
        total += float(d.mean())
        var += float(d.var()) / d.shape[0]
        lvars.append(float(d.var()))
    return total, float(np.sqrt(var)), lvars


def _sde_point_sets(torch, dev, mt, out):
    from mlmc_tpu_torch.ops import lattice, sobol

    P = SDE_QMC
    d, n, step = P["sobol_dim"], P["sobol_points"], P["sobol_chunk"]
    host_step = min(step, 1 << 12)
    dv = sobol.direction_numbers(d)
    seeds = sobol.scramble_seeds(SEED, 0, 1, d, device=dev)[0]
    dv_t = torch.as_tensor(dv.astype(np.int64))
    card_s = host_s = 0.0
    for start in range(0, n, step):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        raw = sobol.sobol_bits(dv_t.to(dev), start, step)
        scr = sobol.owen_scramble(raw, seeds[None])
        torch.cuda.synchronize()
        card_s += time.perf_counter() - t0
        raw, scr = raw.cpu(), scr.cpu()
        t0 = time.perf_counter()
        raw_h = sobol.sobol_bits(dv_t, start, step, device="cpu")
        _require(torch.equal(raw, raw_h),
                 "raw Sobol' bits at points %d.. differ between the card and the CPU" % start)
        for sub in range(0, step, host_step):     # slices that stay in the CPU's cache
            scr_h = sobol.owen_scramble(raw_h[sub:sub + host_step], seeds.cpu()[None])
            _require(torch.equal(scr[sub:sub + host_step], scr_h),
                     "scrambled Sobol' bits at points %d.. differ between the card and "
                     "the CPU" % (start + sub))
        host_s += time.perf_counter() - t0
    out["sobol"] = dict(dim=d, points=n, card_s=card_s, cpu_s=host_s)
    print("Sobol' d=%d, %d points, raw and Owen-scrambled: equal bit for bit on the "
          "card and the CPU (card %.3f s, CPU %.3f s on %d threads, host clock)"
          % (d, n, card_s, host_s, torch.get_num_threads()))

    dl, nl, R = P["lattice"]
    t0 = time.perf_counter()
    z = lattice.cbc_vector(nl, dl)
    cbc_s = time.perf_counter() - t0
    f_per = lambda u: torch.prod(1.0 + 0.25 * (u * u - u + 1.0 / 6.0), dim=1)
    f_exp = lambda u: torch.prod(torch.exp(u), dim=1)
    checks = {}
    for name, fn, tent, truth in (("periodic", f_per, False, 1.0),
                                  ("tent_exp", f_exp, True, (np.e - 1.0) ** dl)):
        res = lattice.lattice_estimate(fn, dl, n=nl, n_shifts=R, z=z, seed=SEED,
                                       use_tent=tent, dtype=torch.float64, device=dev)
        err = abs(res["mean"] - truth)
        _require(err <= 6 * res["se"], "lattice %s: |mean - %.6g| = %.3g > 6 se %.3g"
                 % (name, truth, err, 6 * res["se"]))
        checks[name] = dict(mean=res["mean"], truth=truth, err=err, se=res["se"])
    out["lattice"] = dict(dim=dl, n=nl, shifts=R, cbc_s=cbc_s, **checks)
    print("lattice d=%d n=%d R=%d: CBC %.3f s; periodic |err| %.3g (6 se %.3g), tent exp "
          "rel err %.3g (6 se / truth %.3g)"
          % (dl, nl, R, cbc_s, checks["periodic"]["err"], 6 * checks["periodic"]["se"],
             checks["tent_exp"]["err"] / checks["tent_exp"]["truth"],
             6 * checks["tent_exp"]["se"] / checks["tent_exp"]["truth"]))


def _qmc_run(mt, fns, dims, p, target, seed, dev, **kw):
    """bench_qmc's protocol: one warm extension of level 0, then the timed
    adaptive run; returns (result, wall, MC evaluations for the target)."""
    import torch

    ml = mt.MLQMC(fns, dims, n_randomizations=p["R"], seed=seed,
                  chunk_size=p["chunk"], device=dev, **kw)
    if "cost_per_sample" not in kw:
        ml.extend(0, p["chunk"])     # bench_qmc warms level 0 first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ml.run(target_var=target, n_init=p["n_init"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mc = float(np.sum(np.sqrt(ml.point_variances()))) ** 2 / target
    _require(res["target_met"], "MLQMC missed its target %g: var %.4g" % (target, res["var"]))
    return ml, res, wall, mc


def _sde_mlqmc(torch, dev, mt, out):
    from mlmc_tpu_torch.parallel import SampleMesh

    P = SDE_QMC
    lp = [[0.5], [0.25], [0.125], [0.0625], [0.03125]]
    fns, dims = mt.synth_qmc_level_fns(lp, distr="norm")
    p = P["qmc_synth"]
    runs = {}
    for point_set in ("sobol", "lattice"):
        _, res, wall, mc = _qmc_run(mt, fns, dims, p, p["target"], 11, dev,
                                    point_set=point_set)
        evals = int(np.sum(res["n_evaluations"]))
        runs[point_set] = dict(wall_s=wall, evaluations=evals, mc_evaluations=mc,
                               mc_over_qmc=mc / evals, mean=res["mean"], var=res["var"],
                               n_samples=res["n_samples"].tolist(), rounds=res["rounds"])
        print("MLQMC synthetic 5 levels (%s) to %g: %.3f s, %d evaluations, n %s, var %.4g; "
              "MC would need %.4g: MC/QMC %.1f"
              % (point_set, p["target"], wall, evals, res["n_samples"].tolist(),
                 res["var"], mc, mc / evals))
    out["qmc_synth"] = runs

    # the same run over two shards of the card: the sums equal, shard order
    cost = [1.0] * len(lp)
    one, res1, _, _ = _qmc_run(mt, fns, dims, p, p["target"], 11, dev, cost_per_sample=cost)
    two, res2, _, _ = _qmc_run(mt, fns, dims, p, p["target"], 11, None, cost_per_sample=cost,
                               mesh=SampleMesh([dev, dev], group=False))
    _require(np.array_equal(res1["n_samples"], res2["n_samples"]) and all(
        np.array_equal(a.sums, b.sums) and np.array_equal(a.sums_sq, b.sums_sq)
        for a, b in zip(one._levels, two._levels)),
        "MLQMC over SampleMesh([dev, dev]) differs from one device")
    out["qmc_mesh_equal"] = True
    print("MLQMC synthetic over SampleMesh([dev, dev]): n %s and every randomization's "
          "sums equal to the one-device run bit for bit" % res2["n_samples"].tolist())

    shoot = mt.ShootingSimulation1D(dict(
        start_position=(0.0, 0.0), start_velocity=(10.0, 0.0),
        area_borders=(-2000.0, 2000.0, -2000.0, 2000.0), max_time=10.0,
        complexity=1000, n_modes=256,
        fields_params=dict(model="gauss", corr_length=0.1, sigma=0.5, log=False)))
    sfns, sdims = mt.shooting_qmc_level_fns(shoot, [[5.0], [2.0], [1.0]])
    p = P["qmc_shooting"]
    _, res, wall, mc = _qmc_run(mt, sfns, sdims, p, p["target"], 13, dev)
    evals = int(np.sum(res["n_evaluations"]))
    out["qmc_shooting"] = dict(wall_s=wall, evaluations=evals, mc_evaluations=mc,
                               mc_over_qmc=mc / evals, mean=res["mean"], var=res["var"],
                               n_samples=res["n_samples"].tolist(),
                               variance_reduction=res["mc_variance_reduction"].tolist())
    print("MLQMC shooting (256 phase dims, 200/500/1000 steps) to %g: %.3f s, %d "
          "evaluations, n %s; MC would need %.4g: MC/QMC %.1f; gain per level %s"
          % (p["target"], wall, evals, res["n_samples"].tolist(), mc, mc / evals,
             np.round(res["mc_variance_reduction"], 1).tolist()))


def _sde_batches(torch, dev, mt, out):
    from mlmc_tpu_torch.sim import jumps, levy, rough, sde
    from mlmc_tpu_torch.tool.profile_simulations import device_breakdown

    P = SDE_QMC
    disc = float(np.exp(-RATE))
    # ---- GBM Milstein 256 + 64 -------------------------------------- #
    sim = mt.SDESimulation(dict(model=mt.gbm(RATE, SIGMA, 1.0), scheme="milstein",
                                payoff=sde.european_call(1.0, disc)))
    cfg = sim.level_instance([1 / 256], [1 / 64]).config_dict
    B = P["gbm_batch"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    ms = _time_ms(torch, lambda: mt.SDESimulation.calculate_batch(cfg, gen, B), reps=3)
    prof = device_breakdown("GBM Milstein 256+64", lambda: mt.SDESimulation.calculate_batch(
        cfg, gen, B), 1, top=4)
    idx = torch.arange(B, device=dev)
    whole = mt.SDESimulation.calculate_keyed_batch(cfg, SEED, 1, idx, torch.zeros_like(idx))
    halves = [mt.SDESimulation.calculate_keyed_batch(cfg, SEED, 1, h, torch.zeros_like(h))
              for h in (idx[:B // 2], idx[B // 2:])]
    for k in (0, 1):
        _require(torch.equal(whole[k], torch.cat([h[k] for h in halves])),
                 "GBM keyed batch differs from the same indices in two halves")
    out["gbm_batch"] = dict(batch=B, batch_ms=ms, samples_per_s=B / ms * 1e3,
                            device_events_per_batch=prof["events_per_call"],
                            device_busy_ms=prof["busy_ms"],
                            device_idle_share=prof["idle_share"])
    print("GBM Milstein 256+64 batch of %d: %.3f ms (CUDA events, median of 3): %.4g coupled "
          "samples/s; %.0f device events, busy %.3f ms, idle %.1f%%; keyed rows equal to the "
          "same indices in two halves bit for bit"
          % (B, ms, B / ms * 1e3, prof["events_per_call"], prof["busy_ms"],
             100 * prof["idle_share"]))

    # ---- deep-OTM call under the Girsanov tilt ----------------------- #
    K = 1.8
    theta = mt.gbm_call_shift(RATE, SIGMA, 1.0, K, 1.0)
    B = P["otm_batch"]
    stats = {}
    for name, shift in (("is", theta), ("plain", None)):
        extra = {"drift_shift": shift} if shift else {}
        c = mt.SDESimulation(dict(model=mt.gbm(RATE, SIGMA, 1.0), scheme="milstein",
                                  payoff=sde.european_call(K, disc), **extra)
                             ).level_instance([1 / 256], [0]).config_dict
        g = torch.Generator(device=dev).manual_seed(SEED + len(name))
        v = mt.SDESimulation.calculate_batch(c, g, B)[0][:, 0].double()
        stats[name] = (float(v.mean()), float(v.var()))
    bs = mt.black_scholes_call(1.0, K, RATE, SIGMA, 1.0)
    se = np.sqrt(stats["is"][1] / B)
    _require(abs(stats["is"][0] - bs) <= 6 * se,
             "deep-OTM IS price %.6g vs Black-Scholes %.6g: > 6 se %.3g"
             % (stats["is"][0], bs, 6 * se))
    ratio = stats["plain"][1] / stats["is"][1]
    out["otm_is"] = dict(theta=theta, price=stats["is"][0], black_scholes=bs, se=se,
                         plain_mean=stats["plain"][0], variance_ratio=ratio)
    print("deep-OTM call K=1.8 (theta %.4f, B=%d): IS %.6g vs Black-Scholes %.6g (se %.3g); "
          "plain/IS variance ratio %.1f" % (theta, B, stats["is"][0], bs, se, ratio))

    # ---- Heston ------------------------------------------------------- #
    hp = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    p_ref = sde.heston_call_price(1.0, 1.0, RATE, T=1.0, **hp)
    model = sde.heston(mu=RATE, s0=1.0, **hp)
    B = P["heston_batch"]
    g = torch.Generator(device=dev).manual_seed(SEED)

    def heston_level(nf, nc):
        z = torch.randn((B, nf, 2), generator=g, device=dev)
        pf_f, _, pf_c = sde.coupled_system_functionals(
            dict(model=model, total_time=1.0, n_fine=nf, n_coarse=nc), z)
        pay = lambda pf: disc * torch.clamp(pf.terminal[:, 0] - 1.0, min=0.0)
        return pay(pf_f), (pay(pf_c) if pf_c is not None else torch.zeros(B, device=dev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    price, se, lvars = _sde_telescope(torch, [(32, 0), (128, 32), (512, 128)], heston_level)
    wall = time.perf_counter() - t0
    _require(abs(price - p_ref) <= 6 * se + 2e-4,
             "Heston %.6g vs semi-analytic %.6g: > 6 se + 2e-4 (se %.3g)" % (price, p_ref, se))
    out["heston"] = dict(price=price, semi_analytic=p_ref, se=se, wall_s=wall,
                         coupled_paths_per_s=3 * B / wall, level_vars=lvars)
    print("Heston levels (32,0),(128,32),(512,128), B=%d each: %.6g vs %.6g (se %.3g), "
          "%.3f s: %.4g coupled paths/s" % (B, price, p_ref, se, wall, 3 * B / wall))

    # ---- Merton (keyed draws: the inversion Poisson) ------------------ #
    lam, jm, jv = 0.8, -0.1, 0.15
    msim = jumps.JumpDiffusionSimulation(dict(
        model=jumps.merton(RATE, SIGMA, lam, jm, jv, 1.0), payoff=sde.european_call(1.0, disc)))
    p_ref = jumps.merton_call_price(1.0, 1.0, RATE, SIGMA, lam, jm, jv, 1.0)
    B = P["merton_batch"]

    def keyed_level(S, simobj, nf, nc, level, B):
        c = simobj.level_instance([1.0 / nf], [1.0 / nc if nc else 0]).config_dict
        ids = torch.arange(B, device=dev)
        f, cc, _ = S.calculate_keyed_batch(c, SEED, level, ids, torch.zeros_like(ids))
        return f[:, 0], cc[:, 0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    levels = [(16, 0), (32, 16), (64, 32), (128, 64)]
    price, se, lvars = _sde_telescope(torch, levels, lambda nf, nc: keyed_level(
        jumps.JumpDiffusionSimulation, msim, nf, nc, levels.index((nf, nc)), B))
    wall = time.perf_counter() - t0
    _require(abs(price - p_ref) <= 6 * se + 1e-3,
             "Merton %.6g vs closed form %.6g: > 6 se + 1e-3 (se %.3g)" % (price, p_ref, se))
    out["merton"] = dict(price=price, closed_form=p_ref, se=se, wall_s=wall,
                         coupled_paths_per_s=len(levels) * B / wall, level_vars=lvars)
    print("Merton levels %s, B=%d each (keyed, inversion Poisson): %.6g vs %.6g (se %.3g), "
          "%.3f s: %.4g coupled paths/s" % (levels, B, price, p_ref, se, wall,
                                            len(levels) * B / wall))

    # ---- variance gamma (keyed draws: the boosted Marsaglia-Tsang) ---- #
    vgp = dict(sigma=0.12, theta=-0.14, nu=0.2)
    vmodel = levy.variance_gamma(RATE, **vgp)
    B = P["vg_batch"]
    vsim = levy.VarianceGammaSimulation(dict(model=vmodel, payoff=sde.european_call(1.0, disc)))
    f0, _ = keyed_level(levy.VarianceGammaSimulation, vsim, 4, 0, 0, B)
    call = f0.double()
    ref = levy.vg_call_price(1.0, 1.0, RATE, T=1.0, **vgp)
    se0 = float(call.std() / np.sqrt(B))
    _require(abs(float(call.mean()) - ref) <= 6 * se0,
             "VG call %.6g vs COS %.6g: > 6 se %.3g" % (float(call.mean()), ref, se0))
    asim = levy.VarianceGammaSimulation(dict(model=vmodel, payoff=sde.asian_call(0.95, disc)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vlevels = [(8, 0), (16, 8), (32, 16), (64, 32)]
    asian, ase, alvars = _sde_telescope(torch, vlevels, lambda nf, nc: keyed_level(
        levy.VarianceGammaSimulation, asim, nf, nc, 10 + vlevels.index((nf, nc)), B))
    wall = time.perf_counter() - t0
    out["vg"] = dict(call=float(call.mean()), cos=ref, call_se=se0, asian=asian,
                     asian_se=ase, asian_wall_s=wall,
                     coupled_paths_per_s=len(vlevels) * B / wall, level_vars=alvars)
    print("VG terminal call (B=%d, keyed gamma): %.6g vs COS %.6g (se %.3g); Asian telescope "
          "%s: %.6g (se %.3g), %.3f s: %.4g coupled paths/s"
          % (B, float(call.mean()), ref, se0, vlevels, asian, ase, wall,
             len(vlevels) * B / wall))

    # ---- rBergomi ----------------------------------------------------- #
    B = P["rbergomi_batch"]
    rmodel = rough.rbergomi()
    g = torch.Generator(device=dev).manual_seed(SEED)

    def rb_level(model, nf, nc):
        z = torch.randn((B, 3 * nf), generator=g, device=dev)
        s_f, s_c = rough.coupled_rbergomi_paths(
            dict(model=model, total_time=1.0, n_fine=nf, n_coarse=nc),
            z[:, :2 * nf], z[:, 2 * nf:] * np.sqrt(1.0 / nf))
        pay = lambda s: torch.clamp(s - 1.0, min=0.0)
        return pay(s_f), (pay(s_c) if s_c is not None else torch.zeros(B, device=dev))

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rlevels = [(32, 0), (64, 32), (128, 64), (256, 128)]
    price, se, lvars = _sde_telescope(torch, rlevels, lambda nf, nc: rb_level(rmodel, nf, nc))
    wall = time.perf_counter() - t0
    _require(np.isfinite(price) and 0.0 < price < 0.2, "rBergomi price %.6g" % price)
    m0 = rough.rbergomi(xi0=0.04, eta=0.0, hurst=0.1, rho=-0.9)
    d0, _ = rb_level(m0, 64, 0)
    d0 = d0.double()
    bs = mt.black_scholes_call(1.0, 1.0, 0.0, 0.2, 1.0)
    se0 = float(d0.std() / np.sqrt(B))
    _require(abs(float(d0.mean()) - bs) <= 6 * se0,
             "rBergomi eta=0 %.6g vs Black-Scholes %.6g: > 6 se %.3g"
             % (float(d0.mean()), bs, se0))
    out["rbergomi"] = dict(price=price, se=se, wall_s=wall,
                           coupled_paths_per_s=len(rlevels) * B / wall,
                           level_var_ratios=[lvars[i + 1] / lvars[i]
                                             for i in range(len(lvars) - 1)],
                           eta0=float(d0.mean()), eta0_black_scholes=bs, eta0_se=se0)
    print("rBergomi levels %s, B=%d each: ATM call %.6g (se %.3g), %.3f s: %.4g coupled "
          "paths/s; eta=0: %.6g vs Black-Scholes %.6g (se %.3g)"
          % (rlevels, B, price, se, wall, len(rlevels) * B / wall, float(d0.mean()), bs, se0))


def _sde_qmc_and_unbiased(torch, dev, mt, out):
    from mlmc_tpu_torch.sim import sde

    P = SDE_QMC
    disc = float(np.exp(-RATE))
    sim = mt.SDESimulation(dict(model=mt.gbm(RATE, SIGMA, 1.0), scheme="milstein",
                                payoff=sde.european_call(1.0, disc)))
    fns, dims = mt.sde_qmc_level_fns(sim, [[1 / 8], [1 / 32], [1 / 128]])
    p = P["qmc_sde"]
    _, res, wall, mc = _qmc_run(mt, fns, dims, p, p["target"], 7, dev)
    bs = mt.black_scholes_call(1.0, 1.0, RATE, SIGMA, 1.0)
    err = abs(res["mean"] - bs)
    _require(err <= 6 * np.sqrt(res["var"]) + 3e-4,
             "MLQMC SDE call %.6g vs Black-Scholes %.6g: > 6 sigma + 3e-4" % (res["mean"], bs))
    gain = res["mc_variance_reduction"]
    _require(bool(np.all(gain > 5)), "MLQMC SDE call: mc_variance_reduction %s" % gain)
    evals = int(np.sum(res["n_evaluations"]))
    out["qmc_sde"] = dict(wall_s=wall, evaluations=evals, price=res["mean"],
                          black_scholes=bs, err=err, var=res["var"],
                          n_samples=res["n_samples"].tolist(),
                          variance_reduction=gain.tolist(), mc_over_qmc=mc / evals)
    print("MLQMC GBM call (levels 1/8, 1/32, 1/128, R=12) to %g: %.3f s, %d evaluations, "
          "%.6g vs Black-Scholes %.6g; gain per level %s; MC/QMC %.1f"
          % (p["target"], wall, evals, res["mean"], bs, np.round(gain, 1).tolist(),
             mc / evals))

    u = P["unbiased"]
    strike = 1.05
    usim = mt.SDESimulation(dict(model=mt.gbm(RATE, SIGMA, 1.0), scheme="milstein",
                                 payoff=sde.european_call(strike, disc)))
    mc_u = mt.UnbiasedMLMC(
        mt.sde_unbiased_level_fn(usim, n0=8, refine=4), mt.GeometricLevels(0.125),
        estimator="coupled", seed=11,
        chunk_size=lambda lv: max(u["chunk"] >> (2 * lv), u["min_chunk"]),
        cost_fn=lambda lv: 4.0 ** lv, device=dev)
    mc_u.sample(u["warm"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est = mc_u.run(target_var=u["target"], n_init=u["n_init"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bs = mt.black_scholes_call(1.0, strike, RATE, SIGMA, 1.0)
    se = float(np.sqrt(est["var"]))
    _require(est["target_met"] and abs(est["mean"] - bs) <= 6 * se,
             "Rhee-Glynn call %.6g vs Black-Scholes %.6g: > 6 se %.3g (target met: %s)"
             % (est["mean"], bs, se, est["target_met"]))
    out["unbiased"] = dict(wall_s=wall, draws=int(est["n_draws"]),
                           draws_per_s=est["n_draws"] / wall, price=est["mean"],
                           black_scholes=bs, se=se, deepest_level=int(max(est["levels"])),
                           n_per_level=est["n_samples"].tolist(), target=u["target"])
    print("Rhee-Glynn coupled-sum call (n0=8, refine=4, r=1/8) to %g: %.3f s, %d draws "
          "(%.4g draws/s), %.6g vs Black-Scholes %.6g (se %.3g); deepest level %d "
          "(%d fine steps); samples per level %s"
          % (u["target"], wall, est["n_draws"], est["n_draws"] / wall, est["mean"], bs, se,
             max(est["levels"]), 8 * 4 ** int(max(est["levels"])),
             est["n_samples"].tolist()))


def _sde_stored_run(torch, dev, mt, out):
    """Sampler -> DeviceBatchPool -> DeviceMemory for the GBM path
    functionals, one allocation round, the call in the Quantity algebra,
    Legendre(10) moments of the terminal value by kernels C and D."""
    from mlmc_tpu_torch.quantity.quantity_estimate import estimate_mean

    P = SDE_QMC
    sim = mt.SDESimulation(dict(model=mt.gbm(RATE, SIGMA, 1.0), scheme="milstein",
                                qoi="functionals"))
    storage = mt.DeviceMemory(device=dev)
    pool = mt.DeviceBatchPool(seed=SEED, device_results=True, max_batch=1 << 20,
                              min_bucket=1 << 14, device=dev)
    sampler = mt.Sampler(storage, pool, sim, [[h] for h in P["stored_levels"]])
    sampler.set_initial_n_samples(P["stored_n"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    _require(storage.get_n_collected() == P["stored_n"],
             "stored SDE run: %s collected" % storage.get_n_collected())
    root = mt.make_root_quantity(storage, sim.result_format())
    terminal = root["terminal"][1.0]["-"][0]
    domain = mt.estimate_domain(terminal, storage, quantile=0.001)
    mfn = mt.Legendre(10, domain)
    est = mt.Estimate(terminal, storage, mfn)
    raw, ns = est.estimate_diff_vars_fast()                        # kernel C
    variances, n_ops = est.estimate_diff_vars_regression(
        sampler._n_scheduled_samples, raw_vars=raw)
    n_est = mt.estimate_n_samples_for_target_variance(
        P["stored_target"], variances, n_ops, n_levels=sampler.n_levels)
    t0 = time.perf_counter()
    sampler.process_adding_samples(n_est, 0, 1.0)      # the whole gap at once
    sampler.ask_sampling_pool_for_samples()
    torch.cuda.synchronize()
    alloc_s = time.perf_counter() - t0
    disc = float(np.exp(-RATE))
    call = disc * np.maximum(terminal - 1.0, 0.0)
    qm = estimate_mean(call)
    price, pvar = float(np.asarray(qm.mean).ravel()[0]), float(np.asarray(qm.var).ravel()[0])
    bs = mt.black_scholes_call(1.0, 1.0, RATE, SIGMA, 1.0)
    _require(abs(price - bs) <= 6 * np.sqrt(pvar) + 2e-3,
             "stored SDE call %.6g vs Black-Scholes %.6g: > 6 sigma + 2e-3 (var %.3g)"
             % (price, bs, pvar))
    fast_mean, fast_var = est.estimate_moments_fast()              # kernel C
    ext_mean, ext_var = est.estimate_moments_extended()            # kernel D
    _require(fast_mean[0] == 1.0 and ext_mean[0] == 1.0 and np.all(np.isfinite(ext_var)),
             "stored SDE moments: mean[0] %r / %r" % (fast_mean[0], ext_mean[0]))
    out["stored"] = dict(n_initial=P["stored_n"], n_estimated=np.asarray(n_est).tolist(),
                         n_collected=storage.get_n_collected(), sample_s=sample_s,
                         allocation_s=alloc_s, price=price, price_var=pvar,
                         black_scholes=bs, domain=list(domain),
                         moments_fast_vs_f64=float(np.max(np.abs(fast_mean - ext_mean))),
                         pool_dispatches=pool.n_dispatches)
    print("stored SDE run (GBM Milstein functionals, levels 1/8..1/512): %s samples in "
          "%.3f s, allocation for %g: %s, %s collected after it (%.3f s); the call in the "
          "Quantity algebra %.6g vs Black-Scholes %.6g (sigma %.3g); Legendre(10) on "
          "(%.3f, %.3f): fast vs f64 tier max |mean diff| %.3g"
          % (P["stored_n"], sample_s, P["stored_target"], np.asarray(n_est).tolist(),
             storage.get_n_collected(), alloc_s, price, bs, np.sqrt(pvar), domain[0],
             domain[1], out["stored"]["moments_fast_vs_f64"]))
    return est


def sde_qmc_path(torch, dev):
    """QMC point sets, MLQMC, the SDE family's batches and prices, the
    MLQMC and unbiased SDE calls, and the stored SDE run (kernels C and D);
    returns the path's launch counts and the kernels' errors at its
    streams."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    out = {"path": "sde_qmc"}
    with Phase(torch, "sde_qmc path") as whole:
        with Phase(torch, "sde_qmc: Sobol' bits and the CBC lattice") as ph:
            _sde_point_sets(torch, dev, mt, out)
        out["point_sets_s"] = ph.seconds
        with Phase(torch, "sde_qmc: MLQMC synthetic (Sobol', lattice, mesh) and shooting") as ph:
            _sde_mlqmc(torch, dev, mt, out)
        out["mlqmc_s"] = ph.seconds
        with Phase(torch, "sde_qmc: SDE, Heston, Merton, VG, rBergomi batches") as ph:
            _sde_batches(torch, dev, mt, out)
        out["batches_s"] = ph.seconds
        with Phase(torch, "sde_qmc: MLQMC SDE call and the Rhee-Glynn call") as ph:
            _sde_qmc_and_unbiased(torch, dev, mt, out)
        out["qmc_unbiased_s"] = ph.seconds
        with Phase(torch, "sde_qmc: the stored SDE run (kernels C and D)") as ph:
            est = _sde_stored_run(torch, dev, mt, out)
        out["stored_s"] = ph.seconds
        counts = {**ck.launch_counts(), **cx.launch_counts()}
    out.update(seconds=whole.seconds, launches=counts,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print("sde_qmc path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, out["peak_memory_gb"]))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by the sde_qmc path" % name)
    with Phase(torch, "kernels C/D vs plain at the stored SDE run's streams"):
        errs = _streams_vs_plain(torch, dev, est, "the stored SDE streams")
    print(json.dumps(out))
    return counts, {"samples_mlmc": errs[0], "samples_ext": errs[1]}


# ------------------------------------------------------------------------ #
# the e2 path: SPDE, reactions, transport, Longstaff-Schwartz, BSDE,
# sensitivity, nested expectations, the stored SPDE run (kernels C and D)
# ------------------------------------------------------------------------ #
#: bench_extra.py's sizes (bench_spde, bench_reactions, bench_transport,
#: bench_american, bench_heston's Bermudan half, bench_bsde,
#: bench_sensitivity, bench_nested)
E2 = dict(
    spde=dict(T=0.5, batch=1 << 13,
              levels=[(32, 16, 0, 0), (64, 64, 32, 16), (128, 256, 64, 64)]),
    reactions=dict(T=1.0, batch=1 << 15,
                   levels=[(4, 0), (8, 4), (16, 8), (32, 16), (64, 32)],
                   ssa_lanes=1 << 13, ssa_events=512),
    transport=dict(fine=64, coarse=16, batch=1024, pool=[1024, 1024], muscl_batch=256,
                   muscl_steps_per_cell=160, moments=10),
    american=dict(rate=0.06, sigma=0.2, n_dates=50, paths=1 << 18, dual=(1 << 14, 64),
                  heston_dates=16, heston_sub=8, heston_paths=1 << 16,
                  heston_dual=(1 << 12, 512), max_flips=16),
    bsde=dict(bs=(50, 1 << 17, 5), nonlinear=(32, 1 << 16, 6)),
    sensitivity=dict(n=1 << 17, R=16, chunk=1 << 13, subspace_samples=1 << 16),
    # bench_nested's chunk is 2^12 at every level; the chunk here shrinks
    # with the level's inner count (the same estimator, fewer launches)
    nested=dict(target=1e-7, n_init=1 << 16, warm=1 << 14, chunk=1 << 16, min_chunk=64,
                block=1 << 16),
    stored=dict(n=[1 << 14, 1 << 12, 1 << 10], target=1e-7, moments=10),
)


def _e2_trace(torch, out, key, what, fn):
    """Run ``fn`` under torch.profiler (the device alone traced) and record
    its device events and idle share in ``out[key]``; returns fn's result.
    Reading a trace costs ~35 us of host time per device event, so a phase
    of 1e5-1e6 launches traces its main batch, not the whole phase."""
    from mlmc_tpu_torch.tool.profile_simulations import device_activity

    result, act = device_activity(fn)
    out.setdefault(key, {}).update(
        traced=what, traced_wall_s=act["wall_s"], device_events=act["events"],
        device_busy_ms=act["busy_ms"], device_span_ms=act["span_ms"],
        device_idle_share=act["idle_share"])
    return result


def _e2_phase(torch, out, key, label, fn, trace_whole=True):
    """One phase: its host wall time, and (``trace_whole``) its device
    events and idle share; a phase that does not trace itself whole
    traces its main batch with ``_e2_trace``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = (_e2_trace(torch, out, key, "the whole phase", fn) if trace_whole
              else fn())
    torch.cuda.synchronize()
    o = out.setdefault(key, {})
    o["wall_s"] = time.perf_counter() - t0
    print("phase %s %s: %.3f s (host clock); %s: %.3f s traced, %d device events, busy "
          "%.3f ms of a %.3f ms span: idle %.1f%%"
          % (out["path"], label, o["wall_s"], o["traced"], o["traced_wall_s"],
             o["device_events"],
             o["device_busy_ms"], o["device_span_ms"], 100 * o["device_idle_share"]))
    return result


def _e2_spde(torch, dev, mt, out):
    """bench_spde: the stochastic heat telescope against the discrete law."""
    from mlmc_tpu_torch.sim import spde

    P = E2["spde"]
    T, B = P["T"], P["batch"]
    sim = mt.SPDESimulation(dict(model=mt.stochastic_heat(1.0, 1.0), total_time=T))
    idx = torch.arange(B, device=dev)
    total, var, lvars, secs = 0.0, 0.0, [], []
    for lev, (Nf, nf, Nc, nc) in enumerate(P["levels"]):
        coarse = [0, 0] if Nc == 0 else [1.0 / Nc, T / nc]
        cfg = sim.level_instance([1.0 / Nf, T / nf], coarse).config_dict
        t0 = time.perf_counter()
        f, c, failed = mt.SPDESimulation.calculate_keyed_batch(cfg, SEED, lev, idx,
                                                               torch.zeros_like(idx))
        d = (f - c)[:, 0].double()
        total += float(d.mean())
        var += float(d.var()) / B
        lvars.append(float(d.var()))
        secs.append(time.perf_counter() - t0)
        _require(not bool(failed.any()), "SPDE level %d: failed samples" % lev)
    se = float(np.sqrt(var))
    exact = spde.discrete_heat_l2_moment(1.0, 1.0, T, 128, 256)
    cont = mt.heat_spde_l2_moment(1.0, 1.0, T)
    ratios = [lvars[i + 1] / lvars[i] for i in range(len(lvars) - 1)]
    _require(abs(total - exact) <= 6 * se, "SPDE energy %.6g vs the discrete law %.6g: "
             "> 6 se (%.3g)" % (total, exact, se))
    out["spde"] = dict(batch=B, energy=total, se=se, discrete_closed_form=exact,
                       continuum=cont, level_variances=lvars, level_var_ratios=ratios,
                       level_seconds=secs)
    print("SPDE stochastic heat, levels %s, %d keyed fields each: E||u(T)||^2 %.6g vs the "
          "discrete law %.6g (se %.3g, continuum %.6g); level variances %s, ratios %s; "
          "level seconds %s"
          % ([(a, b) for a, b, _, _ in P["levels"]], B, total, exact, se, cont,
             ["%.3g" % v for v in lvars], ["%.3f" % r for r in ratios],
             ["%.3f" % t for t in secs]))


def _e2_reactions(torch, dev, mt, out):
    """bench_reactions: the dimerization telescope against the exact SSA."""
    from mlmc_tpu_torch.random.keyed import SampleKeys

    P = E2["reactions"]
    T, B = P["T"], P["batch"]
    net = mt.dimerization()
    sim = mt.ReactionSimulation(dict(network=net, total_time=T))
    idx = torch.arange(B, device=dev)
    total, var, lvars, secs = 0.0, 0.0, [], []
    for lev, (nf, nc) in enumerate(P["levels"]):
        cfg = sim.level_instance([T / nf], [0 if nc == 0 else T / nc]).config_dict
        t0 = time.perf_counter()
        f, c, _ = mt.ReactionSimulation.calculate_keyed_batch(cfg, SEED, lev, idx,
                                                              torch.zeros_like(idx))
        d = (f[:, 0] - c[:, 0]).double()
        total += float(d.mean())
        var += float(d.var()) / B
        lvars.append(float(d.var()))
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    se = float(np.sqrt(var))
    n_ssa = P["ssa_lanes"]
    t0 = time.perf_counter()
    x, overran = mt.ssa_exact(net, T, SampleKeys(SEED + 1, 0, torch.arange(n_ssa, device=dev)),
                              P["ssa_events"])
    ref_x = x[:, 0].double()
    n_over = int(overran.sum())
    ssa_s = time.perf_counter() - t0
    ref, se_ref = float(ref_x.mean()), float(ref_x.std() / np.sqrt(n_ssa))
    sig = float(np.hypot(se, se_ref))
    _require(n_over == 0, "exact SSA: %d lanes overran %d events" % (n_over, P["ssa_events"]))
    _require(abs(total - ref) < 6 * sig + 1.5, "dimerization telescope %.4f vs exact SSA %.4f:"
             " > 6 sigma + 1.5 (sigma %.3g)" % (total, ref, sig))
    ratios = [lvars[i + 1] / lvars[i] for i in range(len(lvars) - 1)]
    out["reactions"] = dict(batch=B, telescoped_mean=total, se=se, ssa_mean=ref,
                            ssa_se=se_ref, ssa_lanes=n_ssa, ssa_overruns=n_over, ssa_s=ssa_s,
                            level_var_ratios=ratios, level_seconds=secs,
                            finest_level_samples_per_s=B / secs[-1])
    print("dimerization tau-leap, levels %s, %d keyed lanes each: monomers %.4f (se %.3g) vs "
          "exact SSA %.4f (se %.3g, %d lanes, %d events, %d overran, %.3f s); level variance "
          "ratios %s; the (64, 32) level %.3f s (%.4g coupled samples/s)"
          % (P["levels"], B, total, se, ref, se_ref, n_ssa, P["ssa_events"], n_over, ssa_s,
             ["%.3f" % r for r in ratios], secs[-1], B / secs[-1]))


def _e2_transport(torch, dev, mt, out):
    """bench_transport: a coupled batch, the sharded pool tier, the 40 QoI
    streams through Estimate (kernels C and D), a MUSCL batch; returns the
    estimate."""
    from mlmc_tpu_torch.parallel import SampleMesh

    P = E2["transport"]
    base = dict(sigma=1.0, corr_length=0.3, field_method="circulant")
    sim = mt.TransportSimulation(base)
    levels = [[1.0 / P["coarse"]], [1.0 / P["fine"]]]
    cfg = sim.level_instance(levels[1], levels[0]).config_dict
    B = P["batch"]
    idx = torch.arange(B, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    f, c, failed = _e2_trace(
        torch, out, "transport", "the upwind batch of %d" % B,
        lambda: mt.TransportSimulation.calculate_keyed_batch(cfg, SEED, 1, idx,
                                                             torch.zeros_like(idx)))
    batch_s = out["transport"]["traced_wall_s"]
    n_failed = int(failed.sum())
    _require(f.shape == (B, 40) and n_failed < B // 10,
             "transport batch: shape %s, %d failed" % (tuple(f.shape), n_failed))
    ok = ~failed
    _require(bool(torch.isfinite(f[ok]).all() and torch.isfinite(c[ok]).all()),
             "transport batch: non-finite QoI on a sample that did not fail")

    def pool_run(sharding):
        storage = mt.DeviceMemory(device=dev)
        pool = mt.DeviceBatchPool(seed=SEED, sharding=sharding, device_results=True,
                                  max_batch=1 << 20, device=dev)
        sampler = mt.Sampler(storage, pool, sim, levels)
        sampler.set_initial_n_samples(P["pool"])
        sampler.schedule_samples()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sampler.ask_sampling_pool_for_samples()
        torch.cuda.synchronize()
        return storage, time.perf_counter() - t0

    one, one_s = pool_run(None)
    two, two_s = pool_run(SampleMesh([dev, dev]))
    _require(one.get_n_collected() == two.get_n_collected(),
             "transport pools collected %s / %s" % (one.get_n_collected(),
                                                   two.get_n_collected()))
    for a, b in zip(one.sample_pairs(), two.sample_pairs()):
        _require(torch.equal(a, b), "transport pool over [dev, dev] differs from one device")
    root = mt.make_root_quantity(one, sim.result_format())
    domain = mt.estimate_domain(root, one, quantile=0.001)
    est = mt.Estimate(root, one, mt.Legendre(P["moments"], domain))
    raw, ns = est.estimate_diff_vars_fast()                         # kernel C
    mean, var = est.estimate_moments_extended()                     # kernel D
    _require(mean.shape == (40, P["moments"]) and np.all(mean[:, 0] == 1.0)
             and np.all(np.isfinite(var)), "transport moments: shape %s" % (mean.shape,))
    muscl = mt.TransportSimulation(dict(base, scheme="muscl",
                                        steps_per_cell=P["muscl_steps_per_cell"]))
    cfg_m = muscl.level_instance(levels[1], levels[0]).config_dict
    idx_m = torch.arange(P["muscl_batch"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm, cm, failed_m = mt.TransportSimulation.calculate_keyed_batch(
        cfg_m, SEED, 1, idx_m, torch.zeros_like(idx_m))
    torch.cuda.synchronize()
    muscl_s = time.perf_counter() - t0
    _require(bool(torch.isfinite(fm).all() and torch.isfinite(cm).all()),
             "MUSCL batch: %d of %d samples not finite"
             % (int((~torch.isfinite(fm).all(dim=1)).sum()), P["muscl_batch"]))
    out["transport"].update(
        batch=B, batch_s=batch_s, samples_per_s=B / batch_s, failed=n_failed,
        steps=[cfg["_n_steps_fine"], cfg["_n_steps_coarse"]],
        pool=P["pool"], collected=one.get_n_collected(), pool_one_device_s=one_s,
        pool_two_shards_s=two_s, estimate_n_valid=ns.tolist(), domain=list(domain),
        muscl_batch=P["muscl_batch"], muscl_steps_per_cell=P["muscl_steps_per_cell"],
        muscl_s=muscl_s)
    print("transport 64^2 + 16^2 upwind, %d coupled samples (%d + %d steps): %.3f s "
          "(traced), %.4g samples/s, %d failed; pools %s: one device %.3f s, over [dev, dev] %.3f s, "
          "payloads equal bit for bit (%s collected); 40 QoI x 2 levels through Estimate "
          "(C variances, D means), n_valid %s; MUSCL batch of %d at %d steps per cell: "
          "%.3f s, every QoI finite"
          % (B, cfg["_n_steps_fine"], cfg["_n_steps_coarse"], batch_s, B / batch_s,
             n_failed, P["pool"], one_s, two_s, one.get_n_collected(), ns.tolist(),
             P["muscl_batch"], P["muscl_steps_per_cell"], muscl_s))
    return est


def _e2_american(torch, dev, mt, out):
    """bench_american and bench_heston's Bermudan half: the bracket
    lower bound <= tree <= dual upper bound, the Heston bracket, and the
    mesh run against one device with its flipped paths."""
    from mlmc_tpu_torch.parallel import SampleMesh
    from mlmc_tpu_torch.parallel.mesh import single_device_mesh
    from mlmc_tpu_torch.sim import american as am
    from mlmc_tpu_torch.sim import sde

    P = E2["american"]
    r, sig, N, Bp = P["rate"], P["sigma"], P["n_dates"], P["paths"]
    put = mt.put_payoff(1.0)
    lo = _e2_trace(torch, out, "american", "the 2 x %d-path price" % Bp,
                   lambda: mt.lsmc_price(put, 1.0, r, 1.0, N, sigma=sig, degree=3,
                                         n_paths=Bp, seed=2, device=dev))
    price_s = out["american"]["traced_wall_s"]
    surf = mt.lsmc_price(put, 1.0, r, 1.0, N, sigma=sig, degree=7, n_paths=Bp, seed=5,
                         itm_only=False, device=dev)
    n_dual, n_inner = P["dual"]
    dual = mt.lsmc_dual_bound(put, 1.0, r, 1.0, N, surf["coef"], sigma=sig,
                              n_paths=n_dual, n_inner=n_inner, seed=6, device=dev)
    tree = mt.bermudan_binomial(1.0, 1.0, r, sig, 1.0, N, n_steps=200 * N)
    holds = lo["price"] - 4 * lo["price_se"] <= tree <= dual["upper"] + 4 * dual["upper_se"]
    _require(holds, "Bermudan bracket: %.6g - 4 x %.3g <= tree %.6g <= %.6g + 4 x %.3g fails"
             % (lo["price"], lo["price_se"], tree, dual["upper"], dual["upper_se"]))
    # Heston (bench_heston's parameters)
    hp = dict(kappa=2.0, theta=0.04, xi=0.3, rho=-0.7, v0=0.04)
    model = sde.heston(mu=0.05, s0=1.0, **hp)
    hput = lambda s: torch.clamp(1.0 - s[..., 0], min=0.0)
    hk = dict(model=model, n_sub=P["heston_sub"], degree=3, n_paths=P["heston_paths"],
              device=dev)
    t0 = time.perf_counter()
    h_lo = mt.lsmc_price(hput, 1.0, 0.05, 1.0, P["heston_dates"], seed=41, **hk)
    h_surf = mt.lsmc_price(hput, 1.0, 0.05, 1.0, P["heston_dates"], itm_only=False,
                           seed=42, **hk)
    hb, hi = P["heston_dual"]
    h_up = mt.lsmc_dual_bound(hput, 1.0, 0.05, 1.0, P["heston_dates"], h_surf["coef"],
                              model=model, n_sub=P["heston_sub"], n_paths=hb, n_inner=hi,
                              seed=43, device=dev)
    heston_s = time.perf_counter() - t0
    h_width = h_up["upper"] - h_lo["price"]
    _require(h_lo["price"] - 4 * h_lo["price_se"] <= h_up["upper"] + 4 * h_up["upper_se"],
             "Heston Bermudan: lower %.6g above upper %.6g" % (h_lo["price"], h_up["upper"]))
    # the mesh: the one-device paths, the pooled TSQR fit, in float64 (in
    # float32 the degree-3 fit of the early dates' narrow state clouds moves
    # its coefficients by ~5% between one QR and the stacked one, and
    # hundreds of the 2^18 decisions flip)
    dyn = am._Dynamics(1.0, r, 1.0, N, sig, None, "euler", 1, 3, None, torch.float64,
                       "pricing")
    normals = am._keyed_panel_normals(2, dyn, N)
    one, p_one = am._lsmc(put, dyn, N, Bp, True, normals, single_device_mesh(dev),
                          keep_paths=True)
    two, p_two = am._lsmc(put, dyn, N, Bp, True, normals, SampleMesh([dev, dev]),
                          keep_paths=True)
    flip_eval = p_one["stop"] != p_two["stop"]
    flip_fit = p_one["stop_insample"] != p_two["stop_insample"]
    flipped = int(flip_eval.sum()) + int(flip_fit.sum())
    slack = float((p_one["value"] - p_two["value"]).abs()[flip_eval].sum()) / Bp
    dprice = abs(one["price"] - two["price"])
    coef_rel = float(np.max(np.abs(one["coef"] - two["coef"])) / np.max(np.abs(one["coef"])))
    cont_rel = _e2_continuation_gap(torch, dyn, one["coef"], two["coef"], p_one, N, dev)
    _require(flipped <= P["max_flips"], "mesh LSMC: %d of %d paths flipped (at most %d)"
             % (flipped, Bp, P["max_flips"]))
    _require(dprice <= slack + 1e-12 * abs(one["price"]),
             "mesh LSMC price %.15g vs one device %.15g: more than the flipped paths' %.3g"
             % (two["price"], one["price"], slack))
    # a fit-pass flip moves the earlier dates' fits by O(payoff / B)
    tol = 1e-9 if not bool(flip_fit.any()) else 1e-4
    _require(coef_rel <= tol and cont_rel <= tol,
             "mesh LSMC coefficients / continuation values differ by %.3g / %.3g relative "
             "(tol %g)" % (coef_rel, cont_rel, tol))
    out["american"].update(
        price=lo["price"], price_se=lo["price_se"], price_insample=lo["price_insample"],
        binomial=tree, dual_upper=dual["upper"], dual_upper_se=dual["upper_se"],
        bracket_width=dual["upper"] - lo["price"], exercise_frac=lo["exercise_frac"],
        price_s=price_s, paths_per_s=2 * Bp / price_s, dual_s=dual["wall_s"],
        heston=[h_lo["price"], h_up["upper"]], heston_width=h_width,
        heston_width_pct=100 * h_width / h_lo["price"], heston_s=heston_s,
        mesh_flipped_paths=flipped, mesh_price_diff=dprice, mesh_flip_slack=slack,
        mesh_coef_rel=coef_rel, mesh_continuation_rel=cont_rel)
    print("Bermudan put, %d dates, 2 x %d paths: LSMC %.6g (se %.3g, %.3f s traced, %.4g "
          "paths/s) <= "
          "tree %.6g <= dual %.6g (se %.3g, %d x %d inner, %.3f s): bracket width %.3g; "
          "Heston (%d dates, n_sub %d, %d paths, dual %d x %d): [%.5f, %.5f], width %.3g "
          "(%.2f%%), %.3f s; mesh [dev, dev] vs one device (float64): %d of %d paths "
          "flipped (fit + evaluation), |price diff| %.3g <= flipped payoffs / B %.3g, "
          "coefficients %.3g and continuation values %.3g relative"
          % (N, Bp, lo["price"], lo["price_se"], price_s, 2 * Bp / price_s, tree,
             dual["upper"], dual["upper_se"], n_dual, n_inner, dual["wall_s"],
             dual["upper"] - lo["price"], P["heston_dates"], P["heston_sub"],
             P["heston_paths"], hb, hi, h_lo["price"], h_up["upper"], h_width,
             100 * h_width / h_lo["price"], heston_s, flipped, Bp, dprice, slack, coef_rel,
             cont_rel))


def _e2_continuation_gap(torch, dyn, coef_a, coef_b, paths, N, dev):
    """Max relative gap of the two coefficient stacks' continuation values
    on a fresh set of 2^14 keyed paths, over the dates."""
    from mlmc_tpu_torch.sim import american as am

    idx = torch.arange(1 << 14, device=dev)
    z = am._keyed_panel_normals(99, dyn, N)(0, idx)
    s = dyn.initial(idx.shape[0], dev)
    gap, scale = 0.0, 0.0
    for i in range(N - 1):
        s = dyn.step(s, z[:, i], i)
        G = dyn.basis(s).double()
        ca = G @ torch.tensor(coef_a[i], device=dev)
        cb = G @ torch.tensor(coef_b[i], device=dev)
        gap = max(gap, float((ca - cb).abs().max()))
        scale = max(scale, float(ca.abs().max()))
    return gap / max(scale, 1e-300)


def _e2_bsde(torch, dev, mt, out):
    """bench_bsde: the measure-change driver and the manufactured anchor."""
    from mlmc_tpu_torch.sim import sde

    P = E2["bsde"]
    mu, R, SIG, T = 0.15, 0.05, 0.2, 1.0
    lam = (mu - R) / SIG
    n, B, deg = P["bs"]
    bs = mt.black_scholes_call(1.0, 1.0, R, SIG, T)
    res = mt.solve_bsde(mt.gbm(mu, SIG, 1.0), lambda x: torch.clamp(x - 1.0, min=0.0),
                        lambda t, x, y, z: -R * y - lam * z, T, n, n_paths=B, degree=deg,
                        seed=3, device=dev)
    _require(abs(res["y0"] - bs) < 6 * res["y0_se"] + 1e-3,
             "BSDE Black-Scholes driver: y0 %.6g vs %.6g (se %.3g)" % (res["y0"], bs,
                                                                       res["y0_se"]))
    alpha, c, x0 = 0.4, 0.5, 0.8
    model = sde.SDEModel(drift=lambda x, t: torch.zeros_like(x),
                         diffusion=lambda x, t: torch.ones_like(x), s0=x0)
    u_ex = lambda t, x: torch.exp(alpha * (T - t)) * torch.sin(x)
    drv = lambda t, x, y, z: (alpha + 0.5) * y + c * (y ** 2 - u_ex(t, x) ** 2)
    n2, B2, deg2 = P["nonlinear"]
    res2 = mt.solve_bsde(model, torch.sin, drv, T, n2, n_paths=B2, degree=deg2, scale=1.0,
                         seed=8, device=dev)
    y_ref = float(np.exp(alpha * T) * np.sin(x0))
    _require(abs(res2["y0"] - y_ref) < 6 * res2["y0_se"] + 5e-3,
             "BSDE nonlinear anchor: y0 %.6g vs %.6g (se %.3g)" % (res2["y0"], y_ref,
                                                                  res2["y0_se"]))
    out["bsde"] = dict(bs_y0=res["y0"], bs_closed_form=bs, bs_se=res["y0_se"],
                       bs_wall_s=res["wall_s"], path_dates_per_s=B * n / res["wall_s"],
                       nonlinear_y0=res2["y0"], nonlinear_exact=y_ref,
                       nonlinear_se=res2["y0_se"], nonlinear_wall_s=res2["wall_s"])
    print("BSDE: Black-Scholes driver (%d dates, %d paths, degree %d) y0 %.6g vs %.6g (se "
          "%.3g, %.3f s, %.4g path-dates/s); nonlinear anchor (%d dates, %d paths, degree "
          "%d) y0 %.6g vs %.6g (se %.3g, %.3f s)"
          % (n, B, deg, res["y0"], bs, res["y0_se"], res["wall_s"], B * n / res["wall_s"],
             n2, B2, deg2, res2["y0"], y_ref, res2["y0_se"], res2["wall_s"]))


def _e2_sensitivity(torch, dev, mt, out):
    """bench_sensitivity: Ishigami's indices, and an active subspace."""
    P = E2["sensitivity"]
    a, b = 7.0, 0.1

    def ishigami(u):
        x = 2 * np.pi * u - np.pi
        return (torch.sin(x[:, 0]) + a * torch.sin(x[:, 1]) ** 2
                + b * x[:, 2] ** 4 * torch.sin(x[:, 0]))

    v1, v2 = 0.5 * (1 + b * np.pi ** 4 / 5) ** 2, a ** 2 / 8
    v13 = 8 * b ** 2 * np.pi ** 8 / 225
    v = v1 + v2 + v13
    s_exact = np.array([v1, v2, 0.0]) / v
    st_exact = np.array([v1 + v13, v2, v13]) / v
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = mt.sobol_indices(ishigami, 3, n=P["n"], n_randomizations=P["R"], seed=4,
                           chunk_size=P["chunk"], device=dev)
    wall = time.perf_counter() - t0
    err1 = np.abs(res.first_order - s_exact)
    errt = np.abs(res.total_effect - st_exact)
    _require(np.all(err1 < 6 * res.first_order_se + 1e-3)
             and np.all(errt < 6 * res.total_effect_se + 1e-3),
             "Ishigami indices: first %s (se %s), total %s (se %s)"
             % (res.first_order, res.first_order_se, res.total_effect, res.total_effect_se))
    w = torch.tensor([0.48, -0.6, 0.64, 0.0], dtype=torch.float32, device=dev)
    sub = mt.active_subspace(lambda x: torch.tanh(x @ w), 4,
                             n_samples=P["subspace_samples"], seed=5, device=dev)
    align = abs(float(sub["W"][:, 0] @ w.double().cpu().numpy()))
    _require(align > 1 - 1e-4 and sub["explained"][0] > 1 - 1e-4,
             "active subspace: |<w1, w>| %.6g, explained %.6g" % (align, sub["explained"][0]))
    out["sensitivity"] = dict(n=P["n"], R=P["R"], indices_s=wall,
                              n_evaluations=res.n_evaluations,
                              model_evals_per_s=res.n_evaluations / wall,
                              max_abs_err_first_order=float(err1.max()),
                              max_abs_err_total_effect=float(errt.max()),
                              max_se=float(max(res.first_order_se.max(),
                                               res.total_effect_se.max())),
                              subspace_alignment=align, subspace_wall_s=sub["wall_s"])
    print("Sobol' indices, Ishigami, n=%d x %d randomizations (%d evaluations): %.3f s, %.4g "
          "model evaluations/s; max |error| first order %.3g, total effect %.3g (max se "
          "%.3g); active subspace of a ridge function: |<w1, w>| = %.8f"
          % (P["n"], P["R"], res.n_evaluations, wall, res.n_evaluations / wall,
             err1.max(), errt.max(), out["sensitivity"]["max_se"], align))


def _e2_nested(torch, dev, mt, out):
    """bench_nested: unbiased EVPPI of the Gaussian information problem."""
    from mlmc_tpu_torch import nested

    P = E2["nested"]
    sigma_y, sigma_x, mu = 1.3, 2.0, 0.2
    fn = nested.nested_level_fn(nested.gaussian_information_fn(sigma_y, sigma_x, mu),
                                g=nested.g_max0, n0=4, block=P["block"])
    mc = mt.UnbiasedMLMC(fn, mt.GeometricLevels(2.0 ** -1.25), estimator="single", seed=7,
                         chunk_size=lambda lv: max(P["chunk"] >> lv, P["min_chunk"]),
                         cost_fn=lambda lv: 2.0 ** lv, device=dev)
    _e2_trace(torch, out, "nested", "the warm-up draw of %d" % P["warm"],
              lambda: mc.sample(P["warm"]))
    t0 = time.perf_counter()
    res = mc.run(target_var=P["target"], n_init=P["n_init"])
    wall = time.perf_counter() - t0
    exact = nested.evppi_gaussian_exact(sigma_y, mu)
    se = float(np.sqrt(res["var"]))
    _require(res["target_met"] and abs(res["mean"] - exact) < 6 * se,
             "unbiased EVPPI %.6g vs %.6g (se %.3g, target met %s)"
             % (res["mean"], exact, se, res["target_met"]))
    out["nested"].update(value=res["mean"], exact=exact, se=se, run_s=wall,
                         draws=int(res["n_draws"]), draws_per_s=res["n_draws"] / wall,
                         levels_explored=len(res["levels"]))
    print("unbiased EVPPI to %g: %.6g vs %.6g (se %.3g), %d draws in %.3f s (%.4g draws/s), "
          "levels 0..%d" % (P["target"], res["mean"], exact, se, res["n_draws"], wall,
                            res["n_draws"] / wall, len(res["levels"]) - 1))


def _e2_stored_spde(torch, dev, mt, out):
    """SPDESimulation (energy QoI) through Sampler -> DeviceBatchPool ->
    DeviceMemory, one allocation round, the mean in the Quantity algebra,
    Legendre moments by kernels C and D; returns the estimate."""
    from mlmc_tpu_torch.quantity.quantity_estimate import estimate_mean
    from mlmc_tpu_torch.sim import spde

    P, S = E2["stored"], E2["spde"]
    T = S["T"]
    sim = mt.SPDESimulation(dict(model=mt.stochastic_heat(1.0, 1.0), total_time=T))
    levels = [[1.0 / Nf, T / nf] for Nf, nf, _, _ in S["levels"]]
    storage = mt.DeviceMemory(device=dev)
    pool = mt.DeviceBatchPool(seed=SEED, device_results=True, max_batch=1 << 14,
                              device=dev)
    sampler = mt.Sampler(storage, pool, sim, levels)
    sampler.set_initial_n_samples(P["n"])
    t0 = time.perf_counter()
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    root = mt.make_root_quantity(storage, sim.result_format())
    energy = root["l2sq"][T]["-"][0]
    domain = mt.estimate_domain(energy, storage, quantile=0.001)
    est = mt.Estimate(energy, storage, mt.Legendre(P["moments"], domain))
    raw, ns = est.estimate_diff_vars_fast()                          # kernel C
    _require(np.all(np.isfinite(raw[:, 1:])), "stored SPDE level variances %s" % raw)
    # the allocation for the energy's mean: its level variances (fine -
    # coarse of the stored pairs) and each level's N * n cell-steps as cost
    # (the log-quadratic regression takes one step per level, an SPDE
    # level has two, [dx, dt])
    v_energy = [float((p[0, :, 0] - (p[0, :, 1] if p.shape[2] > 1 else 0)).double().var())
                for p in storage.sample_pairs()]
    cost = [float(Nf * nf) for Nf, nf, _, _ in S["levels"]]
    n_est = mt.estimate_n_samples_for_target_variance(
        P["target"], np.asarray(v_energy)[:, None], cost, n_levels=sampler.n_levels)
    t0 = time.perf_counter()
    sampler.process_adding_samples(n_est, 0, 1.0)
    sampler.ask_sampling_pool_for_samples()
    torch.cuda.synchronize()
    alloc_s = time.perf_counter() - t0
    qm = estimate_mean(energy)
    mean = float(np.asarray(qm.mean).ravel()[0])
    mvar = float(np.asarray(qm.var).ravel()[0])
    exact = spde.discrete_heat_l2_moment(1.0, 1.0, T, 128, 256)
    _require(abs(mean - exact) <= 6 * np.sqrt(mvar), "stored SPDE energy %.6g vs the discrete "
             "law %.6g: > 6 se (%.3g)" % (mean, exact, np.sqrt(mvar)))
    fast_mean, _ = est.estimate_moments_fast()                       # kernel C
    ext_mean, ext_var = est.estimate_moments_extended()              # kernel D
    _require(fast_mean[0] == 1.0 and ext_mean[0] == 1.0 and np.all(np.isfinite(ext_var)),
             "stored SPDE moments: mean[0] %r / %r" % (fast_mean[0], ext_mean[0]))
    out["stored_spde"] = dict(n_initial=P["n"], level_variances=v_energy,
                              n_estimated=np.asarray(n_est).tolist(),
                              n_collected=storage.get_n_collected(), sample_s=sample_s,
                              allocation_s=alloc_s, mean=mean, mean_var=mvar,
                              discrete_closed_form=exact, domain=list(domain),
                              moments_fast_vs_f64=float(np.max(np.abs(fast_mean - ext_mean))))
    print("stored SPDE run (energy, levels (32, 16) (64, 64) (128, 256)): %s samples in %.3f "
          "s, allocation for %g: %s, %s collected after it (%.3f s); the mean in the Quantity "
          "algebra %.6g vs the discrete law %.6g (se %.3g); Legendre(%d) fast vs f64 tier "
          "max |mean diff| %.3g"
          % (P["n"], sample_s, P["target"], np.asarray(n_est).tolist(),
             storage.get_n_collected(), alloc_s, mean, exact, np.sqrt(mvar), P["moments"],
             out["stored_spde"]["moments_fast_vs_f64"]))
    return est


def e2_path(torch, dev):
    """The remaining path simulations and their first users (slice E2),
    each phase traced for its device events and idle share; kernels C and
    D at the transport streams and the stored SPDE run; returns the path's
    launch counts and the kernels' errors at its streams."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    out = {"path": "e2"}
    run = lambda key, label, fn, whole=True: _e2_phase(
        torch, out, key, label, lambda: fn(torch, dev, mt, out), whole)
    with Phase(torch, "e2 path") as whole:
        run("spde", "a. SPDE stochastic heat telescope", _e2_spde)
        run("reactions", "b. dimerization tau-leap and exact SSA", _e2_reactions)
        est_t = run("transport", "c. transport batch, sharded pool, Estimate, MUSCL",
                    _e2_transport, False)
        run("american", "d. Longstaff-Schwartz, duals, Heston, mesh", _e2_american, False)
        run("bsde", "e. BSDE", _e2_bsde)
        run("sensitivity", "f. Sobol' indices and active subspace", _e2_sensitivity)
        run("nested", "g. unbiased nested EVPPI", _e2_nested, False)
        est_s = run("stored_spde", "h. the stored SPDE run (kernels C and D)",
                    _e2_stored_spde)
        counts = {**ck.launch_counts(), **cx.launch_counts()}
    out.update(seconds=whole.seconds, launches=counts,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print("e2 path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, out["peak_memory_gb"]))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by the e2 path" % name)
    with Phase(torch, "kernels C/D vs plain at the e2 streams"):
        errs_t = _streams_vs_plain(torch, dev, est_t, "the transport streams (40 QoI)",
                                   components=range(40))
        errs_s = _streams_vs_plain(torch, dev, est_s, "the stored SPDE streams")
    print(json.dumps(out))
    return counts, {"samples_mlmc": max(errs_t[0], errs_s[0]),
                    "samples_ext": max(errs_t[1], errs_s[1])}


# ------------------------------------------------------------------------ #
# the e3 path: the drivers beyond MLMC, multilevel MCMC and design
# ------------------------------------------------------------------------ #
# the sizes of bench_extra.py's bench_mimc, bench_mimc_darcy, bench_mfmc,
# bench_mlblue, bench_risk, bench_mcmc and bench_oed
E3 = dict(
    heat=dict(sigma=0.5, n0=(4, 4), total_time=0.25),
    # bench_mimc's chunk is 2^12: each chunk is a few hundred launches per
    # corner, so the card takes 2^14 (2^15 for the synthetic check)
    mimc_heat=dict(level=4, chunk=1 << 14, target=1e-9, seed=3, work_keys=4096,
                   synth_target=1e-6, synth_chunk=1 << 15),
    # bench_mimc_darcy runs float32 with cg_tol=1e-6 (the TPU has no f64); here
    # float64 at the value function's default cg_tol=1e-10
    mimc_darcy=dict(chunk=1 << 9, target=1e-8, bias_tol=3e-4, n_pilot=1 << 9,
                    max_indices=16, seed=3, work_keys=512),
    mfmc=dict(fidelities=[(3, 3), (1, 1), (0, 0)], pilot=1 << 13, budget=5e5,
              chunk=1 << 12, seed=2, synth_costs=[1.0, 0.05, 0.01], synth_budget=1e5),
    mlblue=dict(budget=5e5, pilot=1 << 13, chunk=1 << 12, seed=4),
    # bench_risk's chunk is 2^13: the CDF stage draws ~2.5e7 level-0 pairs
    # (the grid's worst point has F(1 - F) ~ 1/4 against a target of 1e-8),
    # 3000 chunks of launches; 2^17 here. The hedge takes 100 of the
    # bench's 250 steps (the ratio settles within ~30)
    risk=dict(levels=[1 / 4, 1 / 16, 1 / 64, 1 / 256], alpha=0.95, target_se=2e-3,
              bandwidth=[0.08, 0.04, 0.02, 0.01], chunk=1 << 17, seed=7,
              hedge_alpha=0.9, n_per_level=[4096, 2048, 1024, 512], n_steps=100,
              smoothing=0.01, strike=1.0, premium=0.08),
    # bench_mcmc runs [4000, 600, 300] steps; a step is one batched CG solve
    # per level (~24 ms, launch-bound), so the card takes [600, 200, 100]
    # (level 0 cut first); MLDA 50 steps, the unbiased pairs 150
    mcmc=dict(level_ns=[16, 32, 64], n_modes=64, noise=0.02, chains=256,
              n_steps=[600, 200, 100], seed=8, data_seed=3, side_chains=64,
              fixed_point_steps=20, mlda_steps=50, mlda_sub=4, unbiased_k=25,
              unbiased_m=50),
    oed=dict(n_modes=8, noise=0.05, n_outer=1024, n_inner=256, chunk=1024, block=64,
             seed=3, linear_outer=1 << 14, linear_target=1e-4),
    moments=10,
)


def _mimc_work_ratio(torch, dev, fn, index_set, depth, n_keys):
    """bench_mimc's optimal-work ratio of MIMC over ``index_set`` against
    diagonal MLMC to ``depth`` on ``n_keys`` shared samples, with the cost
    model nx * ny (or nx * nt) = 2^(a0 + a1)."""
    from mlmc_tpu_torch import mimc
    from mlmc_tpu_torch.random.keyed import SampleKeys

    keys = SampleKeys(2, 0, torch.arange(n_keys, device=dev))
    cost = lambda a: 2.0 ** (a[0] + a[1])
    mimc_sum = sum(np.sqrt(float(sum(s * fn(c, keys) for c, s in
                                     mimc.mixed_difference_terms(a)).var()) * cost(a))
                   for a in map(tuple, index_set))
    mlmc_sum, prev = 0.0, None
    for lev in range(depth + 1):
        cur = fn((lev, lev), keys)
        mlmc_sum += np.sqrt(float((cur if prev is None else cur - prev).var())
                            * cost((lev, lev)))
        prev = cur
    return mimc_sum ** 2 / mlmc_sum ** 2


def _e3_mimc_heat(torch, dev, mt, out):
    """bench_mimc: the heat equation over total_degree_set(2, 4) to 1e-9, the
    same run over SampleMesh([dev, dev]) bit for bit, the work ratio against
    diagonal MLMC, and the synthetic model against its exact telescope."""
    from mlmc_tpu_torch import mimc
    from mlmc_tpu_torch.parallel import SampleMesh

    P = E3["mimc_heat"]
    fn, d = mimc.heat_mimc_value_fn(**E3["heat"])
    iset = mimc.total_degree_set(d, P["level"])
    # costs by bench_mimc's work model nx * nt (the bench measures them), so
    # that the one-device and the mesh run allocate alike
    cost = lambda a: 2.0 ** (a[0] + a[1])

    def run(mesh, trace):
        m = mimc.MIMC(fn, iset, seed=P["seed"], cost_fn=cost, chunk_size=P["chunk"],
                      mesh=mesh, device=dev)
        warm = lambda: [m.extend(a, P["chunk"]) for a in iset]
        if trace:
            _e2_trace(torch, out, "mimc_heat", "the first chunk of every index", warm)
        else:
            warm()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = m.run(target_var=P["target"])
        return m, res, time.perf_counter() - t0

    m1, res, wall = run(None, True)
    m2, res2, wall2 = run(SampleMesh([dev, dev]), False)
    _require(res["target_met"], "MIMC heat: variance %.3g above %g" % (res["var"], P["target"]))
    _require(res["n_samples"].tolist() == res2["n_samples"].tolist()
             and all((m1._states[a].sum, m1._states[a].sum_sq)
                     == (m2._states[a].sum, m2._states[a].sum_sq) for a in iset)
             and res["mean"] == res2["mean"],
             "MIMC heat over [dev, dev] differs from one device")
    ratio = _mimc_work_ratio(torch, dev, fn, iset, P["level"], P["work_keys"])
    fs, _ = mimc.synth_mimc_value_fn(mean=1.0)
    ms = mimc.MIMC(fs, iset, seed=1, chunk_size=P["synth_chunk"], device=dev)
    rs = ms.run(target_var=P["synth_target"])
    c, p1, p2, rho = 0.5, 1.0, 1.5, 0.5
    g = lambda a: 1.0 + c * (2.0 ** (-a[0] * p1) + 2.0 ** (-a[1] * p2)
                             + rho * 2.0 ** (-a[0] * p1 - a[1] * p2))
    telescope = sum(s * g(cn) for a in iset for cn, s in mimc.mixed_difference_terms(a))
    _require(rs["target_met"] and abs(rs["mean"] - telescope) <= 6 * np.sqrt(rs["var"]),
             "MIMC synthetic %.6g vs its telescope's exact mean %.6g (se %.3g)"
             % (rs["mean"], telescope, np.sqrt(rs["var"])))
    out["mimc_heat"].update(
        run_s=wall, mesh_run_s=wall2, mean=res["mean"], var=res["var"],
        n_total=int(res["n_samples"].sum()), n_indices=len(iset), rounds=res["rounds"],
        work_ratio_vs_diag_mlmc=ratio, synth_mean=rs["mean"],
        synth_se=float(np.sqrt(rs["var"])), synth_telescope=telescope,
        synth_limit_gap=abs(telescope - 1.0))
    print("MIMC heat, total degree %d (%d indices) to %g: mean %.8g, var %.3g, %d samples in "
          "%d rounds, %.3f s (over [dev, dev] %.3f s, sums equal bit for bit); work ratio vs "
          "diagonal MLMC %.3f; synthetic to %g: %.6g vs its telescope's exact mean %.6g (se "
          "%.3g; the telescope sits %.3g from the limit 1)"
          % (P["level"], len(iset), P["target"], res["mean"], res["var"],
             res["n_samples"].sum(), res["rounds"], wall, wall2, ratio,
             P["synth_target"], rs["mean"], telescope,
             np.sqrt(rs["var"]), abs(telescope - 1.0)))


def _e3_mimc_darcy(torch, dev, mt, out):
    """bench_mimc_darcy: anisotropic Darcy MIMC, adaptive index growth, float64."""
    from mlmc_tpu_torch import mimc

    P = E3["mimc_darcy"]
    fn, _ = mimc.darcy_mimc_value_fn(sigma=1.0, corr_length=0.3, n0=(4, 4))
    m = mimc.MIMC(fn, [(0, 0)], seed=P["seed"], chunk_size=P["chunk"], device=dev)
    _e2_trace(torch, out, "mimc_darcy", "the first pilot chunk at (0, 0)",
              lambda: m.extend((0, 0), P["n_pilot"]))
    t0 = time.perf_counter()
    res = m.run_adaptive(target_var=P["target"], bias_tol=P["bias_tol"],
                         n_pilot=P["n_pilot"], max_indices=P["max_indices"])
    wall = time.perf_counter() - t0
    _require(res["target_met"], "Darcy MIMC: variance %.3g above %g" % (res["var"],
                                                                        P["target"]))
    depth = int(max(max(a) for a in res["index_set"]))
    ratio = _mimc_work_ratio(torch, dev, fn, res["index_set"], depth, P["work_keys"])
    out["mimc_darcy"].update(
        run_s=wall, mean=res["mean"], var=res["var"], n_total=int(res["n_samples"].sum()),
        index_set=[list(a) for a in res["index_set"]], depth=depth,
        target_met=res["target_met"], bias_converged=res["bias_converged"],
        bias_est=res["bias_est"], work_ratio_vs_diag_mlmc=ratio)
    print("MIMC Darcy (float64, cg_tol 1e-10), adaptive to %g: mean %.8g, var %.3g, %d "
          "samples, %.3f s; target met %s, bias converged %s (frontier bias %.3g vs %g); "
          "%d indices, depth %d: %s; work ratio vs diagonal MLMC %.3f"
          % (P["target"], res["mean"], res["var"], res["n_samples"].sum(), wall,
             res["target_met"], res["bias_converged"], res["bias_est"], P["bias_tol"],
             len(res["index_set"]), depth, [tuple(a) for a in res["index_set"]], ratio))


def _heat_fidelities(mimc):
    fn, _ = mimc.heat_mimc_value_fn(**E3["heat"])
    fids = E3["mfmc"]["fidelities"]
    return ([lambda keys, a=a: fn(a, keys) for a in fids],
            [2.0 ** (a0 + a1) for a0, a1 in fids])


def _e3_mfmc(torch, dev, mt, out):
    """bench_mfmc: the heat fidelities; the synthetic family against its law."""
    from mlmc_tpu_torch import mimc, multifidelity

    P = E3["mfmc"]
    models, costs = _heat_fidelities(mimc)
    mf = multifidelity.MFMC(models, costs=costs, seed=P["seed"], chunk_size=P["chunk"],
                            device=dev)
    st = _e2_trace(torch, out, "mfmc", "the pilot of %d" % P["pilot"],
                   lambda: mf.pilot(P["pilot"]))
    t0 = time.perf_counter()
    res = mf.estimate(budget=P["budget"])
    wall = time.perf_counter() - t0
    _require(np.isfinite(res["mean"]) and res["var"] > 0, "MFMC heat: %s" % res)
    ms = multifidelity.MFMC(multifidelity.synth_fidelity_models(), costs=P["synth_costs"],
                            seed=5, chunk_size=P["chunk"], device=dev)
    ss = ms.pilot(P["pilot"])
    rs = ms.estimate(budget=P["synth_budget"])
    rhos = (0.95, 0.8)
    se_rho = [(1 - r * r) / np.sqrt(ss["n_pilot"]) for r in rhos]
    _require(abs(rs["mean"] - 1.0) <= 6 * np.sqrt(rs["var"])
             and all(abs(g - r) <= 6 * s for g, r, s in zip(ss["rho"][1:], rhos, se_rho)),
             "MFMC synthetic: mean %.6g (se %.3g), pilot rho %s vs %s"
             % (rs["mean"], np.sqrt(rs["var"]), ss["rho"][1:], rhos))
    out["mfmc"].update(estimate_s=wall, rho=st["rho"].tolist(), subset=list(res["subset"]),
                       m=res["m"].tolist(), mean=res["mean"], var=res["var"],
                       speedup_vs_mc=res["speedup"], synth_mean=rs["mean"],
                       synth_se=float(np.sqrt(rs["var"])), synth_rho=ss["rho"][1:].tolist())
    print("MFMC heat fidelities %s: pilot rho %s, subset %s, m %s, mean %.8g (var %.3g), "
          "speedup vs MC %.1f, estimate %.3f s; synthetic: %.6g vs 1 (se %.3g), pilot rho "
          "%s vs %s" % (P["fidelities"], np.round(st["rho"], 4).tolist(), list(res["subset"]),
                        res["m"].tolist(), res["mean"], res["var"], res["speedup"], wall,
                        rs["mean"], np.sqrt(rs["var"]), np.round(ss["rho"][1:], 4).tolist(),
                        rhos))
    return res


def _e3_mlblue(torch, dev, mt, out, mfmc_res):
    """bench_mlblue: the heat fidelity groups at the same budget."""
    from mlmc_tpu_torch import mimc

    P = E3["mlblue"]
    models, costs = _heat_fidelities(mimc)
    res = _e2_trace(torch, out, "mlblue", "the whole estimate", lambda: mt.mlblue(
        models, costs, budget=P["budget"], seed=P["seed"], n_pilot=P["pilot"],
        chunk_size=P["chunk"], device=dev))
    gap = abs(res["mean"] - mfmc_res["mean"])
    _require(res["var"] > 0 and gap <= 6 * np.sqrt(res["var"] + mfmc_res["var"]),
             "MLBLUE %.8g vs MFMC %.8g: > 6 se apart" % (res["mean"], mfmc_res["mean"]))
    out["mlblue"].update(mean=res["mean"], var=res["var"], mlmc_var=res["mlmc_var"],
                         efficiency_vs_mlmc=res["efficiency_vs_mlmc"],
                         n_per_group=res["n_per_group"].tolist(),
                         n_evaluations=res["n_evaluations"])
    print("MLBLUE heat groups, budget %g: mean %.8g (var %.3g; MFMC's %.8g), efficiency vs "
          "MLMC %.2f, n per group %s, %d evaluations"
          % (P["budget"], res["mean"], res["var"], mfmc_res["mean"],
             res["efficiency_vs_mlmc"], res["n_per_group"].tolist(), res["n_evaluations"]))


def _lognormal_tail(rate, sigma, alpha):
    """VaR and CVaR at ``alpha`` of the loss -S_T, S_T lognormal (S_0 = 1, T = 1)."""
    import scipy.stats as st

    mu_ln = rate - 0.5 * sigma ** 2
    z = st.norm.ppf(1 - alpha)
    return (-np.exp(mu_ln + sigma * z),
            -np.exp(mu_ln + 0.5 * sigma ** 2) * st.norm.cdf(z - sigma) / (1 - alpha))


def _e3_risk(torch, dev, mt, out):
    """bench_risk: VaR/CVaR of the GBM loss at MLMC cost against the lognormal
    closed forms; the CVaR-optimal put hedge."""
    from mlmc_tpu_torch import risk
    from mlmc_tpu_torch.random.keyed import SampleKeys
    from mlmc_tpu_torch.sim.sde import SDESimulation, gbm, terminal_value

    P = E3["risk"]
    sim = SDESimulation(dict(model=gbm(RATE, SIGMA, 1.0), payoff=terminal_value()))
    fwd_pair, L = mt.simulation_pair_fn(sim, [[h] for h in P["levels"]])

    def loss_pair(level, keys):
        f, c, v = fwd_pair(level, keys)
        return -f, -c, v

    _e2_trace(torch, out, "risk", "one chunk of the finest level",
              lambda: fwd_pair(L - 1, SampleKeys(P["seed"], L - 1,
                                                 torch.arange(P["chunk"], device=dev))))
    t0 = time.perf_counter()
    res = risk.cvar_mlmc(loss_pair, L, P["alpha"], target_se=P["target_se"],
                         bandwidth=P["bandwidth"], kernel_order=4, chunk_size=P["chunk"],
                         seed=P["seed"], cost_fn=lambda lv: 4.0 ** lv, device=dev)
    wall = time.perf_counter() - t0
    var_x, cvar_x = _lognormal_tail(RATE, SIGMA, P["alpha"])
    _require(abs(res["var"] - var_x) <= 6 * res["var_se"]
             and abs(res["cvar"] - cvar_x) <= 6 * res["cvar_se"],
             "VaR %.6g vs %.6g (se %.3g), CVaR %.6g vs %.6g (se %.3g)"
             % (res["var"], var_x, res["var_se"], res["cvar"], cvar_x, res["cvar_se"]))
    K, premium = P["strike"], P["premium"]

    def hedged(level, theta, keys):
        f, c, v = fwd_pair(level, keys)
        f, c = f.double(), c.double()
        h = theta[0]
        return (-(f + h * torch.clamp(K - f, min=0.0)) + premium * h,
                -(c + h * torch.clamp(K - c, min=0.0)) + premium * h, v)

    t0 = time.perf_counter()
    opt = risk.optimize_cvar(hedged, np.array([0.0]), alpha=P["hedge_alpha"], n_levels=L,
                             n_per_level=P["n_per_level"], n_steps=P["n_steps"],
                             smoothing=P["smoothing"], seed=8, device=dev)
    opt_s = time.perf_counter() - t0
    _, unhedged = _lognormal_tail(RATE, SIGMA, P["hedge_alpha"])
    _require(opt["cvar"] <= unhedged, "hedged CVaR %.6g above the unhedged %.6g"
             % (opt["cvar"], unhedged))
    out["risk"].update(cvar_s=wall, var=res["var"], var_exact=var_x, var_se=res["var_se"],
                       cvar=res["cvar"], cvar_exact=cvar_x, cvar_se=res["cvar_se"],
                       n_per_level=res["n_per_level"].tolist(), rounds=res["rounds"],
                       hedge_ratio=float(opt["theta"][0]), hedge_cvar=opt["cvar"],
                       unhedged_cvar=unhedged, hedge_t=opt["t"], optimize_s=opt_s,
                       optimize_steps=P["n_steps"])
    print("GBM loss at %g: VaR %.6g vs %.6g (se %.3g), CVaR %.6g vs %.6g (se %.3g), n per "
          "level %s, %d rounds, %.3f s; CVaR_%g hedge: ratio %.4f, CVaR %.6g vs unhedged "
          "%.6g, %d steps in %.3f s"
          % (P["alpha"], res["var"], var_x, res["var_se"], res["cvar"], cvar_x,
             res["cvar_se"], res["n_per_level"].tolist(), res["rounds"], wall,
             P["hedge_alpha"], float(opt["theta"][0]), opt["cvar"], unhedged,
             P["n_steps"], opt_s))


def _f32_qoi(fn):
    """``fn`` with its QoI rounded to float32 values (kept float64): the
    packed streams of kernels C and D are float32, so phase h's sums then
    see the chains' values exactly."""
    def wrapped(theta):
        ll, q = fn(theta)
        return ll, q.float().double()
    return wrapped


def _e3_mcmc(torch, dev, mt, out):
    """bench_mcmc: multilevel MCMC on the Darcy inverse problem, the CRN fixed
    point, MLDA at 16/32 and the unbiased pairs at 16; returns MLMCMC's
    result."""
    from mlmc_tpu_torch import mcmc

    P = E3["mcmc"]
    prob = mcmc.make_darcy_inverse(P["level_ns"], n_modes=P["n_modes"], sigma=1.0,
                                   noise_std=P["noise"])
    _, _, data = prob["synthetic"](P["data_seed"], device=dev)
    fns = [_f32_qoi(f) for f in prob["loglik_qoi_fns"](data)]
    d = prob["d"]
    ml = mcmc.MLMCMC(fns, d=d)
    _e2_trace(torch, out, "mcmc", "3 steps of every level (256 chains)",
              lambda: ml.run(n_steps=[3] * 3, n_chains=P["chains"], burn=0, seed=0,
                             device=dev))
    res = ml.run(n_steps=P["n_steps"], n_chains=P["chains"], seed=P["seed"], device=dev)
    rs = res["results"]
    solves = sum(r.n_forward if hasattr(r, "n_forward") else r.n_forward_f + r.n_forward_c
                 for r in rs)
    th_hat = torch.as_tensor(rs[0].theta.mean(axis=0), device=dev)[None]
    misfit_fit = -float(fns[-1](th_hat)[0][0])
    misfit_prior = -float(fns[-1](torch.zeros_like(th_hat))[0][0])
    _require(misfit_fit < 0.1 * misfit_prior, "posterior-mean misfit %.4g vs the prior's "
             "%.4g" % (misfit_fit, misfit_prior))
    _require(all(0.0 < a < 1.0 for a in res["acc_rates"]),
             "acceptance rates %s" % res["acc_rates"])
    beta = rs[0].beta
    fixed = mcmc.run_coupled(fns[0], fns[0], d, P["fixed_point_steps"],
                             n_chains=P["side_chains"], beta=beta, seed=1, device=dev)
    _require(np.all(fixed.diff == 0.0) and fixed.glued_rate == 1.0,
             "CRN fixed point: max |diff| %.3g, glued %.3f"
             % (np.abs(fixed.diff).max(), fixed.glued_rate))
    t0 = time.perf_counter()
    mlda = mcmc.run_mlda(fns[:2], d, P["mlda_steps"], n_chains=P["side_chains"],
                         subsamples=P["mlda_sub"], beta=beta, seed=2, device=dev)
    mlda_s = time.perf_counter() - t0
    _require(0.0 < mlda.acc_rate < 1.0 and np.all(np.isfinite(mlda.mean)),
             "MLDA: acceptance %.3f, mean %s" % (mlda.acc_rate, mlda.mean))
    t0 = time.perf_counter()
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", RuntimeWarning)
        unb = mcmc.run_unbiased(fns[0], d, k=P["unbiased_k"], m=P["unbiased_m"],
                                n_pairs=P["side_chains"], beta=beta, seed=3, device=dev)
    unb_s = time.perf_counter() - t0
    met = unb["tau"][unb["tau"] >= 0]
    _require(np.all(np.isfinite(unb["H"])), "unbiased MCMC: non-finite H")
    out["mcmc"].update(
        wall_s=res["wall_s"], pde_solves=int(solves), solves_per_s=solves / res["wall_s"],
        flux_mean=float(res["mean"][0]), flux_se=float(res["se"][0]),
        level_means=[float(m[0]) for m in res["level_means"]],
        level_ses=[float(s[0]) for s in res["level_ses"]], acc_rates=res["acc_rates"],
        mismatch_rates=[r.mismatch_rate for r in rs[1:]], ess_level0=rs[0].ess,
        rhat_level0=rs[0].rhat, beta=beta, misfit_fit_vs_prior=[misfit_fit, misfit_prior],
        mlda_s=mlda_s, mlda_acc=mlda.acc_rate, mlda_mean=float(mlda.mean[0]),
        unbiased_s=unb_s, unbiased_mean=float(unb["mean"][0]),
        unbiased_se=float(unb["se"][0]), unbiased_frac_unmet=unb["frac_unmet"],
        unbiased_tau_median=float(np.median(met)) if met.size else None,
        unbiased_warned=bool(caught))
    print("MLMCMC Darcy 16/32/64, %d chains, steps %s: %.3f s, %d PDE solves (%.4g/s); flux "
          "%.6g (se %.3g), level means %s, acceptance %s, mismatch %s, level-0 ESS %.1f, "
          "R-hat %.3f, beta %.4g; misfit at the posterior mean %.4g vs the prior's %.4g; CRN "
          "fixed point exactly zero over %d steps; MLDA 16/32 (%d chains, %d steps, %d "
          "sub-steps): acceptance %.3f, flux %.6g, %.3f s; unbiased pairs at 16 (k %d, m %d): "
          "flux %.6g (se %.3g), %.1f%% unmet, median tau %s, %.3f s"
          % (P["chains"], P["n_steps"], res["wall_s"], solves, solves / res["wall_s"],
             res["mean"][0], res["se"][0], [float("%.6g" % m[0]) for m in res["level_means"]],
             ["%.3f" % a for a in res["acc_rates"]],
             ["%.4f" % r.mismatch_rate for r in rs[1:]], rs[0].ess, rs[0].rhat, beta,
             misfit_fit, misfit_prior, P["fixed_point_steps"], P["side_chains"],
             P["mlda_steps"], P["mlda_sub"], mlda.acc_rate, mlda.mean[0], mlda_s,
             P["unbiased_k"], P["unbiased_m"], unb["mean"][0], unb["se"][0],
             100 * unb["frac_unmet"], out["mcmc"]["unbiased_tau_median"], unb_s))
    return res


def _e3_oed(torch, dev, mt, out):
    """bench_oed: the spread and cluster designs by nested-MC EIG; a linear
    forward against the closed form by eig_nmc and the unbiased EIG."""
    from mlmc_tpu_torch import mcmc, oed

    P = E3["oed"]
    torch.cuda.reset_peak_memory_stats(dev)
    g = np.linspace(0.2, 0.8, 3)
    c = np.linspace(0.45, 0.55, 3)
    designs = {"spread": [[x, y] for x in g for y in g],
               "cluster": [[x, y] for x in c for y in c]}
    results = {}
    for name, pts in designs.items():
        prob = mcmc.make_darcy_inverse([16], n_modes=P["n_modes"], sigma=1.0,
                                       obs_points=pts, noise_std=P["noise"])
        fwd = lambda th, prob=prob: prob["forward"](th, 16)[0]
        call = lambda: oed.eig_nmc(fwd, P["noise"], prob["d"], n_outer=P["n_outer"],
                                   n_inner=P["n_inner"], seed=P["seed"],
                                   chunk_size=P["chunk"], block=P["block"], device=dev)
        t0 = time.perf_counter()
        res = (_e2_trace(torch, out, "oed", "the spread design's EIG", call)
               if name == "spread" else call())
        results[name] = dict(eig=res["eig"], se=res["se"], pde_solves=res["n_forward"],
                             wall_s=time.perf_counter() - t0)
    better = max(results, key=lambda k: results[k]["eig"])
    sep = abs(results["spread"]["eig"] - results["cluster"]["eig"]) / np.hypot(
        results["spread"]["se"], results["cluster"]["se"])
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    G = 0.25 * np.random.default_rng(SEED).normal(size=(3, 4))
    Gt = torch.tensor(G, device=dev)
    lin = lambda th: th @ Gt.T
    exact = oed.linear_gaussian_eig(G, 0.5)
    runs = [oed.eig_nmc(lin, 0.5, 4, n_outer=P["linear_outer"], n_inner=n, seed=5,
                        chunk_size=P["chunk"], device=dev) for n in (P["n_inner"] // 2,
                                                                   P["n_inner"])]
    bias = max(runs[0]["eig"] - runs[1]["eig"], 0.0)
    t0 = time.perf_counter()
    unb = oed.expected_information_gain(lin, 0.5, 4, target_var=P["linear_target"], seed=6,
                                        device=dev)
    unb_s = time.perf_counter() - t0
    _require(abs(runs[1]["eig"] - exact) <= 6 * runs[1]["se"] + bias
             and unb["target_met"] and abs(unb["mean"] - exact) <= 6 * unb["se"],
             "linear EIG %.6g: nmc %.6g (se %.3g, bias allowance %.3g), unbiased %.6g (se "
             "%.3g)" % (exact, runs[1]["eig"], runs[1]["se"], bias, unb["mean"], unb["se"]))
    out["oed"].update(designs=results, preferred=better, separation_sigmas=sep,
                      peak_memory_gb=peak, linear_exact=exact, linear_nmc=runs[1]["eig"],
                      linear_nmc_se=runs[1]["se"], linear_nmc_bias=bias,
                      linear_unbiased=unb["mean"], linear_unbiased_se=unb["se"],
                      linear_unbiased_s=unb_s, linear_unbiased_levels=len(unb["levels"]))
    print("OED Darcy 16^2 (%d-d prior), %d outer x %d inner, block %d: spread %.4f (se %.4f, "
          "%.3f s), cluster %.4f (se %.4f, %.3f s): %s preferred by %.1f sigma; peak device "
          "memory %.3f GB; linear design: closed form %.6g, nmc %.6g (se %.3g, bias %.3g), "
          "unbiased %.6g (se %.3g, levels 0..%d, %.3f s)"
          % (2 * P["n_modes"], P["n_outer"], P["n_inner"], P["block"],
             results["spread"]["eig"], results["spread"]["se"], results["spread"]["wall_s"],
             results["cluster"]["eig"], results["cluster"]["se"],
             results["cluster"]["wall_s"], better, sep, peak, exact, runs[1]["eig"],
             runs[1]["se"], bias, unb["mean"], unb["se"], len(unb["levels"]) - 1, unb_s))


def _e3_stored_mcmc(torch, dev, mt, out, res):
    """The post-burn MCMC series in a three-level DeviceMemory: Estimate's fast
    tier (kernel C variances, kernel D means), and kernel D's level sums of
    phi_1(fine) - phi_1(coarse) against MLMCMC's level means; returns the
    estimate."""
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
    from mlmc_tpu_torch.tags import TagRange

    rs = res["results"]
    pairs = [(rs[0].qoi.reshape(-1), None)] + [(r.qoi_f.reshape(-1), r.qoi_c.reshape(-1))
                                              for r in rs[1:]]
    spec = [QuantitySpec(name="flux", unit="m^3/s", shape=(1,), times=[0],
                         locations=["outflow"])]
    storage = mt.DeviceMemory(device=dev)
    storage.save_global_data(result_format=spec,
                             level_parameters=[[1.0 / n] for n in E3["mcmc"]["level_ns"]])
    for lv, (f, c) in enumerate(pairs):
        f = torch.as_tensor(f, device=dev)[:, None]
        c = torch.zeros_like(f) if c is None else torch.as_tensor(c, device=dev)[:, None]
        storage.save_scheduled_samples(lv, TagRange(lv, 0, f.shape[0]))
        storage.save_samples_bulk(lv, TagRange(lv, 0, f.shape[0]), f, c)
    values = np.concatenate([np.concatenate([f, c]) if c is not None else f
                             for f, c in pairs])
    lo, hi = float(values.min()), float(values.max())
    domain = (lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo))
    root = mt.make_root_quantity(storage, spec)
    flux = root["flux"][0]["outflow"][0]
    est = mt.Estimate(flux, storage, mt.Legendre(E3["moments"], domain))
    raw, ns = est.estimate_diff_vars_fast()                          # kernel C
    mean, var = est.estimate_moments_extended()                      # kernel D
    _require(ns.tolist() == [len(f) for f, _ in pairs] and mean[0] == 1.0
             and np.all(np.isfinite(raw[:, 1:])) and np.all(np.isfinite(var)),
             "stored MCMC estimate: n %s, mean[0] %r" % (ns.tolist(), mean[0]))
    scale, shift, offset = ck.transform_constants(domain, f64=True)[:3]
    levels = est._stream_results(est._moments_fn, [0], f64=True)       # kernel D
    got = []
    for lv in range(levels.n_valid.shape[0]):
        m1 = float(levels.sums[lv, 0, 1]) / float(levels.n_valid[lv, 0])
        got.append((m1 - offset) / scale + shift if lv == 0 else m1 / scale)
    want = [float(m[0]) for m in res["level_means"]]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    _require(max(rel) <= 1e-12, "kernel D's level means %s vs MLMCMC's %s (rel %s)"
             % (got, want, rel))
    out.setdefault("stored_mcmc", {}).update(n_samples=ns.tolist(), domain=list(domain),
                              level_means_kernel_d=got, level_means_mlmcmc=want,
                              level_mean_rel_err=rel, level_diff_vars_iid=raw[:, 1].tolist())
    print("stored MCMC series (levels %s samples, flux QoI rounded to float32 in the "
          "chains): kernel C level variances of phi_1 %s and kernel D means; kernel D's "
          "level means %s vs MLMCMC's %s, rel %s (tol 1e-12). The variances treat the "
          "series as iid samples: they are no posterior standard error (the chains are "
          "autocorrelated)"
          % (ns.tolist(), ["%.3g" % v for v in raw[:, 1]], ["%.10g" % v for v in got],
             ["%.10g" % v for v in want], ["%.2g" % r for r in rel]))
    return est


def e3_path(torch, dev):
    """The drivers beyond MLMC (MIMC, MFMC, MLBLUE, risk), multilevel MCMC and
    design (slice E3), each phase with its wall and its main batch's device
    events and idle share; kernels C and D on the stored MCMC series; returns
    the path's launch counts and the kernels' errors at its streams."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.precision import EPS64, extended_bound_constant

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    out = {"path": "e3"}
    run = lambda key, label, fn, *args, whole=False: _e2_phase(
        torch, out, key, label, lambda: fn(torch, dev, mt, out, *args), whole)
    with Phase(torch, "e3 path") as whole:
        run("mimc_heat", "a. MIMC heat, mesh, work ratio, synthetic", _e3_mimc_heat)
        run("mimc_darcy", "b. MIMC Darcy, adaptive, float64", _e3_mimc_darcy)
        mf = run("mfmc", "c. MFMC", _e3_mfmc)
        run("mlblue", "d. MLBLUE", _e3_mlblue, mf)
        run("risk", "e. VaR/CVaR and the CVaR hedge", _e3_risk)
        res = run("mcmc", "f. MLMCMC, CRN fixed point, MLDA, unbiased", _e3_mcmc)
        run("oed", "g. OED", _e3_oed)
        est = run("stored_mcmc", "h. the stored MCMC series (kernels C and D)",
                  _e3_stored_mcmc, res, whole=True)
        counts = {**ck.launch_counts(), **cx.launch_counts()}
    out.update(seconds=whole.seconds, launches=counts,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print("e3 path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, out["peak_memory_gb"]))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by the e3 path" % name)
    with Phase(torch, "kernels C/D vs plain at the stored MCMC streams"):
        errs = _streams_vs_plain(torch, dev, est, "the stored MCMC streams")
        mfn = est._moments_fn
        streams = est._packed_streams(mfn, [0])
        consts = ck.transform_constants(mfn.domain, f64=True)
        got = cx.samples_ext_cuda(streams, mfn.size, basis="legendre", consts=consts,
                                  device=dev)
        plain, s_abs = (cx.samples_ext_plain(streams, mfn.size, basis="legendre",
                                             consts=consts, absolute=a) for a in (False, True))
        bound = EPS64 * extended_bound_constant()
        _, rel = _compare(torch, got, plain, s_abs, "kernel D at the stored MCMC streams",
                          rtol=bound)
        print("kernel D at the stored MCMC streams within its derived bound %.3g * S_abs: "
              "max / S_abs %.3g" % (bound, rel))
    print(json.dumps(out))
    return counts, {"samples_mlmc": errs[0], "samples_ext": errs[1]}


# ------------------------------------------------------------------------ #
# the e45 path (slices E4-E5): inference and surrogates
# ------------------------------------------------------------------------ #
E45 = dict(
    # bench_bayes_compact's 3-d linear-Gaussian problem (noise-free data)
    linear=dict(d=3, K=5, noise=0.5, seed=0),
    esmda=dict(n_ens=2048, n_steps=4, seed=1, darcy_ens=128, darcy_steps=6),
    darcy=dict(level_ns=[16, 32, 64], n_modes=64, noise=0.02, data_seed=3),
    smc=dict(n_particles=1024, n_moves=6, seed=2),
    rare=dict(gamma=4.0, n_particles=1024, n_moves=6, seed=3, ce_seed=4, n=32,
              n_modes=64, pilot=4096, darcy_particles=2048, log_sds=4.75),
    filter=dict(d=40, T=200, spin=100, ens=[64, 256, 1024], inflation=1.05, seed=5,
                kf_ens=2048, ml_ens=64, ml_R=8, ml_T=10),
    particle=dict(T=400, N=1 << 15, phi=0.98, sig=0.16, seed=6, ml_T=100, ml_r=0.5,
                  ml_counts=[1 << 15, 1 << 14, 1 << 13, 1 << 12], trace_T=40),
    pod=dict(n=32, rank=24, snapshots=64, held_out=256, costs=[1.0, 0.12], budget=3000.0,
             chunk=1 << 8, pilot=1 << 10, check=2048),
    colloc=dict(n=32, n_modes=4, levels=[2, 3, 4]),
    pce=dict(degree=3, n_fit=1024, costs=[1.0, 1e-3], budget=2e4, pilot=1 << 12,
             cv_n=1 << 14),
    gp=dict(n_init=10, n_iter=25),
    stored=dict(n0=1 << 16, n1=1 << 12, seed=11, moments=25),
)


def _e45_linear(torch, dev):
    """bench_bayes_compact's problem: (A [K, d] on the card, y, the
    conjugate posterior mean, log Z, the likelihood's constant)."""
    P = E45["linear"]
    rng = np.random.default_rng(P["seed"])
    A = rng.standard_normal((P["K"], P["d"]))
    y = A @ rng.standard_normal(P["d"])
    noise = P["noise"]
    sig = np.linalg.inv(np.eye(P["d"]) + A.T @ A / noise ** 2)
    mu = sig @ A.T @ y / noise ** 2
    S = A @ A.T + noise ** 2 * np.eye(P["K"])
    log_z = -0.5 * (P["K"] * np.log(2 * np.pi) + np.linalg.slogdet(S)[1]
                    + y @ np.linalg.solve(S, y))
    const = -0.5 * P["K"] * np.log(2 * np.pi * noise ** 2)
    return torch.tensor(A, device=dev), y, mu, float(log_z), const


_E45_DARCY = {}


def _e45_darcy(torch, dev, mt):
    """bench_bayes's Darcy inverse problem (16/32/64, 64 modes, 9 pressure
    observations) and its synthetic data; built once."""
    if not _E45_DARCY:
        P = E45["darcy"]
        prob = mt.make_darcy_inverse(P["level_ns"], n_modes=P["n_modes"], sigma=1.0,
                                     noise_std=P["noise"])
        _E45_DARCY.update(prob=prob, data=prob["synthetic"](P["data_seed"], device=dev)[2])
    return _E45_DARCY["prob"], _E45_DARCY["data"]


def _e45_esmda(torch, dev, mt, out):
    """a. ES-MDA: the linear problem against its conjugate posterior, and the
    hierarchical run on the 16/32/64 Darcy hierarchy."""
    P, noise = E45["esmda"], E45["linear"]["noise"]
    A, y, mu, _, _ = _e45_linear(torch, dev)
    t0 = time.perf_counter()
    cal = mt.esmda(lambda th: th @ A.T, y, noise, n_ens=P["n_ens"], n_steps=P["n_steps"],
                   d=A.shape[1], seed=P["seed"], device=dev)
    lin_s = time.perf_counter() - t0
    err = float(np.max(np.abs(cal["mean"] - mu)))
    _require(err < 0.1, "ES-MDA linear: posterior mean off by %.3g (tol 0.1)" % err)
    prob, data = _e45_darcy(torch, dev, mt)
    fwds = [lambda th, n=n: prob["forward"](th, n)[0] for n in prob["level_ns"]]
    hier = _e2_trace(torch, out, "esmda", "the hierarchical run (%d members, %d steps)"
                     % (P["darcy_ens"], P["darcy_steps"]),
                     lambda: mt.hierarchical_esmda(
                         fwds, data, E45["darcy"]["noise"], n_ens=P["darcy_ens"],
                         n_steps=P["darcy_steps"], d=prob["d"], seed=P["seed"],
                         device=dev))
    mis = hier["misfit"]
    _require(np.all(np.isfinite(mis)) and mis[-1] < mis[0],
             "hierarchical ES-MDA: the misfit did not fall: %s" % mis)
    out["esmda"].update(linear_mean_err=err, linear_s=lin_s, misfit=list(map(float, mis)),
                        n_forward=hier["n_forward"], hier_s=hier["wall_s"])
    print("ES-MDA linear (J %d, %d steps): max |mean - posterior mean| %.3g (tol 0.1), "
          "%.3f s; hierarchical 16/32/64 (J %d, %d steps): misfit %s, forwards per level "
          "%s, %.3f s" % (P["n_ens"], P["n_steps"], err, lin_s, P["darcy_ens"],
                          P["darcy_steps"], ["%.3g" % m for m in mis], hier["n_forward"],
                          hier["wall_s"]))


def _e45_smc(torch, dev, mt, out):
    """b. Tempered SMC: the linear problem's evidence within 6 se of the
    closed form; hierarchical SMC on the Darcy hierarchy."""
    P, noise = E45["smc"], E45["linear"]["noise"]
    A, y, _, log_z, const = _e45_linear(torch, dev)
    yt = torch.tensor(y, device=dev)

    def lin(th):
        r = th @ A.T - yt
        return const - 0.5 * (r * r).sum(1) / noise ** 2, th[:, :1]

    smc = mt.smc_tempering(lin, A.shape[1], n_particles=P["n_particles"],
                           n_moves=P["n_moves"], seed=P["seed"], device=dev)
    dev_sig = abs(smc["log_evidence"] - log_z) / smc["log_evidence_se"]
    _require(dev_sig < 6.0, "SMC linear: log Z %.5g vs %.5g, %.2f se"
             % (smc["log_evidence"], log_z, dev_sig))
    prob, data = _e45_darcy(torch, dev, mt)
    fns = prob["loglik_qoi_fns"](data)
    theta = torch.randn(P["n_particles"], prob["d"], dtype=torch.float64, device=dev,
                        generator=torch.Generator(dev).manual_seed(P["seed"]))
    _e2_trace(torch, out, "smc", "one 64^2 likelihood batch of %d particles"
              % P["n_particles"], lambda: fns[-1](theta))
    t0 = time.perf_counter()
    hs = mt.hierarchical_smc(fns, prob["d"], n_particles=P["n_particles"],
                             n_moves=P["n_moves"], seed=P["seed"], device=dev)
    hs_s = time.perf_counter() - t0
    solves = int(np.sum(hs["n_forward"]))
    log_norm = -0.5 * len(data) * np.log(2 * np.pi * E45["darcy"]["noise"] ** 2)
    _require(hs["lambdas"][-1] == 1.0 and np.isfinite(hs["log_evidence"])
             and np.all(np.isfinite(hs["mean"])), "hierarchical SMC: %s" % hs["lambdas"])
    out["smc"].update(linear_log_z=smc["log_evidence"], linear_log_z_exact=log_z,
                      linear_err_se=dev_sig, linear_stages=len(smc["acc_rates"]),
                      darcy_s=hs_s, darcy_stages=len(hs["acc_rates"]), darcy_solves=solves,
                      darcy_solves_per_s=solves / hs_s, n_forward=hs["n_forward"],
                      log_evidence=hs["log_evidence"] + log_norm,
                      log_evidence_se=hs["log_evidence_se"], flux_mean=float(hs["mean"][0]),
                      flux_se=float(hs["se"][0]), acc_final=hs["acc_rates"][-1])
    print("SMC linear (%d particles, %d moves): log Z %.5g vs exact %.5g (%.2f se, tol 6), "
          "%d stages; hierarchical 16/32/64: %.3f s, %d stages, %d solves (%.4g/s), log "
          "evidence %.4f (se %.3g), flux %.6g (se %.3g), final acceptance %.3f"
          % (P["n_particles"], P["n_moves"], smc["log_evidence"], log_z, dev_sig,
             len(smc["acc_rates"]), hs_s, len(hs["acc_rates"]), solves, solves / hs_s,
             hs["log_evidence"] + log_norm, hs["log_evidence_se"], hs["mean"][0],
             hs["se"][0], hs["acc_rates"][-1]))


def _e45_rare(torch, dev, mt, out):
    """c. bench_bayes_compact's Phi(-4) by subset simulation and by
    cross-entropy IS; bench_rare's Darcy flux tail."""
    from math import erfc, sqrt

    P = E45["rare"]
    p_exact = 0.5 * erfc(P["gamma"] / sqrt(2.0))
    ss = mt.subset_simulation(lambda th: th[:, 0], P["gamma"], E45["linear"]["d"],
                              n_particles=P["n_particles"], n_moves=P["n_moves"],
                              seed=P["seed"], device=dev)
    ss_sig = abs(ss["log_p"] - np.log(p_exact)) / ss["log_p_se"]
    _require(ss_sig < 6.0, "subset Phi(-4): p %.4g vs %.4g, %.2f se in log p"
             % (ss["p"], p_exact, ss_sig))
    ce = mt.cross_entropy_is(lambda th: th[:, 0], P["gamma"], E45["linear"]["d"],
                             seed=P["ce_seed"], device=dev)
    ce_sig = abs(ce["p"] - p_exact) / ce["p_se"]
    _require(ce_sig < 6.0, "cross-entropy Phi(-4): p %.4g vs %.4g, %.2f se"
             % (ce["p"], p_exact, ce_sig))
    prob = mt.make_darcy_inverse([P["n"]], n_modes=P["n_modes"], sigma=1.0)
    flux = lambda th: prob["forward"](th, P["n"])[1]
    theta = torch.randn(P["pilot"], prob["d"], dtype=torch.float64, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    pilot = _e2_trace(torch, out, "rare", "the pilot's %d flux solves at 32^2"
                      % P["pilot"], lambda: flux(theta))
    lg = torch.log(pilot)
    gamma = float(torch.exp(lg.mean() + P["log_sds"] * lg.std(unbiased=False)))
    t0 = time.perf_counter()
    tail = mt.subset_simulation(flux, gamma, prob["d"], n_particles=P["darcy_particles"],
                                n_moves=P["n_moves"], seed=1, device=dev)
    tail_s = time.perf_counter() - t0
    _require(0.0 < tail["p"] < 1e-3 and tail["p_lo"] < tail["p"] < tail["p_hi"]
             and tail["n_stages"] >= 3, "Darcy flux tail: %s"
             % {k: tail[k] for k in ("p", "p_lo", "p_hi", "n_stages")})
    out["rare"].update(subset_p=ss["p"], subset_p_exact=p_exact, subset_err_se=ss_sig,
                       subset_stages=ss["n_stages"], ce_p=ce["p"], ce_p_se=ce["p_se"],
                       ce_err_se=ce_sig, ce_weight_ess=ce["weight_ess"], darcy_gamma=gamma,
                       darcy_p=tail["p"], darcy_band=[tail["p_lo"], tail["p_hi"]],
                       darcy_stages=tail["n_stages"], darcy_s=tail_s,
                       darcy_solves_per_s=tail["n_forward"] / tail_s,
                       darcy_acc_final=tail["acc_rates"][-1])
    print("rare events: subset Phi(-4) %.4g vs %.4g (%.2f se in log p, %d stages); "
          "cross-entropy %.4g (se %.3g, %.2f se, weight ESS %.3f); Darcy flux tail on 32^2 "
          "(128-d RFF, %d particles): gamma %.4g, p %.3g in [%.3g, %.3g], %d stages, %.3f s "
          "(%.4g solves/s)" % (ss["p"], p_exact, ss_sig, ss["n_stages"], ce["p"], ce["p_se"],
                               ce_sig, ce["weight_ess"], P["darcy_particles"], gamma,
                               tail["p"], tail["p_lo"], tail["p_hi"], tail["n_stages"],
                               tail_s, tail["n_forward"] / tail_s))


def _lorenz_truth(mt, torch, P):
    """bench_filter's truth: a spun-up Lorenz-96 state and 200 cycles of
    it, every other variable observed with unit noise (host, float64)."""
    step = mt.lorenz96_step(dt=0.05)
    x = torch.tensor(3.0 + np.random.default_rng(2).normal(size=(1, P["d"])))
    for t in range(P["spin"]):
        x = step(x, None, t)
    rng = np.random.default_rng(3)
    truth, ys, xt = [], [], x
    for t in range(P["T"]):
        xt = step(xt, None, t)
        truth.append(xt[0].numpy())
        ys.append(truth[-1][::2] + rng.normal(size=P["d"] // 2))
    return x.numpy(), np.array(truth), np.array(ys)


def _ou_euler_level(torch, kappa, sig_m, window, n_sub):
    """OU over one window by n_sub Euler substeps, the noise drawn as
    [N, n_sub d] from the keys (the same keys at any n_sub)."""
    dt = window / n_sub

    def transition(x, keys, t):
        z = keys.normals(n_sub * x.shape[1], x.dtype).reshape(x.shape[0], n_sub, -1)
        for j in range(n_sub):
            x = x - kappa * x * dt + sig_m * np.sqrt(dt) * z[:, j]
        return x
    return transition


def _e45_filter(torch, dev, mt, out):
    """d. bench_filter: ETKF on Lorenz-96 at three ensemble sizes; enkf
    against the exact Kalman filter; the MLEnKF fixed point."""
    P = E45["filter"]
    x_spun, truth, ys = _lorenz_truth(mt, torch, P)
    step = mt.lorenz96_step(dt=0.05)
    res = {}
    for J in P["ens"]:
        x0 = torch.tensor(x_spun + np.random.default_rng(4).normal(size=(J, P["d"])),
                          device=dev)
        run = lambda: mt.enkf(step, lambda xx: xx[:, ::2], ys, 1.0, n_ens=J, d=P["d"],
                              x0=x0, inflation=P["inflation"], method="etkf",
                              seed=P["seed"], device=dev)
        o = (_e2_trace(torch, out, "filter", "the J = %d ETKF pass" % J, run)
             if J == P["ens"][-1] else run())
        o = run()                                   # the warm pass is timed
        rmse = float(np.sqrt(np.mean((o["means"][P["T"] // 2:] - truth[P["T"] // 2:]) ** 2)))
        res["J%d" % J] = dict(rmse=rmse, spread=float(o["spread"][-1]), wall_s=o["wall_s"],
                              member_steps_per_s=J * P["T"] / o["wall_s"])
        if J >= 256:
            _require(rmse < 1.0, "ETKF Lorenz-96 J=%d: RMSE %.3f >= the noise 1.0" % (J, rmse))
    rng = np.random.default_rng(0)
    d, k, T = 4, 2, 40
    M = 0.9 * np.linalg.qr(rng.normal(size=(d, d)))[0]
    H = rng.normal(size=(k, d))
    q, r = 0.3, 0.4
    x, xs, ysl = rng.normal(size=d), [], []
    for _ in range(T):
        x = M @ x + q * rng.normal(size=d)
        ysl.append(H @ x + r * rng.normal(size=k))
        xs.append(x.copy())
    kf = mt.kalman_filter(M, H, q ** 2 * np.eye(d), r ** 2 * np.eye(k), np.zeros(d),
                          np.eye(d), np.array(ysl))
    Mt, Ht = torch.tensor(M, device=dev), torch.tensor(H, device=dev)
    ekf = mt.enkf(lambda x, keys, t: x @ Mt.T + q * keys.normals(d, x.dtype),
                  lambda x: x @ Ht.T, np.array(ysl), r, n_ens=P["kf_ens"], d=d, seed=1,
                  device=dev)
    sd = np.sqrt(np.array([np.trace(c) / d for c in kf["covs"]]))
    kf_rmse = np.sqrt(np.mean((ekf["means"] - kf["means"]) ** 2, axis=1))
    ll_rel = abs(ekf["loglik"] - kf["loglik"]) / abs(kf["loglik"])
    _require(np.all(kf_rmse < 0.5 * sd) and ll_rel < 0.02,
             "enkf vs Kalman: rmse/sd %.3g, loglik rel %.3g"
             % (float(np.max(kf_rmse / sd)), ll_rel))
    tr = _ou_euler_level(torch, 1.0, 0.5, 0.5, 4)
    data = np.random.default_rng(1).normal(size=(P["ml_T"], 1))
    ml = mt.multilevel_enkf(lambda lev: tr, lambda x: x, data, 0.4, n_levels=3, d=1,
                            n_ens=P["ml_ens"], n_replicates=P["ml_R"], method="etkf",
                            seed=2, device=dev)
    _require(np.all(ml["correction_l1"] == 0.0)
             and np.array_equal(ml["means"], ml["level_means"][0]),
             "MLEnKF identical kernels: corrections %s" % ml["correction_l1"])
    out["filter"].update(lorenz=res, kf_max_rmse_over_sd=float(np.max(kf_rmse / sd)),
                         kf_loglik_rel=ll_rel, mlenkf_corrections=ml["correction_l1"].tolist())
    print("ETKF Lorenz-96 (40 vars, 20 obs, %d cycles): %s; enkf (J %d) vs the Kalman "
          "filter: max rmse/sd %.3f (tol 0.5), loglik rel %.3g (tol 0.02); MLEnKF with "
          "identical kernels: corrections exactly zero" % (
              P["T"], {j: "RMSE %.3f, spread %.3f, %.0f member-steps/s" % (
                  v["rmse"], v["spread"], v["member_steps_per_s"]) for j, v in res.items()},
              P["kf_ens"], float(np.max(kf_rmse / sd)), ll_rel))


def _ou_levels(n_levels, delta=0.5, theta=1.0, sigma=1.0):
    """Euler OU transitions over one observation window sharing the
    finest Brownian path through the keys (tests/test_particle.py's
    hierarchy, drawn from the port's keys)."""
    n_fin = 2 ** (n_levels - 1)

    def make(lev):
        n_sub = 2 ** lev
        dt = delta / n_sub

        def trans(x, keys, t):
            dw = keys.normals(n_fin, x.dtype)
            dw = (dw * np.sqrt(delta / n_fin)).reshape(x.shape[0], n_sub, -1).sum(-1)
            xx = x[:, 0]
            for i in range(n_sub):
                xx = xx + (-theta * xx) * dt + sigma * dw[:, i]
            return xx[:, None]
        return trans
    return make


def _e45_particle(torch, dev, mt, out):
    """e. bench_particle: the bootstrap PF on stochastic volatility; the
    4-level Euler-OU MLPF, and the same over SampleMesh([dev, dev]) equal
    to the one-device run bit for bit."""
    P = E45["particle"]
    phi, sig = P["phi"], P["sig"]
    rng = np.random.default_rng(3)
    xs, truth, ys = 0.0, [], []
    for t in range(P["T"]):
        xs = phi * xs + sig * rng.standard_normal()
        truth.append(xs)
        ys.append(np.exp(0.5 * xs) * rng.standard_normal())
    truth, ys = np.array(truth), np.array(ys)[:, None]
    prior_sd = sig / np.sqrt(1 - phi ** 2)

    def trans(x, keys, t):
        return phi * x + sig * keys.normals(1, x.dtype)

    def ll(x, y):
        return -0.5 * (x[:, 0] + y[0] * y[0] * torch.exp(-x[:, 0]))

    kw = dict(n_particles=P["N"], d=1, seed=P["seed"],
              x0_sampler=lambda keys: prior_sd * keys.normals(1, torch.float64), device=dev)
    _e2_trace(torch, out, "particle", "%d cycles of the bootstrap PF (2^15 particles)"
              % P["trace_T"], lambda: mt.particle_filter(trans, ll, ys[:P["trace_T"]], **kw))
    pf = mt.particle_filter(trans, ll, ys, **kw)
    rmse = float(np.sqrt(np.mean((pf["means"][P["T"] // 2:, 0] - truth[P["T"] // 2:]) ** 2)))
    _require(rmse < prior_sd, "PF stochastic volatility: RMSE %.3f >= prior sd %.3f"
             % (rmse, prior_sd))
    rng = np.random.default_rng(7)
    xs, ysou = 0.0, []
    for t in range(P["ml_T"]):
        for _ in range(8):
            xs = xs * (1.0 - 0.5 / 8) + np.sqrt(0.5 / 8) * rng.standard_normal()
        ysou.append(xs + P["ml_r"] * rng.standard_normal())
    ysou = np.array(ysou)[:, None]
    llou = lambda x, y: -0.5 * ((y[0] - x[:, 0]) / P["ml_r"]) ** 2
    runs = {}
    for name, mkw in (("one", dict(device=dev)),
                      ("mesh", dict(mesh=mt.SampleMesh([dev, dev], group=False)))):
        t0 = time.perf_counter()
        runs[name] = mt.multilevel_particle_filter(_ou_levels(4), llou, ysou, n_levels=4,
                                                   d=1, n_particles=P["ml_counts"],
                                                   seed=8, **mkw)
        runs[name]["host_s"] = time.perf_counter() - t0
    ml = runs["one"]
    c = ml["correction_l1"]
    _require(np.all(np.isfinite(ml["means"])) and c[-1] < c[0],
             "MLPF corrections do not decay: %s" % c)
    same = all(np.array_equal(runs["mesh"][k], ml[k]) for k in ("means", "means_se",
                                                                "correction_l1"))
    _require(same, "MLPF over [dev, dev] differs from one device: max |dmeans| %.3g"
             % float(np.max(np.abs(runs["mesh"]["means"] - ml["means"]))))
    out["particle"].update(pf_rmse=rmse, pf_prior_sd=prior_sd, pf_loglik=pf["loglik"],
                           pf_resample_frac=pf["resample_frac"], pf_wall_s=pf["wall_s"],
                           pf_particle_steps_per_s=P["N"] * P["T"] / pf["wall_s"],
                           mlpf_correction_l1=c.tolist(),
                           mlpf_mean_se=float(np.mean(ml["means_se"])),
                           mlpf_wall_s=ml["wall_s"], mlpf_mesh_wall_s=runs["mesh"]["wall_s"],
                           mlpf_mesh_bit_for_bit=same)
    print("bootstrap PF stochastic volatility (2^15 particles, %d cycles): RMSE %.3f < prior "
          "sd %.3f, loglik %.1f, resampled %.3f, %.3f s (%.4g particle-steps/s); MLPF 4-level "
          "OU %s: corrections %s, mean se %.3g, %.3f s; over [dev, dev] %.3f s, equal bit for "
          "bit" % (P["T"], rmse, prior_sd, pf["loglik"], pf["resample_frac"], pf["wall_s"],
                   P["N"] * P["T"] / pf["wall_s"], P["ml_counts"],
                   ["%.3g" % v for v in c], np.mean(ml["means_se"]), ml["wall_s"],
                   runs["mesh"]["wall_s"]))


def _e45_pod(torch, dev, mt, out):
    """f. tests/test_pod.py's POD surrogate at n = 32, rank 24: energy,
    held-out correlation, and MFMC with the surrogate; returns it."""
    from mlmc_tpu_torch.random.keyed import SampleKeys

    P = E45["pod"]
    t0 = time.perf_counter()
    pod = mt.pod_darcy_surrogate(dict(sigma=1.0, corr_length=0.3), n=P["n"], rank=P["rank"],
                                 n_snapshots=P["snapshots"], device=dev)
    build_s = time.perf_counter() - t0
    energy = float(pod["energy"][pod["rank"] - 1])
    keys = SampleKeys(7, 0, torch.arange(P["held_out"], device=dev))
    red = _e2_trace(torch, out, "pod", "the reduced model on %d identities" % P["held_out"],
                    lambda: pod["model"](keys)).cpu().numpy()
    full = pod["full_model"](keys).cpu().numpy()
    rho = float(np.corrcoef(red, full)[0, 1])
    _require(energy > 0.99 and rho > 0.97, "POD: energy %.4f, rho %.4f" % (energy, rho))
    mf = mt.MFMC([pod["full_model"], pod["model"]], costs=P["costs"], seed=5,
                 chunk_size=P["chunk"], device=dev)
    st = mf.pilot(P["pilot"])
    res = mf.estimate(budget=P["budget"])
    check = pod["full_model"](SampleKeys(31, 0, torch.arange(P["check"], device=dev)))
    check = check.cpu().numpy()
    tol = 6 * np.sqrt(res["var"] + check.var() / check.size)
    _require(res["speedup"] > 1.2 and abs(res["mean"] - check.mean()) < tol,
             "POD MFMC: speedup %.3f, mean %.6g vs %.6g (tol %.3g)"
             % (res["speedup"], res["mean"], check.mean(), tol))
    out["pod"].update(build_s=build_s, energy_at_rank=energy, rho_held_out=rho,
                      mfmc_rho=st["rho"].tolist(), mfmc_speedup=res["speedup"],
                      mfmc_mean=res["mean"], mfmc_se=float(np.sqrt(res["var"])),
                      plain_mean=float(check.mean()))
    print("POD n=32 rank %d (%d snapshots, %.3f s): energy %.5f, held-out rho %.5f; MFMC "
          "(costs %s, budget %g): pilot rho %s, speedup %.3f, mean %.6g vs a plain %d-sample "
          "mean %.6g (tol %.3g)" % (pod["rank"], P["snapshots"], build_s, energy, rho,
                                    P["costs"], P["budget"], np.round(st["rho"], 5).tolist(),
                                    res["speedup"], res["mean"], P["check"], check.mean(),
                                    tol))
    return pod


def _e45_collocation(torch, dev, mt, out):
    """g. bench_collocation: the 8-d RFF flux on 32^2 by Gauss-Hermite
    Smolyak w = 2..4; multilevel collocation on 16/32; the adaptive grid
    on a closed form."""
    P = E45["colloc"]
    prob = mt.make_darcy_inverse([P["n"]], n_modes=P["n_modes"], sigma=1.0)
    flux = lambda th: prob["forward"](th, P["n"])[1]
    vals, nodes, walls = [], [], []
    for w in P["levels"]:
        grid = mt.SparseGrid(prob["d"], w, rule="gauss-hermite")
        run = lambda: float(grid.integrate(flux, device=dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals.append(_e2_trace(torch, out, "collocation", "the w = %d grid (%d solves)"
                              % (w, grid.n_nodes), run) if w == P["levels"][-1] else run())
        walls.append(time.perf_counter() - t0)
        nodes.append(grid.n_nodes)
    deltas = [abs(b - a) for a, b in zip(vals, vals[1:])]
    _require(deltas[-1] < deltas[0], "collocation ladder deltas do not fall: %s" % deltas)
    pml = mt.make_darcy_inverse([16, 32], n_modes=P["n_modes"], sigma=1.0,
                                wave_vectors=prob["wave_vectors"])
    mlc = mt.multilevel_collocation([lambda th, n=n: pml["forward"](th, n)[1]
                                     for n in (16, 32)], prob["d"], device=dev)
    c = np.array([0.8, 0.5, 0.3, 0.2])
    ct = torch.tensor(c, device=dev)
    ad = mt.AdaptiveSparseGrid(4).integrate(lambda th: torch.exp(th @ ct), tol=1e-9,
                                            max_evals=30000, device=dev)
    exact = float(np.exp(0.5 * c @ c))
    _require(ad["converged"] and abs(ad["mean"] - exact) < 5e-9 and np.isfinite(
        float(mlc["mean"][0])), "adaptive grid %.12g vs %.12g (converged %s); multilevel %s"
             % (ad["mean"], exact, ad["converged"], mlc["mean"]))
    out["collocation"].update(n_nodes=nodes, values=vals, ladder_deltas=deltas, wall_s=walls,
                              solves_per_s=nodes[-1] / walls[-1],
                              multilevel_mean=float(mlc["mean"][0]),
                              multilevel_nodes=mlc["n_nodes"],
                              adaptive_err=abs(ad["mean"] - exact),
                              adaptive_evals=ad["n_evals"])
    print("collocation 8-d RFF flux on 32^2, Gauss-Hermite w=%s: nodes %s, values %s, "
          "ladder deltas %s, %.4g solves/s at w=%d; multilevel 16/32 %.8g on %s nodes; "
          "adaptive exp(c.theta) error %.3g in %d evaluations"
          % (P["levels"], nodes, ["%.8g" % v for v in vals], ["%.3g" % v for v in deltas],
             nodes[-1] / walls[-1], P["levels"][-1], mlc["mean"][0], mlc["n_nodes"],
             abs(ad["mean"] - exact), ad["n_evals"]))


def _e45_pce(torch, dev, mt, out):
    """h. bench_pce: a degree-3 PCE of the 32^2 flux in 8 RFF dims from
    1024 solves, its Sobol' indices, the PCE as MFMC's low-fidelity model,
    and pce_control_variate."""
    P = E45["pce"]
    prob = mt.make_darcy_inverse([32], n_modes=4, sigma=1.0)
    d = prob["d"]
    flux = lambda th: prob["forward"](th, 32)[1]
    theta = torch.randn(P["n_fit"], d, dtype=torch.float64, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    t0 = time.perf_counter()
    y = _e2_trace(torch, out, "pce", "the fit's %d flux solves" % P["n_fit"],
                  lambda: flux(theta))
    pce = mt.PCE(d, P["degree"], device=dev).fit_regression(theta, y)
    fit_s = time.perf_counter() - t0
    sob = pce.sobol()
    _require(pce.n_terms == 165 and np.all(np.isfinite(sob["first_order"]))
             and 0.0 < float(np.sum(sob["first_order"])) <= 1.0 + 1e-12,
             "PCE: %d terms, first-order %s" % (pce.n_terms, sob["first_order"]))
    hi = lambda keys: flux(keys.normals(d, torch.float64))
    lo = lambda keys: pce(keys.normals(d, torch.float64))
    mf = mt.MFMC([hi, lo], costs=P["costs"], seed=5, device=dev)
    st = mf.pilot(P["pilot"])
    res = mf.estimate(budget=P["budget"])
    cv = mt.pce_control_variate(flux, pce, n=P["cv_n"], seed=1)
    _require(np.isfinite(res["mean"]) and st["rho"][1] > 0.9 and cv["rho"] > 0.9
             and cv["var_reduction"] > 1.0,
             "PCE MFMC / CV: rho %s, CV %s" % (st["rho"], cv))
    out["pce"].update(fit_s=fit_s, mean=pce.mean(), var=pce.var(),
                      sobol_first=sob["first_order"].tolist(), mfmc_rho=st["rho"].tolist(),
                      mfmc_mean=res["mean"], mfmc_se=float(np.sqrt(res["var"])),
                      mfmc_speedup=res["speedup"], cv_mean=cv["mean"], cv_se=cv["se"],
                      cv_rho=cv["rho"], cv_var_reduction=cv["var_reduction"])
    print("PCE degree 3 (165 terms) of the 32^2 flux from %d solves (%.3f s): mean %.6g, var "
          "%.4g, first-order Sobol' %s; as MFMC's low-fidelity model (costs %s, budget %g): "
          "pilot rho %.5f, mean %.6g (se %.3g), speedup %.2f; control variate (n %d): %.6g "
          "(se %.3g), rho %.5f, variance reduction %.1f"
          % (P["n_fit"], fit_s, pce.mean(), pce.var(), np.round(sob["first_order"], 3).tolist(),
             P["costs"], P["budget"], st["rho"][1], res["mean"], np.sqrt(res["var"]),
             res["speedup"], P["cv_n"], cv["mean"], cv["se"], cv["rho"], cv["var_reduction"]))


def _forrester(x):
    return (6 * x - 2) ** 2 * np.sin(12 * x - 4)


def _e45_gp(torch, dev, mt, out):
    """i. tests/test_gp.py: bayes_opt on Branin and MultilevelGP on
    Forrester."""
    P = E45["gp"]

    def branin(x):
        x = x.cpu().numpy()
        a, b, c = 1.0, 5.1 / (4 * np.pi ** 2), 5.0 / np.pi
        r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
        return (a * (x[1] - b * x[0] ** 2 + c * x[0] - r) ** 2
                + s * (1 - t) * np.cos(x[0]) + s)

    bounds = np.array([[-5.0, 10.0], [0.0, 15.0]])
    X = np.random.default_rng(0).uniform(bounds[:, 0], bounds[:, 1], size=(20, 2))
    yb = np.array([branin(torch.tensor(x)) for x in X])
    _e2_trace(torch, out, "gp", "one GP fit (200 Adam steps, 20 points)",
              lambda: mt.GP("matern52", 1e-6, device=dev).fit(X, yb, n_steps=200))
    bo = mt.bayes_opt(branin, bounds, n_init=P["n_init"], n_iter=P["n_iter"], noise=1e-6,
                      seed=0, device=dev)
    _require(bo["y_best"] < 0.397887 + 0.25, "bayes_opt Branin: y_best %.4f" % bo["y_best"])
    x_lo = np.linspace(0, 1, 25)[:, None]
    y_lo = 0.5 * _forrester(x_lo[:, 0]) + 10 * (x_lo[:, 0] - 0.5) - 5
    x_hi = np.array([0.0, 0.3, 0.55, 0.8, 1.0])[:, None]
    y_hi = _forrester(x_hi[:, 0])
    ml = mt.MultilevelGP(noise=1e-4, device=dev).fit([(x_lo, y_lo), (x_hi, y_hi)],
                                                      n_steps=300)
    single = mt.GP(noise=1e-4, device=dev).fit(x_hi, y_hi, n_steps=300)
    xs = np.linspace(0, 1, 101)[:, None]
    truth = _forrester(xs[:, 0])
    rmse_ml = float(np.sqrt(np.mean((ml.predict(xs)[0] - truth) ** 2)))
    rmse_s = float(np.sqrt(np.mean((single.predict(xs)[0] - truth) ** 2)))
    _require(rmse_ml < 0.5 and rmse_ml < 0.35 * rmse_s and 1.5 < ml.rhos[1] < 2.5,
             "MultilevelGP Forrester: rmse %.3f vs single %.3f, rho %.3f"
             % (rmse_ml, rmse_s, ml.rhos[1]))
    out["gp"].update(bo_y_best=bo["y_best"], bo_x_best=bo["x_best"].tolist(),
                     bo_wall_s=bo["wall_s"], mlgp_rmse=rmse_ml, single_rmse=rmse_s,
                     mlgp_rho=ml.rhos[1], mlgp_wall_s=ml.wall_s)
    print("bayes_opt Branin (%d + %d evaluations, on risk.adam): y_best %.5f (tol 0.397887 "
          "+ 0.25) at %s, %.2f s; MultilevelGP Forrester: RMSE %.4f vs single-level %.4f, "
          "rho %.4f, %.2f s"
          % (P["n_init"], P["n_iter"], bo["y_best"], np.round(bo["x_best"], 4).tolist(),
             bo["wall_s"], rmse_ml, rmse_s, ml.rhos[1], ml.wall_s))


def _e45_stored_pod(torch, dev, mt, out, pod):
    """j. The stored POD-surrogate series: level 0 the POD model on 2^16
    identities, level 1 the pairs (full, POD) on 2^12 shared identities, in a
    DeviceMemory; Estimate's fast tier (kernel C variances) and extended
    tier (kernel D means); D's level means of phi_1 against direct float64
    means of the same values; returns the estimate."""
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
    from mlmc_tpu_torch.random.keyed import SampleKeys
    from mlmc_tpu_torch.tags import TagRange

    P = E45["stored"]
    k0 = SampleKeys(P["seed"], 0, torch.arange(P["n0"], device=dev))
    k1 = SampleKeys(P["seed"], 1, torch.arange(P["n1"], device=dev))
    # the packed streams are float32: store float32 values, so the kernels'
    # sums and the direct means below see the same numbers
    f32 = lambda v: v.float().double()[:, None]
    pairs = [(f32(pod["model"](k0)), None), (f32(pod["full_model"](k1)), f32(pod["model"](k1)))]
    spec = [QuantitySpec(name="flux", unit="m^3/s", shape=(1,), times=[0],
                         locations=["outflow"])]
    storage = mt.DeviceMemory(device=dev)
    storage.save_global_data(result_format=spec, level_parameters=[[1.0 / 32], [1.0 / 32]])
    for lv, (f, c) in enumerate(pairs):
        c = torch.zeros_like(f) if c is None else c
        storage.save_scheduled_samples(lv, TagRange(lv, 0, f.shape[0]))
        storage.save_samples_bulk(lv, TagRange(lv, 0, f.shape[0]), f, c)
    values = torch.cat([pairs[0][0], pairs[1][0], pairs[1][1]])
    lo, hi = float(values.min()), float(values.max())
    domain = (lo - 0.05 * (hi - lo), hi + 0.05 * (hi - lo))
    root = mt.make_root_quantity(storage, spec)
    flux = root["flux"][0]["outflow"][0]
    est = mt.Estimate(flux, storage, mt.Legendre(P["moments"], domain))
    raw, ns = est.estimate_diff_vars_fast()                          # kernel C
    mean, var = est.estimate_moments_extended()                      # kernel D
    _require(ns.tolist() == [P["n0"], P["n1"]] and mean[0] == 1.0
             and np.all(np.isfinite(raw[:, 1:])) and np.all(np.isfinite(var)),
             "stored POD estimate: n %s, mean[0] %r" % (ns.tolist(), mean[0]))
    scale, shift, offset = ck.transform_constants(domain, f64=True)[:3]
    levels = est._stream_results(est._moments_fn, [0], f64=True)       # kernel D
    got = []
    for lv in range(levels.n_valid.shape[0]):
        m1 = float(levels.sums[lv, 0, 1]) / float(levels.n_valid[lv, 0])
        got.append((m1 - offset) / scale + shift if lv == 0 else m1 / scale)
    want = [float(pairs[0][0].mean()), float((pairs[1][0] - pairs[1][1]).mean())]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    _require(max(rel) <= 1e-12, "kernel D's level means %s vs the direct float64 means %s "
             "(rel %s)" % (got, want, rel))
    out.setdefault("stored_pod", {}).update(
        n_samples=ns.tolist(), domain=list(domain), level_means_kernel_d=got,
        level_means_direct=want, level_mean_rel_err=rel, level_diff_vars=raw[:, 1].tolist(),
        flux_mean=got[0] + got[1])
    print("stored POD series (levels %s samples): kernel C level variances of phi_1 %s and "
          "kernel D means; kernel D's level means %s vs the direct float64 means %s, rel %s "
          "(tol 1e-12); the telescoped flux mean %.8g"
          % (ns.tolist(), ["%.3g" % v for v in raw[:, 1]], ["%.10g" % v for v in got],
             ["%.10g" % v for v in want], ["%.2g" % r for r in rel], got[0] + got[1]))
    return est


def e45_path(torch, dev):
    """Inference (ES-MDA, tempered SMC, rare events, ensemble and particle
    filters) and surrogates (POD, collocation, PCE, GP) (slices E4-E5),
    each phase with its wall and its main batch's device events and idle
    share; kernels C and D on the stored POD-surrogate series; returns the
    path's launch counts and the kernels' errors at its streams."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops import cuda_extended as cx
    from mlmc_tpu_torch.ops import cuda_kernels as ck
    from mlmc_tpu_torch.ops.precision import EPS64, extended_bound_constant

    torch.cuda.reset_peak_memory_stats(dev)
    ck.reset_launch_counts()
    cx.reset_launch_counts()
    out = {"path": "e45"}
    run = lambda key, label, fn, *args, whole=False: _e2_phase(
        torch, out, key, label, lambda: fn(torch, dev, mt, out, *args), whole)
    with Phase(torch, "e45 path") as whole:
        run("esmda", "a. ES-MDA", _e45_esmda)
        run("smc", "b. tempered SMC", _e45_smc)
        run("rare", "c. rare events", _e45_rare)
        run("filter", "d. ensemble Kalman filters", _e45_filter)
        run("particle", "e. particle filters", _e45_particle)
        pod = run("pod", "f. POD", _e45_pod)
        run("collocation", "g. collocation", _e45_collocation)
        run("pce", "h. PCE", _e45_pce)
        run("gp", "i. GP", _e45_gp)
        est = run("stored_pod", "j. the stored POD series (kernels C and D)",
                  _e45_stored_pod, pod, whole=True)
        counts = {**ck.launch_counts(), **cx.launch_counts()}
    out.update(seconds=whole.seconds, launches=counts,
               peak_memory_gb=torch.cuda.max_memory_allocated(dev) / 1e9)
    print("e45 path: %.2f s; kernel launches %s; peak device memory %.3f GB"
          % (whole.seconds, counts, out["peak_memory_gb"]))
    for name in ("samples_mlmc", "samples_ext"):
        _require(counts[name] > 0, "kernel %s was not launched by the e45 path" % name)
    with Phase(torch, "kernels C/D vs plain at the stored POD streams"):
        errs = _streams_vs_plain(torch, dev, est, "the stored POD streams")
        mfn = est._moments_fn
        streams = est._packed_streams(mfn, [0])
        consts = ck.transform_constants(mfn.domain, f64=True)
        got = cx.samples_ext_cuda(streams, mfn.size, basis="legendre", consts=consts,
                                  device=dev)
        plain, s_abs = (cx.samples_ext_plain(streams, mfn.size, basis="legendre",
                                             consts=consts, absolute=a) for a in (False, True))
        bound = EPS64 * extended_bound_constant()
        _, rel = _compare(torch, got, plain, s_abs, "kernel D at the stored POD streams",
                          rtol=bound)
        print("kernel D at the stored POD streams within its derived bound %.3g * S_abs: "
              "max / S_abs %.3g" % (bound, rel))
    print(json.dumps(out))
    return counts, {"samples_mlmc": errs[0], "samples_ext": errs[1]}


def _cdf_run(mt, pair, mesh, dev):
    m = mt.MultilevelCDF(pair, 3, np.linspace(-3.0, 3.0, 41), 0.1, seed=13,
                         chunk_size=1 << 10, mesh=mesh, device=dev)
    for lv in range(3):
        m.extend(lv, 2048)
    return m.estimates()


def _unbiased_run(mt, make_fn, mesh, dev):
    fn, _ = make_fn(mean=1.0)
    m = mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.4), estimator="single", seed=21,
                        chunk_size=1 << 10, cost_fn=lambda lv: 2.0 ** lv,
                        mesh=mesh, device=dev)
    m.sample(3000)
    return m.estimates()


def main():
    import torch

    if not torch.cuda.is_available():
        _fail("no CUDA device (torch.cuda.is_available() is false)")
    package = os.path.join(HERE, "mlmc_tpu_torch")
    if not all(os.path.isfile(os.path.join(package, f))
               for f in ("csrc/synth_mlmc.cu", "csrc/samples_mlmc.cu",
                         "csrc/moment_gram.cuh", "native/sample_log.cpp",
                         "native/gmsh_fast.cpp")):
        _fail("run from the root of a checkout: the sources under mlmc_tpu_torch/ "
              "are missing")
    sys.path.insert(0, HERE)
    from mlmc_tpu_torch.ops import _build
    from mlmc_tpu_torch.tool.timing import smi

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi("name,power.limit"))
    print("torch %s, CUDA %s, %s" % (torch.__version__, torch.version.cuda,
                                     torch.cuda.get_device_name(0)))
    with Phase(torch, "kernel build (parallel nvcc) + load"):
        for name in _build.build_all():
            _build.load_library(name)

    own = {"storage_free": storage_free_path(torch, dev),
           "stored": stored_path(torch, dev)}
    later = {"simulations": simulations_path(torch, dev),
             "persisted": persisted_path(torch, dev),
             "sharded": sharded_path(torch, dev),
             "darcy3d": darcy3d_path(torch, dev),
             "sde_qmc": sde_qmc_path(torch, dev),
             "e2": e2_path(torch, dev),
             "e3": e3_path(torch, dev),
             "e45": e45_path(torch, dev)}
    kernels = []
    for path, of_path in own.items():
        for k in of_path:  # launches of every path; errors at every path's streams
            k["launches_by_path"] = {path: k["launches"]}
            for later_path, (counts, errs) in later.items():
                k["launches_by_path"][later_path] = counts[k["name"]]
                k["launches"] += counts[k["name"]]
                k["max_abs_err"] = max(k["max_abs_err"], errs.get(k["name"], 0.0))
            kernels.append(k)
    print(smi("name,power.limit"))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
