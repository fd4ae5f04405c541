"""An adaptive stored run to a target variance, as a user drives it:
``Sampler`` -> ``DeviceBatchPool`` (a new pool per job, seeded by the job)
-> the simulation -> ``DeviceMemory`` -> ``Quantity`` -> ``Estimate``.

The loop: the initial counts are scheduled and collected; then each round
estimates the level variances (kernel C), stops once the estimator's
variance of every moment is at or under the target, and otherwise
regresses the variances, allocates the samples for the target and adds a
step toward them; an allocation that is reached while the variance is
still above the target aims the next one lower. The job ends with the final
moments (``final``: the float32 tier, kernel C, or the float64 tier,
kernel D) and, where the cell asks for one, the maxent density. The last
allocation's inputs that are not the program's answers (the counts then
stored, the per-sample costs the pool measured, the target the loop asked
for) are kept beside its counts, for the check.

Cell parameters: ``initial_n``, ``target_var``, ``max_rounds``,
``add_coeff``, ``pool`` (``min_bucket``, ``max_batch``), ``final``,
``density`` (null or ``tol``), ``warm_jobs``. The stored values of a
checked job's quantity are copied to the host after the job
(``capture``), outside the window.
"""
import numpy as np

from harness.checks import abs_gap, precision, rel_gap
from reference import allocation, darcy, maxent, moments, synth


def _simulation(mt, cfg):
    if cfg["simulation"] == "synth":
        return mt.SynthSimulation(dict(distr=cfg["distribution"], complexity=2))
    field = cfg["field"]
    return mt.DiffusionSimulation(dict(sigma=field["sigma"], corr_length=field["corr_length"],
                                       model=field["model"], field_method=field["method"]))


def select(root, path):
    q = root
    for key in path:
        q = q[tuple(key) if isinstance(key, list) else key]
    return q


class Job:
    def __init__(self, ctx):
        import mlmc_tpu_torch as mt

        self.ctx, self.mt = ctx, mt
        self.cfg, self.cell = ctx.config, ctx.cell
        self.sim = _simulation(mt, self.cfg)
        self.levels = [[float(h)] for h in self.cfg["levels"]["steps"]]
        for i in range(int(self.cell["warm_jobs"])):
            self.run(ctx.warm_seed(i), False)

    def run(self, seed, keep):
        mt, cell, span = self.mt, self.cell, self.ctx.span
        target = float(cell["target_var"])
        storage = mt.DeviceMemory(device=self.ctx.device)
        pool = mt.DeviceBatchPool(seed=seed, device_results=True,
                                  min_bucket=int(cell["pool"]["min_bucket"]),
                                  max_batch=int(cell["pool"]["max_batch"]),
                                  device=self.ctx.device)
        sampler = mt.Sampler(storage, pool, self.sim, self.levels)
        with span("sampling"):
            sampler.set_initial_n_samples(list(cell["initial_n"]))
            sampler.schedule_samples()
            sampler.ask_sampling_pool_for_samples()
        root = mt.make_root_quantity(storage, self.sim.result_format())
        mfn = mt.Legendre(int(self.cfg["moments"]["n"]), tuple(self.cfg["moments"]["domain"]))
        est = mt.Estimate(select(root, self.cfg["quantity"]), storage, mfn)
        alloc_target, var, alloc = target, np.inf, None
        for rounds in range(int(cell["max_rounds"])):
            with span("estimate"):
                raw, ns = est.estimate_diff_vars_fast()
                var = float(np.max((raw[:, 1:] / ns[:, None]).sum(axis=0)))
                if var <= target:
                    break
                variances, n_ops = est.estimate_diff_vars_regression(
                    sampler._n_scheduled_samples, raw_vars=raw)
                n_est = mt.estimate_n_samples_for_target_variance(
                    alloc_target, variances, n_ops, n_levels=sampler.n_levels)
            alloc = {"n": [int(v) for v in storage.get_n_collected()],
                     "costs": [float(c) for c in n_ops], "target": alloc_target,
                     "n_est": [int(v) for v in n_est]}
            with span("sampling"):
                if sampler.process_adding_samples(n_est, 0, float(cell["add_coeff"])):
                    alloc_target *= 0.95 * target / var
        if var > target:
            raise RuntimeError("the run stopped at variance %.4g above its target %.4g "
                               "after %d rounds" % (var, target, rounds))
        with span("estimate"):
            if cell["final"] == "extended":
                mean, _ = est.estimate_moments_extended()
            else:
                mean, _ = est.estimate_moments_fast()
        dist = None
        if cell["density"] is not None:
            with span("density"):
                dist, _info, result, _orth = est.construct_density_fast(
                    tol=float(cell["density"]["tol"]))
            if not result.success:
                raise RuntimeError("maxent density: %s" % result.message)
        self.ctx.tracer.count("pool_dispatches", pool.n_dispatches)
        counts = [int(n) for n in storage.get_n_collected()]
        answer = {"n": counts, "n_valid": [int(v) for v in ns], "l_vars": raw,
                  "mean": mean, "alloc": alloc}
        if keep:
            answer.update(storage=storage, density=dist)
        return {"seed": seed, "samples": sum(counts), "answer": answer}

    def capture(self, rec):
        """After a checked job: its quantity as stored, every sample of every
        level, as (fine, coarse or None) float32 host arrays; the storage
        itself is let go."""
        storage = rec["answer"].pop("storage")
        comp = int(self.cfg["component"])
        stored = []
        for lvl in range(len(self.levels)):
            pairs = storage.sample_pairs_level(self.mt.ChunkSpec(level_id=lvl))[comp]
            stored.append((pairs[:, 0].cpu().numpy(),
                           pairs[:, 1].cpu().numpy() if lvl else None))
        rec["answer"]["stored"] = stored

    def release(self):
        pass


def _level_values(ctx, seed, level, n, values):
    """(fine, coarse) of the job's quantity on the first n samples of a
    level, recomputed by the plain reference."""
    cfg = ctx.config
    idx = ctx.torch.arange(int(n), dtype=ctx.torch.int64, device=ctx.device)
    if cfg["simulation"] == "synth":
        fine, coarse = synth.record_values(seed, level, idx, cfg["levels"]["steps"],
                                           [int(cfg["component"])], values)
        return fine[:, 0], (coarse[:, 0] if coarse is not None else None)
    grids = [int(round(1.0 / h)) for h in cfg["levels"]["steps"]]
    field = cfg["field"]
    return darcy.sample_fluxes(seed, level, idx, grids, field["corr_length"],
                               field["sigma"], values)


def reference_values(ctx, rec, control):
    """The reference's own values of every sample the job stored, (fine,
    coarse or None) per level, in the configuration's value precision (one
    step lower for the control)."""
    values, _ = precision(ctx.config, control)
    return [_level_values(ctx, rec["seed"], lvl, n, values)
            for lvl, n in enumerate(rec["answer"]["n"])]


def estimates_of(ctx, rec, stored, control):
    """The reference's arithmetic on stored values (fine, coarse or None
    tensors per level): the level variances and the estimator variance of
    the float32 tier, the final moments of the tier the cell names, the
    density, and the counts of the job's last allocation: from the level
    variances of the samples then stored (the first ones of each level),
    regressed, for the costs and the target that allocation was given."""
    cfg, cell = ctx.config, ctx.cell
    values, acc = precision(cfg, control)
    R, domain = int(cfg["moments"]["n"]), tuple(cfg["moments"]["domain"])
    fast, ext = [], []
    for fine, coarse in stored:
        fast.append(moments.to_host(moments.stream_sums(fine, coarse, domain, R, values, acc), acc))
        if cell["final"] == "extended":
            ext.append(moments.to_host(moments.stream_sums(fine, coarse, domain, R, acc, acc), acc))
    est = moments.estimate(fast)
    final = moments.estimate(ext) if ext else est
    out = {"n_valid": est["n"], "l_vars": est["l_vars"], "var": est["var"],
           "mean": final["mean"], "alloc_n": None}
    alloc = rec["answer"]["alloc"]
    if alloc is not None:
        then = [moments.to_host(moments.stream_sums(
                    f[:n], None if c is None else c[:n], domain, R, values, acc), acc)
                for (f, c), n in zip(stored, alloc["n"])]
        l_vars = moments.estimate(then)["l_vars"].astype(np.float64)
        steps = [float(h) for h in cfg["levels"]["steps"]]
        out["alloc_n"] = allocation.counts(alloc["target"], allocation.regressed(l_vars, steps),
                                           alloc["costs"])
    if cell["density"] is not None:
        rho, _ = maxent.density(est["cov"].astype(np.float64), est["mean"].astype(np.float64),
                                domain, orth_tol=1e-4, tol=1e-12 if not control else 1e-6)
        out["density"] = rho
    return out


def _host(values):
    return [(f.double().cpu().numpy(), None if c is None else c.double().cpu().numpy())
            for f, c in values]


def count_gap(got, want):
    """Largest gap of sample counts beyond one, relative to the reference's
    count (at least 1): counts are rounded to whole samples, so a count one
    off is rounding, whichever side rounds."""
    got, want = np.asarray(got, dtype=np.float64), np.asarray(want, dtype=np.float64)
    return float(np.max(np.maximum(np.abs(got - want) - 1.0, 0.0) / np.maximum(want, 1.0)))


def compare(ctx, got, want):
    """The gaps of what a job (or the control in its place) estimated from
    its stored values to the reference's estimate from the same values."""
    out = {"n_valid_gap": abs_gap(got["n_valid"], want["n_valid"]),
           "level_var_gap": rel_gap(got["l_vars"][:, 1:], want["l_vars"][:, 1:]),
           "mean_gap": abs_gap(got["mean"], want["mean"]),
           "alloc_gap": 0.0}
    if want["alloc_n"] is not None:
        mine = got["alloc_n"] if "alloc_n" in got else got["alloc"]["n_est"]
        out["alloc_gap"] = count_gap(mine, want["alloc_n"])
    if want.get("density") is not None:
        a, b = ctx.config["moments"]["domain"]
        x = np.linspace(a, b, 401)
        ref = want["density"](x)
        dens = got["density"]
        mine = dens(x) if callable(dens) else dens.density(x)
        out["density_gap"] = float(np.max(np.abs(mine - ref)) / np.max(ref))
    return out


def check(ctx, records, control):
    """Two comparisons with the plain reference. The stored values against
    the reference's own values of the same samples (``payload_gap``: the
    draws and the simulation); everything estimated from them (level
    variances, allocation, stopping rule, final moments, density) against
    the reference's arithmetic on those stored values, so that the error
    the simulation is allowed does not hide an error of the estimator."""
    torch = ctx.torch
    numbers = {}
    target = float(ctx.cell["target_var"])
    for rec in records:
        ref_vals = _host(reference_values(ctx, rec, control=False))
        if control:
            stored = reference_values(ctx, rec, control=True)
            got = estimates_of(ctx, rec, stored, control=True)
        else:
            as_dev = lambda a: None if a is None else torch.as_tensor(a, device=ctx.device)
            stored = [(as_dev(f), as_dev(c)) for f, c in rec["answer"]["stored"]]
            got = rec["answer"]
        want = estimates_of(ctx, rec, stored, control=False)
        out = compare(ctx, got, want)
        out["payload_gap"] = max(
            max(rel_gap(g, w, floor=1.0) for g, w in zip(gs, ws) if g is not None)
            for gs, ws in zip(_host(stored), ref_vals))
        out["target_ratio"] = float(np.max(want["var"][1:])) / target
        for k, v in out.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers
