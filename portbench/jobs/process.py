"""Processing a stored run, as upstream ``ProcessBase``'s ``process`` verb
does: set-up builds one stored run from the seed (``Sampler`` ->
``DeviceBatchPool`` -> the simulation -> ``DeviceMemory``, the counts of
the cell); each job then estimates the structured quantity the
configuration names (``structured_quantity``: every component of it, one
(component, level) stream each) with Legendre moments on a domain drawn
from the job's seed: the float32 tier (kernel C, one launch) and the
float64 tier (kernel D, one launch).

Cell parameters: ``n_per_level``, ``pool`` (``min_bucket``,
``max_batch``), ``domain_jitter`` (each end of the configuration's domain
moves outward by up to this much), ``warm_jobs``.
"""
import numpy as np

from harness.checks import abs_gap, precision, rel_gap
from harness.runner import derive_seed
from reference import moments, synth


def run_seed(ctx):
    """The seed of the stored run, for the program and the reference alike."""
    return derive_seed(ctx.seed, 3)


def job_domain(config, cell, seed):
    a, b = config["moments"]["domain"]
    u = np.random.default_rng(seed).random(2)
    jitter = float(cell["domain_jitter"])
    return (a - jitter * u[0], b + jitter * u[1])


class Job:
    def __init__(self, ctx):
        import mlmc_tpu_torch as mt

        self.ctx, self.mt = ctx, mt
        cfg, cell = ctx.config, ctx.cell
        sim = mt.SynthSimulation(dict(distr=cfg["distribution"], complexity=2))
        self.storage = mt.DeviceMemory(device=ctx.device)
        pool = mt.DeviceBatchPool(seed=run_seed(ctx), device_results=True,
                                  min_bucket=int(cell["pool"]["min_bucket"]),
                                  max_batch=int(cell["pool"]["max_batch"]),
                                  device=ctx.device)
        sampler = mt.Sampler(self.storage, pool, sim,
                             [[float(h)] for h in cfg["levels"]["steps"]])
        sampler.set_initial_n_samples(list(cell["n_per_level"]))
        sampler.schedule_samples()
        sampler.ask_sampling_pool_for_samples()
        root = mt.make_root_quantity(self.storage, sim.result_format())
        self.quantity = root[cfg["structured_quantity"]]
        for i in range(int(cell["warm_jobs"])):
            self.run(ctx.warm_seed(i), False)

    def run(self, seed, keep):
        cfg, mt = self.ctx.config, self.mt
        domain = job_domain(cfg, self.ctx.cell, seed)
        est = mt.Estimate(self.quantity, self.storage, mt.Legendre(int(cfg["moments"]["n"]), domain))
        with self.ctx.span("estimate"):
            mean_f, var_f = est.estimate_moments_fast()
            mean_d, var_d = est.estimate_moments_extended()
        counts = [int(n) for n in self.storage.get_n_collected()]
        return {"seed": seed, "samples": sum(counts) * len(cfg["components"]),
                "answer": {"domain": domain, "counts": counts, "mean_fast": mean_f,
                           "var_fast": var_f, "mean_ext": mean_d, "var_ext": var_d}}

    def release(self):
        self.storage = self.quantity = None


class _Stored:
    """The reference's own copy of the stored run: every component of every
    sample, recomputed from the run's seed and the job's counts."""

    def __init__(self, ctx, counts, values):
        cfg, seed = ctx.config, run_seed(ctx)
        self.levels = []
        for lvl, n in enumerate(counts):
            idx = ctx.torch.arange(int(n), dtype=ctx.torch.int64, device=ctx.device)
            self.levels.append(synth.record_values(seed, lvl, idx, cfg["levels"]["steps"],
                                                   cfg["components"], values))


def reference_answer(ctx, stored, domain, control):
    """Both tiers' means and variances [M, R] on ``domain``: a sample is
    valid on a level when every component's fine and coarse values map
    into the reference interval (in the values precision); the float32
    tier computes its rows in the values precision, the float64 tier in the
    sums precision."""
    values, acc = precision(ctx.config, control)
    R = int(ctx.config["moments"]["n"])
    consts = moments.transform(domain, values)
    per_tier = {"fast": [], "ext": []}
    n_valid = []
    for fine, coarse in stored.levels:
        ok = moments.map_values(fine, consts, values)[1].all(dim=1)
        if coarse is not None:
            ok &= moments.map_values(coarse, consts, values)[1].all(dim=1)
        n_valid.append(int(ok.sum()))
        for tier, rows in (("fast", values), ("ext", acc)):
            per_tier[tier].append([moments.to_host(moments.stream_sums(
                fine[:, m], None if coarse is None else coarse[:, m], domain, R,
                rows, acc, valid=ok), acc) for m in range(fine.shape[1])])
    out = {"n_valid": n_valid}
    for tier, levels in per_tier.items():
        ests = [moments.estimate([lv[m] for lv in levels]) for m in range(len(levels[0]))]
        out["mean_" + tier] = np.stack([e["mean"] for e in ests])
        out["var_" + tier] = np.stack([e["var"] for e in ests])
    return out


def compare(got, want):
    return {"fast_mean_gap": abs_gap(got["mean_fast"], want["mean_fast"]),
            "fast_var_gap": rel_gap(got["var_fast"][:, 1:], want["var_fast"][:, 1:]),
            "ext_mean_gap": abs_gap(got["mean_ext"], want["mean_ext"]),
            "ext_var_gap": rel_gap(got["var_ext"][:, 1:], want["var_ext"][:, 1:])}


def check(ctx, records, control):
    numbers = {}
    stored = {}
    for rec in records:
        counts = rec["answer"]["counts"]
        if "program" not in stored:
            stored["program"] = _Stored(ctx, counts, precision(ctx.config)[0])
            if control:
                stored["control"] = _Stored(ctx, counts, precision(ctx.config, True)[0])
        domain = rec["answer"]["domain"]
        want = reference_answer(ctx, stored["program"], domain, control=False)
        got = (reference_answer(ctx, stored["control"], domain, control=True)
               if control else rec["answer"])
        for k, v in compare(got, want).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        m = len(ctx.config["components"])
        rec["work"] = {"counts": counts * m, "n_valid": want["n_valid"] * m,
                       "has_coarse": [lvl > 0 for lvl in range(len(counts))] * m,
                       "n_moments": int(ctx.config["moments"]["n"])}
    return numbers
