"""A fixed storage-free estimate: one ``synth_mlmc_pipeline`` call (samples
drawn, mapped and reduced on the device, every level in one launch of
kernel A), then ``accumulators_to_estimates`` (level means and variances,
the mean, its variance and the moment covariance, on the host).

Cell parameters: ``n_per_level`` (samples of each level), ``warm_jobs``.
Configuration: ``levels.steps``, ``moments`` (``n``, ``domain``),
``precision``.
"""
import numpy as np

from harness.checks import abs_gap, precision, rel_gap
from reference import moments, synth


class Job:
    def __init__(self, ctx):
        import mlmc_tpu_torch as mt
        from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates

        self.ctx = ctx
        self._pipeline = mt.synth_mlmc_pipeline
        self._estimates = accumulators_to_estimates
        cfg = ctx.config
        self.steps = [float(h) for h in cfg["levels"]["steps"]]
        self.R = int(cfg["moments"]["n"])
        self.domain = tuple(cfg["moments"]["domain"])
        self.n = [int(n) for n in ctx.cell["n_per_level"]]
        for i in range(int(ctx.cell["warm_jobs"])):
            self._estimate(ctx.warm_seed(i))

    def _estimate(self, seed):
        with self.ctx.span("kernel"):
            accs = self._pipeline(seed, self.R, self.n, self.steps,
                                  domain=self.domain, device=self.ctx.device)
        with self.ctx.span("estimates"):
            return self._estimates(accs)

    def run(self, seed, keep):
        est = self._estimate(seed)
        return {"seed": seed, "samples": sum(self.n), "answer": est}

    def release(self):
        pass


def reference_answer(ctx, seed, control):
    cfg, cell = ctx.config, ctx.cell
    values, acc = precision(cfg, control)
    levels = synth.fused_level_sums(
        seed, [int(n) for n in cell["n_per_level"]], cfg["levels"]["steps"],
        int(cfg["moments"]["n"]), tuple(cfg["moments"]["domain"]), values, acc, ctx.device)
    est = moments.estimate(levels)
    est["n_samples"] = est["n"]
    return est


def compare(got, want):
    return {
        "n_valid_gap": abs_gap(got["n_samples"], want["n_samples"]),
        "mean_gap": abs_gap(got["mean"], want["mean"]),
        "var_gap": rel_gap(got["var"][1:], want["var"][1:]),
        "cov_gap": abs_gap(got["cov"], want["cov"]) / float(np.max(np.abs(want["cov"]))),
    }


def check(ctx, records, control):
    """The largest gap of each kind over the checked jobs. The traced jobs
    also get the counts that the kernel metrics need."""
    numbers = {}
    for rec in records:
        want = reference_answer(ctx, rec["seed"], control=False)
        got = reference_answer(ctx, rec["seed"], control=True) if control else rec["answer"]
        for k, v in compare(got, want).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        rec["work"] = {"n_valid": [int(n) for n in want["n_samples"]],
                       "n_moments": int(ctx.config["moments"]["n"])}
    return numbers
