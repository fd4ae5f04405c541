"""A storage-free estimate over a group of processes, one per card: each
job is one ``sharded_synth_pipeline`` step over ``global_sample_mesh``
(kernel A on every card over its share of each level's sample indices,
then one all-reduce of the accumulators), then
``accumulators_to_estimates`` on rank 0.

The run's own process is rank 0 on the run's device. Set-up loads the
kernels there first, so that no worker builds them, then starts ranks
1 .. P-1 (``sharded_worker.py``), rank r on card r (on the CPU in a
rehearsal, over gloo), and every rank joins the group with its device
named. A job broadcasts (seed, go) from rank 0 as one int64 tensor; every
rank runs the step of that seed. ``release`` broadcasts stop and waits for
the workers. A worker that exits early, or a job, join or release that
waits longer than ``guard_s``, ends the run at once with no result.

Cell parameters: ``n_per_level`` (samples of each level, each a multiple
of the process count), ``warm_jobs``, ``guard_s``. Configuration:
``levels.steps``, ``moments`` (``n``, ``domain``), ``precision``,
``mesh.processes``.
"""
import contextlib
import json
import os
import socket
import subprocess
import sys
import threading
import time

from harness.checks import precision
from harness.runner import CODE_DIR, load_module
from reference import moments, sharded

WORKER = os.path.join(CODE_DIR, "jobs", "sharded_worker.py")
fused = load_module(os.path.join(CODE_DIR, "jobs", "fused.py"), "portbench_job_fused")
worker = load_module(WORKER, "portbench_sharded_worker")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def processes(ctx):
    return int(ctx.config["mesh"]["processes"])


def rank_device(ctx, rank):
    """Rank ``rank``'s device: card ``rank``, or the CPU in a rehearsal."""
    return ctx.device if ctx.device.type == "cpu" else ctx.torch.device("cuda", rank)


class Job:
    def __init__(self, ctx):
        import torch.distributed as dist

        import mlmc_tpu_torch as mt
        from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates

        self.ctx, self.dist = ctx, dist
        self._estimates = accumulators_to_estimates
        cfg, cell = ctx.config, ctx.cell
        self.world = processes(ctx)
        self.guard_s = float(cell["guard_s"])
        self.n = [int(n) for n in cell["n_per_level"]]
        spec = {"steps": [float(h) for h in cfg["levels"]["steps"]],
                "n_moments": int(cfg["moments"]["n"]),
                "domain": [float(x) for x in cfg["moments"]["domain"]],
                "n_per_level": self.n}
        if ctx.device.type == "cuda":
            # build and load kernel A here, before any worker looks for it
            mt.synth_mlmc_pipeline(0, spec["n_moments"], [4096] * len(self.n), spec["steps"],
                                   domain=tuple(spec["domain"]), device=ctx.device)
        self.workers, self._busy_since, self._stopping = [], None, False
        self._done = threading.Event()
        threading.Thread(target=self._watch, daemon=True).start()
        address = "tcp://127.0.0.1:%d" % _free_port()
        with self._guard():
            self.workers = [subprocess.Popen(
                [sys.executable, WORKER, "--rank", str(r), "--world", str(self.world),
                 "--address", address, "--device", str(rank_device(ctx, r)),
                 "--parent", str(os.getpid()), "--spec", json.dumps(spec)],
                stdout=subprocess.DEVNULL) for r in range(1, self.world)]
            mesh = worker.join(0, self.world, address, ctx.device)
        self.step = worker.make_step(mesh, spec)
        for i in range(int(cell["warm_jobs"])):
            self._estimate(ctx.warm_seed(i))

    @contextlib.contextmanager
    def _guard(self):
        self._busy_since = time.monotonic()
        try:
            yield
        finally:
            self._busy_since = None

    def _watch(self):
        while not self._done.wait(0.5):
            dead = [] if self._stopping else [
                (r, p.returncode) for r, p in enumerate(self.workers, 1) if p.poll() is not None]
            since = self._busy_since
            if dead:
                self._abort("worker rank %d exited with code %s" % dead[0])
            elif since is not None and time.monotonic() - since > self.guard_s:
                self._abort("the group made no progress for %g s" % self.guard_s)

    def _abort(self, why):
        print("portbench: sharded: %s; the run ends with no result" % why,
              file=sys.stderr, flush=True)
        for p in self.workers:
            p.kill()
        os._exit(1)

    def _broadcast(self, seed, go):
        torch = self.ctx.torch
        self.dist.broadcast(torch.tensor([int(seed), int(go)], dtype=torch.int64,
                                         device=self.ctx.device), src=0)

    def _estimate(self, seed):
        with self._guard():
            self._broadcast(seed, 1)
            with self.ctx.span("kernel"):
                accs = self.step(seed)
            with self.ctx.span("estimates"):
                return self._estimates(accs)

    def run(self, seed, keep):
        est = self._estimate(seed)
        return {"seed": seed, "samples": sum(self.n), "answer": est}

    def release(self):
        if self._done.is_set():
            return
        self._stopping = True
        with self._guard():
            try:
                self._broadcast(0, 0)
                if self.ctx.device.type == "cuda":
                    self.ctx.torch.cuda.synchronize(self.ctx.device)
            finally:
                self.dist.destroy_process_group()
            for p in self.workers:
                p.wait()
        self._done.set()
        bad = [(r, p.returncode) for r, p in enumerate(self.workers, 1) if p.returncode]
        if bad:
            raise RuntimeError("worker rank %d exited with code %s" % bad[0])


def shard_devices(ctx):
    """Where the reference runs each shard: on card s once the workers are
    gone, where the machine has a card per shard, else on the run's
    device."""
    torch, world = ctx.torch, processes(ctx)
    if ctx.device.type == "cuda" and torch.cuda.device_count() >= world:
        return [torch.device("cuda", s) for s in range(world)]
    return [ctx.device] * world


def reference_answer(ctx, seed, control):
    """The estimate of the shards' ranges added in shard order, and shard
    0's valid counts. Chunks of 2^24 samples keep the host's launches of
    four shards at once few."""
    from concurrent.futures import ThreadPoolExecutor

    cfg, cell = ctx.config, ctx.cell
    values, acc = precision(cfg, control)
    world, n = processes(ctx), [int(x) for x in cell["n_per_level"]]
    devices = shard_devices(ctx)

    def shard_sums(s):
        return sharded.range_level_sums(
            seed, sharded.shard_ranges(n, world, s), cfg["levels"]["steps"],
            int(cfg["moments"]["n"]), tuple(cfg["moments"]["domain"]), values, acc,
            devices[s], chunk=1 << 24)

    with ThreadPoolExecutor(len(set(devices))) as pool:
        per_shard = list(pool.map(shard_sums, range(world)))
    est = moments.estimate(sharded.add_shards(per_shard))
    est["n_samples"] = est["n"]
    return est, [int(level["n_valid"]) for level in per_shard[0]]


def check(ctx, records, control):
    """The largest gap of each kind over the checked jobs (``fused.compare``).
    Each checked job gets shard 0's valid counts as its ``work``: card 0's
    share, which the kernel metric of this cell holds card 0's time to."""
    numbers = {}
    for rec in records:
        want, shard0 = reference_answer(ctx, rec["seed"], control=False)
        got = reference_answer(ctx, rec["seed"], control=True)[0] if control else rec["answer"]
        for k, v in fused.compare(got, want).items():
            numbers[k] = max(numbers.get(k, 0.0), v)
        rec["work"] = {"n_valid": shard0, "n_moments": int(ctx.config["moments"]["n"])}
    return numbers
