"""The sharded job kind (synth5.sharded4) on the CPU: rank 0 in the run's
process and three workers over gloo, at tiny sizes. The run is correct, the
control and a broken timed path are not, a dead rank ends the run at once
with no result, and the two readers of the cell read what they should from
a trace and nothing from a trace without their kernels."""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from conftest import CODE, make_root
from harness.checks import judge
from harness.manifest import Manifest
from harness.runner import Context, Run, derive_seed, load_module, metric_reader
from harness.tracing import DeviceTrace, Tracer

CELL = "synth5.sharded4"
TINY = {CELL: dict(n_per_level=[4000, 2000, 1000, 500, 200], check_share=0.5, trace_jobs=2)}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(str(tmp_path_factory.mktemp("sharded_root")), cells=TINY)


def _start(root, seconds, trace="0"):
    return subprocess.Popen(
        [sys.executable, os.path.join(CODE, "run.py"), "--workload", CELL, "--seed",
         "3000000123", "--seconds", seconds, "--trace", trace, "--root", root,
         "--cpu-rehearsal"], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("trace", ["0", "1"])
def test_rehearsal_runs_and_is_correct(root, trace):
    run = _start(root, "0.5", trace)
    out, err = run.communicate(timeout=300)
    assert run.returncode == 0, err[-3000:]
    result = json.loads(out.strip().splitlines()[-1])
    assert result["correct"] and result["attempted"] >= 2, err[-2000:]
    if trace == "0":
        assert set(result["metrics"]) == {"setup_s", "samples_per_s", "job_p95_ms"}
    else:
        # a CPU run carries no device metric, and kernel A's launcher, whose
        # span prepare_ms.fused reads, runs only on a card
        assert set(result["metrics"]) <= {"host_ms.fused"}


def _job(root, seed=3000000077):
    manifest = Manifest(root)
    spec = manifest.cell_file(CELL)
    config = manifest.config(manifest.cell(CELL)["config"])
    device = torch.device("cpu")
    kind = load_module(os.path.join(CODE, "jobs", "sharded.py"), "kind_sharded")
    ctx = Context(torch, device, config, spec, Tracer(torch, device, False), seed)
    return kind, ctx, spec


def test_the_control_fails_and_the_program_passes(root):
    kind, ctx, spec = _job(root)
    job = kind.Job(ctx)
    try:
        rec = job.run(derive_seed(3000000077, 0, 0), True)
    finally:
        job.release()
    assert judge(kind.check(ctx, [rec], control=False), spec["limits"])[0]
    assert not judge(kind.check(ctx, [rec], control=True), spec["limits"])[0]
    # the kernel metric's work: shard 0's valid samples, a quarter of each level
    assert [4 * n for n in rec["work"]["n_valid"]] == pytest.approx(
        rec["answer"]["n_samples"].tolist(), rel=0.1)


@pytest.mark.parametrize("fault", [None, "rank0_alone", "same_indices"])
def test_shards_left_out_or_drawn_twice_are_not_correct(root, fault):
    """The check holds the job to its guarantee: each sample index of each
    level drawn and reduced once. Four shards of the right ranges added
    pass; rank 0's shard alone (no all-reduce), or four shards that all
    draw shard 0's indices, fail."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.ops.fused_estimate import accumulators_to_estimates
    from mlmc_tpu_torch.parallel import SampleMesh

    kind, ctx, spec = _job(root)
    cfg, seed = ctx.config, derive_seed(3000000077, 0, 0)
    counts = [n // 4 for n in spec["n_per_level"]]
    shards = [0] if fault == "rank0_alone" else range(4)
    parts = [mt.synth_mlmc_pipeline(
        seed, int(cfg["moments"]["n"]), counts, cfg["levels"]["steps"],
        domain=tuple(cfg["moments"]["domain"]), device="cpu",
        starts=[0 if fault == "same_indices" else s * c for c in counts]) for s in shards]
    accs = SampleMesh(["cpu"] * len(parts), group=False).reduce(parts)
    rec = {"seed": seed, "answer": accumulators_to_estimates(accs)}
    assert judge(kind.check(ctx, [rec], control=False), spec["limits"])[0] == (fault is None)


def _children(pid):
    with open("/proc/%d/task/%d/children" % (pid, pid)) as f:
        return [int(c) for c in f.read().split()]


def _alive(pid):
    try:
        with open("/proc/%d/stat" % pid) as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


@pytest.mark.parametrize("victim", ["worker", "rank0"])
def test_a_dead_rank_ends_the_run_soon(root, victim):
    """A worker killed in the window ends the run with an error and no
    result line within seconds; with rank 0 killed, every worker exits."""
    run = _start(root, "120")
    deadline = time.monotonic() + 120
    while len(_children(run.pid)) < 3 and time.monotonic() < deadline:
        time.sleep(0.2)
    workers = _children(run.pid)
    assert len(workers) == 3
    time.sleep(8)           # the group joined and the window running
    killed = time.monotonic()
    if victim == "worker":
        os.kill(workers[1], signal.SIGKILL)
        out, err = run.communicate(timeout=60)
        assert run.returncode != 0 and time.monotonic() - killed < 30
        assert not any(line.startswith("{") for line in out.splitlines())
        # the watchdog's word, or gloo's error from rank 0's collective,
        # whichever comes first
        assert "worker rank 2 exited" in err or "closed by peer" in err, err[-2000:]
    else:
        run.kill()
        run.communicate(timeout=60)
        while any(_alive(w) for w in workers) and time.monotonic() - killed < 30:
            time.sleep(0.2)
        assert not any(_alive(w) for w in workers)


@pytest.mark.parametrize("module", [None, "jax", "mlmc_tpu.estimate"])
def test_a_worker_names_the_forbidden_modules_it_loaded(monkeypatch, module):
    """A worker's last word on stop: the modules that may not load in a
    run that its own process loaded (a non-empty list exits non-zero)."""
    import types

    worker = load_module(os.path.join(CODE, "jobs", "sharded_worker.py"), "kind_sharded_worker")
    for name in [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "mlmc_tpu")]:
        monkeypatch.delitem(sys.modules, name)      # loaded by other tests of this process
    if module is not None:
        monkeypatch.setitem(sys.modules, module, types.ModuleType(module))
    assert worker.forbidden_loaded() == ([] if module is None else [module.split(".")[0]])


def _trace(ops, n_jobs=2):
    jobs = [(float(j), j + 0.9) for j in range(n_jobs)]
    return DeviceTrace(ops, [("job", s, e) for s, e in jobs], jobs)


def _run(trace, work=None):
    records = [dict(wall=1.0, spans={}, counters={}, samples=1) for _ in range(2)]
    if work is not None:
        for r in records:
            r["work"] = work
    return Run(records, 2.0, 1.0, trace, records)


def test_readers_of_the_cell():
    from harness import roofline

    ops = [("void (anonymous namespace)::synth_mlmc_kernel<4>(float const*)", 0.0, 0.4),
           ("void gram::gram_reduce<LevelCoarse>(double*)", 0.4, 0.5),
           ("ncclDevKernel_Broadcast_RING_LL(ncclDevKernelArgsStorage<4096ul>)", 0.5, 0.51),
           ("ncclDevKernel_AllReduce_Sum_f64_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            0.51, 0.53),
           ("ncclDevKernel_AllReduce_Sum_i64_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            0.53, 0.54),
           ("void synth_mlmc_kernel<4>(float const*)", 1.0, 1.4),
           ("void gram_reduce(double*)", 1.4, 1.5),
           ("ncclDevKernel_AllReduce_Sum_f64_RING_LL(...)", 1.5, 1.52)]
    shard0 = [256000000, 96000000, 32000000, 12000000, 4000000]   # float64-bound
    run = _run(_trace(ops), {"n_valid": shard0, "n_moments": 25})
    allreduce = metric_reader("allreduce_ms.sharded").read(run)
    assert allreduce == pytest.approx(1e3 * 0.05 / 2)
    share = metric_reader("kernel_a.roofline_pct.sharded").read(run)
    least = roofline.least_seconds(*roofline.fused_work(shard0, 25))[0]
    assert share == pytest.approx(100.0 * 2 * least / 1.0)
    # four times the work (the whole job's counts) would read four times as much
    whole = _run(_trace(ops), {"n_valid": [4 * n for n in shard0], "n_moments": 25})
    assert metric_reader("kernel_a.roofline_pct.sharded").read(whole) == pytest.approx(4 * share)

    other = _run(_trace([("void at::native::elementwise_kernel(...)", 0.0, 0.1)]),
                 {"n_valid": shard0, "n_moments": 25})
    assert metric_reader("allreduce_ms.sharded").read(other) is None
    assert metric_reader("kernel_a.roofline_pct.sharded").read(other) is None
    assert metric_reader("allreduce_ms.sharded").read(_run(None)) is None
    assert metric_reader("kernel_a.roofline_pct.sharded").read(_run(None)) is None
