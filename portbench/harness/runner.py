"""One run of one cell: set-up, the measured window, the check, the result.

The window is a closed loop with one client: jobs run back to back, each
from a seed of its own derived from (--seed, job index), from the start of
the first job to the end of the last job that started inside --seconds.
A job ends when its results are on the host. After the window the peak
device memory is read, the program's state is freed, and the plain
reference judges the jobs chosen for the check (drawn from the seed; in a
traced run, the traced jobs). The result is one JSON line, the last line of
standard output; the numbers compared, each beside its limit, are the last
lines of standard error and the last key of that line.
"""
import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np

CODE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "mlmc_tpu")


def _process_age():
    """Seconds since this process started (Linux /proc), or 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def derive_seed(seed, *tags):
    """A 63-bit seed of (seed, tags) that no other tuple shares by design."""
    words = np.random.SeedSequence([int(seed) % 2 ** 64, *tags]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Context:
    """What a job kind is given: the cell's data, the device, the tracer."""

    def __init__(self, torch, device, config, cell, tracer, seed):
        self.torch, self.device, self.config, self.cell = torch, device, config, cell
        self.tracer, self.seed = tracer, seed
        self.span = tracer.span

    def warm_seed(self, i):
        return derive_seed(self.seed, 1, i)


class Run:
    """What a metric reader is given (see metrics/README.md)."""

    def __init__(self, records, window_s, setup_s, trace, traced):
        self.records, self.window_s, self.setup_s = records, window_s, setup_s
        self.trace, self.traced = trace, traced


def _fail(msg):
    print("portbench: " + msg, file=sys.stderr)
    sys.exit(2)


def _power_limit():
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def load_cell(root, workload):
    """(manifest, entry, config, cell, kind) of a cell: its entry in
    BENCHMARK.json, its configuration, its own file and its job kind's
    module. Every build and kernel cache of the run is pointed at a fixed
    place inside the checkout."""
    from harness.manifest import Manifest

    manifest = Manifest(root)
    entry = manifest.cell(workload)
    config = manifest.config(entry["config"])
    cell = manifest.cell_file(workload)
    if cell["traffic"] != entry["traffic"]:
        _fail("cell file traffic %r differs from BENCHMARK.json's %r"
              % (cell["traffic"], entry["traffic"]))
    cache = os.path.join(manifest.root, ".portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(cache, sub)
    kind = load_module(os.path.join(CODE_DIR, "jobs", cell["job"] + ".py"),
                       "portbench_job_" + cell["job"])
    return manifest, entry, config, cell, kind


def open_device(torch, chips, cpu_rehearsal):
    """The card the run uses, or the CPU in a rehearsal; a machine with
    fewer cards than the cell asks for ends the run with no result."""
    if cpu_rehearsal:
        return torch.device("cpu")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _fail("needs %d CUDA device(s); found %s" % (
            chips, torch.cuda.device_count() if torch.cuda.is_available() else 0))
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    return device


def metric_reader(name):
    """The reader of a metric: ``metrics/<name>.py``, or where there is none
    ``metrics/<stem>.py``, the stem being the name up to its first dot, so
    that metrics of one quantity split by cells share a reader."""
    path = os.path.join(CODE_DIR, "metrics", name + ".py")
    if not os.path.isfile(path):
        path = os.path.join(CODE_DIR, "metrics", name.split(".")[0] + ".py")
    return load_module(path, "portbench_metric_" + name.replace(".", "_"))


def main(argv=None):
    t_origin = time.perf_counter() - _process_age()
    p = argparse.ArgumentParser(description="Run one cell of the benchmark.")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--root", default=os.path.dirname(CODE_DIR),
                   help="directory of BENCHMARK.json (default: the checkout)")
    p.add_argument("--cpu-rehearsal", action="store_true",
                   help="tests only: run on the CPU with the kernels' plain "
                        "versions; reports no device metric")
    args = p.parse_args(argv)

    manifest, entry, config, cell, kind = load_cell(args.root, args.workload)

    import torch

    device = open_device(torch, entry["chips"], args.cpu_rehearsal)

    from harness.tracing import Tracer, device_trace

    traced = bool(args.trace)
    tracer = Tracer(torch, device, traced)
    ctx = Context(torch, device, config, cell, tracer, args.seed)
    job = kind.Job(ctx)
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    # ---- the window ------------------------------------------------------ #
    n_traced = int(cell["trace_jobs"]) if traced else 0
    profiling = traced and device.type == "cuda"
    prof = None
    if profiling:
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    records, failed, error = [], 0, None
    share = float(cell["check_share"])
    t0 = time.perf_counter()
    setup_s = t0 - t_origin
    end = t0
    aside = aside_in_window = 0.0   # the benchmark's own copies after checked jobs
    j = 0
    while j == 0 or time.perf_counter() - t0 - aside < args.seconds:
        keep = j < n_traced if traced else (
            j == 0 or np.random.default_rng(derive_seed(args.seed, 2, j)).random() < share)
        tracer.new_job()
        aside_in_window = aside
        start = time.perf_counter()
        try:
            with tracer.span("job"):
                rec = job.run(derive_seed(args.seed, 0, j), keep)
        except Exception as exc:  # a job that fails ends the run as not correct
            failed, error = 1, "job %d: %s: %s" % (j, type(exc).__name__, exc)
            end = time.perf_counter()
            j += 1
            break
        end = time.perf_counter()
        rec.update(index=j, wall=end - start, spans=dict(tracer.spans),
                   counters=dict(tracer.counters), checked=keep)
        records.append(rec)
        if keep and hasattr(job, "capture"):
            # what the check needs of a job's state, taken after its end and
            # left out of the window
            job.capture(rec)
            aside += time.perf_counter() - end
        j += 1
        if prof is not None and j == n_traced:
            prof.stop()
    window_s = end - t0 - aside_in_window
    if prof is not None and j < n_traced:
        prof.stop()

    memory_peak = (torch.cuda.max_memory_allocated(device)
                   if device.type == "cuda" else 0)
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        _fail("modules that may not load in a run were loaded: %s" % ", ".join(found))
    job.release()
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # ---- the check --------------------------------------------------------- #
    from harness.checks import judge

    checked = [r for r in records if r["checked"]]
    numbers = kind.check(ctx, checked, control=False) if checked else {}
    correct, rows = judge(numbers, cell["limits"])
    correct = correct and failed == 0 and bool(records)

    # ---- metrics ----------------------------------------------------------- #
    trace = None
    if prof is not None:
        trace = device_trace(prof, tracer.names)
    run = Run(records, window_s, setup_s, trace, records[:n_traced])
    metrics = {}
    for spec in manifest.metrics(args.workload, traced):
        if device.type != "cuda" and spec["source"] == "device_trace":
            continue
        value = metric_reader(spec["name"]).read(run)
        if value is not None:
            metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}

    if device.type == "cuda":
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
               "count": entry["chips"], "memory_peak_bytes": int(memory_peak)}
        smi = _power_limit()
        if smi:
            dev["name_and_power_limit"] = smi
        if trace is not None:
            dev.update(busy_s=trace.busy_s, window_s=trace.window_s)
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    result = {"correct": bool(correct), "attempted": j, "failed": failed,
              "metrics": metrics, "device": dev}
    if trace is not None:
        result["breakdown"] = trace.breakdown()
    if error:
        result["error"] = error
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    if error:
        print("portbench: " + error, file=sys.stderr)
    if records:
        walls = np.array([r["wall"] for r in records])
        half = len(walls) // 2
        print("jobs: %d in %.3f s; wall median %.6g s, first half mean %.6g s, second half "
              "mean %.6g s, max %.6g s" % (len(walls), window_s, np.median(walls),
                                           walls[:half].mean() if half else walls.mean(),
                                           walls[half:].mean(), walls.max()), file=sys.stderr)
    for name, value, limit in rows:
        print("check %s: %r (limit %r)" % (name, value, limit), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
