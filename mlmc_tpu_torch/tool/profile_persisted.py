"""Where the time of a persisted run goes, on one GPU.

Run from the root of a checkout:

    python3 -m mlmc_tpu_torch.tool.profile_persisted

Drives ``chip_smoke.py``'s persisted path through the binary log (the
synthetic simulation's 24 components on 2^21 + 2^19 + 2^17 samples: the
first half of every level, close, reopen, the rest, close; then the three
estimation tiers over the reopened directory) with a host-clock timer
around each step, and prints the card's ``nvidia-smi`` name and power
limit, each step's calls and seconds, and one JSON line:

* card -> host -> file: the pool's fetch (it waits for the batch and
  copies the f32 payload into pageable host memory), the widening to the
  file's f64 records, ``write``, ``fdatasync``, the id sidecar, the
  scheduled-id log and every rewrite of the JSON metadata, reopening;
* file -> host -> card: the copy out of the memory map, the transpose and
  upload of each chunk, and the rest of each tier.

A timer includes what its function calls; the steps listed are disjoint
except where the output says that one includes or lies inside another.
"""
import collections
import json
import os
import shutil
import tempfile
import time

import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import native, sample_storage_bin
from mlmc_tpu_torch.ops import _build
from mlmc_tpu_torch.quantity import quantity
from mlmc_tpu_torch.tool.timing import smi

LEVELS = [[0.1], [0.01], [0.001]]
FULL = [1 << 21, 1 << 19, 1 << 17]


class Timers:
    """Host-clock seconds and calls of wrapped functions, by name."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self._undo = []

    def wrap(self, owner, attr, name):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.seconds[name] += time.perf_counter() - t0
                self.calls[name] += 1

        setattr(owner, attr, timed)
        self._undo.append((owner, attr, fn))

    def restore(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)

    def take(self):
        """The table so far, then start anew."""
        out = {name: (self.calls[name], self.seconds[name]) for name in self.seconds}
        self.seconds.clear()
        self.calls.clear()
        return out


def _stage(directory, counts, dev):
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = mt.SampleStorageBin(directory)
    pool = mt.DeviceBatchPool(seed=3, device_results=False, max_batch=1 << 18,
                              inflight_bytes=1 << 26, device=dev)
    sampler = mt.Sampler(storage, pool, sim, LEVELS)
    sampler.set_initial_n_samples(counts)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    storage.close()


def _report(title, total, table, order):
    print("%s: %.3f s" % (title, total))
    for name in order:
        calls, seconds = table.get(name, (0, 0.0))
        print("  %-58s %5d calls %8.3f s %5.1f%%"
              % (name, calls, seconds, 100.0 * seconds / total))
    return {"seconds": total, "steps": {n: table.get(n, (0, 0.0)) for n in order}}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_persisted: no CUDA device")
    if not native.available():
        raise SystemExit("profile_persisted: the sample-log library did not "
                         "build:\n%s" % native.build_error())
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit"))
    _build.load_library("samples_mlmc")     # kernels C, D: built before timing
    timers = Timers()
    bin_cls = sample_storage_bin.SampleStorageBin
    write_steps = [
        (mt.DeviceBatchPool, "_fetch",
         "pool fetch: wait for the batch, f32 payload to pageable host"),
        (sample_storage_bin, "host_pairs", "widen to [n, 2, M] f64 records"),
        (native.SampleLogWriter, "append", "write() of the records"),
        (native.SampleLogWriter, "flush", "fdatasync() of the log"),
        (bin_cls, "_append_ids", "collected ids: tag strings + the .ids sidecar"),
        (bin_cls, "save_scheduled_samples",
         "scheduled ids: tag strings + metadata rewrite"),
        (bin_cls, "_save_meta", "every JSON metadata rewrite (partly inside the step above)"),
        (bin_cls, "__init__", "open the directory (metadata and ids read back)"),
        (bin_cls, "unfinished_ids", "unfinished ids (scheduled - finished)"),
    ]
    read_steps = [
        (native.SampleLogReader, "read", "copy the chunk out of the memory map"),
        (quantity.QuantityStorage, "samples",
         "chunk to the card (includes the copy above): transpose, upload"),
    ]
    for owner, attr, name in write_steps + read_steps:
        timers.wrap(owner, attr, name)
    directory = tempfile.mkdtemp(prefix="mlmc_profile_persisted_")
    out = {"card": smi("name,power.limit"), "samples": sum(FULL)}
    try:
        half = [n // 2 for n in FULL]
        for title, counts in (("stage 1 (first half of every level)", half),
                              ("stage 2 (reopen, the rest)", FULL)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _stage(os.path.join(directory, "run"), counts, dev)
            total = time.perf_counter() - t0
            out[title] = _report("card -> host -> file, " + title, total,
                                 timers.take(), [s[2] for s in write_steps])
        storage = mt.SampleStorageBin(os.path.join(directory, "run"))
        timers.take()
        sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
        mfn = mt.Legendre(8, (-10, 10))
        root = mt.make_root_quantity(storage, sim.result_format(), device=dev)
        est = mt.Estimate(root["length"][1]["10"][0, 0], storage, mfn)
        for tier, call in (("generic tier", lambda: est.estimate_moments(mfn)),
                           ("fast tier (kernel C)", est.estimate_moments_fast),
                           ("f64 tier (kernel D)", est.estimate_moments_extended)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            out[tier] = _report("file -> host -> card, " + tier, total,
                                timers.take(), [s[2] for s in read_steps])
        storage.close()
    finally:
        timers.restore()
        shutil.rmtree(directory, ignore_errors=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
