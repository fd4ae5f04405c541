"""Sample execution runtimes (pools), counterpart of
``mlmc_tpu/sampling_pool.py``.

The pool contract is kept (``schedule_sample`` / ``get_finished`` /
``have_permanent_samples``):

* ``DeviceBatchPool`` — scheduled sample ids become Philox counters (seed,
  level, index, attempt); a level's pending samples run as whole batches of
  tensor code on the pool's device (``calculate_keyed_batch`` of the
  synthetic, shooting and Darcy simulations) and stay there until the
  storage takes them. NaN results and injected failures become failed
  samples, unless the level says ``nan_result_is_failure=False`` (the
  shooting simulations store NaN as a result); renewals re-run with the
  attempt as salt.
* ``OneProcessPool`` / ``ProcessPool`` / ``ThreadPool`` — the host loops
  for simulations without a keyed batch path (external programs, workspace
  simulations), with md5(sample_id) seeding. A pool's ``device`` goes to a
  simulation's ``calculate`` that takes one. ``ProcessPool`` starts its
  workers with ``spawn`` and has them compute on the CPU: a worker process
  never initialises CUDA. Simulations that need a directory per sample
  (``need_sample_workspace``) run inside ``<work_dir>/output/<sample_id>``;
  failed samples and the first few successful ones are archived there.
"""
import collections
import hashlib
import inspect
import os
import shutil
import sys
import time
import traceback
from abc import ABC, abstractmethod

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.tool import profiling

# bulk level results: arrays instead of per-sample tuples (storages with
# save_samples_bulk consume these without marshalling)
BulkResults = collections.namedtuple("BulkResults", ["ids", "fine", "coarse"])


def _round_up_bucket(n, min_bucket=256):
    """Next power-of-two bucket >= n: the cost class of a batch."""
    b = min_bucket
    while b < n:
        b *= 2
    return b


class _SampleWorkspace:
    """Per-sample scratch-directory lifecycle for host simulations.

    Each workspace sample runs in ``<output>/<sample_id>`` seeded with the
    simulation's common files; on completion the directory is dropped,
    except the first ``KEEP_SUCCESSFUL`` successful samples (archived for
    inspection) and every failed sample (archived for debugging).
    """

    FAILED_DIR = "failed"
    SUCCESSFUL_DIR = "several_successful"
    KEEP_SUCCESSFUL = 5

    def __init__(self, work_dir=None, debug=False):
        self.debug = debug
        self.output_dir = (os.path.join(os.path.abspath(work_dir), "output")
                           if work_dir is not None else None)
        for sub in ("", self.FAILED_DIR, self.SUCCESSFUL_DIR):
            self._fresh_dir(sub)

    def _fresh_dir(self, sub=""):
        if self.output_dir is None:
            return None
        path = os.path.join(self.output_dir, sub)
        if not self.debug and os.path.exists(path):
            shutil.rmtree(path)
        os.makedirs(path, mode=0o775, exist_ok=True)
        return path

    def default_to_cwd(self):
        """Late-bind the output dir for pools created without work_dir."""
        if self.output_dir is None:
            self.output_dir = os.getcwd()

    def sample_dir(self, sample_id):
        path = os.path.join(self.output_dir, sample_id)
        os.makedirs(path, mode=0o775, exist_ok=True)
        return path

    def enter(self, sample_id, level_sim):
        """Create + populate the sample dir and chdir into it."""
        path = self.sample_dir(sample_id)
        for f in level_sim.common_files or ():
            shutil.copy(f, path)
        os.chdir(path)

    def _archive(self, sample_id, sub):
        target = os.path.join(self.output_dir, sub, sample_id)
        shutil.rmtree(target, ignore_errors=True)
        shutil.copytree(self.sample_dir(sample_id), target)

    def finish(self, sample_id, level_sim, failed):
        """Archive-or-drop the sample dir after the result is in."""
        if not level_sim.need_sample_workspace or self.output_dir is None:
            return
        if failed:
            self._archive(sample_id, self.FAILED_DIR)
        elif int(sample_id[-7:]) < self.KEEP_SUCCESSFUL:
            self._archive(sample_id, self.SUCCESSFUL_DIR)
        shutil.rmtree(self.sample_dir(sample_id), ignore_errors=True)


def _takes_device(calculate):
    """Whether ``calculate`` has a ``device`` parameter (decided by its
    signature: catching TypeError would hide a real one)."""
    params = inspect.signature(calculate).parameters
    return "device" in params or any(
        p.kind is inspect.Parameter.VAR_KEYWORD for p in params.values())


def _expected_result_len(result_format):
    return int(sum(np.prod(spec.shape) * len(spec.times) * len(spec.locations)
                   for spec in result_format))


class SamplingPool(ABC):
    """Runtime environment for samples."""

    # class attrs under the names scripts of the original library use
    FAILED_DIR = _SampleWorkspace.FAILED_DIR
    SEVERAL_SUCCESSFUL_DIR = _SampleWorkspace.SUCCESSFUL_DIR
    N_SUCCESSFUL = _SampleWorkspace.KEEP_SUCCESSFUL

    def __init__(self, work_dir=None, debug=False):
        self._workspace = _SampleWorkspace(work_dir, debug)
        self._debug = debug

    @property
    def _output_dir(self):
        return self._workspace.output_dir

    @abstractmethod
    def schedule_sample(self, sample_id, level_sim: LevelSimulation):
        """Queue one sample for calculation."""

    @abstractmethod
    def have_permanent_samples(self, sample_ids):
        """Inform the pool about scheduled-but-unfinished ids (resume)."""

    @abstractmethod
    def get_finished(self):
        """:return: (successful, failed, n_running, n_ops) per level."""

    @staticmethod
    def compute_seed(sample_id):
        """md5(sample_id) -> uint32."""
        digest = hashlib.md5(sample_id.encode("ascii")).digest()
        return np.frombuffer(digest, dtype="uint32")[0]

    @staticmethod
    def calculate_sample(sample_id, level_sim, work_dir=None, seed=None,
                         device=None):
        """Single-sample wrapper: reproducible seed, wall-time measurement,
        result-shape validation, exception -> traceback string.

        :param work_dir: the pool's output directory; a simulation with
            ``need_sample_workspace`` runs inside ``work_dir/sample_id``
        :param device: handed to a ``calculate`` that takes one, when given;
            None leaves the choice to the simulation (the shooting and
            Darcy simulations then take the current CUDA device)"""
        if seed is None:
            seed = SamplingPool.compute_seed(sample_id)
        if level_sim.need_sample_workspace:
            ws = _SampleWorkspace.__new__(_SampleWorkspace)
            ws.output_dir = work_dir
            ws.debug = True  # enter() only; lifecycle handled by the pool
            ws.enter(sample_id, level_sim)
        try:
            start = time.perf_counter()
            where = ({"device": device} if device is not None
                     and _takes_device(level_sim.calculate) else {})
            result = level_sim.calculate(level_sim.config_dict, seed, **where)
            elapsed = time.perf_counter() - start
            fine, coarse = result[0], result[1]
            if isinstance(fine, np.ndarray) and isinstance(coarse, np.ndarray):
                want = _expected_result_len(level_sim.result_format)
                got = (fine.size, coarse.size)
                if got != (want, want):
                    raise ValueError(
                        "result shape mismatch: expected {} values per "
                        "part, got fine={} coarse={}".format(want, *got))
        except Exception:
            err = "".join(traceback.format_exception(*sys.exc_info()))
            return sample_id, (None, None), err, 0
        return sample_id, result, "", elapsed


class OneProcessPool(SamplingPool):
    """Everything runs inline in one process, one sample per call.

    Collection is plain per-level lists: results are produced and drained
    on the pool owner's thread only (ProcessPool/ThreadPool also process
    futures inside ``get_finished``), so no lock is needed.
    """

    def __init__(self, work_dir=None, debug=False, device=None):
        """:param work_dir: parent of the ``output`` directory of sample
            workspaces (None: the cwd at the first workspace sample)
        :param debug: keep every sample directory
        :param device: where each sample is computed (see
            ``calculate_sample``)"""
        super().__init__(work_dir=work_dir, debug=debug)
        self._device = device
        self._done = {}    # level_id -> [(sample_id, (fine, coarse))]
        self._errors = {}  # level_id -> [(sample_id, message)]
        self._n_running = 0
        self.times = {}    # level_id -> [total seconds, n samples]

    def schedule_sample(self, sample_id, level_sim):
        self._n_running += 1
        if level_sim.need_sample_workspace:
            self._workspace.default_to_cwd()
        self._process_result(
            *SamplingPool.calculate_sample(sample_id, level_sim,
                                           work_dir=self._output_dir,
                                           device=self._device),
            level_sim)

    def _process_result(self, sample_id, result, err_msg, elapsed, level_sim):
        lid = level_sim.level_id
        # always create the level's record: a level whose samples all fail
        # must still appear in the cost vector
        t = self.times.setdefault(lid, [0, 0])
        if elapsed:
            t[0] += elapsed
            t[1] += 1
        if err_msg:
            self._errors.setdefault(lid, []).append((sample_id, err_msg))
            self._workspace.finish(sample_id, level_sim, failed=True)
        else:
            self._done.setdefault(lid, []).append(
                (sample_id, (result[0], result[1])))
            if not self._debug:
                self._workspace.finish(sample_id, level_sim, failed=False)

    def have_permanent_samples(self, sample_ids):
        return False

    def _drain(self, store):
        out = {lid: lst for lid, lst in store.items() if lst}
        for lst in out.values():
            self._n_running -= len(lst)
        store.clear()
        return out

    def get_finished(self):
        return (self._drain(self._done), self._drain(self._errors),
                self._n_running, list(self.times.items()))


class ProcessPool(OneProcessPool):
    """Multi-process local pool via concurrent.futures.

    The workers are started with ``spawn`` (a fork of a process that holds
    a CUDA context does not survive its first CUDA call) and compute every
    sample with ``device="cpu"``, whatever device the parent works on.
    """

    def __init__(self, n_processes, work_dir=None, debug=False):
        import concurrent.futures
        import multiprocessing

        super().__init__(work_dir=work_dir, debug=debug, device="cpu")
        self._executor = concurrent.futures.ProcessPoolExecutor(
            max_workers=n_processes,
            mp_context=multiprocessing.get_context("spawn"))
        self._futures = []

    def schedule_sample(self, sample_id, level_sim):
        self._n_running += 1
        if level_sim.need_sample_workspace:
            self._workspace.default_to_cwd()
        fut = self._executor.submit(
            SamplingPool.calculate_sample, sample_id, level_sim,
            self._output_dir, None, self._device)
        fut._mlmc_sample_id = sample_id
        self._futures.append((fut, level_sim))

    def get_finished(self):
        pending = []
        for fut, level_sim in self._futures:
            if not fut.done():
                pending.append((fut, level_sim))
                continue
            try:
                result = fut.result()
            except Exception as exc:
                # executor-level failure (worker died, unpicklable config):
                # report it as a failed sample instead of crashing collection
                # and leaving the future to be re-processed on retry
                sample_id = getattr(fut, "_mlmc_sample_id", "<unknown>")
                self._process_result(
                    sample_id, None,
                    "executor failure: {}".format(exc), 0, level_sim)
                continue
            self._process_result(*result, level_sim)
        self._futures = pending
        return super().get_finished()

    def close(self):
        """Wait for the scheduled samples and stop the workers."""
        self._executor.shutdown(wait=True)


class ThreadPool(ProcessPool):
    """Thread pool for simulations that shell out to external programs:
    the workers block in subprocess calls, so threads are enough. The
    threads share the owner's process, so the pool's ``device`` goes
    through as in ``OneProcessPool``."""

    def __init__(self, n_thread, work_dir=None, debug=False, device=None):
        import concurrent.futures

        OneProcessPool.__init__(self, work_dir=work_dir, debug=debug,
                                device=device)
        self._executor = concurrent.futures.ThreadPoolExecutor(
            max_workers=n_thread)
        self._futures = []


class DeviceBatchPool(SamplingPool):
    """A level's scheduled samples run as whole device batches.

    * sample ``(level, index)`` on its ``attempt`` draws from the Philox
      counter of ``calculate_keyed_batch``: stable and replayable, and the
      same whichever batch a sample falls in;
    * batches larger than ``max_batch`` run in slices; ``min_bucket`` sets
      the power-of-two cost class of a batch;
    * failed samples (NaN results, injected failures) return to the
      sampler as failed ids; renewals re-run with attempt + 1;
    * per-level wall time for the allocation formula's C_l comes from
      designated synchronous probes (the first and second call per (level,
      cost class)); every other batch is enqueued without waiting, and the
      failure masks of a wave come to the host in ONE blocking fetch.

    :param work_dir, debug: the pools' leading arguments (a batch pool
        runs no workspace simulation; ``work_dir`` gets its ``output``
        directory all the same)
    :param seed: Philox key of every sample
    :param sharding: a ``parallel.SampleMesh``: a batch's indices are
        split into equal shares over the shards (padded with repeats of
        its last sample, which are dropped), each shard runs its share
        of ``calculate_keyed_batch`` on its device, and the payloads are
        gathered to the pool's device in index order. The samples are
        those of ``sharding=None``; a sharded batch counts one dispatch
        per local shard
    :param bulk: report a batch's successful samples as one ``BulkResults``
        of arrays; False reports (id, (fine, coarse)) tuples of host rows
    :param device_results: keep result payloads on the device (pair with
        ``DeviceMemory``); only the failure masks cross to the host
    :param inflight_bytes: this pool's budget of un-fetched host-bound
        payload (None: ``INFLIGHT_BYTES``)
    :param device: where batches run (with a mesh: where their payloads
        are gathered); None = the current CUDA device (with a mesh: its
        first device)
    """

    #: byte budget of un-fetched payloads of a host-bound wave: the wave
    #: fetches early past it, so the device never holds more of a round's
    #: payload at once (device_results pools are exempt)
    INFLIGHT_BYTES = 1 << 30

    def __init__(self, work_dir=None, debug=False, seed=0, min_bucket=256,
                 sharding=None, bulk=True, max_batch=65536,
                 device_results=False, inflight_bytes=None, device=None):
        super().__init__(work_dir=work_dir, debug=debug)
        self._sharding = sharding
        self._bulk = bool(bulk)
        self._device_results = bool(device_results)
        self._max_batch = int(max_batch)
        self._inflight_bytes = int(inflight_bytes if inflight_bytes
                                   is not None else self.INFLIGHT_BYTES)
        self._seed = int(seed)
        self._device = (sharding.devices[0] if sharding is not None
                        and device is None else resolve_device(device))
        self._pending = {}  # level_id -> list[(indices, attempts or None)]
        self._attempts = {}  # level_id -> {index: times scheduled}
        self._level_sims = {}
        self.times = {}
        self._min_bucket = min_bucket
        self._warm = set()  # (level, bucket, is_range) keys that ran once
        self._timed = set()  # keys with a warm C_l probe
        self._cold_times = {}  # first-call timings
        self.n_dispatches = 0  # device batch calls (observability)
        self.n_blocking_fetches = 0  # host-blocking device fetches (ditto)

    # ------------------------------------------------------------------ #
    def schedule_level_batch(self, level_sim, indices, renew=False):
        """Queue a whole index array (or a contiguous range) for one level;
        ``renew=True`` salts each index with its retry count so failed
        samples re-run with fresh randomness while staying replayable."""
        level_id = level_sim.level_id
        self._level_sims[level_id] = level_sim
        if isinstance(indices, range) and not renew and indices.step == 1:
            self._pending.setdefault(level_id, []).append((indices, None))
            return
        indices = np.asarray(indices, dtype=np.int64)
        if renew:
            att_map = self._attempts.setdefault(level_id, {})
            attempts = np.empty(len(indices), dtype=np.int64)
            for k, i in enumerate(indices.tolist()):
                n_prev = att_map.get(i, 1)  # scheduled at least once before
                att_map[i] = n_prev + 1
                attempts[k] = n_prev
        else:
            attempts = np.zeros(len(indices), dtype=np.int64)
        self._pending.setdefault(level_id, []).append((indices, attempts))

    def schedule_sample(self, sample_id, level_sim):
        from mlmc_tpu_torch.tags import parse_tag

        _, idx = parse_tag(sample_id)
        level_id = level_sim.level_id
        att_map = self._attempts.setdefault(level_id, {})
        attempt = att_map.get(idx, 0)
        att_map[idx] = attempt + 1
        self._level_sims[level_id] = level_sim
        self._pending.setdefault(level_id, []).append(
            (np.array([idx], dtype=np.int64), np.array([attempt], dtype=np.int64)))

    def have_permanent_samples(self, sample_ids):
        return False

    def n_pending(self):
        return sum(sum(len(seg[0]) for seg in v) for v in self._pending.values())

    def _level_slices(self, level_id):
        """Pop a level's pending segments into dispatch slices of at most
        ``max_batch`` samples.

        :return: list of (indices (range or int64 array), attempts or None,
            cost class)
        """
        segments = self._pending.pop(level_id, None)
        if not segments:
            return []
        if (all(isinstance(seg[0], range) for seg in segments)
                and all(segments[i][0].stop == segments[i + 1][0].start
                        for i in range(len(segments) - 1))):
            # contiguous fresh batches: indices are built on the device
            idxs = range(segments[0][0].start, segments[-1][0].stop)
            attempts = None
        else:
            arrs = [np.arange(seg[0].start, seg[0].stop, dtype=np.int64)
                    if isinstance(seg[0], range) else seg[0]
                    for seg in segments]
            atts = [np.zeros(len(seg[0]), dtype=np.int64)
                    if seg[1] is None else seg[1] for seg in segments]
            idxs = np.concatenate(arrs)
            attempts = np.concatenate(atts)
        force = self._max_batch if len(idxs) > self._max_batch else None
        slices = []
        for start in range(0, len(idxs), self._max_batch):
            sub = idxs[start:start + self._max_batch]  # range stays a range
            att = None if attempts is None \
                else attempts[start:start + self._max_batch]
            bucket = force or _round_up_bucket(len(sub), self._min_bucket)
            if self._sharding is not None:
                # the cost class tiles over the mesh's shards
                bucket = self._sharding.pad_to_shards(bucket)
            slices.append((sub, att, bucket))
        return slices

    def execute_level(self, level_id):
        """Run all pending samples of one level as device batches."""
        recs = [self._dispatch_batch(level_id, *sl)
                for sl in self._level_slices(level_id)]
        return self._collect(recs)

    def _sync(self):
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _dispatch_batch(self, level_id, idxs, attempts, bucket):
        """Enqueue one batch of samples ``idxs`` (with ``attempts``).

        PyTorch enqueues device work without waiting, so consecutive
        batches (across slices and levels) run back to back; results are
        completed later in one blocking fetch (``_collect``). Only the
        first and second call per (level, cost class) wait, as the C_l
        timing probes: the queue is drained first, so a probe measures its
        own batch.
        :return: pending-record dict (completed in ``_collect``)
        """
        level_sim = self._level_sims[level_id]
        if level_sim.calculate_keyed_batch is None:
            raise ValueError("the simulation has no keyed batch path "
                             "(calculate_keyed_batch); use OneProcessPool")
        n = len(idxs)
        is_range = isinstance(idxs, range)
        warm_key = (level_id, bucket, is_range)
        first_call = warm_key not in self._warm
        self._warm.add(warm_key)
        timed = first_call or warm_key not in self._timed
        if timed:
            profiling.count("pool.probes")
            with profiling.span("pool.drain"):
                self._sync()
        t0 = time.perf_counter()
        with profiling.span("pool.dispatch"):
            if self._sharding is not None:
                fine, coarse, failed = self._sharded_batch(level_sim, level_id,
                                                           idxs, attempts)
            else:
                self.n_dispatches += 1
                if is_range:
                    idx_t = torch.arange(idxs.start, idxs.stop, dtype=torch.int64,
                                         device=self._device)
                    att_t = torch.zeros_like(idx_t)
                else:
                    idx_t = torch.from_numpy(idxs).to(self._device)
                    att_t = torch.from_numpy(attempts).to(self._device)
                fine, coarse, failed = self._keyed_batch(level_sim, level_id,
                                                         idx_t, att_t)
        if is_range:
            idxs = np.arange(idxs.start, idxs.stop, dtype=np.int64)
        rec = dict(level_id=level_id, idxs=idxs, n=n, fine=fine,
                   coarse=coarse, failed=failed, first_call=first_call)
        if timed:
            # synchronous C_l probe: the fetch waits for the batch
            self.n_blocking_fetches += 1
            self._fetch([rec])
            rec["elapsed"] = time.perf_counter() - t0
            if not first_call:
                self._timed.add(warm_key)
        return rec

    def _keyed_batch(self, level_sim, level_id, idx_t, att_t):
        """One keyed batch on the indices' device; NaN results are failed
        samples (sims with NaN as a QoI value store them instead, masked
        at estimation time)."""
        fine, coarse, failed = level_sim.calculate_keyed_batch(
            level_sim.config_dict, self._seed, level_id, idx_t, att_t)
        if getattr(level_sim, "nan_result_is_failure", True):
            failed = (failed | torch.isnan(fine).any(dim=1)
                      | torch.isnan(coarse).any(dim=1))
        return fine, coarse, failed

    def _sharded_batch(self, level_sim, level_id, idxs, attempts):
        """The batch split over the mesh: equal shares (the last sample
        repeated to fill them), each shard's share on its device, no wait
        between shards; the payloads gathered to the pool's device in
        index order and trimmed to the batch.

        :param idxs: range or int64 array; attempts: int64 array or None
        """
        mesh = self._sharding
        n = len(idxs)
        idx = (np.arange(idxs.start, idxs.stop, dtype=np.int64)
               if isinstance(idxs, range) else np.asarray(idxs, np.int64))
        att = (np.zeros(n, dtype=np.int64) if attempts is None
               else np.asarray(attempts, np.int64))
        padded = mesh.pad_to_shards(n)
        idx = np.concatenate([idx, np.full(padded - n, idx[-1], np.int64)])
        att = np.concatenate([att, np.zeros(padded - n, np.int64)])
        parts = []
        for shard, device in mesh.local_shards():
            lo, hi = mesh.bounds(padded, shard)
            parts.append(self._keyed_batch(
                level_sim, level_id, torch.from_numpy(idx[lo:hi]).to(device),
                torch.from_numpy(att[lo:hi]).to(device)))
            self.n_dispatches += 1
        return tuple(mesh.gather([p[k] for p in parts], device=self._device)[:n]
                     for k in range(3))

    def _fetch(self, recs):
        """Bring the failure masks (and, for host-bound pools, the
        payloads) of ``recs`` to the host."""
        with profiling.span("pool.fetch"):
            masks = torch.cat([r["failed"] for r in recs]).cpu().numpy()
            start = 0
            for r in recs:
                r["failed_host"] = masks[start:start + r["n"]]
                start += r["n"]
                if not self._device_results:
                    r["fine"] = r["fine"].cpu().numpy()
                    r["coarse"] = r["coarse"].cpu().numpy()

    def _collect(self, recs):
        """Complete dispatched batches: every still-pending failure mask
        comes to the host in ONE blocking fetch."""
        pend = [r for r in recs if "failed_host" not in r]
        if pend:
            self.n_blocking_fetches += 1
            self._fetch(pend)
        succ_all, fail_all = {}, {}
        with profiling.span("pool.finalize"):
            for rec in recs:
                s, f = self._finalize(rec)
                self._merge_results(succ_all, s)
                self._merge_results(fail_all, f)
        return succ_all, fail_all

    @staticmethod
    def _merge_results(dst, src):
        """Merge per-level result dicts; every value normalizes to a LIST
        of per-slice BulkResults or of (id, payload) tuples."""
        for k, v in src.items():
            items = [v] if isinstance(v, BulkResults) else list(v)
            dst.setdefault(k, []).extend(items)

    def _finalize(self, rec):
        """Post-process one completed batch into (successful, failed)."""
        from mlmc_tpu_torch.tags import TagArray, format_tags

        level_id, idxs, n = rec["level_id"], rec["idxs"], rec["n"]
        fine, coarse = rec["fine"], rec["coarse"]
        failed = rec["failed_host"]
        ok = ~failed
        failed_out = [(sid, "result is nan")
                      for sid in format_tags(level_id, idxs[failed]).tolist()]
        if not self._bulk:
            if isinstance(fine, torch.Tensor):
                fine, coarse = fine.cpu().numpy(), coarse.cpu().numpy()
            ok_pos = np.flatnonzero(ok)
            ok_ids = format_tags(level_id, idxs[ok_pos]).tolist()
            successful = [(sid, (fine[i], coarse[i]))
                          for sid, i in zip(ok_ids, ok_pos)]
        elif not failed_out:
            successful = BulkResults(TagArray(level_id, idxs), fine, coarse)
        else:
            keep = (torch.from_numpy(ok).to(fine.device)
                    if isinstance(fine, torch.Tensor) else ok)
            successful = BulkResults(TagArray(level_id, idxs[ok]), fine[keep],
                                     coarse[keep])

        n_ok = int(np.count_nonzero(ok))
        if level_id not in self.times:
            self.times[level_id] = [0, 0]
        if n_ok and rec.get("elapsed") is not None:
            # wall time is charged only to successful samples and only on
            # the designated probes; the first call per (level, cost class)
            # accumulates separately and stands in for C_l until a warm
            # measurement arrives
            target = self.times[level_id] if not rec["first_call"] \
                else self._cold_times.setdefault(level_id, [0, 0])
            target[0] += rec["elapsed"] * n_ok / max(n, 1)
            target[1] += n_ok
        return ({level_id: successful} if n_ok else {}), (
            {level_id: failed_out} if failed_out else {}
        )

    def get_finished(self):
        """Drain every pending level in one wave.

        Two passes: (A) the slices that are still needed as C_l timing
        probes run first, each waiting for its own batch; a (level, cost
        class) gets at most the probes it lacks (the first and the second
        call), however many of its slices the wave holds; (B) every other
        slice of every level is enqueued back to back and completes in ONE
        blocking fetch (or one per ``INFLIGHT_BYTES`` of host-bound
        payload).
        """
        with profiling.span("pool.wave"):
            recs, deferred = [], []
            missing = {}  # probes each key lacked when the wave began
            for level_id in sorted(self._pending.keys()):
                for sl in self._level_slices(level_id):
                    key = (level_id, sl[2], isinstance(sl[0], range))
                    if key not in missing:
                        missing[key] = (0 if key in self._timed
                                        else 1 if key in self._warm else 2)
                    if missing[key]:
                        missing[key] -= 1
                        recs.append(self._dispatch_batch(level_id, *sl))
                    else:
                        deferred.append((level_id, sl))
            successful, failed = {}, {}

            def drain(recs):
                s, f = self._collect(recs)
                self._merge_results(successful, s)
                self._merge_results(failed, f)

            pending_bytes = 0
            for level_id, sl in deferred:
                rec = self._dispatch_batch(level_id, *sl)
                recs.append(rec)
                if not self._device_results:
                    pending_bytes += (rec["fine"].numel() * rec["fine"].element_size()
                                      + rec["coarse"].numel()
                                      * rec["coarse"].element_size())
                    if pending_bytes >= self._inflight_bytes:
                        # host-bound payloads: drain the wave early so the
                        # un-fetched device buffers stay under the budget
                        drain(recs)
                        recs, pending_bytes = [], 0
            if recs:
                drain(recs)
            # warm timings win; first-call timings only stand in while a level
            # has no warm measurement yet
            times = {lvl: list(t) for lvl, t in self._cold_times.items()}
            for lvl, t in self.times.items():
                if t[1]:
                    times[lvl] = list(t)
            return successful, failed, self.n_pending(), list(times.items())
