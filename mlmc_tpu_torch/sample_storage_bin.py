"""High-throughput binary sample storage over the native C++ engine,
counterpart of ``mlmc_tpu/sample_storage_bin.py``.

Per-level append-only memory-mapped record logs
(``mlmc_tpu_torch/native/sample_log.cpp``) carry the [N, 2, M] result
stream, with a background page-prefetch thread on the read side, while the
light metadata (scheduled/failed ids, costs, level parameters, result
format) lives in a JSON sidecar. Same SampleStorage contract as Memory /
SampleStorageHDF (chunked [M, N, 2] reads, resume, renew-failed), so it is
a drop-in for the Sampler and the Quantity layer. The payload stays in the
files and is read chunk by chunk as host numpy (``payload_resident`` stays
False); the bulk write path takes tensors on any device as well as numpy.

Use SampleStorageHDF when interoperability with GeoMop/MLMC files matters;
use this backend for raw throughput (no HDF5 chunk-tree overhead, zero-copy
mmap reads). The directory layout (``level_<l>.bin``, ``level_<l>.ids``,
``meta.json``) is that of ``mlmc_tpu``: either package resumes the other's.
"""
import json
import os
from typing import List

import numpy as np

from mlmc_tpu_torch.sample_storage import SampleStorage, host_pairs
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec, ChunkSpec
from mlmc_tpu_torch import native


DEFAULT_CHUNK_RECORDS = 1 << 16


class SampleStorageBin(SampleStorage):
    """Samples persisted in native binary logs + JSON metadata sidecar."""

    def __init__(self, dir_path, chunk_records=DEFAULT_CHUNK_RECORDS):
        super().__init__()
        if not native.available():
            raise RuntimeError(
                "native engine unavailable ({}); use Memory or "
                "SampleStorageHDF".format(native.build_error()))
        self._dir = os.path.abspath(dir_path)
        os.makedirs(self._dir, exist_ok=True)
        self._meta_path = os.path.join(self._dir, "meta.json")
        self._chunk_records = int(chunk_records)
        self._writers = {}
        self._readers = {}
        self._meta = {
            "level_parameters": [],
            "result_format": [],
            "scheduled": {},
            "failed": {},
            "n_ops": {},
            "m": None,
        }
        if os.path.exists(self._meta_path):
            with open(self._meta_path) as f:
                self._meta = json.load(f)
            self._meta.pop("collected_ids", None)  # legacy location
        # collected ids live in append-only sidecars (one per level) so
        # save_samples never rewrites them (JSON rewrite dominated writes)
        self._collected_ids = {}
        self._id_files = {}
        for name in os.listdir(self._dir):
            if name.startswith("level_") and name.endswith(".ids"):
                lvl = int(name[len("level_"):-len(".ids")])
                with open(os.path.join(self._dir, name)) as f:
                    self._collected_ids[lvl] = f.read().split()

    # ------------------------------------------------------------------ #
    def _level_path(self, level_id):
        return os.path.join(self._dir, "level_{}.bin".format(int(level_id)))

    def _append_ids(self, level_id, ids):
        level_id = int(level_id)
        if level_id not in self._id_files:
            self._id_files[level_id] = open(
                os.path.join(self._dir, "level_{}.ids".format(level_id)), "a")
        self._id_files[level_id].write("\n".join(ids) + "\n")
        self._id_files[level_id].flush()
        self._collected_ids.setdefault(level_id, []).extend(ids)

    def _writer(self, level_id):
        if level_id not in self._writers:
            self._writers[level_id] = native.SampleLogWriter(
                self._level_path(level_id), self._meta["m"])
        return self._writers[level_id]

    def _reader(self, level_id):
        # reopen if the log grew since the reader was created
        path = self._level_path(level_id)
        r = self._readers.get(level_id)
        if r is not None:
            expected = len(self._collected_ids.get(level_id, []))
            if r.n_records < expected:
                r.close()
                r = None
        if r is None:
            if level_id in self._writers:
                self._writers[level_id].flush()
            r = native.SampleLogReader(path)
            self._readers[level_id] = r
        return r

    def _save_meta(self):
        tmp = self._meta_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self._meta, f)
        os.replace(tmp, self._meta_path)

    def close(self):
        for w in self._writers.values():
            w.close()
        for r in self._readers.values():
            r.close()
        for f in self._id_files.values():
            f.close()
        self._writers = {}
        self._readers = {}
        self._id_files = {}
        self._save_meta()

    # ------------------------------------------------------------------ #
    def save_global_data(self, result_format: List[QuantitySpec],
                         level_parameters=None):
        self.save_result_format(result_format)
        self._meta["level_parameters"] = np.asarray(
            level_parameters, dtype=float).tolist()
        m = int(sum(int(np.prod(q.shape)) * len(q.times) * len(q.locations)
                    for q in result_format))
        if self._meta["m"] not in (None, m):
            raise ValueError("result size changed for existing storage")
        self._meta["m"] = m
        self._save_meta()

    def save_result_format(self, res_spec: List[QuantitySpec]):
        fmt = [dict(name=q.name, unit=q.unit, shape=list(q.shape),
                    times=list(q.times), locations=list(q.locations))
               for q in res_spec]
        if self._meta["result_format"] and self._meta["result_format"] != fmt:
            raise ValueError(
                "You are setting a new different result format for an "
                "existing sample storage")
        self._meta["result_format"] = fmt

    def load_result_format(self) -> List[QuantitySpec]:
        return [
            QuantitySpec(name=q["name"], unit=q["unit"],
                         shape=tuple(q["shape"]), times=q["times"],
                         locations=[tuple(l) if isinstance(l, list) else l
                                    for l in q["locations"]])
            for q in self._meta["result_format"]
        ]

    # ------------------------------------------------------------------ #
    def save_samples(self, successful, failed):
        for level_id, res in successful.items():
            if len(res) == 0:
                continue
            ids = [sid for sid, _ in res]
            values = np.stack(
                [np.stack([np.ravel(f), np.ravel(c)]) for _, (f, c) in res])
            self._writer(int(level_id)).append(values)
            self._append_ids(level_id, ids)
        for level_id, res in failed.items():
            if len(res) == 0:
                continue
            self._meta["failed"].setdefault(str(int(level_id)), []).extend(
                [[sid, msg] for sid, msg in res])
        for w in self._writers.values():
            w.flush()
        self._save_meta()

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        # rows past len(ids) are not samples (see Memory.save_samples_bulk):
        # never write them to the log
        self._writer(int(level_id)).append(
            host_pairs(fine, coarse, len(ids)))
        self._writers[int(level_id)].flush()
        self._append_ids(level_id, list(ids))

    def save_scheduled_samples(self, level_id, samples):
        self._meta["scheduled"].setdefault(str(int(level_id)), []).extend(
            list(samples))
        self._save_meta()

    def load_scheduled_samples(self):
        return {int(k): list(v) for k, v in self._meta["scheduled"].items()}

    # ------------------------------------------------------------------ #
    def _n_level_collected(self, level_id):
        return len(self._collected_ids.get(int(level_id), []))

    def _level_chunks(self, level_id, n_samples=None):
        n_total = self._n_level_collected(level_id)
        if n_samples is not None:
            n_total = min(n_total, int(n_samples))
        chunk = self._chunk_records
        for i, start in enumerate(range(0, max(n_total, 1), chunk)):
            yield ChunkSpec(chunk_id=i,
                            chunk_slice=slice(start, min(start + chunk, n_total), 1),
                            level_id=int(level_id))

    def sample_pairs_level(self, chunk_spec):
        level_id = int(chunk_spec.level_id or 0)
        sl = chunk_spec.chunk_slice
        if sl is None:
            sl = slice(0, self._n_level_collected(level_id), 1)
        if self._n_level_collected(level_id) == 0:
            # zero-collected level: no log file exists yet — an empty,
            # correctly shaped chunk (mirrors Memory.sample_pairs_level)
            m = int(self._meta["m"] or 0)
            empty = np.zeros((0, 2 if level_id else 1, m))
            return empty.transpose((2, 0, 1))
        reader = self._reader(level_id)
        chunk = reader.read(sl.start, sl.stop - sl.start)  # [N, 2, M]
        if level_id == 0:
            chunk = chunk[:, :1, :]
        return chunk.transpose((2, 0, 1))

    def sample_pairs(self):
        # indexed by LEVEL ID (a gap must not shift later levels); empty
        # levels leave a None slot, as in the Memory backend
        levels = self.get_level_ids()
        out = [None] * (max(levels) + 1 if levels else 0)
        for level_id in levels:
            n = self._n_level_collected(level_id)
            if n == 0:
                continue
            spec = ChunkSpec(chunk_id=0, chunk_slice=slice(0, n, 1),
                             level_id=level_id)
            out[level_id] = self.sample_pairs_level(spec)
        return out

    # ------------------------------------------------------------------ #
    def n_finished(self):
        levels = self.get_level_ids()
        if not levels:
            return np.zeros(0)
        n = np.zeros(max(levels) + 1)
        for lvl in levels:
            n[lvl] = self._n_level_collected(lvl) + \
                len(self._meta["failed"].get(str(lvl), []))
        return n

    def unfinished_ids(self):
        unfinished = []
        for lvl_key, scheduled in self._meta["scheduled"].items():
            done = set(self._collected_ids.get(int(lvl_key), []))
            done.update(sid for sid, _ in self._meta["failed"].get(lvl_key, []))
            unfinished.extend(sorted(set(scheduled) - done))
        return unfinished

    def failed_samples(self):
        return {k: [sid for sid, _ in v]
                for k, v in self._meta["failed"].items()}

    def clear_failed(self):
        self._meta["failed"] = {}
        self._save_meta()

    def save_n_ops(self, n_ops):
        # latest cumulative [total time, n] report replaces the record
        # (pools report totals per drain; re-adding double-counts)
        for level, (time, n_samples) in n_ops:
            self._meta["n_ops"][str(int(level))] = [float(time),
                                                    float(n_samples)]
        self._save_meta()

    def get_n_ops(self):
        levels = self.get_level_ids()
        n_ops = [0.0] * (max(levels) + 1 if levels else 0)
        for key, (time, n) in self._meta["n_ops"].items():
            if n > 0:
                n_ops[int(key)] = time / n
        return n_ops

    def get_level_ids(self):
        ids = set(self._collected_ids.keys())
        ids.update(int(k) for k in self._meta["scheduled"].keys())
        if not ids and self._meta["level_parameters"]:
            ids = set(range(len(self._meta["level_parameters"])))
        return sorted(ids)

    def get_n_collected(self):
        # indexed by level id, zero-filled (positional lists over a
        # sorted id set desync on gaps)
        levels = self.get_level_ids()
        out = [0] * (max(levels) + 1 if levels else 0)
        for lvl in levels:
            out[lvl] = self._n_level_collected(lvl)
        return out

    def get_n_levels(self):
        return max(len(self._meta["level_parameters"]),
                   len(self.get_level_ids()))

    def get_level_parameters(self):
        return self._meta["level_parameters"]
