"""HDF5-backed sample storage (checkpoint/resume), counterpart of
``mlmc_tpu/sample_storage_hdf.py`` over the schema layer in
``mlmc_tpu_torch/tool/hdf5.py``.

Contract identical to ``Memory``: chunked ``[M, N, 2]`` reads (level 0
stripped to ``[M, N, 1]``), scheduled / failed bookkeeping, per-level cost
attr, result-format guard on resume. The payload lives in the file and is
read chunk by chunk as host numpy (``payload_resident`` stays False); the
bulk write path takes tensors on any device as well as numpy. A file
written by ``mlmc_tpu`` or by GeoMop/MLMC opens here and the reverse.
"""
import os
from typing import List

import numpy as np

from mlmc_tpu_torch.sample_storage import SampleStorage, host_pairs
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
import mlmc_tpu_torch.tool.hdf5 as hdf


class SampleStorageHDF(SampleStorage):
    """Samples persisted in an HDF5 file (the GeoMop/MLMC schema)."""

    def __init__(self, file_path):
        """:param file_path: hdf5 file path (existing file -> resume)"""
        super().__init__()
        resuming = os.path.exists(file_path)
        self._hdf_object = hdf.HDF5(file_path=file_path,
                                    load_from_file=resuming)
        self._level_groups = []
        if resuming:
            self._rebuild_level_groups(
                len(self._hdf_object.level_parameters))

    def _rebuild_level_groups(self, n_levels):
        self._level_groups = [self._hdf_object.add_level_group(str(lid))
                              for lid in range(n_levels)]

    def close(self):
        self._hdf_object.close()

    # ------------------------------------------------------------------ #
    # QuantitySpec (de)marshalling. The on-disk structured dtype — field
    # names, S50 strings, f64 times, (3,)-float or S50 locations — is the
    # schema of GeoMop/MLMC files and is kept byte-compatible on purpose:
    # files are exchanged with that library and with mlmc_tpu. The shape
    # slot length follows the spec, so non-2-D result shapes round-trip.
    # ------------------------------------------------------------------ #
    @staticmethod
    def _spec_dtype(spec: QuantitySpec):
        """Structured dtype describing one QuantitySpec on disk."""
        loc0 = spec.locations[0]
        point_locations = (not isinstance(loc0, (str, bytes))
                           and len(loc0) == 3)
        return np.dtype([
            ("name", "S50"),
            ("unit", "S50"),
            ("shape", np.int32, (max(len(spec.shape), 1),)),
            ("times", np.float64, (len(spec.times),)),
            ("locations",
             np.dtype((np.float64, (3,))) if point_locations else "S50",
             (len(spec.locations),)),
        ])

    def save_global_data(self, result_format: List[QuantitySpec],
                         level_parameters=None):
        self._hdf_object.create_file_structure(level_parameters)
        if len(self._level_groups) != len(level_parameters):
            self._rebuild_level_groups(len(level_parameters))
        self.save_result_format(result_format)

    def save_result_format(self, result_format: List[QuantitySpec],
                           res_dtype=None):
        stored = None
        try:
            stored = self.load_result_format()
        except AttributeError:
            pass  # fresh file: nothing stored yet
        if stored is not None and stored != result_format:
            raise ValueError(
                "result format differs from the one stored in {!r}; a "
                "resume must keep the simulation's result schema".format(
                    self._hdf_object.file_name))
        self._hdf_object.save_result_format(
            result_format,
            res_dtype if res_dtype is not None
            else self._spec_dtype(result_format[0]))

    def load_result_format(self) -> List[QuantitySpec]:
        def decode_loc(loc):
            return loc.decode() if isinstance(loc, bytes) else tuple(loc)

        return [
            QuantitySpec(
                name=row[0].decode(),
                unit=row[1].decode(),
                shape=tuple(int(s) for s in row[2]),
                times=list(row[3]),
                locations=[decode_loc(loc) for loc in row[4]],
            )
            for row in self._hdf_object.load_result_format()
        ]

    # ------------------------------------------------------------------ #
    def save_samples(self, successful, failed):
        self._save_successful(successful)
        self._save_failed(failed)
        self._hdf_object.flush()

    def _save_successful(self, successful_samples):
        for level, samples in successful_samples.items():
            if len(samples) > 0:
                ids = [sid for sid, _ in samples]
                values = np.array(
                    [np.stack([np.ravel(f), np.ravel(c)]) for _, (f, c) in samples],
                    dtype=np.float64)  # [N, 2, M]
                self._level_groups[level].append_successful(ids, values)

    def _save_failed(self, failed_samples):
        for level, samples in failed_samples.items():
            if len(samples) > 0:
                self._level_groups[int(level)].append_failed(list(samples))

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        # rows past len(ids) are not samples (see Memory.save_samples_bulk)
        # and must not reach the file, or counts/ids desync on resume
        self._level_groups[level_id].append_successful(
            ids, host_pairs(fine, coarse, len(ids)))
        self._hdf_object.flush()

    def save_scheduled_samples(self, level_id, samples: List[str]):
        self._level_groups[level_id].append_scheduled(samples)

    def load_scheduled_samples(self):
        return {
            int(level.level_id):
                np.char.decode(level.scheduled()["sample_id"]).tolist()
            for level in self._level_groups
        }

    # ------------------------------------------------------------------ #
    def _level_chunks(self, level_id, n_samples=None):
        return self._level_groups[level_id].chunks(n_samples)

    def sample_pairs(self):
        levels_results = [None] * len(self._level_groups)
        n_collected = self.get_n_collected()  # one pass, not one per level
        for level in self._level_groups:
            lid = int(level.level_id)
            n = n_collected[lid]
            if n == 0:
                levels_results[lid] = []
                continue
            chunk_spec = next(self.chunks(level_id=lid, n_samples=int(n)))
            levels_results[lid] = self.sample_pairs_level(chunk_spec)
        return levels_results

    def sample_pairs_level(self, chunk_spec):
        """:return: np.ndarray [M, N, 2] ([M, N, 1] on level 0)"""
        level_id = int(chunk_spec.level_id or 0)
        raw = self._level_groups[level_id].collected(chunk_spec.chunk_slice)
        if raw is None:
            # zero-collected level (no dataset yet): empty, shaped chunk
            m = sum(int(np.prod(spec.shape)) * len(spec.times)
                    * len(spec.locations)
                    for spec in self.load_result_format())
            raw = np.zeros((0, 2, m))
        # on-disk [N, 2, M] -> estimation layout [M, N, C]; level 0 carries
        # no coarse slot
        n_slots = 1 if level_id == 0 else raw.shape[1]
        return raw[:, :n_slots, :].transpose((2, 0, 1))

    # ------------------------------------------------------------------ #
    def n_finished(self):
        counts = {int(lg.level_id): lg.n_finished()
                  for lg in self._level_groups}
        return np.array([counts.get(lid, 0)
                         for lid in range(len(self._level_groups))],
                        dtype=float)

    def unfinished_ids(self):
        return [sid for lg in self._level_groups
                for sid in lg.get_unfinished_ids()]

    def failed_samples(self):
        return {str(level.level_id): list(level.get_failed_ids())
                for level in self._level_groups}

    def clear_failed(self):
        for level in self._level_groups:
            level.clear_failed_dataset()

    def save_n_ops(self, n_ops):
        # pools report CUMULATIVE [total time, n] totals per drain: the
        # latest report replaces the attr (re-adding per poll double-counts)
        for level_id, (time, n_samples) in n_ops:
            if n_samples > 0 or \
                    self._level_groups[level_id].n_ops_estimate is None:
                self._level_groups[level_id].n_ops_estimate = \
                    [float(time), float(n_samples)]

    def get_n_ops(self):
        n_ops = [0.0] * len(self._level_groups)
        for level in self._level_groups:
            est = level.n_ops_estimate
            if est is not None and est[1] > 0:
                n_ops[int(level.level_id)] = est[0] / est[1]
        return n_ops

    def get_level_ids(self):
        return [int(level.level_id) for level in self._level_groups]

    def get_level_parameters(self):
        return self._hdf_object.load_level_parameters()

    def get_n_collected(self):
        return [level.collected_n_items() for level in self._level_groups]

    def get_n_levels(self):
        return len(self._level_groups)
