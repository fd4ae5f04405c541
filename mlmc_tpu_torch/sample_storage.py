"""Sample persistence contract + in-memory backends (counterpart of
``mlmc_tpu/sample_storage.py``).

The contract (chunked [M, N, 2] reads, scheduled/failed bookkeeping, n_ops
cost accounting) keeps the Quantity layer and the Sampler backend-agnostic.
``Memory`` holds per-level contiguous numpy arrays on the host;
``DeviceMemory`` holds each level's payload in one tensor on a CUDA device
(or on the CPU when asked), so samples made by a ``DeviceBatchPool`` with
``device_results=True`` are stored and estimated without crossing to the
host; both feed the bootstrap and ``Quantity.subsample`` (a ``chunk_size``
sets the chunking the streaming subsample runs over). The file-backed
backends, for runs that outlive the process, are ``SampleStorageHDF``
(``sample_storage_hdf.py``) and ``SampleStorageBin``
(``sample_storage_bin.py``).
"""
import itertools
from abc import ABCMeta, abstractmethod
from typing import Dict, List

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.quantity.quantity_spec import ChunkSpec, QuantitySpec


def host_pairs(fine, coarse, n_valid):
    """The first ``n_valid`` rows of ``fine``/``coarse`` [N, M] (numpy or
    tensors on any device) as one f64 numpy payload [n_valid, 2, M]: what
    the host and file storages hold. Narrower floats widen exactly."""
    def array(x):
        if isinstance(x, torch.Tensor):
            x = x[:n_valid].cpu().numpy()
        return np.asarray(x)[:n_valid]

    fine, coarse = array(fine), array(coarse)
    out = np.empty((fine.shape[0], 2) + fine.shape[1:], dtype=np.float64)
    out[:, 0] = fine
    out[:, 1] = coarse
    return out


def _pow2_at_least(n, floor=1024):
    return max(floor, 1 << int(max(n, 1) - 1).bit_length())


class SampleStorage(metaclass=ABCMeta):
    """Store and retrieve sample data (results, schedules, costs)."""

    #: payloads live in RAM or device memory (whole-level gathers are
    #: cheap); out-of-core backends leave this False and stream chunks
    payload_resident = False

    @abstractmethod
    def save_samples(self, successful_samples, failed_samples):
        """Write results to storage."""

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        """Bulk write path: a whole level batch as arrays (no per-sample
        tuples). The default adapter wraps into the tuple contract;
        array-native backends override. fine/coarse: [N, M]."""
        res = [(sid, (f, c)) for sid, f, c in zip(ids, fine, coarse)]
        self.save_samples({level_id: res}, {})

    @abstractmethod
    def save_result_format(self, res_spec: List[QuantitySpec]):
        """Save result format."""

    @abstractmethod
    def load_result_format(self) -> List[QuantitySpec]:
        """Load result format."""

    @abstractmethod
    def save_global_data(self, result_format: List[QuantitySpec], level_parameters=None):
        """Save global data: result_format, level_parameters."""

    @abstractmethod
    def save_scheduled_samples(self, level_id, samples):
        """Save scheduled sample ids."""

    @abstractmethod
    def load_scheduled_samples(self):
        """:return: Dict[level_id, List[sample_id: str]]"""

    @abstractmethod
    def sample_pairs(self):
        """:return: List[Array[M, N, 2]]"""

    def chunks(self, level_id=None, n_samples=None):
        """Generator of ChunkSpec over levels."""
        assert isinstance(n_samples, (type(None), int)), "n_samples param must be int"
        level_ids = self.get_level_ids()
        if level_id is not None:
            level_ids = [level_id]
        return itertools.chain(*[self._level_chunks(lid, n_samples) for lid in level_ids])

    @abstractmethod
    def _level_chunks(self, level_id, n_samples=None):
        """Generator of ChunkSpec for one level."""

    @abstractmethod
    def n_finished(self):
        """Number of finished samples per level."""

    @abstractmethod
    def save_n_ops(self, n_ops: Dict[int, List[float]]):
        """Save per-level cost accounting [total time, n samples]."""

    @abstractmethod
    def get_n_ops(self):
        """Cost (time) per sample for each level."""

    @abstractmethod
    def unfinished_ids(self):
        """Get unfinished sample ids."""

    @abstractmethod
    def get_level_ids(self):
        """List of level ids."""

    @abstractmethod
    def get_n_levels(self):
        """Number of levels."""

    @abstractmethod
    def get_level_parameters(self):
        """Level parameters (simulation steps)."""

    @abstractmethod
    def get_n_collected(self):
        """Number of collected results per level."""


class _LevelData:
    """One level's complete state (results, identity, bookkeeping).

    Host (numpy) appends collect SEGMENTS merged lazily on first read — an
    adaptive round writes many batches before the next estimate, and eager
    per-append concatenation would copy the whole store each time.

    Device appends write into a power-of-two CAPACITY tensor, so a level
    grows by doubling (or straight to a reserved size) instead of being
    copied on every append. Rows past ``n`` are zeros and not part of the
    payload; ``pairs`` slices them off (a view).
    """

    __slots__ = ("_segments", "_buf", "_n", "_reserve", "ids", "failed",
                 "scheduled", "n_ops", "n_finished")

    def __init__(self):
        self._segments = []        # host mode: list of [n_i, 2, M] numpy
        self._buf = None           # device mode: [cap, 2, M] tensor
        self._n = 0                # device mode: valid rows in _buf
        self._reserve = 0          # device mode: requested min capacity
        self.ids = None            # TagChain of successful sample ids
        self.failed = []           # [(sample_id, message)]
        self.scheduled = None      # TagChain of scheduled ids
        self.n_ops = None          # latest cumulative [total time, n] report
        self.n_finished = 0        # successful + failed

    def append_pairs(self, ids, pairs, n_valid=None):
        """Append the first ``n_valid`` rows of ``pairs`` [n, 2, M] (numpy:
        host mode; tensor: device mode)."""
        from mlmc_tpu_torch.tags import TagChain

        if self.ids is None:
            self.ids = TagChain()
        self.ids.extend(ids)
        n_valid = pairs.shape[0] if n_valid is None else int(n_valid)
        self.n_finished += n_valid
        if not isinstance(pairs, torch.Tensor):
            self._segments.append(pairs[:n_valid])
            return
        need = max(self._n + n_valid, self._reserve)
        if self._buf is None:
            self._buf = pairs.new_zeros((_pow2_at_least(need),) + pairs.shape[1:])
        elif need > self._buf.shape[0]:
            self._grow(_pow2_at_least(need, floor=2 * self._buf.shape[0]))
        self._buf[self._n:self._n + n_valid] = pairs[:n_valid]
        self._n += n_valid

    def _grow(self, cap):
        grown = self._buf.new_zeros((cap,) + self._buf.shape[1:])
        grown[:self._n] = self._buf[:self._n]
        self._buf = grown

    def reserve(self, n_rows):
        """Request capacity for ``n_rows`` total rows (device mode only):
        the next append grows the buffer once to the target's power of
        two instead of doubling through every intermediate capacity."""
        self._reserve = max(self._reserve, int(n_rows))
        if self._buf is not None and self._reserve > self._buf.shape[0]:
            self._grow(_pow2_at_least(self._reserve))

    @property
    def pairs(self):
        """[N, 2, M] valid payload (host segments merged + cached; device
        buffers sliced to the valid count)."""
        if self._buf is not None:
            return self._buf[:self._n]
        if not self._segments:
            return None
        if len(self._segments) > 1:
            self._segments = [np.concatenate(self._segments, axis=0)]
        return self._segments[0]

    @property
    def raw_payload(self):
        """(payload in native [N_cap, 2, M] layout, valid count): device
        capacity buffers pass through whole (tail rows are not payload)."""
        if self._buf is not None:
            return self._buf, self._n
        return self.pairs, self.n_collected

    @property
    def n_collected(self):
        if self._buf is not None:
            return int(self._n)
        return int(sum(seg.shape[0] for seg in self._segments))


class Memory(SampleStorage):
    """In-RAM storage: per-level [N, 2, M] float64 numpy arrays, each level
    held as one cohesive ``_LevelData`` record."""

    payload_resident = True

    def __init__(self, chunk_size=None):
        self._levels = {}          # level_id -> _LevelData
        self._result_specification = []
        self._level_parameters = []
        # in samples per chunk; None = single chunk per level
        self._chunk_size = chunk_size
        super().__init__()

    #: device of the payload (None: host numpy)
    device = None

    def _level(self, level_id) -> _LevelData:
        return self._levels.setdefault(level_id, _LevelData())

    def _levels_with_results(self):
        return [lid for lid, st in self._levels.items() if st.n_collected]

    def _level_span(self):
        """Number of KNOWN levels (scheduled, failed, costed or filled).

        Per-level vectors must span every known level, not just those
        that happen to have data yet: the sampler's wait loop and the
        estimator's ``range(get_n_levels())`` both index by level id."""
        return max(self._levels) + 1 if self._levels else 0

    # -------------------------------------------------------------- write
    def save_samples(self, successful_samples, failed_samples):
        self._save_successful(successful_samples)
        for level_id, res in failed_samples.items():
            if len(res):
                level = self._level(level_id)
                level.failed.extend(res)
                level.n_finished += len(res)

    def _as_pairs(self, fine, coarse, n_valid):
        """[n, 2, M] payload in this storage's form: f64 numpy on the host."""
        return host_pairs(fine, coarse, n_valid)

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        """``fine``/``coarse`` [N, M]; rows past ``len(ids)`` are not
        samples and are dropped."""
        n_valid = len(ids)
        self._level(level_id).append_pairs(
            ids, self._as_pairs(fine, coarse, n_valid), n_valid=n_valid)

    def raw_level_payload(self, level_id):
        """(native-layout payload [N_cap, 2, M], valid count) for the
        whole-level estimation tiers; device buffers are returned WHOLE
        (the capacity tail is not payload, consumers mask by position)."""
        return self._levels[int(level_id)].raw_payload

    def reserve_capacity(self, level_id, n_rows):
        """Hint the final per-level sample count (called by the sampler at
        scheduling time): device levels grow their capacity buffer straight
        to the target's power of two. Host mode is a no-op."""

    def _save_successful(self, samples):
        """:param samples: Dict[level_id, List[Tuple[sample_id, (fine, coarse)]]]"""
        for level_id, res in samples.items():
            if len(res) == 0:
                continue
            ids = [s_id for s_id, _ in res]
            fine = np.stack([np.ravel(np.asarray(f)) for _, (f, _c) in res])
            coarse = np.stack([np.ravel(np.asarray(c)) for _, (_f, c) in res])
            self.save_samples_bulk(level_id, ids, fine, coarse)

    def save_global_data(self, result_format, level_parameters=None):
        self.save_result_format(result_format)
        self._level_parameters = level_parameters

    def save_result_format(self, res_spec: List[QuantitySpec]):
        self._result_specification = res_spec

    def save_scheduled_samples(self, level_id, samples):
        from mlmc_tpu_torch.tags import TagChain

        level = self._level(level_id)
        if level.scheduled is None:
            level.scheduled = TagChain()
        level.scheduled.extend(samples)

    def save_n_ops(self, n_ops):
        """:param n_ops: iterable of (level_id, [total time, n_samples]).

        Pools report CUMULATIVE totals per drain, so the latest report
        REPLACES the record."""
        for level_id, (time, n_samples) in n_ops:
            self._level(level_id).n_ops = [float(time), float(n_samples)]

    # --------------------------------------------------------------- read
    def load_result_format(self) -> List[QuantitySpec]:
        return self._result_specification

    def load_scheduled_samples(self):
        return {lid: st.scheduled for lid, st in self._levels.items()
                if st.scheduled is not None}

    def n_finished(self):
        out = np.zeros(self._level_span())
        for lid, st in self._levels.items():
            out[lid] = st.n_finished
        return out

    def sample_pairs(self):
        # indexed by level id: a level whose samples ALL failed leaves a
        # None slot instead of shifting (or crashing) the later levels
        out = [None] * self._level_span()
        for lid in self._levels_with_results():
            out[lid] = self.sample_pairs_level(ChunkSpec(level_id=lid))
        return out

    def _level_chunks(self, level_id, n_samples=None):
        n_total = self._levels[level_id].n_collected
        if n_samples is not None:
            n_total = min(n_total, n_samples)
        chunk = self._chunk_size or n_total or 1
        for i, start in enumerate(range(0, max(n_total, 1), chunk)):
            yield ChunkSpec(
                chunk_id=i,
                chunk_slice=slice(start, min(start + chunk, n_total), 1),
                level_id=level_id,
            )

    def _empty_pairs(self):
        m = sum(int(np.prod(spec.shape)) * len(spec.times)
                * len(spec.locations) for spec in self._result_specification)
        return np.zeros((0, 2, m))

    def sample_pairs_level(self, chunk_spec):
        """:return: [M, chunk size, 2] (level 0: [M, chunk size, 1]); a
        device storage returns a view of its payload tensor"""
        pairs = self._levels[int(chunk_spec.level_id)].pairs
        if pairs is None:
            # a known level with zero collected results (all failed or
            # still scheduled): an empty chunk, correctly shaped
            pairs = self._empty_pairs()
        if chunk_spec.chunk_slice is not None:
            pairs = pairs[chunk_spec.chunk_slice]
        # level 0 has no coarse part: strip the auxiliary zero slot
        if chunk_spec.level_id == 0:
            pairs = pairs[:, :1, :]
        if isinstance(pairs, torch.Tensor):
            return pairs.permute(2, 0, 1)
        return pairs.transpose((2, 0, 1))

    def get_n_ops(self):
        # every KNOWN level appears, including cost 0.0 for levels that
        # have not reported yet
        out = [0.0] * self._level_span()
        for lid, st in self._levels.items():
            if st.n_ops is not None:
                t, n = st.n_ops
                out[lid] = t / n if n else 0.0
        return out

    def unfinished_ids(self):
        return []

    def failed_samples(self):
        return {str(lid): [s_id for s_id, _ in st.failed]
                for lid, st in self._levels.items() if st.failed}

    def clear_failed(self):
        for st in self._levels.values():
            st.failed = []

    def get_level_ids(self):
        return self._levels_with_results()

    def get_n_collected(self):
        out = [0] * self._level_span()
        for lid in self._levels_with_results():
            out[int(lid)] = self._levels[lid].n_collected
        return out

    def get_n_levels(self):
        # ALL known levels, not just levels that already hold results
        return self._level_span()

    def get_level_parameters(self):
        return self._level_parameters


class DeviceMemory(Memory):
    """Device-resident storage: each level's results stay in one tensor
    on ``device`` from the pool to the estimator.

    With a ``DeviceBatchPool(device_results=True)``, samples are produced,
    stored and estimated on the card; only the id/cost/failure bookkeeping
    lives on the host. The payload keeps the dtype of the first batch
    stored on a level (float32 from the pool).

    :param device: where the payload lives; None = the current CUDA device
    """

    def __init__(self, chunk_size=None, device=None):
        super().__init__(chunk_size=chunk_size)
        self.device = resolve_device(device)

    def _as_pairs(self, fine, coarse, n_valid):
        def tensor(x):
            x = torch.as_tensor(x)
            return x[:n_valid].to(self.device)

        pairs = torch.stack([tensor(fine), tensor(coarse)], dim=1)
        if not pairs.is_floating_point():
            pairs = pairs.to(torch.float64)
        return pairs

    def save_samples_bulk(self, level_id, ids, fine, coarse):
        n_valid = len(ids)
        level = self._level(level_id)
        pairs = self._as_pairs(fine, coarse, n_valid)
        if level._buf is not None and pairs.dtype != level._buf.dtype:
            pairs = pairs.to(level._buf.dtype)
        level.append_pairs(ids, pairs, n_valid=n_valid)

    def reserve_capacity(self, level_id, n_rows):
        self._level(level_id).reserve(n_rows)

    def _empty_pairs(self):
        return torch.as_tensor(super()._empty_pairs(), device=self.device)
