"""Sample scheduling / collection driver (counterpart of
``mlmc_tpu/sampler.py``).

Sample identity is the integer pair ``(level, index)`` (see
mlmc_tpu_torch.tags), per-level target/scheduled counts are int64 vectors,
and scheduling a level is one O(1) dispatch — a range handed to the pool's
batch hook (``schedule_level_batch``) and a ``TagRange`` to the storage.
Host pools without a batch hook receive one ``schedule_sample`` call per
sample.
"""
import time
import numpy as np
from typing import List

from mlmc_tpu_torch.sample_storage import SampleStorage
from mlmc_tpu_torch.sampling_pool import SamplingPool
from mlmc_tpu_torch.sim.simulation import Simulation
from mlmc_tpu_torch.tags import TagRange, parse_tags
from mlmc_tpu_torch.tool import profiling
from mlmc_tpu_torch.tool.log import get_logger, event

_log = get_logger("sampler")


class Sampler:
    """Decides per-level sample counts, dispatches work, stores results."""

    ADDING_SAMPLES_TIMEOUT = 1e-15

    def __init__(
        self,
        sample_storage: SampleStorage,
        sampling_pool: SamplingPool,
        sim_factory: Simulation,
        level_parameters: List[List[float]],
        seed=1234,
    ):
        """
        :param sample_storage: stores scheduled ids, results, result format
        :param sampling_pool: executes samples
        :param sim_factory: simulation factory creating level instances
        :param level_parameters: per-level simulation steps
        :param seed: global seed for host-side randomness
        """
        np.random.seed(seed)
        self.sample_storage = sample_storage
        self._sampling_pool = sampling_pool

        n_levels = len(level_parameters)
        self._n_target_samples = np.zeros(n_levels, dtype=np.int64)
        self._level_sim_objects = self._make_level_sims(level_parameters, sim_factory)

        sample_storage.save_global_data(
            level_parameters=level_parameters, result_format=sim_factory.result_format()
        )

        # resume: scheduled counters continue from the stored schedule log
        self._n_scheduled_samples = np.zeros(n_levels, dtype=np.int64)
        for level_id, tags in sample_storage.load_scheduled_samples().items():
            self._n_scheduled_samples[int(level_id)] = len(tags)

        self._check_failed_samples()

    # ------------------------------------------------------------------ #
    @property
    def n_levels(self):
        return len(self._level_sim_objects)

    @property
    def n_finished_samples(self):
        out = np.asarray(self.sample_storage.n_finished())
        if len(out) < self.n_levels:
            # defensive: a storage that sizes by levels-with-data would
            # otherwise crash the wait loop's per-level indexing
            out = np.pad(out, (0, self.n_levels - len(out)))
        return out

    @staticmethod
    def _make_level_sims(level_parameters, sim_factory):
        """One LevelSimulation per level; level 0 gets the sentinel coarse
        step [0]."""
        coarse_params = [[0], *level_parameters[:-1]]
        sims = []
        for level_id, (fine, coarse) in enumerate(zip(level_parameters, coarse_params)):
            sim = sim_factory.level_instance(fine, coarse)
            sim.calculate = sim_factory.calculate
            sim.calculate_batch = getattr(sim_factory, "calculate_batch", None)
            sim.calculate_keyed_batch = getattr(
                sim_factory, "calculate_keyed_batch", None)
            sim.result_format = sim_factory.result_format()
            sim.level_id = level_id
            sims.append(sim)
        return sims

    # the original library's name for the same step
    def _create_level_sim_objects(self, level_parameters, sim_factory):
        self._level_sim_objects = self._make_level_sims(level_parameters, sim_factory)

    def sample_range(self, n0, nL):
        """Geometric sequence of length n_levels decreasing from n0 to nL."""
        return np.round(np.geomspace(n0, nL, self.n_levels)).astype(np.int64)

    def set_initial_n_samples(self, n_samples=None):
        """Seed per-level targets; 1 or 2 values expand to a geometric fill."""
        counts = [100, 10] if n_samples is None else list(np.atleast_1d(n_samples))
        if len(counts) == 1:
            counts.append(10)
        if len(counts) == 2:
            counts = self.sample_range(counts[0], counts[1])
        self._n_target_samples = np.ceil(np.asarray(counts)).astype(np.int64)

    # ------------------------------------------------------------------ #
    # dispatch
    # ------------------------------------------------------------------ #
    def schedule_samples(self, timeout=None):
        """Dispatch the gap between target and scheduled counts per level."""
        self.ask_sampling_pool_for_samples(timeout=timeout)
        gap = self._n_target_samples - self._n_scheduled_samples
        reserve = getattr(self.sample_storage, "reserve_capacity", None)
        with profiling.span("sampler.schedule"):
            for level_id in np.flatnonzero(gap > 0):
                if reserve is not None:
                    # device storages pre-grow to the target's power of two
                    # instead of doubling through every intermediate capacity
                    reserve(int(level_id), int(self._n_target_samples[level_id]))
                self._dispatch_level(int(level_id), int(gap[level_id]))

    def _dispatch_level(self, level_id, count):
        """Schedule ``count`` fresh samples on one level: a single TagRange
        to batch-capable pools + an O(1) schedule-log append."""
        level_sim = self._level_sim_objects[level_id]
        start = int(self._n_scheduled_samples[level_id])
        tags = TagRange(level_id, start, start + count)

        batch_hook = getattr(self._sampling_pool, "schedule_level_batch", None)
        if batch_hook is not None:
            # hand the contiguous range itself: batch pools then build the
            # sample indices on the device instead of uploading an array
            batch_hook(level_sim, range(tags.start, tags.stop))
        else:
            for tag in tags:
                self._sampling_pool.schedule_sample(tag, level_sim)

        self._n_scheduled_samples[level_id] += count
        self.sample_storage.save_scheduled_samples(level_id, tags)
        event(_log, "scheduled", level=level_id, n=count)

    def renew_failed_samples(self):
        """Re-dispatch every failed sample id, then clear the failed store.

        Same id => replayable base seed; the DeviceBatchPool additionally
        salts retries with an attempt counter so random failures do not
        repeat deterministically.
        """
        batch_hook = getattr(self._sampling_pool, "schedule_level_batch", None)
        for level_id, tags in self.sample_storage.failed_samples().items():
            level_id = int(level_id)
            level_sim = self._level_sim_objects[level_id]
            if batch_hook is not None:
                batch_hook(level_sim, parse_tags(list(tags)), renew=True)
            else:
                for tag in tags:
                    self._sampling_pool.schedule_sample(tag, level_sim)
        self.sample_storage.clear_failed()

    def _check_failed_samples(self):
        """Hand scheduled-but-unfinished ids to the pool (resume support)."""
        self._sampling_pool.have_permanent_samples(self.sample_storage.unfinished_ids())

    # ------------------------------------------------------------------ #
    # collection
    # ------------------------------------------------------------------ #
    def ask_sampling_pool_for_samples(self, sleep=0, timeout=None):
        """Drain finished samples from the pool into storage.

        ``timeout=None`` blocks until the pool is idle; ``timeout<=0``
        returns immediately; ``timeout>0`` drains for at most that long.
        :return: number of still-running samples (0 when drained)
        """
        if timeout is not None and timeout <= 0:
            return 1
        deadline = None if timeout is None else time.perf_counter() + timeout
        while True:
            done, dead, n_running, costs = self._sampling_pool.get_finished()
            with profiling.span("sampler.store"):
                self._store_samples(done, dead, costs)
            if n_running == 0:
                return 0
            if deadline is not None and time.perf_counter() >= deadline:
                return n_running
            time.sleep(sleep)

    def _store_samples(self, successful_samples, failed_samples, n_ops):
        from mlmc_tpu_torch.sampling_pool import BulkResults

        tupled = {}
        for level_id, res in successful_samples.items():
            if isinstance(res, BulkResults):
                res = [res]
            if len(res) and isinstance(res[0], BulkResults):
                # one BulkResults per device slice; payload arrays may be
                # bucket-padded past len(ids) (storages slice or mask)
                for bulk in res:
                    event(_log, "collected", level=level_id,
                          n=len(bulk.ids))
                    self.sample_storage.save_samples_bulk(
                        level_id, bulk.ids, bulk.fine, bulk.coarse)
            elif len(res):
                event(_log, "collected", level=level_id, n=len(res))
                tupled[level_id] = res
        for level_id, res in failed_samples.items():
            if len(res):
                event(_log, "failed", level=level_id, n=len(res))
        if tupled or failed_samples:
            self.sample_storage.save_samples(tupled, failed_samples)
        self.sample_storage.save_n_ops(n_ops)

    # ------------------------------------------------------------------ #
    # adaptive enlargement
    # ------------------------------------------------------------------ #
    def process_adding_samples(self, n_estimated, sleep=0, add_coeff=0.1,
                               timeout=ADDING_SAMPLES_TIMEOUT):
        """One adaptive round toward ``n_estimated`` per-level counts.

        Each level moves a fraction ``add_coeff`` of its remaining gap —
        jumping straight to the goal once the gap falls below ``add_coeff``
        of it — then waits for half of the newly scheduled work.

        :return: True when scheduled == estimated on all growing levels
        """
        self.ask_sampling_pool_for_samples(timeout=timeout)
        n_estimated = np.asarray(n_estimated)
        # reserve device-storage capacity for the FULL allocation estimate
        # now, even though each round only schedules a fraction of the gap:
        # the level buffer then grows once instead of being copied at every
        # doubling on the way
        reserve = getattr(self.sample_storage, "reserve_capacity", None)
        if reserve is not None:
            for level_id, n in enumerate(n_estimated):
                if np.isfinite(n) and n > 0:
                    # ~10% headroom: variance estimates sharpen between
                    # rounds, and an allocation drifting just past a pow2
                    # boundary would otherwise cost one more copy
                    reserve(int(level_id), int(np.ceil(1.1 * n)))
        scheduled = np.asarray(self.l_scheduled_samples(), dtype=float)

        gap = n_estimated - scheduled
        step = np.where(add_coeff * n_estimated > gap, gap, add_coeff * gap)
        grown = np.ceil(scheduled + np.maximum(step, 0))

        growing = np.flatnonzero(n_estimated > grown)
        self.set_scheduled_and_wait(grown, growing, sleep, timeout=timeout)
        return bool(np.all(n_estimated[growing] == grown[growing]))

    def set_scheduled_and_wait(self, n_scheduled, greater_items, sleep,
                               fin_sample_coef=0.5, timeout=1e-7):
        """Raise targets to ``n_scheduled``, dispatch, and block until at
        least ``fin_sample_coef`` of each growing level has finished."""
        self.set_level_target_n_samples(n_scheduled)
        self.schedule_samples(timeout=timeout)

        goal = fin_sample_coef * np.asarray(n_scheduled)
        while np.any(self.n_finished_samples[greater_items] < goal[greater_items]):
            time.sleep(sleep)
            self.ask_sampling_pool_for_samples(timeout=timeout)

    def set_level_target_n_samples(self, n_samples):
        """Targets only ever grow (monotone schedule)."""
        counts = np.ceil(np.asarray(n_samples)).astype(np.int64)
        n = min(len(counts), len(self._n_target_samples))
        self._n_target_samples[:n] = np.maximum(self._n_target_samples[:n], counts[:n])

    def l_scheduled_samples(self):
        return self._n_scheduled_samples
