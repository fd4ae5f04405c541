"""Adaptive storage-free MLMC driver (counterpart of
``mlmc_tpu/fused_driver.py``).

Geometric initial counts, level-variance estimation, variance-optimal
allocation ``n_l ∝ sqrt(V_l/C_l)``, iterate until the target variance is
met — over streaming moment accumulators: samples are drawn, pushed
through the moment pipeline and reduced on the device, never stored. A
chunk of a level draws from a generator seeded from (seed, level, its
first sample index), and an extra round continues at the level's count
(as JAX's ``start_index``), so no sample is redrawn, the final estimate
uses every sample drawn, and a sample mesh (``mesh=``) splits the chunks
over its shards without changing them.
"""
import time

import numpy as np
import torch

from mlmc_tpu_torch import estimator as est_mod
from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops.fused_estimate import (
    MomentAccumulators, accumulators_to_estimates, fused_level_moments)


def level_sim_chunk_fn(level_sim, component=0, calc_batch=None):
    """Adapt a LevelSimulation with a batch path to the scalar-QoI
    contract ``f(generator, n, device) -> (fine [n], coarse [n], failed [n])``.

    :param component: index into the flattened result vector
    :param calc_batch: override when the level_sim was built outside a
        Sampler (which is what wires ``calculate_batch``)
    """
    config = level_sim.config_dict
    calc = calc_batch or level_sim.calculate_batch
    if calc is None:
        raise ValueError("LevelSimulation has no batch path; pass calc_batch=")

    def f(generator, n, device=None):
        fine, coarse, failed = calc(config, generator, n, device)
        return fine[..., component], coarse[..., component], failed

    return f


def sim_level_chunk_fns(sim_factory, level_parameters, component=0):
    """Per-level scalar chunk fns straight from a Simulation factory."""
    fns = []
    for level_id, params in enumerate(level_parameters):
        coarse = [0] if level_id == 0 else level_parameters[level_id - 1]
        level_sim = sim_factory.level_instance(params, coarse)
        fns.append(level_sim_chunk_fn(
            level_sim, component=component,
            calc_batch=getattr(sim_factory, "calculate_batch", None)))
    return fns


class FusedMLMC:
    """Adaptive MLMC over fused accumulators (no sample storage).

    :param sim_chunk_fns: per-level ``f(generator, n, device) -> (fine,
        coarse, failed)``
    :param moments_fn: moment basis
    :param seed: a chunk of level l draws from ``chunk_generator(seed, l,
        its first sample index)``
    :param chunk_size: samples per loop step
    :param acc_dtype: accumulator dtype
    :param mesh: a ``parallel.SampleMesh``: each round's chunks of a level
        are strided over the shards (chunk ``i * D + s`` on shard ``s``)
        and the accumulators summed over the mesh
    :param device: where samples are drawn and reduced without a mesh;
        None = the current CUDA device (with a mesh: its first device)
    """

    def __init__(self, sim_chunk_fns, moments_fn, seed=0, chunk_size=1 << 16,
                 acc_dtype=torch.float64, mesh=None, device=None):
        self._fns = list(sim_chunk_fns)
        self._moments_fn = moments_fn
        self._seed = int(seed)
        self._chunk = int(chunk_size)
        self._acc_dtype = acc_dtype
        self._mesh = mesh
        self._device = (resolve_device(device) if mesh is None
                        else mesh.devices[0])
        self.n_levels = len(self._fns)
        self._n_drawn = [0] * self.n_levels
        self._accs = [None] * self.n_levels
        self._cost_per_sample = [0.0] * self.n_levels

    def _sync(self):
        if self._mesh is not None:
            self._mesh.synchronize()
        elif self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    def _run_level(self, level, n_new):
        """Draw n_new more samples on a level, continuing its stream."""
        if n_new <= 0:
            return
        if self._mesh is None:
            shards, n_shards = [(0, self._device)], 1
        else:
            shards, n_shards = self._mesh.local_shards(), self._mesh.n_devices
        self._sync()
        t0 = time.perf_counter()
        per_shard = [fused_level_moments(
            self._fns[level], self._moments_fn, (self._seed, level),
            int(n_new), self._chunk, is_level0=(level == 0),
            acc_dtype=self._acc_dtype, start_index=self._n_drawn[level],
            shard=s, n_shards=n_shards, device=d) for s, d in shards]
        acc = per_shard[0] if self._mesh is None else self._mesh.reduce(per_shard)
        self._sync()
        elapsed = time.perf_counter() - t0
        if acc.sums.ndim != 1:
            raise NotImplementedError(
                "FusedMLMC drives scalar QoIs (accumulators [R]); this "
                "sim_chunk_fn produced a {}-component QoI — estimate "
                "components separately (level_sim_chunk_fn(component=m))"
                .format(acc.sums.shape[0]))
        if self._accs[level] is None:
            self._accs[level] = acc
        else:
            self._accs[level] = MomentAccumulators(
                *(a + b for a, b in zip(self._accs[level], acc)))
        self._n_drawn[level] += int(n_new)
        # exponential-moving per-sample cost
        c = elapsed / int(n_new)
        old = self._cost_per_sample[level]
        self._cost_per_sample[level] = c if old == 0 else 0.5 * (old + c)

    def estimates(self):
        """Current MLMC estimates from the accumulated state (numpy)."""
        for lvl, a in enumerate(self._accs):
            if a is None:
                raise RuntimeError("level {} has no samples yet".format(lvl))
        return accumulators_to_estimates(self._accs)

    def construct_density(self, tol=1e-8, orth_moments_tol=1e-7):
        """Maxent PDF from the accumulated moment/covariance state:
        orthogonalize the basis against the sampled covariance, rotate the
        mean estimates, solve (on this driver's device), with
        ``SimpleDistribution``'s default regularization (0.01), as
        ``mlmc_tpu``'s driver.

        :return: (SimpleDistribution, info, solver result, orthogonal basis)
        """
        import mlmc_tpu_torch.tool.simple_distribution as sd

        est = self.estimates()
        return sd.density_from_moments(
            self._moments_fn, est["cov"], est["mean"], tol=tol, reg_param=0.01,
            orth_moments_tol=orth_moments_tol, device=self._device)

    # ------------------------------------------------------------------ #
    # checkpoint / resume: accumulators and stream positions, with the
    # keys that mlmc_tpu's save_state writes
    # ------------------------------------------------------------------ #
    def save_state(self, path):
        """Checkpoint accumulators and counts to .npz."""
        state = {"n_drawn": np.asarray(self._n_drawn),
                 "cost": np.asarray(self._cost_per_sample)}
        for lvl, acc in enumerate(self._accs):
            if acc is None:
                continue
            for field, value in acc._asdict().items():
                state["acc{}_{}".format(lvl, field)] = value.detach().cpu().numpy()
        np.savez(path, **state)

    def load_state(self, path):
        """Resume from a checkpoint written by this class or by
        ``mlmc_tpu.FusedMLMC.save_state``: each level continues at its
        ``n_drawn``. (An mlmc_tpu checkpoint's samples came from JAX's
        keys; the continued samples are this package's.)"""
        data = np.load(path)
        self._n_drawn = [int(v) for v in data["n_drawn"]]
        self._cost_per_sample = [float(v) for v in data["cost"]]
        fields = MomentAccumulators._fields
        for lvl in range(self.n_levels):
            if "acc{}_{}".format(lvl, fields[0]) in data:
                self._accs[lvl] = MomentAccumulators(*(
                    torch.as_tensor(data["acc{}_{}".format(lvl, f)],
                                    dtype=self._acc_dtype, device=self._device)
                    for f in fields))
            else:
                self._accs[lvl] = None

    def run(self, target_var, initial_n=(1000, 100), add_coeff=0.1,
            max_rounds=50):
        """Adaptive loop to the target variance (add-10% rounds).

        :return: estimates dict (see ``estimates``) + 'history' of per-round
            (n_samples, max moment variance)
        """
        n0, nL = initial_n
        init = np.round(np.exp2(np.linspace(
            np.log2(n0), np.log2(nL), self.n_levels))).astype(int)
        for lvl, n in enumerate(init):
            self._run_level(lvl, int(n))

        history = []
        for _round in range(max_rounds):
            est = self.estimates()
            history.append((est["n_samples"].copy(),
                            float(np.max(est["var"][1:]))))
            if np.max(est["var"][1:]) <= target_var:
                break
            n_opt = est_mod.estimate_n_samples_for_target_variance(
                target_var, est["l_vars"],
                np.maximum(self._cost_per_sample, 1e-12), self.n_levels)
            drawn = np.asarray(self._n_drawn)
            gap = np.maximum(n_opt - drawn, 0)
            add = np.where(gap <= add_coeff * n_opt, gap,
                           np.ceil(gap * add_coeff)).astype(int)
            if not np.any(add > 0):
                # noisy wall-time costs can stall the allocation while the
                # variance target is unmet: force progress on the level
                # contributing the largest variance share
                contrib = est["l_vars"][:, 1:].max(axis=1) / np.maximum(
                    est["n_samples"], 1)
                worst = int(np.argmax(contrib))
                add[worst] = max(int(0.5 * drawn[worst]), 64)
            for lvl in range(self.n_levels):
                self._run_level(lvl, int(add[lvl]))

        est = self.estimates()
        est["history"] = history
        est["cost_per_sample"] = list(self._cost_per_sample)
        return est
