"""Multilevel quasi-Monte Carlo (MLQMC) driver (counterpart of
``mlmc_tpu/qmc.py``).

The Giles-Waterhouse algorithm ("Multilevel quasi-Monte Carlo path
simulation", 2009): each level runs R independent randomizations of one
low-discrepancy sequence (Owen-scrambled Sobol' or a randomly shifted
extensible lattice), the level estimator's variance is measured across
the randomizations, and the level whose variance is cheapest to reduce
gets its point count doubled until the total meets the target.

Doubling extends the sequence (Sobol' and the extensible lattice nest
their power-of-two prefixes), so every evaluated point stays in the
estimate. An extension is a Python loop over fixed-size chunks: each
chunk makes the points of all R randomizations at once (the R axis leads:
``[R, chunk, d]``), evaluates the level function on them flattened to
``[R * chunk, d]`` and adds the per-randomization sums.

Contract: ``level_fns[l](u [n, d_l]) -> (fine [n], coarse [n])`` tensor
code (level 0 returns coarse == 0); ``[n, K]`` for a vector QoI
(``qoi_dim=K``). QMC points cannot be dropped without bias, so a
non-finite result fails the run.

Departures from ``mlmc_tpu``:
- the scramble words and the lattice shifts are Philox numbers of the
  identities (seed, level, randomization) (``ops/sobol.scramble_seeds``,
  ``ops/lattice.random_shifts``), not draws from a JAX key;
  ``convert.mlqmc_from_jax`` carries a JAX run's across;
- the chunk sums accumulate in float64 whatever the point dtype, in place
  of the float32 path's compensated carry (``df64.two_sum``);
- ``run`` takes each level's cost from measured wall time unless
  ``cost_per_sample`` is given, so its decisions differ between machines
  unless the costs are fixed.
"""
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops import lattice, sobol
from mlmc_tpu_torch.random.distributions import as_torch_distr

__all__ = ["MLQMC", "QMCLevelState", "synth_qmc_level_fns",
           "shooting_qmc_level_fns", "darcy_qmc_level_fns",
           "qmc_level_fns_from_normals", "moments_qmc_level_fns"]


def _per_row_sums(x):
    """Sums over axis 1 of x [R, n, ...], one reduction per row: a
    reduction kernel may order its sum by the tensor's shape, and a shard
    of the mesh holds fewer rows than one device, so each row is reduced
    alone to keep a shard's sums equal to the one-device run's."""
    return torch.stack([row.sum(dim=0) for row in x])


class QMCLevelState:
    """Per-level accumulators: float64 sums over the point prefix of each
    randomization (shape [R] for scalar QoIs, [R, K] for vector QoIs)."""

    def __init__(self, n_rand, qoi_dim=None):
        shape = (n_rand,) if qoi_dim is None else (n_rand, qoi_dim)
        self.n = 0
        self.sums = np.zeros(shape)          # sum_i diff_i per r(,k)
        self.sums_sq = np.zeros(shape)       # sum_i diff_i^2 per r(,k)
        self.elapsed = 0.0


class MLQMC:
    """Adaptive multilevel QMC.

    :param level_fns: per-level ``f(u [n, d_l]) -> (fine [n], coarse [n])``
    :param dims: per-level point dimension d_l (int or per-level list)
    :param n_randomizations: independent randomizations per level
    :param seed: the seed of the scramble words / shifts
    :param cost_per_sample: optional per-level relative costs for the
        allocation rule; measured wall time otherwise
    :param chunk_size: points per chunk of an extension (power of two)
    :param dtype: the points' dtype (float32 or float64)
    :param qoi_dim: None for scalar level functions; K for ``[n, K]`` ones
        (the loop then targets the worst component)
    :param mesh: a ``parallel.SampleMesh``: the R randomizations split over
        its shards (R must divide by the shard count); each shard's sums
        are gathered in shard order, equal to the one-device run
    :param point_set: ``'sobol'`` (Owen-scrambled) or ``'lattice'`` (an
        extensible rank-1 lattice with a random shift per randomization)
    :param lattice_n_max: lattice sequence capacity (power of two)
    :param lattice_tent: apply the tent transform on the lattice path
    :param device: where the points are made without a mesh (None: the
        current CUDA device)
    """

    def __init__(self, level_fns: Sequence[Callable], dims,
                 n_randomizations: int = 32, seed: int = 0,
                 cost_per_sample: Optional[Sequence[float]] = None,
                 chunk_size: int = 1 << 15, dtype=torch.float32,
                 qoi_dim: Optional[int] = None, mesh=None,
                 point_set: str = "sobol",
                 lattice_n_max: int = 1 << 20,
                 lattice_tent: bool = True, device=None):
        self._fns = list(level_fns)
        n_levels = len(self._fns)
        if np.isscalar(dims):
            dims = [int(dims)] * n_levels
        if len(dims) != n_levels:
            raise ValueError("dims must match level_fns")
        self._dims = [int(d) for d in dims]
        self._R = int(n_randomizations)
        if self._R < 2:
            raise ValueError("need >= 2 randomizations to estimate variance")
        self._chunk = int(chunk_size)
        if self._chunk & (self._chunk - 1):
            raise ValueError("chunk_size must be a power of two")
        if dtype not in (torch.float32, torch.float64):
            raise ValueError("dtype must be torch.float32 or torch.float64")
        self._dtype = dtype
        if point_set not in ("sobol", "lattice"):
            raise ValueError("point_set must be 'sobol' or 'lattice'")
        if point_set == "sobol" and (lattice_n_max != 1 << 20
                                     or lattice_tent is not True):
            raise ValueError("lattice_n_max/lattice_tent apply to "
                             "point_set='lattice' only")
        self._point_set = point_set
        self._mesh = mesh
        if mesh is not None and self._R % mesh.n_devices:
            raise ValueError(
                "n_randomizations=%d must divide by the mesh's %d devices"
                % (self._R, mesh.n_devices))
        home = mesh.devices[0] if mesh is not None else resolve_device(device)
        self._device = home
        if point_set == "sobol":
            self._capacity = 1 << 30
            self._dvs = {d: torch.as_tensor(sobol.direction_numbers(d).astype(np.int64))
                         for d in set(self._dims)}
            self._seeds = [sobol.scramble_seeds(seed, lev, self._R, d, home)
                           for lev, d in enumerate(self._dims)]   # [R, d_l] words
        else:
            n_max = int(lattice_n_max)
            if n_max < 2 or n_max & (n_max - 1):
                raise ValueError("lattice_n_max must be a power of two")
            self._capacity = n_max
            self._lat_n_max = n_max
            self._lat_tent = bool(lattice_tent)
            # one fast-CBC vector per distinct dimension, built for the full
            # capacity (every embedded power-of-two prefix shares it)
            self._zs = {d: lattice.cbc_vector(n_max, d) % n_max
                        for d in set(self._dims)}
            self._seeds = [lattice.random_shifts(seed, lev, self._R, d, dtype, home)
                           for lev, d in enumerate(self._dims)]   # [R, d_l] shifts
        self._qoi_dim = None if qoi_dim is None else int(qoi_dim)
        self._levels = [QMCLevelState(self._R, self._qoi_dim)
                        for _ in range(n_levels)]
        self._fixed_cost = (None if cost_per_sample is None
                            else np.asarray(cost_per_sample, dtype=float))
        self._chunks = {}

    # ------------------------------------------------------------------ #
    @property
    def n_levels(self):
        return len(self._fns)

    @property
    def n_samples(self):
        """Per-level point counts (each counted once; every randomization
        uses the same sequence positions)."""
        return np.array([s.n for s in self._levels])

    def _points(self, level, pos, chunk, seeds):
        """The chunk's points under each randomization: [R_s, chunk, d]."""
        d = self._dims[level]
        if self._point_set == "sobol":
            bits = sobol.sobol_bits(self._dvs[d], pos, chunk, device=seeds.device)
            bits = sobol.owen_scramble(bits[None], seeds[:, None, :])
            return sobol.uniforms_from_bits(bits, self._dtype)
        u = lattice.lattice_points_extensible(
            self._zs[d], self._lat_n_max, shift=seeds, start=pos, count=chunk,
            dtype=self._dtype, device=seeds.device)
        if self._lat_tent:
            u = lattice.tent(u)
        # strictly inside (0, 1): the shift-mod and the tent's fold can land
        # on 0 or 1, which ndtri-based level functions turn into +-inf
        tiny = 2.0 ** -32 if self._dtype == torch.float64 else 2.0 ** -24
        return u.clamp(tiny, 1.0 - tiny)

    def _shard_sums(self, level, start, n_chunks, chunk, seeds):
        """(sums, sums_sq) [R_s(, K)] in float64 of this shard's
        randomizations over points [start, start + n_chunks * chunk)."""
        fn = self._fns[level]
        R = seeds.shape[0]
        shape = (R,) if self._qoi_dim is None else (R, self._qoi_dim)
        s = torch.zeros(shape, dtype=torch.float64, device=seeds.device)
        s2 = torch.zeros_like(s)
        for c in range(n_chunks):
            u = self._points(level, start + c * chunk, chunk, seeds)
            fine, coarse = fn(u.reshape(R * chunk, -1))
            d = (fine - coarse).to(self._dtype).to(torch.float64)
            d = d.reshape((R, chunk) + tuple(d.shape[1:]))
            s = s + _per_row_sums(d)
            s2 = s2 + _per_row_sums(d * d)
        return s, s2

    def extend(self, level, n_add):
        """Evaluate points [n, n + n_add) of level ``level``'s sequence
        under every randomization and fold them into the accumulators."""
        state = self._levels[level]
        n_add = int(n_add)
        if state.n + n_add > self._capacity:
            raise ValueError(
                "%d points exceed the sequence capacity %d (%s)"
                % (state.n + n_add, self._capacity,
                   "Sobol' direction numbers carry 30 bits"
                   if self._point_set == "sobol"
                   else "raise lattice_n_max — the CBC vector serves "
                        "every embedded power-of-two size"))
        # the chunk is fixed at a level's first extension
        chunk = self._chunks.setdefault(level, min(self._chunk, n_add))
        n_chunks, rem = divmod(n_add, chunk)
        if rem:
            raise ValueError(
                "extension size %d is not a multiple of this level's "
                "chunk %d (extensions after the first must be multiples; "
                "run() keeps everything power-of-two)" % (n_add, chunk))
        t0 = time.perf_counter()
        seeds = self._seeds[level]
        if self._mesh is None:
            sums, sums_sq = self._shard_sums(level, state.n, n_chunks, chunk, seeds)
        else:
            parts = [self._shard_sums(level, state.n, n_chunks, chunk, sd)
                     for sd in self._mesh.shard_batch(seeds)]
            sums = self._mesh.gather([p[0] for p in parts])
            sums_sq = self._mesh.gather([p[1] for p in parts])
        sums, sums_sq = sums.cpu().numpy(), sums_sq.cpu().numpy()
        state.elapsed += time.perf_counter() - t0
        if not (np.all(np.isfinite(sums)) and np.all(np.isfinite(sums_sq))):
            raise FloatingPointError(
                "level %d produced non-finite results; QMC points cannot be "
                "dropped without bias — fix the level function or use the "
                "MC drivers (FusedMLMC / Sampler) with failure renewal"
                % level)
        state.sums += sums
        state.sums_sq += sums_sq
        state.n += n_add

    # ------------------------------------------------------------------ #
    def level_estimates(self):
        """(means [L(,K)], est_vars [L(,K)]): per-level estimator mean and
        the variance of that mean measured across randomizations."""
        means, est_vars = [], []
        for s in self._levels:
            y_r = s.sums / max(s.n, 1)
            means.append(np.mean(y_r, axis=0))
            est_vars.append(np.var(y_r, axis=0, ddof=1) / self._R)
        return np.array(means), np.array(est_vars)

    def point_variances(self):
        """Per-level plain-MC per-point variances (pooled across
        randomizations); the QMC gain is ``point_var / (n est_var R)``."""
        out = []
        for s in self._levels:
            n = max(s.n, 2)
            v_r = (s.sums_sq / n - (s.sums / n) ** 2) * n / (n - 1)
            out.append(np.mean(v_r, axis=0))
        return np.array(out)

    def _costs(self):
        if self._fixed_cost is not None:
            return self._fixed_cost
        measured = np.array([s.elapsed / max(s.n, 1) for s in self._levels])
        if not np.all(measured > 0):
            measured = np.ones(self.n_levels)
        return measured

    def _worst(self, per_level):
        """[L(,K)] -> [L]: vector QoIs are driven by their worst component."""
        per_level = np.asarray(per_level)
        return per_level if per_level.ndim == 1 else per_level.max(axis=-1)

    def run(self, target_var, n_init: int = 256, max_rounds: int = 60):
        """Adaptive loop: double the point count of the level whose
        estimator variance is cheapest to halve until sum_l V_l <= target
        (vector QoIs: until max_k sum_l V_{l,k} <= target).

        :return: dict with mean, estimator variance, per-level breakdown
            and the measured QMC-vs-MC variance-reduction factors
        """
        n_init = max(2, int(n_init))
        n_init = 1 << (n_init - 1).bit_length()   # next power of two
        for lev in range(self.n_levels):
            if self._levels[lev].n == 0:
                self.extend(lev, n_init)
        rounds = 0
        while rounds < max_rounds:
            _, est_vars = self.level_estimates()
            if float(np.max(np.sum(est_vars, axis=0))) <= target_var:
                break
            costs = self._costs()
            ns = self.n_samples
            # doubling level l removes ~V_l/2 variance at cost C_l n_l
            payoff = self._worst(est_vars) / (costs * ns)
            lev = int(np.argmax(payoff))
            self.extend(lev, int(ns[lev]))
            rounds += 1
        means, est_vars = self.level_estimates()
        point_vars = self.point_variances()
        ns = self.n_samples
        total = ns * self._R
        var = np.sum(est_vars, axis=0)
        total_b = total if est_vars.ndim == 1 else total[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            gain = point_vars / (est_vars * total_b)
        scalar = est_vars.ndim == 1
        return dict(mean=float(np.sum(means)) if scalar
                    else np.sum(means, axis=0),
                    var=float(var) if scalar else var,
                    level_means=means, level_vars=est_vars,
                    n_samples=ns, n_evaluations=total,
                    n_randomizations=self._R, rounds=rounds,
                    target_met=bool(np.max(var) <= target_var),
                    mc_variance_reduction=gain)


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def synth_qmc_level_fns(level_parameters, distr="norm", nan_fraction=0.0):
    """QMC level functions for the synthetic QoI ``y + h sqrt(1e-4 + |y|)``
    (fine and coarse sharing the draw).

    :return: (level_fns, dims) for :class:`MLQMC`
    """
    if nan_fraction:
        raise ValueError("QMC has no unbiased failure-renewal story; "
                         "use the MC drivers for nan_fraction > 0")
    from mlmc_tpu_torch.sim.synth_simulation import SynthSimulation

    d = as_torch_distr(distr)
    fns = []
    for lev, params in enumerate(level_parameters):
        fine_step = float(params[0])
        coarse_step = 0.0 if lev == 0 else float(level_parameters[lev - 1][0])

        def fn(u, fine_step=fine_step, coarse_step=coarse_step):
            y = d.sample_uniforms(u)
            fine = SynthSimulation.sample_fn(y, fine_step)
            coarse = (torch.zeros_like(fine) if coarse_step == 0
                      else SynthSimulation.sample_fn(y, coarse_step))
            return fine, coarse

        fns.append(fn)
    return fns, [d.qmc_dim] * len(fns)


def shooting_qmc_level_fns(sim, level_parameters, component=0):
    """QMC level functions for the shooting simulations: the points drive
    the spectral force field's phases. The QoI is NaN when a trajectory
    leaves ``area_borders``, which fails the run: configure borders the
    trajectories cannot reach.

    :param sim: a ShootingSimulation1D/2D instance
    :param level_parameters: as for Sampler ([[fine_step], ...])
    :param component: index into the result (0 = final y / x)
    :return: (level_fns, dims) for :class:`MLQMC`
    """
    cls = type(sim)
    fns, dims = [], []
    for lev, params in enumerate(level_parameters):
        coarse = [0] if lev == 0 else level_parameters[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        d = len(cfg["_wave_numbers"]) * cls.N_FORCE_AXES

        def fn(u, cfg=cfg):
            trig = cls._phase_trig_from_uniforms(cfg, u)
            fine = cls._calculate_level(cfg, trig, "fine")
            if cfg["coarse"]["n_elements"] > 0:
                coarse_r = cls._calculate_level(cfg, trig, "coarse")
            else:
                coarse_r = torch.zeros_like(fine)
            return fine[:, component], coarse_r[:, component]

        fns.append(fn)
        dims.append(d)
    return fns, dims


def darcy_qmc_level_fns(sim, level_parameters):
    """QMC level functions for the Darcy simulations with the RFF field:
    the points drive the spectral mode phases (``2 pi u``) through the
    batched ``_calculate(config, phases=[B, M])`` of ``DiffusionSimulation``
    (``field_method='rff'``) or ``DiffusionSimulation3D``.

    :return: (level_fns, dims) for :class:`MLQMC`
    """
    cls = type(sim)
    fns, dims = [], []
    for lev, params in enumerate(level_parameters):
        coarse = [0] if lev == 0 else level_parameters[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        if "_wave_vectors" not in cfg:
            raise ValueError(
                "darcy_qmc_level_fns needs field_method='rff' "
                "(got %r)" % (cfg.get("field_method", "rff"),))

        def fn(u, cfg=cfg):
            fine, coarse_r = cls._calculate(cfg, phases=2 * np.pi * u)[:2]
            return fine[:, 0], coarse_r[:, 0]

        fns.append(fn)
        dims.append(int(np.shape(cfg["_wave_vectors"])[0]))
    return fns, dims


def _without_safe_eval(moments):
    """The moment basis with ``safe_eval=False`` (no NaN clipping),
    recursing through ``TransformedMoments``."""
    from mlmc_tpu_torch.moments import TransformedMoments

    if isinstance(moments, TransformedMoments):
        return TransformedMoments(_without_safe_eval(moments._origin),
                                  moments._transform_mat)
    return type(moments)(moments.size, moments.domain,
                         log=moments._is_log, safe_eval=False)


def moments_qmc_level_fns(level_fns, dims, moments, out_of_domain="error"):
    """Lift scalar QMC level functions to moment-vector level functions
    (``[n, R]``), so the maxent density rides the QMC tier. Level 0's
    coarse moment block is zero (phi(0) is not the zero vector).

    :param out_of_domain: ``"error"`` (out-of-domain values become NaN and
        fail the run) or ``"clip"`` (clamp to the domain first)
    :return: (vector_level_fns, dims, qoi_dim) for :class:`MLQMC`
    """
    if out_of_domain not in ("error", "clip"):
        raise ValueError("out_of_domain must be 'error' or 'clip'")
    if out_of_domain == "clip":
        moments = _without_safe_eval(moments)
        lo, hi = moments.domain

        def prep(v):
            return torch.clamp(v, lo, hi)
    else:
        def prep(v):
            return v

    out_fns = []
    for lev, fn in enumerate(level_fns):
        def qfn(u, fn=fn, lev=lev):
            fine, coarse = fn(u)
            fine_m = moments.eval_all(prep(fine))
            if lev == 0:
                coarse_m = torch.zeros_like(fine_m)
            else:
                coarse_m = moments.eval_all(prep(coarse))
            return fine_m, coarse_m

        out_fns.append(qfn)
    return out_fns, list(dims), moments.size


def qmc_level_fns_from_normals(normal_fns: List[Callable], n_normals):
    """Adapt level functions written over standard-normal blocks:
    ``normal_fns[l](z [n, m_l]) -> (fine, coarse)``.

    :return: (level_fns, dims) for :class:`MLQMC`
    """
    if np.isscalar(n_normals):
        n_normals = [int(n_normals)] * len(normal_fns)

    fns = []
    for fn, m in zip(normal_fns, n_normals):
        def qfn(u, fn=fn):
            return fn(sobol.normals_from_uniforms(u))

        fns.append(qfn)
    return fns, [int(m) for m in n_normals]
