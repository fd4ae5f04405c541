"""Particle filtering (counterpart of ``mlmc_tpu/particle.py``): the
bootstrap filter and the multilevel particle filter.

Given ``x_t ~ M_l(. | x_{t-1})``, ``y_t ~ g(. | x_t)``,
:func:`particle_filter` is the bootstrap filter (Gordon-Salmond-Smith
1993): propagate a particle population through the model, reweight by the
observation likelihood, and systematically resample when the effective
sample size degenerates. It returns filtered means, the unbiased
marginal-likelihood estimate, and island standard errors (resampling
couples particles, so the naive population variance is wrong).

:func:`multilevel_particle_filter` is the MLPF of Jasra, Kamatani, Law &
Zhou (SIAM J. Numer. Anal. 55, 2017): filtered expectations telescope over
a discretization hierarchy, each correction from a coupled pair of
filters: shared driving noise in the propagation plus maximally coupled
resampling (with probability ``sum_i min(w^f_i, w^c_i)`` both filters pick
the same ancestor). Identical fine and coarse kernels give exactly zero
corrections.

**Batch contract.** ``transition(x [N, d], keys, t) -> x' [N, d]`` with
``keys`` the ``random.keyed.SampleKeys`` of the step's particles (draw the
model noise from ``keys.normals(n, dtype)``, [N, n]: the same identities
give the same noise, which is the MLPF coupling); ``loglik_obs(x [N, d], y
[K]) -> [N]``; ``phi(x [N, d]) -> [N, q]``. The population is [islands, m,
d] on the device and each step is a few tensor operations.

**Draws.** Particle p's draws at step t of level l are keyed by (seed, l,
t, p): ``SampleKeys(seed, word(tag, l, t), p)`` with ``word = tag << 28 |
l << 20 | t`` and the tag naming the stream (0 the initial states, 1 the
propagation, 2 the island's resampling uniform, keyed by the island, 3-6
the coupled resampling's four uniforms). ``mlmc_tpu`` salts each mesh
shard's key with its device index; here every island draws from its own
identities, so a ``SampleMesh`` run, whose shards each run their islands,
equals the one-device run bit for bit (per-island sums and prefix sums run
in a fixed pairwise order for that). ``draws=`` takes any object with
``init``, ``propagate``, ``resample`` and ``coupled`` (see
:class:`ParticleDraws`) in their place (a test hands in JAX's).
"""
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.parallel.mesh import single_device_mesh
from mlmc_tpu_torch.random.keyed import SampleKeys, keyed_uniforms
from mlmc_tpu_torch.smc import (_scan, _searchsorted, _softmax,
                                _systematic_resample, _tree_sum)

__all__ = ["particle_filter", "multilevel_particle_filter", "ParticleDraws"]

T_BITS, LEVEL_BITS = 20, 8


def _word(tag, level, t):
    """The level word of stream ``tag`` at step ``t`` of level ``level``."""
    if not (0 <= t < 1 << T_BITS and 0 <= level < 1 << LEVEL_BITS):
        raise ValueError("a filter keys at most 2^20 steps and 256 levels")
    return tag << (T_BITS + LEVEL_BITS) | level << T_BITS | t


class ParticleDraws:
    """The draws of a filter level from its particles' identities.

    ``init(idx)`` and ``propagate(t, idx)`` return the ``SampleKeys`` of
    particles ``idx`` (int64, on the shard's device); ``resample(t,
    islands)`` the [I, 1] uniforms of the islands' systematic resampling;
    ``coupled(t, idx)`` the four [N] uniforms (same-ancestor test, common,
    fine, coarse) of the coupled resampling."""

    def __init__(self, seed, level=0, dtype=torch.float64):
        self.seed, self.level, self.dtype = int(seed), int(level), dtype

    def _keys(self, tag, t, idx):
        return SampleKeys(self.seed, _word(tag, self.level, t), idx)

    def init(self, idx):
        return self._keys(0, 0, idx)

    def propagate(self, t, idx):
        return self._keys(1, t, idx)

    def _uniforms(self, tag, t, idx):
        return keyed_uniforms(self.seed, _word(tag, self.level, t), idx,
                              torch.zeros_like(idx), 1, self.dtype)[:, 0]

    def resample(self, t, islands):
        return self._uniforms(2, t, islands)[:, None]

    def coupled(self, t, idx):
        return tuple(self._uniforms(tag, t, idx) for tag in (3, 4, 5, 6))


def _island_se(vals):
    """Across-island standard error of the island means, last axis
    first: vals [I, ...] -> (mean [...], se [...])."""
    vals = np.asarray(vals, np.float64)
    mean = vals.mean(axis=0)
    n = vals.shape[0]
    se = vals.std(axis=0, ddof=1) / np.sqrt(n) if n > 1 else 0.0 * mean
    return mean, se


def _log_softmax(a):
    """log softmax over the last axis (:func:`smc._tree_sum`'s order)."""
    sh = a - a.max(dim=-1, keepdim=True).values
    return sh - torch.log(_tree_sum(torch.exp(sh)))[..., None]


def _weighted_mean(w, v):
    """sum_j w[i, j] v[i, j, :] in a fixed order: w [I, m], v [I, m, q] ->
    [I, q]."""
    return _tree_sum((w[:, :, None] * v).transpose(1, 2))


def _shards(mesh, n_islands, device):
    """The mesh (one shard on ``device`` when None) and the (device, first
    island, island count) of each local shard."""
    mesh = single_device_mesh(device) if mesh is None else mesh
    if n_islands % mesh.n_devices:
        raise ValueError(f"n_islands={n_islands} must divide by the "
                         f"mesh's {mesh.n_devices} devices")
    n_loc = n_islands // mesh.n_devices
    return mesh, [(dev, s * n_loc, n_loc) for s, dev in mesh.local_shards()]


def _initial(draws, x0, x0_sampler, dev, lo, n_loc, m, d, dtype):
    """The shard's initial particles [n_loc, m, d]."""
    idx = torch.arange(lo * m, (lo + n_loc) * m, dtype=torch.int64, device=dev)
    if x0 is not None:
        x = torch.as_tensor(x0).reshape(-1, d)[lo * m:(lo + n_loc) * m]
    else:
        keys = draws.init(idx)
        x = x0_sampler(keys) if x0_sampler is not None else keys.normals(d, dtype)
    return idx, torch.as_tensor(x).to(dev, dtype).reshape(n_loc, m, d)


def particle_filter(transition: Callable, loglik_obs: Callable, data,
                    n_particles: int, d: int, seed: int = 0, x0=None,
                    x0_sampler: Optional[Callable] = None,
                    n_islands: int = 8, ess_threshold: float = 0.5,
                    phi: Optional[Callable] = None, dtype=torch.float64,
                    mesh=None, device=None, draws=None):
    """Bootstrap particle filter over ``data`` [T, K].

    :param transition: ``(x [N, d], keys, t) -> x' [N, d]``
    :param loglik_obs: ``(x [N, d], y [K]) -> [N]`` observation
        log-density of each particle
    :param n_particles: total population, split into ``n_islands``
        independent islands of m = n_particles // n_islands
    :param x0_sampler: ``keys -> x [N, d]`` initial particles from their
        keys (default standard normal)
    :param ess_threshold: resample an island when its ESS/m drops below
        this (1.0 = every step, 0.0 = never)
    :param phi: ``x [N, d] -> [N, q]`` test function; the filtered
        ``E[phi(x_t) | y_{1:t}]`` is returned as ``means`` (default the
        identity, q = d)
    :param mesh: optional ``SampleMesh``: the islands shard over its
        devices (``n_islands`` must divide by the device count); the result
        equals the one-device run bit for bit
    :param device: where a run without a mesh computes (None: the current
        CUDA device)
    :param draws: a :class:`ParticleDraws`-like object in place of
        ``ParticleDraws(seed)``
    :return: dict with ``means`` [T, q] (+ ``means_se``), ``loglik``
        (log-mean of the per-island unbiased likelihood estimates) and
        ``loglik_islands`` [I], ``ess`` [T] (island-mean ESS fraction),
        ``resample_frac``, ``particles`` [I, m, d] + ``log_weights`` [I, m]
        final, ``wall_s``
    """
    if not 0.0 <= ess_threshold <= 1.0:
        raise ValueError("ess_threshold must be in [0, 1]")
    if n_particles % n_islands:
        raise ValueError(f"n_particles={n_particles} must be a "
                         f"multiple of n_islands={n_islands}")
    m = n_particles // n_islands
    mesh, shards = _shards(mesh, n_islands, device)
    draws = draws or ParticleDraws(seed, 0, dtype)
    phi = phi if phi is not None else (lambda x: x)
    data_np = np.asarray(data, np.float64)
    T = data_np.shape[0]
    t0 = time.perf_counter()
    state = []
    for dev, lo, n_loc in shards:
        idx, x = _initial(draws, x0, x0_sampler, dev, lo, n_loc, m, d, dtype)
        logw = torch.full((n_loc, m), -np.log(m), dtype=dtype, device=dev)
        ys = torch.tensor(data_np).to(dev, dtype)
        islands = torch.arange(lo, lo + n_loc, dtype=torch.int64, device=dev)
        state.append(dict(x=x, logw=logw, idx=idx, ys=ys, islands=islands, rec=[]))
    for t in range(T):
        for st in state:       # shards in turn: each device's queue fills
            x, logw = st["x"], st["logw"]
            n_loc = x.shape[0]
            x = transition(x.reshape(n_loc * m, d), draws.propagate(t, st["idx"]),
                           t).reshape(n_loc, m, d)
            ll = loglik_obs(x.reshape(n_loc * m, d), st["ys"][t]).reshape(n_loc, m)
            a = logw + ll
            mx = a.max(dim=1, keepdim=True).values
            inc = mx[:, 0] + torch.log(_tree_sum(torch.exp(a - mx)))      # [I]
            logw = a - inc[:, None]
            w = torch.exp(logw)
            ess = 1.0 / (m * _tree_sum(w * w))                             # [I]
            mean_t = _weighted_mean(w, phi(x.reshape(n_loc * m, d)).reshape(n_loc, m, -1))
            do = ess < ess_threshold
            u01 = draws.resample(t, st["islands"]).to(x.device, dtype)
            idx = _systematic_resample(logw, u01, m)
            x_res = torch.take_along_dim(x, idx[:, :, None], dim=1)
            st["x"] = torch.where(do[:, None, None], x_res, x)
            st["logw"] = torch.where(do[:, None], torch.full_like(logw, -np.log(m)), logw)
            st["rec"].append((mean_t, inc, ess, do.to(dtype)))
    parts = []
    for st in state:
        means, incs, ess, resamp = (torch.stack(r) for r in zip(*st["rec"]))
        parts.append((means.transpose(0, 1), incs.sum(0), ess.T, resamp.T,
                      st["x"], st["logw"]))
    means, ll_isl, ess, resamp, x, logw = (
        mesh.gather([p[j] for p in parts]).cpu().numpy() for j in range(6))
    wall = time.perf_counter() - t0
    mean, se = _island_se(means.astype(np.float64))         # [I, T, q]
    ll_isl = ll_isl.astype(np.float64)
    mx = ll_isl.max()
    return {"means": mean, "means_se": se,
            "loglik": float(mx + np.log(np.mean(np.exp(ll_isl - mx)))),
            "loglik_islands": ll_isl,
            "ess": ess.T.mean(axis=1),
            "resample_frac": float(np.mean(resamp)),
            "particles": x, "log_weights": logw,
            "wall_s": wall}


def _coupled_resample(logwf, logwc, u_b, u_common, u_f, u_c, m):
    """Maximally coupled per-island resampling: with probability
    ``alpha = sum_i min(wf_i, wc_i)`` both filters draw the same ancestor
    from ``min(wf, wc)/alpha``; otherwise each draws independently from
    its normalized residual (Jasra et al. 2017, Sec. 3.1). Marginals are
    exactly wf / wc either way.

    logwf/logwc [I, m] normalized, the uniforms [I, m] -> (idxf, idxc)
    [I, m] each.
    """
    wf, wc = _softmax(logwf), _softmax(logwc)
    nu = torch.minimum(wf, wc)                         # [I, m]
    alpha = _tree_sum(nu)[:, None]                     # [I, 1]
    tiny = torch.finfo(logwf.dtype).tiny
    p_common = nu / torch.clamp(alpha, min=tiny)
    p_f = (wf - nu) / torch.clamp(1.0 - alpha, min=tiny)
    p_c = (wc - nu) / torch.clamp(1.0 - alpha, min=tiny)

    def cat(p, u):
        return _searchsorted(_scan(p), u, m)

    same = u_b < alpha
    idx_common = cat(p_common, u_common)
    idxf = torch.where(same, idx_common, cat(p_f, u_f))
    idxc = torch.where(same, idx_common, cat(p_c, u_c))
    return idxf, idxc


def multilevel_particle_filter(
        transition_level: Callable, loglik_obs: Callable, data,
        n_levels: int, d: int, n_particles=4096, seed: int = 0,
        x0_sampler: Optional[Callable] = None, n_islands: int = 8,
        phi: Optional[Callable] = None, dtype=torch.float64, mesh=None,
        device=None, draws=None):
    """Multilevel particle filter: telescoped filtered expectations
    ``E_L[phi(x_t) | y_{1:t}]`` over a transition-kernel hierarchy.

    :param transition_level: ``level -> (x [N, d], keys, t) -> x' [N, d]``
        factory of batched transition kernels, coarsest level 0. The
        coupling at level l >= 1 runs ``transition_level(l)`` and
        ``transition_level(l-1)`` on the same keys: kernels must draw their
        noise so that same-key fine/coarse propagations are pathwise close
    :param n_particles: int (all levels) or per-level sequence
    :param phi: ``x [N, d] -> [N, q]`` test function (default identity)
    :param mesh: optional ``SampleMesh``: each level's islands shard over
        its devices (coupled pairs live on one shard); the result equals
        the one-device run bit for bit
    :param draws: one :class:`ParticleDraws`-like object per level in place
        of ``ParticleDraws(seed, level)``
    :return: dict with ``means`` [T, q] telescoped (+ ``means_se``
        combined across levels in quadrature), ``level_means`` list of
        [T, q] (level 0, then corrections), ``level_ses``,
        ``correction_l1`` [n_levels-1] (time-mean |correction| per coupled
        level), ``loglik`` (the level-0 filter's), ``wall_s``
    """
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    n_per = ([int(n_particles)] * n_levels
             if np.isscalar(n_particles) else list(n_particles))
    if len(n_per) != n_levels:
        raise ValueError(f"n_particles gives {len(n_per)} levels, "
                         f"expected {n_levels}")
    mesh, _ = _shards(mesh, n_islands, device)
    draws = draws or [ParticleDraws(seed, lev, dtype) for lev in range(n_levels)]
    phi = phi if phi is not None else (lambda x: x)
    data_np = np.asarray(data, np.float64)
    T = data_np.shape[0]
    t0 = time.perf_counter()

    pf0 = particle_filter(
        transition_level(0), loglik_obs, data_np, n_per[0], d,
        x0_sampler=x0_sampler, n_islands=n_islands, ess_threshold=1.0,
        phi=phi, dtype=dtype, mesh=mesh, draws=draws[0])
    level_means = [pf0["means"]]
    level_ses = [pf0["means_se"]]
    corr_l1 = []

    for lev in range(1, n_levels):
        if n_per[lev] % n_islands:
            raise ValueError(f"n_particles[{lev}]={n_per[lev]} must be "
                             f"a multiple of n_islands={n_islands}")
        m = n_per[lev] // n_islands
        fine, coarse = transition_level(lev), transition_level(lev - 1)
        dr = draws[lev]
        _, shards = _shards(mesh, n_islands, None)
        state = []
        for dev, lo, n_loc in shards:
            idx, x = _initial(dr, None, x0_sampler, dev, lo, n_loc, m, d, dtype)
            state.append(dict(xf=x, xc=x, idx=idx, rec=[],
                              ys=torch.tensor(data_np).to(dev, dtype)))
        for t in range(T):
            for st in state:
                n_loc = st["xf"].shape[0]
                keys = dr.propagate(t, st["idx"])
                xf = fine(st["xf"].reshape(n_loc * m, d), keys, t)
                xc = coarse(st["xc"].reshape(n_loc * m, d), keys, t)
                y = st["ys"][t]
                logwf = _log_softmax(loglik_obs(xf, y).reshape(n_loc, m))
                logwc = _log_softmax(loglik_obs(xc, y).reshape(n_loc, m))
                corr_t = (_weighted_mean(torch.exp(logwf), phi(xf).reshape(n_loc, m, -1))
                          - _weighted_mean(torch.exp(logwc), phi(xc).reshape(n_loc, m, -1)))
                us = [u.to(xf.device, dtype).reshape(n_loc, m)
                      for u in dr.coupled(t, st["idx"])]
                idxf, idxc = _coupled_resample(logwf, logwc, *us, m)
                st["xf"] = torch.take_along_dim(xf.reshape(n_loc, m, d), idxf[:, :, None], dim=1)
                st["xc"] = torch.take_along_dim(xc.reshape(n_loc, m, d), idxc[:, :, None], dim=1)
                st["rec"].append(corr_t)
        corr = mesh.gather([torch.stack(st["rec"]).transpose(0, 1) for st in state])
        mean, se = _island_se(corr.cpu().numpy().astype(np.float64))   # [I, T, q]
        level_means.append(mean)
        level_ses.append(se)
        corr_l1.append(float(np.mean(np.abs(mean))))

    means = np.sum(level_means, axis=0)
    means_se = np.sqrt(np.sum(np.square(level_ses), axis=0))
    return {"means": means, "means_se": means_se,
            "level_means": level_means, "level_ses": level_ses,
            "correction_l1": np.asarray(corr_l1),
            "loglik": pf0["loglik"],
            "wall_s": time.perf_counter() - t0}
