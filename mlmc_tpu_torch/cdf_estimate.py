"""Multilevel distribution-function and quantile estimation (counterpart
of ``mlmc_tpu/cdf_estimate.py``).

Giles, Nagapetyan & Ritter ("Multilevel Monte Carlo approximation of
distribution functions and densities", SIAM/ASA JUQ 3(1), 2015):
telescope the smoothed indicator ``F(x) ~ E[g((x - X)/delta)]``, g a
polynomial sigmoid, across the levels on a fixed grid. Smoothing makes
the level corrections inherit the coupling's variance decay and caps the
bias at O(delta^2) (O(delta^4) with the fourth-order kernel).

Each extension of a level streams chunks of coupled pairs, forms the
[C, J] smoothed-indicator block against the grid and reduces it to [J]
Kahan-compensated sums; invalid pairs (non-finite, or flagged failed)
are masked and not counted. Over a sample mesh each shard draws its part
of a chunk and the pairs are gathered in index order before the
reduction, so the sums equal one device's bit for bit. Quantiles invert the monotone-projected CDF
on the host, with delta-method standard errors.

Level contract: ``pair_fn(level, keys) -> (fine [C], coarse [C], valid
[C] bool)`` where ``keys`` is a ``random.keyed.SampleKeys`` (seed, level,
sample indices [C] on the chunk's device); coarse is ignored at level 0.
Sample ``i`` of level ``l`` is the identity (seed, l, i) that
``random/keyed`` draws from, as JAX's ``fold_in(fold_in(key(seed), l),
i)``. ``simulation_pair_fn`` builds it from a simulation's keyed batch.
"""
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.parallel.mesh import chunk_rows, single_device_mesh
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["smoothed_indicator", "MultilevelCDF", "simulation_pair_fn"]


def smoothed_indicator(s, order: int = 2):
    """Polynomial sigmoid kernel ``g(s)``: 0 for s <= -1, 1 for s >= 1.

    ``order=2``: the integral of the quartic (Epanechnikov-squared)
    kernel, ``g(s) = 1/2 + (15 s - 10 s^3 + 3 s^5)/16``, bias O(delta^2).
    ``order=4``: a fourth-order (signed) kernel with vanishing second
    moment, bias O(delta^4) for C^4 densities.
    """
    s = torch.clamp(torch.as_tensor(s), -1.0, 1.0)
    if order == 2:
        return 0.5 + (15.0 * s - 10.0 * s ** 3 + 3.0 * s ** 5) / 16.0
    if order == 4:
        return 0.5 + (105.0 * s - 175.0 * s ** 3 + 147.0 * s ** 5
                      - 45.0 * s ** 7) / 64.0
    raise ValueError("kernel order must be 2 or 4")


def _kernel_pdf(s, order):
    """``g'(s)``, the density kernel (for the PDF estimates)."""
    inside = (s > -1.0) & (s < 1.0)
    s = torch.clamp(s, -1.0, 1.0)
    if order == 2:
        k = 15.0 / 16.0 * (1.0 - s * s) ** 2
    else:
        k = 105.0 / 64.0 * (1.0 - 5.0 * s ** 2 + 7.0 * s ** 4
                            - 3.0 * s ** 6)
    return torch.where(inside, k, torch.zeros_like(k))


class _LevelState:
    __slots__ = ("n", "n_valid", "g_sum", "g_sq", "p_sum", "p_sq",
                 "elapsed")

    def __init__(self, J):
        self.n = 0
        self.n_valid = 0
        self.g_sum = np.zeros(J)
        self.g_sq = np.zeros(J)
        self.p_sum = np.zeros(J)
        self.p_sq = np.zeros(J)
        self.elapsed = 0.0


class MultilevelCDF:
    """Adaptive multilevel CDF/PDF/quantile estimator on a fixed grid.

    :param pair_fn: ``(level, keys) -> (fine [C], coarse [C], valid [C])``
    :param n_levels: hierarchy depth
    :param grid: evaluation points x_j (1-D, strictly increasing)
    :param bandwidth: smoothing delta (one value, or one per level: level
        l's fine term uses delta_l and its coarse term delta_{l-1}, so the
        telescope collapses to ``E[g_{delta_{L-1}}(f_{L-1})]``)
    :param kernel_order: 2 (positive kernel) or 4 (signed)
    :param seed: the seed of every sample's identity (seed, level, index)
    :param cost_fn: optional ``level -> relative cost`` for allocation
    :param chunk_size: samples per loop step
    :param dtype: accumulation dtype
    :param mesh: a ``parallel.SampleMesh``: each chunk's pairs split over
        the shards (chunk_size must divide by the device count) and are
        gathered in index order before the [J] sums, which equal one
        device's bit for bit
    :param device: where the chunks run without a mesh; None = the
        current CUDA device
    """

    def __init__(self, pair_fn: Callable, n_levels: int,
                 grid: Sequence[float], bandwidth, kernel_order: int = 2,
                 seed: int = 0, cost_fn: Optional[Callable] = None,
                 chunk_size: int = 1 << 12, dtype=torch.float64, mesh=None,
                 device=None):
        self._fn = pair_fn
        self.n_levels = int(n_levels)
        if self.n_levels < 1:
            raise ValueError("need n_levels >= 1")
        grid = np.asarray(grid, dtype=float)
        if grid.ndim != 1 or grid.size < 2 or np.any(np.diff(grid) <= 0):
            raise ValueError("grid must be 1-D strictly increasing with "
                             ">= 2 points")
        self.grid = grid
        if np.ndim(bandwidth) == 0:
            self._deltas = [float(bandwidth)] * self.n_levels
        else:
            self._deltas = [float(d) for d in bandwidth]
            if len(self._deltas) != self.n_levels:
                raise ValueError("per-level bandwidth needs n_levels values")
        if min(self._deltas) <= 0:
            raise ValueError("bandwidth must be positive")
        if kernel_order not in (2, 4):
            raise ValueError("kernel order must be 2 or 4")
        self._order = int(kernel_order)
        self._chunk = int(chunk_size)
        self._mesh = mesh if mesh is not None else single_device_mesh(device)
        if self._chunk % self._mesh.n_devices:
            raise ValueError(
                "chunk_size=%d must divide by the mesh's %d devices"
                % (self._chunk, self._mesh.n_devices))
        self._dtype = dtype
        self._seed = int(seed)
        self._cost_fn = cost_fn
        self._states = [
            _LevelState(grid.size) for _ in range(self.n_levels)]

    # -------------------------------------------------------------- #
    def _sums(self, level, start, n_chunks):
        """Kahan-compensated [J] sums (g, g^2, pdf, pdf^2) and the valid
        count of chunks [start, start + n_chunks): each shard draws its part
        of a chunk, the pairs are gathered in index order and reduced on the
        mesh's first device, so the sums equal one device's bit for bit."""
        dtype = self._dtype
        device = self._mesh.devices[0]
        x = torch.as_tensor(self.grid, dtype=dtype, device=device)
        delta_f = self._deltas[level]
        delta_c = self._deltas[max(level - 1, 0)]
        order = self._order
        is_l0 = level == 0

        def g_block(v, valid, delta):
            s = (x[None, :] - v[:, None]) / delta
            m = valid[:, None]
            g = torch.where(m, smoothed_indicator(s, order), 0.0)
            p = torch.where(m, _kernel_pdf(s, order) / delta, 0.0)
            return g, p

        def pairs(idx):
            fine, coarse, valid = self._fn(level, SampleKeys(self._seed, level, idx))
            return fine.to(dtype), coarse.to(dtype), valid

        z = torch.zeros(x.numel(), dtype=dtype, device=device)
        accs, comps = [z] * 4, [z] * 4
        nv = torch.zeros((), dtype=torch.int64, device=device)
        for c in range(start, start + n_chunks):
            fine, coarse, valid = chunk_rows(self._mesh, self._chunk, c, pairs)
            valid = valid & torch.isfinite(fine)
            if not is_l0:
                valid = valid & torch.isfinite(coarse)
            gf, pf = g_block(fine, valid, delta_f)
            if is_l0:
                d, p = gf, pf
            else:
                gc, pc = g_block(coarse, valid, delta_c)
                d, p = gf - gc, pf - pc
            terms = (d.sum(0), (d * d).sum(0), p.sum(0), (p * p).sum(0))
            for k, term in enumerate(terms):
                y = term - comps[k]
                t = accs[k] + y
                comps[k] = (t - accs[k]) - y
                accs[k] = t
            nv = nv + valid.sum()
        return [a - c for a, c in zip(accs, comps)] + [nv]

    def extend(self, level, n_add):
        """Draw ``n_add`` more coupled pairs at ``level`` (rounded up to
        whole chunks), continuing its stream."""
        st = self._states[level]
        n_chunks = -(-int(n_add) // self._chunk)
        if n_chunks <= 0:
            return
        start = st.n // self._chunk
        t0 = time.perf_counter()
        sums = self._sums(level, start, n_chunks)
        g_sum, g_sq, p_sum, p_sq = (v.cpu().numpy().astype(np.float64)
                                    for v in sums[:4])
        st.elapsed += time.perf_counter() - t0
        if not all(np.all(np.isfinite(v)) for v in (g_sum, g_sq, p_sum, p_sq)):
            raise FloatingPointError(
                "level %d produced non-finite accumulators" % level)
        st.g_sum += g_sum
        st.g_sq += g_sq
        st.p_sum += p_sum
        st.p_sq += p_sq
        st.n_valid += int(sums[4])
        st.n += n_chunks * self._chunk

    # -------------------------------------------------------------- #
    def estimates(self):
        """CDF / PDF estimates and per-point variances.

        The raw telescoped CDF is monotone-projected (running max, then
        clipped to [0, 1]) for ``cdf``; ``cdf_raw`` keeps the telescope.

        :return: dict(x, cdf, cdf_raw, cdf_var, pdf, pdf_var, n_samples)
        """
        J = self.grid.size
        cdf = np.zeros(J)
        var = np.zeros(J)
        pdf = np.zeros(J)
        pvar = np.zeros(J)
        ns = []
        for st in self._states:
            n = max(st.n_valid, 1)
            mu = st.g_sum / n
            cdf += mu
            bessel = n / max(n - 1, 1)
            v = np.maximum(st.g_sq / n - mu * mu, 0.0) * bessel
            var += v / n
            mp = st.p_sum / n
            pdf += mp
            pvar += np.maximum(st.p_sq / n - mp * mp, 0.0) * bessel / n
            ns.append(st.n_valid)
        mono = np.clip(np.maximum.accumulate(cdf), 0.0, 1.0)
        return dict(x=self.grid, cdf=mono, cdf_raw=cdf, cdf_var=var,
                    pdf=pdf, pdf_var=pvar, n_samples=np.array(ns))

    def quantiles(self, ps):
        """Quantiles by inverting the monotone-projected CDF with linear
        interpolation, with delta-method standard errors
        ``se(q_p) = sqrt(Var[F(q_p)]) / pdf(q_p)``.

        :return: (q [len(ps)], se [len(ps)])
        """
        est = self.estimates()
        ps = np.atleast_1d(np.asarray(ps, dtype=float))
        if np.any((ps <= 0) | (ps >= 1)):
            raise ValueError("quantile levels must be in (0, 1)")
        cdf, x = est["cdf"], est["x"]
        if cdf[0] > ps.min() or cdf[-1] < ps.max():
            raise ValueError(
                "grid does not bracket the requested quantiles "
                "(cdf spans [%.3g, %.3g])" % (cdf[0], cdf[-1]))
        # strictly increasing view for interp (ties get epsilon steps)
        c = np.maximum.accumulate(cdf + 1e-12 * np.arange(len(cdf)))
        q = np.interp(ps, c, x)
        f_at_q = np.maximum(np.interp(q, x, est["pdf"]), 1e-300)
        se_f = np.sqrt(np.interp(q, x, est["cdf_var"]))
        return q, se_f / f_at_q

    # -------------------------------------------------------------- #
    def _costs(self):
        if self._cost_fn is not None:
            return np.array([float(self._cost_fn(lv))
                             for lv in range(self.n_levels)])
        measured = np.array([st.elapsed / max(st.n, 1)
                             for st in self._states])
        if not np.all(measured > 0):
            measured = 2.0 ** np.arange(self.n_levels)
        return measured

    def run(self, target_var, n_init: int = None, max_rounds: int = 20):
        """Adaptive loop on the worst grid point: allocate
        ``n_l ~ sqrt(V_l / C_l)`` against ``max_j Var[F(x_j)]`` until it
        meets the target.

        :return: ``estimates`` dict + rounds/target_met
        """
        n_init = int(n_init or 2 * self._chunk)
        for lv in range(self.n_levels):
            if self._states[lv].n == 0:
                self.extend(lv, n_init)
        rounds = 0
        while rounds < max_rounds:
            pvars, ns = [], []
            for st in self._states:
                n = max(st.n_valid, 1)
                mu = st.g_sum / n
                v = np.maximum(st.g_sq / n - mu * mu, 0.0)
                pvars.append(v.max() * (n / max(n - 1, 1)))
                ns.append(st.n_valid)
            pvars = np.array(pvars)
            ns = np.array(ns, dtype=float)
            if float(np.sum(pvars / np.maximum(ns, 1))) <= target_var:
                break
            costs = self._costs()
            lam = float(np.sum(np.sqrt(pvars * costs))) / target_var
            n_opt = np.maximum(np.ceil(lam * np.sqrt(pvars / costs)),
                               2 * self._chunk)
            gaps = n_opt - ns
            if not np.any(gaps > 0):
                break
            for lv, gap in enumerate(gaps):
                if gap > 0:
                    self.extend(lv, int(gap))
            rounds += 1
        est = self.estimates()
        est.update(rounds=rounds,
                   target_met=bool(est["cdf_var"].max() <= target_var))
        return est


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def simulation_pair_fn(sim, level_parameters: List[List[float]],
                       component: int = 0):
    """Coupled-pair function from a Simulation with a keyed batch path:
    level l runs ``calculate_keyed_batch`` under the
    ``level_instance(params_l, params_{l-1})`` config on the keys'
    samples (first attempts) and returns the chosen component of (fine,
    coarse) and the not-failed flag.

    :param level_parameters: as for Sampler (``[[h0], [h1], ...]``)
    :param component: flat result component to estimate the CDF of
    :return: (pair_fn, n_levels) for ``MultilevelCDF``
    """
    if getattr(type(sim), "calculate_keyed_batch", None) is None:
        raise ValueError("%s has no device batch path"
                         % type(sim).__name__)
    configs = []
    for lev, params in enumerate(level_parameters):
        coarse = [0] * len(params) if lev == 0 else level_parameters[lev - 1]
        configs.append(sim.level_instance(list(params),
                                          list(coarse)).config_dict)

    def pair_fn(level, keys):
        fine, coarse, failed = type(sim).calculate_keyed_batch(
            configs[level], keys.seed, keys.level, keys.indices,
            torch.zeros_like(keys.indices))
        return fine[:, component], coarse[:, component], ~failed

    return pair_fn, len(level_parameters)
