"""Multi-index Monte Carlo (counterpart of ``mlmc_tpu/mimc.py``).

Haji-Ali, Nobile & Tempone ("Multi-index Monte Carlo: when sparsity meets
sampling", Numer. Math. 132, 2016) replace the level scalar by a
multi-index ``alpha in N^d`` over independent discretization axes and
telescope with first-order mixed differences:

    E[f_inf] ~ sum_{alpha in I} E[ Delta f(alpha) ],
    Delta = tensor_i Delta_i,   Delta_i f(alpha) = f(alpha) - f(alpha-e_i)

Mixed-difference means and variances decay at product rates, so a
total-degree index set keeps O(eps^-2) work where single-axis MLMC
(refining every axis together) degrades.

Each extension of an index evaluates every corner of its mixed difference
on one chunk of sample identities (the same identities at every corner:
the coupling) and adds the chunk's sum and sum of squares to float64
accumulators on the device, where ``mlmc_tpu`` keeps Kahan-compensated
float32 sums; one host fetch per extension. Sample ``i`` of the index at
position ``k`` of the set is ``random.keyed.SampleKeys(seed, k, i)`` (JAX:
``fold_in(fold_in(key(seed), k), i)``), so extensions continue a stream
and never redraw. Over a ``SampleMesh`` each shard evaluates its part of
a chunk (``parallel.mesh.chunk_indices``) and the per-sample differences
are gathered in index order before the sums, which therefore equal one
device's bit for bit. The allocation is the CLT-optimal ``n_alpha ~
sqrt(V/C)`` rule summed over the index set.

Contract: ``value_fn(alpha, keys) -> values [C]`` with ``keys`` a
``SampleKeys``; the same identities must give the same random
realization at every alpha (resolution-independent parametrizations:
random-Fourier-feature phases, Brownian increments by bisection).
"""
import itertools
import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from mlmc_tpu_torch.parallel.mesh import chunk_rows, single_device_mesh
from mlmc_tpu_torch.random.keyed import SampleKeys, keyed_uniforms
from mlmc_tpu_torch.sim.diffusion import _wave_vectors_2d, preconditioned_cg

__all__ = ["MIMC", "total_degree_set", "full_tensor_set",
           "mixed_difference_terms", "synth_mimc_value_fn",
           "heat_mimc_value_fn", "darcy_mimc_value_fn"]


# ---------------------------------------------------------------------- #
# index sets and the mixed-difference expansion
# ---------------------------------------------------------------------- #
def total_degree_set(d, level, weights=None):
    """Anisotropic total-degree index set
    ``{alpha : sum_i weights_i alpha_i <= level}`` (weights default 1:
    the standard simplex), sorted lexicographically."""
    w = np.ones(d) if weights is None else np.asarray(weights, dtype=float)
    if w.shape != (d,) or np.any(w <= 0):
        raise ValueError("weights must be %d positive numbers" % d)
    out = []
    maxes = [int(level / w[i]) for i in range(d)]
    for alpha in itertools.product(*(range(m + 1) for m in maxes)):
        if float(np.dot(w, alpha)) <= level + 1e-12:
            out.append(tuple(alpha))
    return sorted(out)


def full_tensor_set(maxes):
    """Full tensor-product index set ``prod_i {0..maxes_i}``."""
    return sorted(itertools.product(*(range(int(m) + 1) for m in maxes)))


def mixed_difference_terms(alpha):
    """Corners and signs of the first-order mixed difference at ``alpha``:
    ``Delta f(alpha) = sum (sign_j * f(corner_j))``, differenced only along
    axes with ``alpha_i > 0`` (at the boundary ``Delta_i f = f``).

    :return: list of (corner tuple, +-1)
    """
    active = [i for i, a in enumerate(alpha) if a > 0]
    terms = []
    for bits in itertools.product((0, 1), repeat=len(active)):
        corner = list(alpha)
        for i, b in zip(active, bits):
            corner[i] -= b
        terms.append((tuple(corner), -1 if sum(bits) % 2 else 1))
    return terms


# ---------------------------------------------------------------------- #
class _IndexState:
    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.elapsed = 0.0


class MIMC:
    """Adaptive multi-index Monte Carlo over a downward-closed index set.

    :param value_fn: ``f(alpha, keys) -> [C]``; the same identities must
        give the same random realization at every alpha
    :param index_set: iterable of d-tuples (see :func:`total_degree_set`)
    :param seed: the seed of every sample's identity (seed, index position,
        sample index)
    :param cost_fn: optional ``alpha -> relative cost`` for the allocation;
        measured wall time per sample otherwise
    :param chunk_size: samples per loop step
    :param dtype: accumulation dtype
    :param mesh: a ``parallel.SampleMesh``: each chunk's samples split over
        the shards (chunk_size must divide by the device count); the sums
        equal one device's bit for bit
    :param device: where the chunks run without a mesh; None = the current
        CUDA device
    """

    def __init__(self, value_fn: Callable, index_set: Sequence[Tuple[int, ...]],
                 seed: int = 0, cost_fn: Optional[Callable] = None,
                 chunk_size: int = 1 << 13, dtype=torch.float64, mesh=None,
                 device=None):
        self._fn = value_fn
        self._set = [tuple(int(a) for a in alpha) for alpha in index_set]
        if not self._set:
            raise ValueError("index_set is empty")
        d = len(self._set[0])
        if any(len(a) != d or min(a) < 0 for a in self._set):
            raise ValueError("index_set entries must be equal-length "
                             "non-negative tuples")
        if len(set(self._set)) != len(self._set):
            raise ValueError("index_set has duplicates")
        # downward closedness: every Delta corner must be representable
        need = {c for a in self._set for c, _ in mixed_difference_terms(a)}
        missing = need - set(self._set)
        if missing:
            raise ValueError(
                "index_set is not downward closed (telescoping would be "
                "biased); missing %s" % sorted(missing)[:4])
        self.d = d
        self._chunk = int(chunk_size)
        self._mesh = mesh if mesh is not None else single_device_mesh(device)
        if self._chunk % self._mesh.n_devices:
            raise ValueError(
                "chunk_size=%d must divide by the mesh's %d devices"
                % (self._chunk, self._mesh.n_devices))
        self._dtype = dtype
        self._seed = int(seed)
        self._states = {a: _IndexState() for a in self._set}
        self._cost_fn = cost_fn

    # -------------------------------------------------------------- #
    @property
    def index_set(self):
        return list(self._set)

    @property
    def n_samples(self):
        return np.array([self._states[a].n for a in self._set])

    def _sums(self, alpha, start, n_chunks):
        """(sum, sum of squares) of the mixed differences at ``alpha`` over
        chunks [start, start + n_chunks), float64 on the host."""
        terms = mixed_difference_terms(alpha)
        index_id = self._set.index(alpha)
        dtype = self._dtype

        def delta(idx):
            keys = SampleKeys(self._seed, index_id, idx)
            out = torch.zeros(idx.shape[0], dtype=dtype, device=idx.device)
            for corner, sign in terms:
                out = out + sign * self._fn(corner, keys).to(dtype)
            return out

        home = self._mesh.devices[0]
        acc = torch.zeros(2, dtype=torch.float64, device=home)
        for c in range(start, start + n_chunks):
            d = chunk_rows(self._mesh, self._chunk, c, delta).to(torch.float64)
            acc = acc + torch.stack([d.sum(), (d * d).sum()])
        return acc.cpu().numpy()

    def extend(self, alpha, n_add):
        """Draw ``n_add`` more mixed-difference samples at ``alpha``
        (rounded up to whole chunks), continuing its stream."""
        alpha = tuple(alpha)
        state = self._states[alpha]
        n_chunks = -(-int(n_add) // self._chunk)
        if n_chunks <= 0:
            return
        t0 = time.perf_counter()
        s, s2 = self._sums(alpha, state.n // self._chunk, n_chunks)
        state.elapsed += time.perf_counter() - t0
        if not (np.isfinite(s) and np.isfinite(s2)):
            raise FloatingPointError(
                "index %s produced non-finite values" % (alpha,))
        state.sum += float(s)
        state.sum_sq += float(s2)
        state.n += n_chunks * self._chunk

    # -------------------------------------------------------------- #
    def estimates(self):
        """Per-index (means, variances per sample, counts) arrays aligned
        with ``index_set``."""
        means, pvars, ns = [], [], []
        for a in self._set:
            st = self._states[a]
            n = max(st.n, 1)
            mu = st.sum / n
            means.append(mu)
            pvars.append(max(st.sum_sq / n - mu * mu, 0.0)
                         * (n / max(n - 1, 1)))
            ns.append(st.n)
        return np.array(means), np.array(pvars), np.array(ns)

    def _costs(self):
        if self._cost_fn is not None:
            return np.array([float(self._cost_fn(a)) for a in self._set])
        measured = np.array([self._states[a].elapsed / max(self._states[a].n, 1)
                             for a in self._set])
        if not np.all(measured > 0):
            measured = np.ones(len(self._set))
        return measured

    def boundary_bias_estimate(self):
        """Truncation-bias surrogate: ``sum |E[Delta]|`` over the outer
        boundary of the index set (indices with no successor in the set)."""
        means, _, _ = self.estimates()
        in_set = set(self._set)
        total = 0.0
        for mu, a in zip(means, self._set):
            succs = [tuple(np.add(a, np.eye(self.d, dtype=int)[i]))
                     for i in range(self.d)]
            if not any(s in in_set for s in succs):
                total += abs(mu)
        return float(total)

    def add_index(self, alpha):
        """Grow the index set by one index (downward closure enforced; the
        streams of the indices already in the set stay untouched)."""
        alpha = tuple(int(a) for a in alpha)
        if len(alpha) != self.d or min(alpha) < 0:
            raise ValueError("alpha must be a non-negative %d-tuple"
                             % self.d)
        if alpha in self._states:
            raise ValueError("index %s already in the set" % (alpha,))
        need = {c for c, _ in mixed_difference_terms(alpha)} - {alpha}
        missing = need - set(self._set)
        if missing:
            raise ValueError(
                "adding %s breaks downward closure; missing %s"
                % (alpha, sorted(missing)))
        self._set.append(alpha)
        self._states[alpha] = _IndexState()

    def _allocate_to_target(self, target_var, max_rounds):
        """CLT-optimal allocation over the current index set: extend the
        gaps until ``sum V_alpha / n_alpha <= target_var``."""
        rounds = 0
        while rounds < max_rounds:
            means, pvars, ns = self.estimates()
            est_var = float(np.sum(pvars / np.maximum(ns, 1)))
            if est_var <= target_var:
                break
            costs = self._costs()
            lam = float(np.sum(np.sqrt(pvars * costs))) / target_var
            n_opt = np.maximum(np.ceil(lam * np.sqrt(
                pvars / costs)), 2 * self._chunk)
            gaps = n_opt - ns
            if not np.any(gaps > 0):
                break
            for a, gap in zip(self._set, gaps):
                if gap > 0:
                    self.extend(a, int(gap))
            rounds += 1
        return rounds

    def run(self, target_var, n_init: int = None, max_rounds: int = 30):
        """Adaptive loop: allocate ``n_alpha = sqrt(V/C) * sum sqrt(V C) /
        eps^2`` (at least 2 chunks), extend the gaps, until the estimator
        variance ``sum V_alpha / n_alpha`` meets the target.

        :return: dict with the telescoped mean, estimator variance, the
            per-index breakdown and the boundary bias surrogate
        """
        n_init = int(n_init or 2 * self._chunk)
        for a in self._set:
            if self._states[a].n == 0:
                self.extend(a, n_init)
        rounds = self._allocate_to_target(target_var, max_rounds)
        means, pvars, ns = self.estimates()
        est_var = float(np.sum(pvars / np.maximum(ns, 1)))
        return dict(mean=float(np.sum(means)), var=est_var,
                    index_set=list(self._set), index_means=means,
                    index_vars=pvars, n_samples=ns, rounds=rounds,
                    target_met=bool(est_var <= target_var),
                    boundary_bias=self.boundary_bias_estimate(),
                    total_work=float(np.sum(self._costs() * ns)))

    def run_adaptive(self, target_var, bias_tol: float = None,
                     n_pilot: int = None, max_indices: int = 64,
                     max_rounds: int = 30, profit: str = "bias_per_cost"):
        """Dimension-adaptive MIMC (Robbe, Nuyens & Vandewalle, SIAM J. Sci.
        Comput. 39(5), 2017): pilot-sample the admissible frontier of the
        current set and accept the frontier index of largest profit,
        opening its admissible forward neighbours, until the frontier's
        summed |mean| drops below ``bias_tol``; then allocate to
        ``target_var`` over the final set.

        :param bias_tol: frontier-bias stop (default ``sqrt(target_var)``);
            pilot means are noisy at ~sqrt(V/n_pilot)
        :param max_indices: cap on the index-set size
        :param profit: "bias_per_cost" (``|E_alpha| / C_alpha``) or
            "bias_per_work" (``|E_alpha| / sqrt(V_alpha C_alpha)``)
        :return: the :meth:`run` dict plus ``accepted`` (growth order),
            ``bias_est``, ``bias_tol``, ``bias_converged``
        """
        if profit not in ("bias_per_cost", "bias_per_work"):
            raise ValueError("profit must be 'bias_per_cost' or "
                             "'bias_per_work'")
        bias_tol = float(np.sqrt(target_var) if bias_tol is None
                         else bias_tol)
        n_pilot = int(n_pilot or 2 * self._chunk)
        for a in self._set:
            if self._states[a].n == 0:
                self.extend(a, n_pilot)

        def admissible_neighbors(of):
            s = set(self._set)
            out = []
            for a in of:
                for i in range(self.d):
                    f = tuple(a[j] + (j == i) for j in range(self.d))
                    if f in s or f in out:
                        continue
                    if all(tuple(f[j] - (j == k) for j in range(self.d))
                           in s for k in range(self.d) if f[k] > 0):
                        out.append(f)
            return out

        active = []
        for f in admissible_neighbors(list(self._set)):
            if len(self._set) >= max_indices:
                break
            self.add_index(f)
            self.extend(f, n_pilot)
            active.append(f)
        accepted = []
        bias_converged = False
        while active:
            means, pvars, ns = self.estimates()
            pos = {a: i for i, a in enumerate(self._set)}
            bias = sum(abs(means[pos[a]]) for a in active)
            if bias <= bias_tol:
                bias_converged = True
                break
            if len(self._set) >= max_indices:
                break
            costs = self._costs()

            def score(a):
                i = pos[a]
                if profit == "bias_per_work":
                    return abs(means[i]) / max(
                        np.sqrt(max(pvars[i], 1e-300) * costs[i]), 1e-300)
                return abs(means[i]) / max(costs[i], 1e-300)

            best = max(active, key=score)
            active.remove(best)
            accepted.append(best)
            for f in admissible_neighbors([best]):
                if len(self._set) >= max_indices:
                    break
                self.add_index(f)
                self.extend(f, n_pilot)
                active.append(f)
        out = self.run(target_var, n_init=n_pilot, max_rounds=max_rounds)
        means, _, _ = self.estimates()
        pos = {a: i for i, a in enumerate(self._set)}
        out.update(accepted=accepted,
                   bias_est=float(sum(abs(means[pos[a]]) for a in active)),
                   bias_tol=bias_tol,
                   bias_converged=bias_converged or not active)
        return out


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def _on(cache, array, device, dtype):
    """``array`` (numpy) as a tensor on ``device``, made once per place."""
    key = (str(device), dtype)
    if key not in cache:
        cache[key] = torch.as_tensor(np.asarray(array, np.float64)).to(device, dtype)
    return cache[key]


def _keyed_phases(keys, n_modes, dtype):
    """Uniform phases in [0, 2 pi) of each sample: [C, n_modes]."""
    u = keyed_uniforms(keys.seed, keys.level, keys.indices,
                       torch.zeros_like(keys.indices), n_modes)
    return 2 * np.pi * u.to(dtype)


def synth_mimc_value_fn(mean=1.0, c=0.5, rates=(1.0, 1.5), rho=0.5,
                        noise=1.0, dtype=torch.float64):
    """Synthetic 2-axis model with an exact tensor error expansion:

    ``f_alpha(w) = mean + noise*Z + c (hx^p1 (1 + Ax) + hy^p2 (1 + Ay)
    + rho hx^p1 hy^p2 (1 + Axy))``

    with ``h_i = 2^-alpha_i`` and Z, Ax, Ay, Axy standard normals of the
    sample (its keyed normals). Mixed differences keep only the product
    term for ``alpha > (0, 0)``, so |E[Delta]| and V[Delta] decay at the
    product rate. The exact limit is ``E[f_inf] = mean``.

    :return: (value_fn, d=2) for :class:`MIMC`
    """
    p1, p2 = float(rates[0]), float(rates[1])

    def value_fn(alpha, keys):
        hx, hy = 2.0 ** -alpha[0], 2.0 ** -alpha[1]
        z, ax, ay, axy = keys.normals(4, dtype).unbind(1)
        return (mean + noise * z
                + c * (hx ** p1 * (1 + ax) + hy ** p2 * (1 + ay)
                       + rho * hx ** p1 * hy ** p2 * (1 + axy)))

    return value_fn, 2


def heat_mimc_value_fn(sigma=0.5, corr_length=0.4, n_modes=64, n0=(4, 4),
                       total_time=0.25, seed=0, k_modes=None,
                       dtype=torch.float64):
    """1-D heat equation with random log-normal conductivity over the two
    axes MIMC was built for, space (axis 0) and time step (axis 1):

        ``u_t = (a(x, w) u_x)_x`` on [0, 1], u(0)=u(1)=0,
        ``u(x, 0) = sin(pi x)``,  QoI = mean_x u(x, T).

    Implicit Euler on finite volumes; ``a = exp(sigma g)``, g a 1-D random
    Fourier field with fixed modes and per-sample phases (the sample's
    keyed uniforms), so one identity gives one field at every resolution.
    The step matrix ``I - dt A`` is the same at every time step: each
    sample's dense inverse ``[nx, nx]`` is formed once and each step is one
    batched product. A Thomas sweep would take ``2 nx`` sequential launches
    per step; the inverse takes one, its error is cond * eps (~1e-13 at
    the deepest index of the total-degree-4 set), and its flops are small.

    :param n0: base grid (n_x, n_t) at alpha = (0, 0); axis i refines as
        ``n0_i * 2^alpha_i``
    :param seed: the seed of the mode draw (a host generator)
    :param k_modes: the modes [n_modes] (numpy) in place of the draw, e.g.
        ``convert.mimc_modes_from_jax``'s
    :return: (value_fn, d=2) for :class:`MIMC`; ``value_fn.from_phases(
        alpha, phases [B, n_modes])`` evaluates given phases and
        ``value_fn.k_modes`` holds the modes
    """
    if k_modes is None:
        gen = torch.Generator().manual_seed(int(seed))
        k_modes = (torch.randn(n_modes, generator=gen, dtype=torch.float64)
                   * (np.sqrt(2.0) / corr_length)).numpy()
    k_modes = np.asarray(k_modes, np.float64)
    n_modes = k_modes.shape[0]
    cache = {}

    def from_phases(alpha, phases):
        device, dt_ = phases.device, phases.dtype
        nx = int(n0[0]) << alpha[0]
        nt = int(n0[1]) << alpha[1]
        dt = total_time / nt
        h = 1.0 / nx
        centers = (torch.arange(nx, device=device, dtype=dt_) + 0.5) * h
        tk = centers[:, None] * _on(cache, k_modes, device, dt_)[None, :]
        g = np.sqrt(2.0 / n_modes) * torch.cos(
            tk[None, :, :] + phases[:, None, :]).sum(-1)        # [B, nx]
        a = torch.exp(sigma * g)
        # interior face conductivities (harmonic) + Dirichlet halves
        af = 2.0 * a[:, :-1] * a[:, 1:] / (a[:, :-1] + a[:, 1:])  # [B, nx-1]
        r = dt / (h * h)
        zero = torch.zeros_like(a[:, :1])
        ends = torch.zeros_like(a)
        ends[:, 0] += 2.0 * a[:, 0]
        ends[:, -1] += 2.0 * a[:, -1]
        mid = 1.0 + r * (torch.cat([af, zero], 1) + torch.cat([zero, af], 1) + ends)
        step = (torch.diag_embed(mid) + torch.diag_embed(-r * af, 1)
                + torch.diag_embed(-r * af, -1))
        inv = torch.linalg.inv(step)                             # [B, nx, nx]
        u = torch.sin(np.pi * centers).expand(a.shape[0], nx)
        for _ in range(nt):
            u = (inv * u[:, None, :]).sum(-1)
        return u.mean(-1)

    def value_fn(alpha, keys):
        return from_phases(alpha, _keyed_phases(keys, n_modes, dtype))

    value_fn.from_phases = from_phases
    value_fn.k_modes = k_modes
    return value_fn, 2


def darcy_mimc_value_fn(sigma=1.0, corr_length=0.3, n_modes=128,
                        n0=(4, 4), model="gauss", seed=0, cg_tol=1e-10,
                        wave_vectors=None, dtype=torch.float64):
    """MIMC on the 2-D Darcy problem with anisotropic refinement: axis 0
    refines the x resolution, axis 1 the y resolution,

        ``-div(K grad u) = 1`` on the unit square, u = 0 on the
        boundary, ``K = exp(sigma g)``, QoI = mean_x u.

    The log-normal random-Fourier conductivity sits at the cell centers of
    the ``(n0_x 2^a0) x (n0_y 2^a1)`` grid (fixed wave vectors, per-sample
    phases: the MIMC coupling); the field is two ``[nx, M] @ [B, M, ny]``
    products (cos(x.k) and sin(x.k) against the phase-shifted y parts).
    The 5-point finite-volume operator takes harmonic-mean faces and
    half-cell Dirichlet faces, and Jacobi-preconditioned CG
    (``sim.diffusion.preconditioned_cg``) solves every sample of the batch,
    each stopping on its own at ``|r| <= cg_tol |b|`` (JAX's rule with
    atol = 0) or at ``20 max(nx, ny)`` iterations.

    ``cg_tol`` must sit far below the mixed-difference magnitudes (~1e-4
    and falling at the product rate): the default 1e-10 needs float64.

    :param seed: the seed of the wave-vector draw (a host generator)
    :param wave_vectors: the wave vectors [n_modes, 2] (numpy) in place of
        the draw, e.g. ``convert.mimc_modes_from_jax``'s
    :return: (value_fn, d=2) for :class:`MIMC`; ``value_fn.from_phases`` and
        ``value_fn.wave_vectors`` as in :func:`heat_mimc_value_fn`
    """
    if wave_vectors is None:
        wave_vectors = _wave_vectors_2d(model, corr_length, n_modes, seed=seed).numpy()
    kvec = np.asarray(wave_vectors, np.float64)
    n_modes = kvec.shape[0]
    amp = np.sqrt(2.0 / n_modes)
    cache = {}

    def from_phases(alpha, phases):
        device, dt_ = phases.device, phases.dtype
        nx = int(n0[0]) << alpha[0]
        ny = int(n0[1]) << alpha[1]
        hx, hy = 1.0 / nx, 1.0 / ny
        kv = _on(cache, kvec, device, dt_)
        xc = (torch.arange(nx, device=device, dtype=dt_) + 0.5) * hx
        yc = (torch.arange(ny, device=device, dtype=dt_) + 0.5) * hy
        tkx = xc[:, None] * kv[None, :, 0]                       # [nx, M]
        tky = yc[:, None] * kv[None, :, 1]                       # [ny, M]
        # cos(x.k + y.k + phi) = cos(x.k) cos(y.k + phi) - sin(x.k) sin(y.k + phi)
        yphi = tky[None, :, :] + phases[:, None, :]              # [B, ny, M]
        g = amp * (torch.matmul(torch.cos(tkx), torch.cos(yphi).transpose(1, 2))
                   - torch.matmul(torch.sin(tkx), torch.sin(yphi).transpose(1, 2)))
        K = torch.exp(sigma * g)                                 # [B, nx, ny]
        ax_i = 2.0 * K[:, :-1] * K[:, 1:] / (K[:, :-1] + K[:, 1:])
        ay_i = 2.0 * K[:, :, :-1] * K[:, :, 1:] / (K[:, :, :-1] + K[:, :, 1:])
        aW = torch.cat([2.0 * K[:, :1], ax_i], 1)
        aE = torch.cat([ax_i, 2.0 * K[:, -1:]], 1)
        aS = torch.cat([2.0 * K[:, :, :1], ay_i], 2)
        aN = torch.cat([ay_i, 2.0 * K[:, :, -1:]], 2)
        rx, ry = 1.0 / (hx * hx), 1.0 / (hy * hy)
        diag = rx * (aW + aE) + ry * (aS + aN)
        zx = torch.zeros_like(K[:, :1])
        zy = torch.zeros_like(K[:, :, :1])

        def op(u):
            uW = torch.cat([zx, u[:, :-1]], 1)
            uE = torch.cat([u[:, 1:], zx], 1)
            uS = torch.cat([zy, u[:, :, :-1]], 2)
            uN = torch.cat([u[:, :, 1:], zy], 2)
            return (diag * u - rx * (aW * uW + aE * uE)
                    - ry * (aS * uS + aN * uN))

        u, _ = preconditioned_cg(op, lambda r: r / diag, torch.ones_like(K),
                                 cg_tol, 20 * max(nx, ny))
        return u.mean((1, 2))

    def value_fn(alpha, keys):
        return from_phases(alpha, _keyed_phases(keys, n_modes, dtype))

    value_fn.from_phases = from_phases
    value_fn.wave_vectors = kvec
    return value_fn, 2
