"""Estimation over stored samples and sample allocation (counterpart of
``mlmc_tpu/estimator.py``).

``Estimate`` wraps (quantity, sample storage, moment basis):

* the generic tier: ``estimate_moments`` / ``estimate_covariance`` /
  ``estimate_diff_vars`` through ``quantity_estimate.estimate_mean``;
* the fast tier: every (component, level) stream of the quantity is
  evaluated on the device, packed, and reduced by ONE launch of kernel C
  (``ops/cuda_kernels.samples_moments``): ``estimate_moments_fast``,
  ``estimate_covariance_fast``, ``estimate_diff_vars_fast`` and
  ``construct_density_fast``;
* the f64 tier: the same streams through kernel D
  (``ops/cuda_extended``): ``estimate_moments_extended`` and
  ``estimate_covariance_extended``;
* the log-quadratic variance regression, the maxent density and the
  domain estimate.

Numbers come back to the host as numpy arrays, as in ``mlmc_tpu``. The
bootstrap and the plot helpers are not ported yet.
"""
import numpy as np
import torch

import mlmc_tpu_torch.quantity.quantity_estimate as qe
from mlmc_tpu_torch.ops import cuda_extended as cx
from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.quantity.quantity import as_tensor
from mlmc_tpu_torch.quantity.quantity_types import ScalarType


class Estimate:
    """Wrapper over (quantity, sample_storage, moments_fn). Work runs on
    the device of the quantity's root (``make_root_quantity``)."""

    def __init__(self, quantity, sample_storage, moments_fn=None):
        self._quantity, self._moments_fn = quantity, moments_fn
        self._sample_storage = sample_storage

    quantity = property(
        lambda self: self._quantity,
        lambda self, q: setattr(self, "_quantity", q))

    n_moments = property(lambda self: self._moments_fn.size)

    @property
    def device(self):
        """Device of the quantity's root: where the estimation runs."""
        return self._quantity.get_quantity_storage().device

    def _resolve_moments(self, moments_fn):
        """Explicit argument wins over the instance default."""
        return self._moments_fn if moments_fn is None else moments_fn

    def _n_components(self):
        """(is scalar, flat component count M) of the quantity."""
        scalar = isinstance(self._quantity.qtype, ScalarType)
        return scalar, 1 if scalar else self._quantity.qtype.size()

    def estimate_moments(self, moments_fn=None):
        """:return: (moment means, variances of those estimates)"""
        moments_fn = self._resolve_moments(moments_fn)
        moments_mean = qe.estimate_mean(qe.moments(self._quantity, moments_fn))
        return moments_mean.mean, moments_mean.var

    def estimate_covariance(self, moments_fn=None):
        """:return: (covariance matrix mean, variance of the estimate)"""
        moments_fn = self._resolve_moments(moments_fn)
        cov_mean = qe.estimate_mean(qe.covariance(self._quantity, moments_fn))
        return cov_mean.mean, cov_mean.var

    #: Moments classes the kernels evaluate by recurrence
    _FAST_BASES = {"Legendre": "legendre", "Monomial": "monomial",
                   "Fourier": "fourier"}

    def _fast_basis(self, moments_fn):
        """Kernel basis name for a moments object, or raise
        NotImplementedError: the fast tiers must never evaluate a
        different basis than the one passed in."""
        basis = self._FAST_BASES.get(type(moments_fn).__name__)
        if basis is None:
            raise NotImplementedError(
                "fast path has no kernel for %s; use estimate_moments"
                % type(moments_fn).__name__)
        if getattr(moments_fn, "_is_log", False):
            raise NotImplementedError(
                "fast path does not implement log-transformed moments; "
                "use estimate_moments")
        if not getattr(moments_fn, "_is_clip", True):
            raise NotImplementedError(
                "fast path always drops out-of-domain samples (kernel "
                "validity masking); a safe_eval=False basis would KEEP "
                "them in estimate_moments — use that path instead")
        return basis

    def _gather_level_qoi(self):
        """Each known level's quantity values [M, N, 1|2] as tensors on the
        estimation device.

        A traceable DAG runs once over each level's stored payload (no
        per-chunk memo, so nothing outlives the call); other DAGs go
        through the chunked ``Quantity.samples`` path.
        """
        storage = self._sample_storage
        n_levels = storage.get_n_levels()
        root = self._quantity.get_quantity_storage()
        by_id = {}
        if self._quantity.traceable():
            dag_eval = self._quantity.build_eval()
            leaves, n_trues, lids = qe._gather_raw_leaves(root)
            for leaf, n, lid in zip(leaves, n_trues, lids):
                by_id[lid] = as_tensor(dag_eval(
                    qe._normalize_leaf(leaf[:n], lid == 0)))
        level_qoi = []
        for lid in range(n_levels):
            if lid not in by_id:
                by_id[lid] = torch.cat(
                    [as_tensor(self._quantity.samples(cs))
                     for cs in storage.chunks(level_id=lid)], dim=1)
            level_qoi.append(by_id[lid].to(root.device))
        qe.cache_clear()
        return level_qoi

    @staticmethod
    def _harmonize_validity(y, components, moments_fn):
        """Structured parity with the generic tier: a sample is valid only
        if EVERY requested component (fine and coarse slot) is valid —
        poison the whole sample so every packed stream reports the same
        n_valid.

        Validity is judged exactly as kernel C judges it: on the f32 values
        through ``t = (x - a) * scale + ref_lo`` with the f32 constants of
        ``cuda_kernels.transform_constants``, one rounding per operation.

        :param y: one level's values [M, N, C] (tensor)
        :return: y with poisoned samples set to NaN
        """
        scale, shift, offset, lo, hi = ck.transform_constants(
            moments_fn.domain, moments_fn.ref_domain)
        sel = y[list(components)].to(torch.float32)
        t = (sel - shift) * scale + offset
        ok = (t >= lo) & (t <= hi)                        # NaN -> not ok
        bad = ~ok.all(dim=2).all(dim=0)
        return torch.where(bad[None, :, None],
                           torch.full_like(y, float("nan")), y)

    def _packed_streams(self, moments_fn, components):
        """Every (component, level) stream of the quantity, component-major,
        packed for kernels C and D on the estimation device."""
        level_qoi = self._gather_level_qoi()
        if len(components) > 1:
            level_qoi = [self._harmonize_validity(q, components, moments_fn)
                         for q in level_qoi]
        fine, coarse, hasc = [], [], []
        for m in components:
            for lvl, q in enumerate(level_qoi):
                fine.append(q[m, :, 0])
                coarse.append(q[m, :, 1] if q.shape[2] > 1 else None)
                hasc.append(lvl > 0)
        return ck.pack_streams(fine, coarse, hasc)

    @staticmethod
    def _split(results, components, n_levels):
        return {m: results[i * n_levels:(i + 1) * n_levels]
                for i, m in enumerate(components)}

    def _fast_results_packed(self, moments_fn, components):
        """Kernel C accumulators for MANY QoI components in ONE launch: the
        DAG is evaluated, harmonized and packed on the device, then every
        (component, level) stream is reduced together.

        :return: {component: [SynthMomentResult (numpy) per level]}
        """
        basis = self._fast_basis(moments_fn)
        streams = self._packed_streams(moments_fn, components)
        out = ck.samples_moments(
            streams, moments_fn.size, domain=tuple(moments_fn.domain),
            ref_domain=tuple(float(v) for v in moments_fn.ref_domain),
            basis=basis)
        host = [f.cpu().numpy() for f in out]  # one fetch per field
        flat = [ck.SynthMomentResult(*(f[s] for f in host))
                for s in range(len(streams.counts))]
        return self._split(flat, components, self._sample_storage.get_n_levels())

    def estimate_covariance_fast(self, moments_fn=None):
        """Fast-tier telescoped moment covariance from one kernel C launch.

        Scalar quantities return ``([R, R], [R])`` (covariance, means);
        structured quantities per-component blocks ``([M, R, R], [M, R])``.
        """
        moments_fn = self._resolve_moments(moments_fn)
        scalar, M = self._n_components()
        R = moments_fn.size
        packed = self._fast_results_packed(moments_fn, list(range(M)))
        cov = np.zeros((M, R, R))
        mean = np.zeros((M, R))
        for m in range(M):
            for lvl, r in enumerate(packed[m]):
                n = max(float(r.n_valid), 1.0)
                cf = np.asarray(r.cov_fine, dtype=np.float64) / n
                cc = np.asarray(r.cov_coarse, dtype=np.float64) / n
                cov[m] += cf - cc if lvl > 0 else cf
                mean[m] += np.asarray(r.sums, dtype=np.float64) / n
        if scalar:
            return cov[0], mean[0]
        return cov, mean

    def _density(self, cov, mean, tol, reg_param, orth_moments_tol):
        """Maxent density from a moment covariance and means: orthogonalize
        the basis, rotate the means, Newton solve on the estimation
        device."""
        import mlmc_tpu_torch.tool.simple_distribution as sd

        moments_obj, info = sd.construct_ortogonal_moments(
            self._moments_fn, cov, tol=orth_moments_tol)
        mu = info[2] @ mean
        moments_data = np.stack((mu[:moments_obj.size],
                                 np.ones(moments_obj.size)), axis=1)
        distr_obj = sd.SimpleDistribution(moments_obj, moments_data,
                                          domain=moments_obj.domain,
                                          device=self.device)
        result = distr_obj.estimate_density_minimize(tol, reg_param)
        return distr_obj, info, result, moments_obj

    def construct_density_fast(self, tol=1e-8, reg_param=0.0,
                               orth_moments_tol=1e-4):
        """Maxent density from STORED samples on the fast tier: one kernel C
        launch gives the moment means and covariance; the orthogonalized
        means follow linearly (mu_orth = L @ mu)."""
        cov, mean = self.estimate_covariance_fast(self._moments_fn)
        return self._density(cov, mean, tol, reg_param, orth_moments_tol)

    def estimate_moments_fast(self, moments_fn=None):
        """Fast tier: moment means/vars of every component from one kernel
        C launch (Legendre/Monomial/Fourier; anything else raises).

        :return: (moment means [R] or [M, R], estimator variances same shape)
        """
        moments_fn = self._resolve_moments(moments_fn)
        self._fast_basis(moments_fn)  # fail fast before the gather
        scalar, M = self._n_components()
        R = moments_fn.size
        n_levels = self._sample_storage.get_n_levels()
        sums = np.zeros((n_levels, M, R))
        sums2 = np.zeros((n_levels, M, R))
        n_valid = np.zeros((n_levels, M))
        packed = self._fast_results_packed(moments_fn, list(range(M)))
        for m in range(M):
            for lvl, r in enumerate(packed[m]):
                sums[lvl, m] = r.sums
                sums2[lvl, m] = r.sums2
                n_valid[lvl, m] = float(r.n_valid)

        n = n_valid[:, :, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            l_means = np.where(n > 0, sums / np.maximum(n, 1), 0.0)
            l_vars = np.where(
                n > 1,
                (sums2 - sums * sums / np.maximum(n, 1)) / np.maximum(n - 1, 1),
                np.inf)
        mean = l_means.sum(axis=0)
        var = (l_vars / np.maximum(n, 1)).sum(axis=0)
        if scalar:
            return mean[0], var[0]
        return mean, var

    def _extended_results(self, moments_fn, components):
        """Per-(component, level) ExtendedMomentResult from ONE kernel D
        launch over every stream.

        :return: {component: [ExtendedMomentResult per level]}
        """
        basis = self._fast_basis(moments_fn)
        streams = self._packed_streams(moments_fn, components)
        out = cx.samples_ext_moments(
            streams, moments_fn.size, domain=tuple(moments_fn.domain),
            ref_domain=tuple(float(v) for v in moments_fn.ref_domain),
            basis=basis)
        flat = [cx.to_host(out, s) for s in range(len(streams.counts))]
        return self._split(flat, components, self._sample_storage.get_n_levels())

    def estimate_moments_extended(self, moments_fn=None):
        """f64-tier moment means/vars (kernel D) on the stored f32 samples;
        shapes match estimate_moments_fast.

        :return: (moment means [R] or [M, R], estimator variances)
        """
        moments_fn = self._resolve_moments(moments_fn)
        scalar, M = self._n_components()
        R = moments_fn.size
        results = self._extended_results(moments_fn, list(range(M)))
        mean = np.zeros((M, R))
        var = np.zeros((M, R))
        for m in range(M):
            for r in results[m]:
                n = max(float(r.n_valid), 1.0)
                mean[m] += r.sums / n
                if r.n_valid > 1:
                    var[m] += (r.sums2 - r.sums * r.sums / n) / (n - 1) / n
                else:
                    var[m] = np.inf
        if scalar:
            return mean[0], var[0]
        return mean, var

    def estimate_covariance_extended(self, moments_fn=None):
        """f64-tier telescoped moment covariance (+ means); shapes match
        estimate_covariance_fast."""
        moments_fn = self._resolve_moments(moments_fn)
        scalar, M = self._n_components()
        R = moments_fn.size
        results = self._extended_results(moments_fn, list(range(M)))
        cov = np.zeros((M, R, R))
        mean = np.zeros((M, R))
        for m in range(M):
            for lvl, r in enumerate(results[m]):
                n = max(float(r.n_valid), 1.0)
                cov[m] += (r.cov_fine - r.cov_coarse if lvl > 0
                           else r.cov_fine) / n
                mean[m] += r.sums / n
        if scalar:
            return cov[0], mean[0]
        return cov, mean

    def estimate_diff_vars(self, moments_fn=None):
        """:return: (level diff variances [L, R], n_samples [L])"""
        moments_fn = self._resolve_moments(moments_fn)
        moments_mean = qe.estimate_mean(qe.moments(self._quantity, moments_fn))
        return moments_mean.l_vars, moments_mean.n_samples

    def estimate_diff_vars_fast(self, moments_fn=None):
        """Fast-tier level diff variances from ONE kernel C launch; feeds
        the adaptive loop (pass the result as ``raw_vars`` to
        ``estimate_diff_vars_regression``). Shapes match
        estimate_diff_vars ([L, R] scalar / [L, M*R] structured).

        :return: (level diff variances, n_samples [L])
        """
        moments_fn = self._resolve_moments(moments_fn)
        scalar, M = self._n_components()
        R = moments_fn.size
        L = self._sample_storage.get_n_levels()
        packed = self._fast_results_packed(moments_fn, list(range(M)))
        l_vars = np.full((L, M, R), np.inf)
        ns = np.zeros(L, dtype=int)
        for m in range(M):
            for lvl, r in enumerate(packed[m]):
                n = float(r.n_valid)
                # every component reports the same count: structured
                # streams share any-component validity
                ns[lvl] = int(n)
                if n > 1:
                    s = np.asarray(r.sums, dtype=np.float64)
                    s2 = np.asarray(r.sums2, dtype=np.float64)
                    l_vars[lvl, m] = (s2 - s * s / n) / (n - 1)
        return (l_vars[:, 0, :] if scalar else l_vars.reshape(L, M * R)), ns

    def estimate_diff_vars_regression(self, n_created_samples, moments_fn=None, raw_vars=None):
        """Smooth level variances by the log-quadratic regression model."""
        self._n_created_samples = n_created_samples
        if raw_vars is None:
            raw_vars, n_samples = self.estimate_diff_vars(
                self._resolve_moments(moments_fn))
        sim_steps = np.squeeze(np.asarray(self._sample_storage.get_level_parameters()))
        vars = self._all_moments_variance_regression(raw_vars, sim_steps)
        return vars, self._sample_storage.get_n_ops()

    def _all_moments_variance_regression(self, raw_vars, sim_steps):
        """Regress each moment column; structured quantities ([L, ..., R])
        are flattened to [L, n_cols]. Zeroth-moment columns are exactly
        zero-variance and pass through untouched."""
        raw = np.asarray(raw_vars, dtype=float)
        flat = raw.reshape(raw.shape[0], -1)
        reg_vars = flat.copy()
        for m in range(flat.shape[1]):
            col = flat[:, m]
            finite = np.isfinite(col)
            if np.allclose(col[finite], 0.0):
                # identically-zero column (e.g. moment 0): an inf slot
                # only means "level not measured yet" — it is still zero
                reg_vars[:, m] = np.where(finite, col, 0.0)
                continue
            reg_vars[:, m] = self._moment_variance_regression(col, sim_steps)
        return reg_vars

    @staticmethod
    def _moment_variance_regression(raw_vars, sim_steps):
        """log var_l = A + B log h_l + C log² h_l  for l = 1..L-1.

        Level 0 is left untouched (no coarse diff there).
        """
        raw_vars = np.asarray(raw_vars, dtype=float)
        L = raw_vars.shape[0]
        L1 = L - 1
        if L < 3 or np.allclose(raw_vars, 0):
            return raw_vars

        K = 3
        X = np.zeros((L1, K))
        log_step = np.log(np.atleast_1d(sim_steps)[1:])
        X[:, 0] = 1.0
        X[:, 1] = log_step
        X[:, 2] = log_step ** 2

        # a deep level's tiny variance can cancel to zero or slightly
        # negative, and a level with n_valid <= 1 reports inf: fit only the
        # finite positive entries, predict everywhere
        pos = np.isfinite(raw_vars[1:]) & (raw_vars[1:] > 0)
        if pos.sum() < K:
            return raw_vars
        log_vars = np.log(raw_vars[1:][pos])
        params, *_ = np.linalg.lstsq(X[pos], log_vars, rcond=None)
        new_vars = raw_vars.copy()
        new_vars[1:] = np.exp(np.dot(X, params))
        return new_vars

    @staticmethod
    def estimate_domain(quantity, sample_storage, quantile=None):
        """Moment domain = union of every level's fine-sample quantile
        range; NaN results are ignored."""
        q = 0.01 if quantile is None else float(quantile)
        lo, hi = np.inf, -np.inf
        for level_id in range(sample_storage.get_n_levels()):
            n = int(sample_storage.get_n_collected()[level_id])
            spec = next(sample_storage.chunks(level_id=level_id,
                                              n_samples=n))
            fine = as_tensor(quantity.samples(spec))[..., 0].reshape(-1)
            fine = fine[torch.isfinite(fine)].cpu().numpy()
            if fine.size == 0:
                continue  # an all-NaN level contributes nothing
            a, b = np.quantile(fine, [q, 1.0 - q])
            lo, hi = min(lo, a), max(hi, b)
        if not (np.isfinite(lo) and np.isfinite(hi)):
            raise ValueError(
                "estimate_domain: no finite sample values in any level")
        return float(lo), float(hi)

    def construct_density(self, tol=1e-8, reg_param=0.0, orth_moments_tol=1e-4, exact_pdf=None):
        """Maximum-entropy density from orthogonalized moments (generic
        tier: the covariance, then the orthogonal moments' means)."""
        import mlmc_tpu_torch.tool.simple_distribution as sd

        if not isinstance(self._quantity.qtype, ScalarType):
            raise NotImplementedError("construct_density supports ScalarType quantities only")

        cov_mean = qe.estimate_mean(qe.covariance(self._quantity, self._moments_fn))
        moments_obj, info = sd.construct_ortogonal_moments(
            self._moments_fn, cov_mean.mean, tol=orth_moments_tol)
        moments_mean = qe.estimate_mean(qe.moments(self._quantity, moments_obj))
        moments_data = np.stack((moments_mean.mean, np.ones(moments_obj.size)), axis=1)
        distr_obj = sd.SimpleDistribution(moments_obj, moments_data,
                                          domain=moments_obj.domain,
                                          device=self.device)
        result = distr_obj.estimate_density_minimize(tol, reg_param)
        return distr_obj, info, result, moments_obj

    def get_level_samples(self, level_id, n_samples=None):
        """Level chunk through the quantity: [M, N, 1|2]."""
        if n_samples is not None:
            n_samples = int(n_samples)
        chunk_spec = next(self._sample_storage.chunks(level_id=level_id, n_samples=n_samples))
        return self._quantity.samples(chunk_spec=chunk_spec)


def estimate_domain(quantity, sample_storage, quantile=None):
    """Module-level alias of Estimate.estimate_domain."""
    return Estimate.estimate_domain(quantity, sample_storage, quantile)



def estimate_n_samples_for_target_variance(target_variance, prescribe_vars, n_ops, n_levels):
    """Variance-optimal level allocation n_l ∝ sqrt(V_l / C_l).

    :param prescribe_vars: [L, R] level variances per moment
    :param n_ops: per-level cost C_l
    :return: [L] optimal sample counts (max over moments)
    """
    vars = np.asarray(prescribe_vars, dtype=float)
    n_ops = np.asarray(n_ops, dtype=float)
    sqrt_var_n = np.sqrt(vars.T * n_ops)  # moments in rows, levels in cols
    total = np.sum(sqrt_var_n, axis=1)
    n_samples_estimate = np.round((sqrt_var_n / n_ops).T * total / target_variance).astype(int)
    n_samples_estimate_safe = np.maximum(
        np.minimum(n_samples_estimate, vars * n_levels / target_variance), 2
    )
    return np.max(n_samples_estimate_safe, axis=1).astype(int)


def calc_level_params(step_range, n_levels):
    """Geometric ladder of simulation steps from coarsest to finest.
    A single level runs at the finest step."""
    coarse, fine = step_range
    assert coarse > fine
    if n_levels == 1:
        return [[float(fine)]]
    return [[float(s)] for s in np.geomspace(coarse, fine, n_levels)]


def determine_level_parameters(n_levels, step_range):
    """Geometric interpolation of simulation steps."""
    return calc_level_params(step_range, n_levels)


def determine_n_samples(n_levels, n_samples=None):
    """Per-level target counts: an explicit full vector passes through, a
    [n0] or [n0, nL] prescription expands geometrically (nL defaults to 3)."""
    spec = [100, 3] if n_samples is None else list(np.atleast_1d(n_samples))
    if len(spec) == 1:
        spec.append(3)
    if len(spec) > 2:
        return np.asarray(spec, dtype=int)
    return np.rint(np.geomspace(spec[0], spec[1], n_levels)).astype(int)
