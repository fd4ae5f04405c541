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
* the f64 tier: the same streams through kernel D (``samples_moments``
  with ``f64``): ``estimate_moments_extended`` and
  ``estimate_covariance_extended``. Both tiers fetch the stacked result
  once per field and telescope it by ``ops/fused_estimate.telescope``;
* the log-quadratic variance regression, the maxent density and the
  domain estimate.

* the bootstrap (``est_bootstrap``, ``est_bootstrap_fast``): every
  replicate of a level is a row of a weight matrix ``W [B, N]`` over the
  level's samples (0/1 rows without replacement, counts with replacement,
  Poisson weights), and the replicate statistics are the two products
  ``W @ dphi`` and ``W @ dphi^2`` in f64 on the estimation device;
* the convergence-rate fit and the Richardson extrapolation.

Numbers come back to the host as numpy arrays, as in ``mlmc_tpu``. The
plot helpers (``plot_variances``, ``plot_bs_var_log``,
``fine_coarse_violinplot``) draw with ``plot/`` on the host.
"""
import hashlib

import numpy as np
import torch

import mlmc_tpu_torch.quantity.quantity_estimate as qe
from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.ops import fused_estimate as fe
from mlmc_tpu_torch.quantity.quantity import as_tensor
from mlmc_tpu_torch.quantity.quantity_types import ScalarType
from mlmc_tpu_torch.tool import profiling


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

    def _resolve_moments(self, moments_fn, remember=False):
        """Explicit argument wins over the instance default; ``remember``
        additionally re-binds the instance default (bootstrap semantics)."""
        if moments_fn is None:
            return self._moments_fn
        if remember:
            self._moments_fn = moments_fn
        return moments_fn

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
        with profiling.span("estimate.gather"):
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
        profiling.count("estimate.packs")
        level_qoi = self._gather_level_qoi()
        with profiling.span("estimate.pack"):
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

    def _stream_results(self, moments_fn, components, f64=False):
        """Accumulators of every (component, level) stream from ONE launch
        of kernel C (the fast tier) or, with ``f64``, kernel D (the f64
        tier): the DAG is evaluated, harmonized and packed on the device,
        every stream reduced together, and the stacked result fetched once
        per field.

        :return: SynthMomentResult of host arrays [L, len(components), ...]
        """
        basis = self._fast_basis(moments_fn)
        streams = self._packed_streams(moments_fn, components)
        with profiling.span("estimate.launch"):
            out = ck.samples_moments(
                streams, moments_fn.size, domain=tuple(moments_fn.domain),
                ref_domain=tuple(float(v) for v in moments_fn.ref_domain),
                basis=basis, f64=f64)
        with profiling.span("estimate.fetch"):
            host = [f.cpu().numpy() for f in out]  # one fetch per field
        # the streams are component-major
        shape = (len(components), self._sample_storage.get_n_levels())
        return ck.SynthMomentResult(*(f.reshape(shape + f.shape[1:]).swapaxes(0, 1)
                                      for f in host))

    def _telescoped(self, moments_fn, f64=False):
        """``fused_estimate.telescope`` of every component of the quantity
        from one launch of kernel C or (``f64``) D; the entries of a
        structured quantity carry a component axis after the level axis."""
        moments_fn = self._resolve_moments(moments_fn)
        scalar, M = self._n_components()
        acc = self._stream_results(moments_fn, list(range(M)), f64)
        return fe.telescope(*(f[:, 0] if scalar else f for f in acc))

    def estimate_covariance_fast(self, moments_fn=None):
        """Fast-tier telescoped moment covariance from one kernel C launch.

        Scalar quantities return ``([R, R], [R])`` (covariance, means);
        structured quantities per-component blocks ``([M, R, R], [M, R])``.
        """
        est = self._telescoped(moments_fn)
        return est["cov"], est["mean"]

    def construct_density_fast(self, tol=1e-8, reg_param=0.0,
                               orth_moments_tol=1e-4):
        """Maxent density from STORED samples on the fast tier: one kernel C
        launch gives the moment means and covariance; the orthogonalized
        means follow linearly (mu_orth = L @ mu)."""
        import mlmc_tpu_torch.tool.simple_distribution as sd

        cov, mean = self.estimate_covariance_fast(self._moments_fn)
        return sd.density_from_moments(
            self._moments_fn, cov, mean, tol=tol, reg_param=reg_param,
            orth_moments_tol=orth_moments_tol, device=self.device)

    def estimate_moments_fast(self, moments_fn=None):
        """Fast tier: moment means/vars of every component from one kernel
        C launch (Legendre/Monomial/Fourier; anything else raises).

        :return: (moment means [R] or [M, R], estimator variances same shape)
        """
        est = self._telescoped(moments_fn)
        return est["mean"], est["var"]

    def estimate_moments_extended(self, moments_fn=None):
        """f64-tier moment means/vars (kernel D) on the stored f32 samples;
        shapes match estimate_moments_fast.

        :return: (moment means [R] or [M, R], estimator variances)
        """
        est = self._telescoped(moments_fn, f64=True)
        return est["mean"], est["var"]

    def estimate_covariance_extended(self, moments_fn=None):
        """f64-tier telescoped moment covariance (+ means); shapes match
        estimate_covariance_fast."""
        est = self._telescoped(moments_fn, f64=True)
        return est["cov"], est["mean"]

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
        est = self._telescoped(moments_fn)
        L = est["l_vars"].shape[0]
        # every component reports the same count: structured streams share
        # any-component validity
        return (est["l_vars"].reshape(L, -1),
                est["n_samples"].reshape(L, -1)[:, 0].astype(int))

    def estimate_diff_vars_regression(self, n_created_samples, moments_fn=None, raw_vars=None):
        """Smooth level variances by the log-quadratic regression model."""
        self._n_created_samples = n_created_samples
        if raw_vars is None:
            raw_vars, n_samples = self.estimate_diff_vars(
                self._resolve_moments(moments_fn))
        with profiling.span("estimate.host"):
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

    def _variance_of_variance(self, n_samples=None):
        """Variance of the LOG of a chi²_{n-1}-distributed variance
        estimate, in closed form.

        A sample variance from n draws is sigma²/(n-1) x chi²_{n-1}; for
        X ~ chi²_d = Gamma(d/2, 2) the log has Var[log X] = psi_1(d/2)
        (trigamma).
        """
        from scipy.special import polygamma

        if n_samples is None:
            n_samples = self._n_created_samples
        df = np.maximum(np.asarray(n_samples, dtype=float) - 1.0, 1.0)
        return polygamma(1, df / 2.0)

    # ------------------------------------------------------------------ #
    # bootstrap
    # ------------------------------------------------------------------ #
    #: byte budget of one block of replicates (its uniforms, its weights
    #: and their temporaries, all [block, N])
    BOOTSTRAP_BLOCK_BYTES = 1 << 29

    def est_bootstrap(self, n_subsamples=100, sample_vector=None,
                      moments_fn=None, regression=False, log=False):
        """Bootstrap means/vars by repeated level subsampling: the
        without-replacement scheme of ``est_bootstrap_fast``, which draws
        the level subsamples that the streaming hypergeometric
        ``Quantity.subsample`` produces."""
        self.est_bootstrap_fast(n_subsamples=n_subsamples,
                                sample_vector=sample_vector,
                                moments_fn=moments_fn,
                                regression=regression, log=log)

    @staticmethod
    def _replicate_generator(generator, seed, level_id, replicate):
        """Seed ``generator`` for one replicate: its stream is a function
        of (seed, level id, replicate index) alone, so a replicate does not
        change with the blocking of the replicates."""
        digest = hashlib.blake2b(
            ("%d/%d/%d" % (int(seed), int(level_id), int(replicate))).encode(),
            digest_size=8).digest()
        return generator.manual_seed(int.from_bytes(digest, "little") >> 1)

    @staticmethod
    def _poisson_cdf(lam):
        """The 12 thresholds of the inverse-CDF Poisson(lam) draw truncated
        at w = 12 (lam <= 1, so the cut is exact to ~1e-12): the weight of
        a uniform u is the number of thresholds below it."""
        from scipy.special import gammaln

        ks = np.arange(13, dtype=np.float64)
        logpmf = -lam + ks * np.log(max(lam, 1e-30)) - gammaln(ks + 1.0)
        return np.cumsum(np.exp(logpmf))[:12]

    @staticmethod
    def _weights_poisson(u, valid, cdf):
        """Poisson weights [B, N] of uniforms ``u`` [B, N]: the count of
        ``cdf`` thresholds strictly below u; invalid samples weigh 0."""
        w = torch.bucketize(u, cdf, right=False).to(u.dtype)
        return w * valid.to(u.dtype)

    @staticmethod
    def _weights_from_indices(idx, n):
        """Pick counts [B, N] of index rows ``idx`` [B, n_sub] (with or
        without repeats)."""
        w = torch.zeros(idx.shape[0], int(n), dtype=torch.float64, device=idx.device)
        return w.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.float64))

    @staticmethod
    def _replicate_stats(w, flat, n_r):
        """Replicate means and variances from weights: with
        ``s = W @ dphi`` and ``sp = W @ dphi^2`` (f64, never TF32),
        ``mean = s / n_r`` and ``var = (sp - s^2 / n_r) / (n_r - 1)``.

        :param w: weights [B, N]; flat: dphi [N, K]; n_r: replicate sizes [B]
        :return: (means [B, K], variances [B, K])
        """
        s = w @ flat
        sp = w @ (flat * flat)
        n_r = n_r[:, None]
        return s / n_r, (sp - s * s / n_r) / (n_r - 1.0)

    def _bootstrap_rows(self, y, moments_fn, scalar):
        """One level's values [M, N, C] -> (dphi [N, R(, M)] f64 with
        invalid lanes zeroed, valid [N]): a sample is invalid when ANY
        component carries NaN, a failed result or a domain clip."""
        y = as_tensor(y).to(torch.float64)
        valid = ~torch.isnan(moments_fn.transform(y)).any(dim=2).any(dim=0)
        phi = torch.nan_to_num(moments_fn.eval_all(y))       # [M, N, C, R]
        dphi = (phi[..., 0, :] - phi[..., 1, :] if y.shape[2] > 1
                else phi[..., 0, :])
        dphi = dphi.permute(1, 2, 0)                         # [N, R, M]
        return (dphi[..., 0] if scalar else dphi), valid

    def _bootstrap_level(self, dphi, valid, n_sub, n_valid, replicates,
                         replace, seed, level_id):
        """(means, variances) [len(replicates), R(, M)] tensors of one
        level's ``replicates`` (a range of replicate indices), on dphi's
        device, in blocks of replicates under ``BOOTSTRAP_BLOCK_BYTES``."""
        N = dphi.shape[0]
        flat = dphi.reshape(N, -1)
        device = flat.device
        gen = torch.Generator(device=device)
        if replace == "poisson":
            cdf = torch.from_numpy(self._poisson_cdf(
                n_sub / max(n_valid, 1))).to(device)
        elif replace:
            # valid sample positions packed first: ONE sort per level,
            # shared by every replicate
            order = torch.argsort((~valid).to(torch.int8), stable=True)
        B = len(replicates)
        block = int(max(1, min(B, self.BOOTSTRAP_BLOCK_BYTES // (32 * max(N, 1)))))
        means, variances = [], []
        for start in range(replicates.start, replicates.stop, block):
            reps = range(start, min(start + block, replicates.stop))
            draws = []
            for b in reps:
                self._replicate_generator(gen, seed, level_id, b)
                if replace is True:
                    draws.append(torch.randint(0, n_valid, (n_sub,),
                                               generator=gen, device=device))
                else:
                    draws.append(torch.rand(N, generator=gen, device=device,
                                            dtype=torch.float64))
            draws = torch.stack(draws)
            if replace == "poisson":
                w = self._weights_poisson(draws, valid, cdf)
                n_r = w.sum(dim=1).clamp(min=2.0)
            else:
                if replace:
                    idx = order[draws]     # uniform over the valid prefix
                else:
                    # without replacement: the n_sub largest keys among the
                    # valid samples (the Gumbel transform of a uniform key
                    # is increasing, so the uniforms select the same set)
                    keys = torch.where(valid[None, :], draws,
                                       torch.full_like(draws, -1.0))
                    idx = torch.topk(keys, n_sub, dim=1).indices
                w = self._weights_from_indices(idx, N)
                n_r = torch.full((len(reps),), float(n_sub),
                                 dtype=torch.float64, device=device)
            m, v = self._replicate_stats(w, flat, n_r)
            means.append(m)
            variances.append(v)
        shape = (B,) + tuple(dphi.shape[1:])
        return torch.cat(means).reshape(shape), torch.cat(variances).reshape(shape)

    def est_bootstrap_fast(self, n_subsamples=100, sample_vector=None,
                           moments_fn=None, seed=0, regression=False,
                           log=False, replace=False, mesh=None):
        """Bootstrap on the estimation device: per level the moment
        differences ``dphi [N, R]`` are built once, and ``n_subsamples``
        replicates are drawn over the VALID samples and reduced by two
        matrix products. Sets ``mean_bs_*``, ``var_bs_*``,
        ``_bs_level_mean_variance`` (and ``var_bs_log_l_vars`` with
        ``log``); shapes are [L, R] per level, [L, R, M] for structured
        quantities.

        :param regression: smooth each replicate's level variances with the
            log-quadratic variance regression before aggregating
        :param log: additionally record the spread of the log variances
        :param replace: resampling scheme.

            * ``False`` (default): without replacement, ``sample_vector[l]``
              of the valid samples per replicate (a top-k over random keys,
              a sort of the level per replicate);
            * ``True``: classical Efron bootstrap, uniform draws with
              replacement over the valid prefix of one shared stable
              argsort;
            * ``'poisson'``: replicate weights ``w_i ~ Poisson(n_sub /
              n_valid)``, independent across samples (E[sum w] = n_sub;
              replicate sizes vary by ~sqrt(n_sub)): no sort, no gather.
        :param seed: replicate b of level l draws from a stream keyed by
            (seed, l, b)
        :param mesh: a ``parallel.SampleMesh`` (``replace='poisson'``
            only): the B replicates split into equal shares over the
            shards, each drawn and reduced on its shard's device; a
            replicate's weights are those of the one-device run
        """
        if replace not in (False, True, "poisson"):
            # an unknown scheme string is truthy and would silently run
            # the classical bootstrap: reject it instead
            raise ValueError("replace must be False, True or 'poisson'")
        B = int(n_subsamples)
        if mesh is not None:
            if replace != "poisson":
                raise ValueError(
                    "mesh-sharded bootstrap runs on the packed "
                    "replace='poisson' path (traceable quantity, all "
                    "levels populated)")
            if B % mesh.n_devices:
                raise ValueError("n_subsamples=%d must divide by the "
                                 "mesh's %d devices" % (B, mesh.n_devices))
        moments_fn = self._resolve_moments(moments_fn, remember=True)
        scalar, _ = self._n_components()
        n_levels = self._sample_storage.get_n_levels()
        sample_vector = determine_sample_vec(
            n_collected_samples=self._sample_storage.get_n_collected(),
            n_levels=n_levels, sample_vector=sample_vector)

        bs_l_means = bs_l_vars = None
        ns = np.empty(n_levels, dtype=int)
        # stored values up to each level's true count: the capacity tail
        # of a device storage is never seen
        for lvl, y in enumerate(self._gather_level_qoi()):
            dphi, valid = self._bootstrap_rows(y, moments_fn, scalar)
            n_valid = int(valid.sum())
            n_sub = int(min(sample_vector[lvl], n_valid))
            if n_sub < 1:
                raise ValueError("bootstrap: level %d has no valid sample" % lvl)
            ns[lvl] = n_sub
            if mesh is None:
                means_l, vars_l = self._bootstrap_level(
                    dphi, valid, n_sub, n_valid, range(B), replace, seed, lvl)
            else:
                share = B // mesh.n_devices
                parts = [self._bootstrap_level(
                    dphi.to(device), valid.to(device), n_sub, n_valid,
                    range(s * share, (s + 1) * share), replace, seed, lvl)
                    for s, device in mesh.local_shards()]
                means_l, vars_l = (mesh.gather([p[k] for p in parts])
                                   for k in range(2))
            means_l, vars_l = means_l.cpu().numpy(), vars_l.cpu().numpy()
            if bs_l_means is None:
                stat_shape = means_l.shape[1:]         # (R,) or (R, M)
                bs_l_means = np.empty((B, n_levels) + stat_shape)
                bs_l_vars = np.empty((B, n_levels) + stat_shape)
            bs_l_means[:, lvl] = means_l
            bs_l_vars[:, lvl] = vars_l
        return self._finish_bootstrap(bs_l_means, bs_l_vars, ns, B,
                                      n_levels, regression, log)

    def _finish_bootstrap(self, bs_l_means, bs_l_vars, ns, B, n_levels,
                          regression, log):
        """Aggregate [B, L, ...] replicate statistics into the bootstrap
        attributes."""
        if regression:
            # each replicate's level variances are smoothed by the variance
            # regression before aggregation
            steps = np.squeeze(np.asarray(
                self._sample_storage.get_level_parameters()))
            for b in range(B):
                bs_l_vars[b] = self._all_moments_variance_regression(
                    bs_l_vars[b], steps).reshape(bs_l_vars[b].shape)

        stat_rank = bs_l_vars.ndim - 2
        ns_bc = np.asarray(ns).reshape((1, n_levels) + (1,) * stat_rank)
        bs_mean = bs_l_means.sum(axis=1)               # [B, R(, M)]
        bs_var = (bs_l_vars / ns_bc).sum(axis=1)

        self.mean_bs_mean = bs_mean.mean(axis=0)
        self.mean_bs_var = bs_var.mean(axis=0)
        self.mean_bs_l_means = bs_l_means.mean(axis=0)
        self.mean_bs_l_vars = bs_l_vars.mean(axis=0)
        self.var_bs_mean = bs_mean.var(axis=0, ddof=1)
        self.var_bs_var = bs_var.var(axis=0, ddof=1)
        self.var_bs_l_means = bs_l_means.var(axis=0, ddof=1)
        self.var_bs_l_vars = bs_l_vars.var(axis=0, ddof=1)
        if log:
            with np.errstate(divide="ignore", invalid="ignore"):
                self.var_bs_log_l_vars = np.nan_to_num(
                    np.log(np.maximum(bs_l_vars, 1e-300))).var(axis=0,
                                                               ddof=1)
        n_coll = np.asarray(self._sample_storage.get_n_collected(), float)
        self._bs_level_mean_variance = self.var_bs_l_means * n_coll.reshape(
            (-1,) + (1,) * (self.var_bs_l_means.ndim - 1))

    def bs_target_var_n_estimated(self, target_var, sample_vec=None):
        """Estimate n_l for a target variance from bootstrapped level vars."""
        sample_vec = determine_sample_vec(
            n_collected_samples=self._sample_storage.get_n_collected(),
            n_levels=self._sample_storage.get_n_levels(),
            sample_vector=sample_vec,
        )
        self.est_bootstrap(n_subsamples=300, sample_vector=sample_vec)
        variances, n_ops = self.estimate_diff_vars_regression(sample_vec, raw_vars=self.mean_bs_l_vars)
        return estimate_n_samples_for_target_variance(
            target_var, variances, n_ops, n_levels=self._sample_storage.get_n_levels()
        )

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

    # ------------------------------------------------------------------ #
    # plots (host-side diagnostics)
    # ------------------------------------------------------------------ #
    def _sample_vec(self, sample_vec):
        return determine_sample_vec(
            n_collected_samples=self._sample_storage.get_n_collected(),
            n_levels=self._sample_storage.get_n_levels(),
            sample_vector=sample_vec)

    def plot_variances(self, sample_vec=None):
        """Bootstrap breakdown of the estimate's variance by level."""
        from mlmc_tpu_torch.plot import plots

        var_plot = plots.VarianceBreakdown(10)
        sample_vec = self._sample_vec(sample_vec)
        self.est_bootstrap(n_subsamples=100, sample_vector=sample_vec)
        var_plot.add_variances(self.mean_bs_l_vars, sample_vec,
                               ref_level_vars=self._bs_level_mean_variance)
        var_plot.show(None)

    def plot_bs_var_log(self, sample_vec=None):
        """Bootstrap variance diagnostics (reference estimator.py:231-247)."""
        from mlmc_tpu_torch.plot import plots

        sample_vec = self._sample_vec(sample_vec)
        self.est_bootstrap(n_subsamples=100, sample_vector=sample_vec)
        bs_plot = plots.BSplots(
            n_samples=sample_vec, bs_n_samples=sample_vec,
            n_moments=self.n_moments, ref_level_var=self.mean_bs_l_vars)
        bs_plot.plot_bs_variances(self.var_bs_l_vars)
        return bs_plot

    def fine_coarse_violinplot(self):
        """Violin comparison of each level's fine samples against the next
        level's coarse samples (reference estimator.py:220-228 +
        violinplot.py:28-69)."""
        import pandas as pd
        from mlmc_tpu_torch.plot import violinplot

        n_levels = self._sample_storage.get_n_levels()
        if n_levels <= 1:
            violinplot.fine_coarse_violinplot(None)
            return

        def frame(values, kind, level_id):
            label = "{} F{} {} C".format(level_id, " " * 5, level_id + 1)
            return pd.DataFrame({"samples": values, "type": kind,
                                 "level": label})

        frames = []
        for lid in range(n_levels):
            values = as_tensor(self.get_level_samples(
                lid, n_samples=self._sample_storage.get_n_collected()[lid])
            )[0].cpu().numpy()
            if lid == 0:
                frames.append(frame(values[:, 0], "fine", 0))
                continue
            frames.append(frame(values[:, 1], "coarse", lid))
            if lid + 1 < n_levels:
                frames.append(frame(values[:, 0], "fine", lid))
        violinplot.fine_coarse_violinplot(pd.concat(frames, axis=0))


def estimate_domain(quantity, sample_storage, quantile=None):
    """Module-level alias of Estimate.estimate_domain."""
    return Estimate.estimate_domain(quantity, sample_storage, quantile)



def estimate_n_samples_for_target_variance(target_variance, prescribe_vars, n_ops, n_levels):
    """Variance-optimal level allocation n_l ∝ sqrt(V_l / C_l).

    :param prescribe_vars: [L, R] level variances per moment
    :param n_ops: per-level cost C_l
    :return: [L] optimal sample counts (max over moments)
    """
    with profiling.span("estimate.host"):
        vars = np.asarray(prescribe_vars, dtype=float)
        n_ops = np.asarray(n_ops, dtype=float)
        sqrt_var_n = np.sqrt(vars.T * n_ops)  # moments in rows, levels in cols
        total = np.sum(sqrt_var_n, axis=1)
        n_samples_estimate = np.round(
            (sqrt_var_n / n_ops).T * total / target_variance).astype(int)
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


def determine_sample_vec(n_collected_samples, n_levels, sample_vector=None):
    if sample_vector is None:
        sample_vector = n_collected_samples
    if len(sample_vector) > n_levels:
        sample_vector = sample_vector[:n_levels]
    return np.array(sample_vector)


def determine_n_samples(n_levels, n_samples=None):
    """Per-level target counts: an explicit full vector passes through, a
    [n0] or [n0, nL] prescription expands geometrically (nL defaults to 3)."""
    spec = [100, 3] if n_samples is None else list(np.atleast_1d(n_samples))
    if len(spec) == 1:
        spec.append(3)
    if len(spec) > 2:
        return np.asarray(spec, dtype=int)
    return np.rint(np.geomspace(spec[0], spec[1], n_levels)).astype(int)


def estimate_convergence_rates(level_means, level_vars, level_steps,
                               n_ops=None):
    """MLMC complexity-theorem rates by log-log least squares over levels.

    Giles' theorem parameters (Giles 2015, Acta Numerica 24): the weak
    rate ``alpha`` (|E[Y_l]| ~ h^alpha), the variance rate ``beta``
    (V_l ~ h^beta) and, when measured per-level costs are supplied, the
    cost rate ``gamma`` (C_l ~ h^-gamma). beta > gamma puts the workload
    in the optimal O(eps^-2) complexity regime. Level 0 is the coarse
    anchor and does not follow the asymptotic decay, so fits use levels
    >= 1.

    :param level_means: per-level telescoped diff means [L] (e.g.
        ``QuantityMean.l_means`` of the plain quantity)
    :param level_vars: per-level diff variances [L]
    :param level_steps: level discretization steps h_l [L] (first entry
        of each level-parameter vector)
    :param n_ops: optional measured per-sample cost per level [L]
    :return: dict with ``alpha``, ``beta`` (and ``gamma``), each the
        fitted d log(.) / d log(h) slope (sign-adjusted so positive
        means the textbook decay), plus ``n_fit_levels``
    """
    h = np.asarray(level_steps, dtype=float).reshape(len(level_means), -1)[:, 0]
    m = np.abs(np.asarray(level_means, dtype=float).ravel())
    v = np.asarray(level_vars, dtype=float).ravel()

    def _fit(y):
        y1, h1 = y[1:], h[1:]
        mask = np.isfinite(y1) & (y1 > 0) & np.isfinite(h1) & (h1 > 0)
        if mask.sum() < 2:
            return np.nan, int(mask.sum())
        A = np.stack([np.log(h1[mask]), np.ones(int(mask.sum()))], axis=1)
        coef, *_ = np.linalg.lstsq(A, np.log(y1[mask]), rcond=None)
        return float(coef[0]), int(mask.sum())

    alpha, n_fit = _fit(m)
    beta, _ = _fit(v)
    rates = {"alpha": alpha, "beta": beta, "n_fit_levels": n_fit}
    if n_ops is not None:
        g, _ = _fit(np.asarray(n_ops, dtype=float).ravel())
        rates["gamma"] = -g if np.isfinite(g) else np.nan
    return rates


def richardson_extrapolation(level_means, level_steps, alpha):
    """Bias-corrected MLMC mean by Richardson extrapolation.

    For a weak rate alpha and refinement factor r = h_{L-1}/h_L, the
    remaining discretization bias of the telescoped estimate is
    ``E[Y_L] / (r^alpha - 1)`` (Giles 2015, eq. 2.8); adding it
    extrapolates the mean to the h -> 0 limit.

    :return: (extrapolated mean, estimated remaining bias)
    """
    m = np.asarray(level_means, dtype=float).ravel()
    h = np.asarray(level_steps, dtype=float).reshape(len(m), -1)[:, 0]
    if len(m) < 2 or not np.isfinite(alpha) or alpha <= 0:
        return float(m.sum()), np.nan
    r = h[-2] / h[-1]
    bias = float(m[-1] / (r ** alpha - 1.0))
    return float(m.sum() + bias), bias
