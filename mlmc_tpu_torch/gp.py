"""Gaussian-process emulation and multilevel cokriging (counterpart of
``mlmc_tpu/gp.py``).

Gaussian-process regression with calibrated predictive uncertainty, and
Kennedy & O'Hagan's autoregressive cokriging (Biometrika 87, 2000) in Le
Gratiet's recursive form (IJUQ 4, 2014),

    f_l(x) = rho_l f_{l-1}(x) + delta_l(x),    delta_l ~ GP,

so a few fine-model runs plus many coarse runs give a fine-accuracy
emulator. Bayesian optimization by expected improvement rides on the GP.

The fit is a Cholesky of the [n, n] kernel matrix; the hyperparameters
(ARD log lengthscales, signal, noise unless fixed, a constant mean, and
the autoregressive rho, the coefficient of a known offset regressor)
maximize the exact log marginal likelihood by Adam on its
``torch.autograd`` gradient, a Python loop of ``n_steps`` on the device
whose NLL trace is fetched once at the end. ``risk.adam`` is optax's
Adam on plain tensors, no ``torch.optim``. A fixed noise and an absent
offset are frozen exactly (their gradients are never formed, so Adam never
moves them).
"""
import math
import time
from typing import Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops import sobol
from mlmc_tpu_torch.risk import adam

__all__ = ["GP", "MultilevelGP", "bayes_opt", "rbf_kernel",
           "matern52_kernel"]


def _sqdist(a, b, inv_ls):
    """Scaled pairwise squared distances: a [n, d], b [m, d] -> [n, m]
    via the |a|^2 + |b|^2 - 2 a.b expansion."""
    a = a * inv_ls[None, :]
    b = b * inv_ls[None, :]
    d2 = ((a * a).sum(1)[:, None] + (b * b).sum(1)[None, :]
          - 2.0 * (a @ b.T))
    return torch.clamp(d2, min=0.0)


def rbf_kernel(a, b, log_ls, log_sf):
    """Squared-exponential: sf^2 exp(-d2/2), ARD lengthscales."""
    d2 = _sqdist(a, b, torch.exp(-log_ls))
    return torch.exp(2.0 * log_sf) * torch.exp(-0.5 * d2)


def matern52_kernel(a, b, log_ls, log_sf):
    """Matern 5/2 (twice-differentiable samples), ARD lengthscales."""
    r = torch.sqrt(_sqdist(a, b, torch.exp(-log_ls)) + 1e-30)
    s = np.sqrt(5.0) * r
    return (torch.exp(2.0 * log_sf) * (1.0 + s + s * s / 3.0)
            * torch.exp(-s))


_KERNELS = {"rbf": rbf_kernel, "matern52": matern52_kernel}


class GP:
    """Exact Gaussian-process regression with marginal-likelihood
    hyperparameter optimization on the device.

    :param kernel: "rbf" | "matern52" | a callable
        ``(a, b, log_ls, log_sf) -> [n, m]``.
    :param noise: observation noise sd; a float fixes it, None learns
        it (log-parameterized).
    :param device: where the fit and the predictions run (None: the
        current CUDA device)
    """

    def __init__(self, kernel="rbf", noise: Optional[float] = None,
                 dtype=torch.float64, device=None):
        self._kernel = (_KERNELS[kernel]
                        if isinstance(kernel, str) else kernel)
        self._noise = noise
        self._dtype = dtype
        self._device = resolve_device(device)
        self._state = None

    def _as(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
            self._device, self._dtype)

    def fit(self, X, y, offset=None, n_steps: int = 250,
            learning_rate: float = 0.05):
        """Fit to X [n, d], y [n]: optimize (ARD lengthscales, signal,
        noise unless fixed, constant mean, and the coefficient rho of
        the known ``offset`` regressor, if given: the residual model is
        ``y - rho*offset - mean ~ GP``) by Adam on the exact marginal
        likelihood."""
        X = self._as(X)
        y = self._as(y)
        if X.ndim != 2 or y.shape != (X.shape[0],):
            raise ValueError("need X [n, d], y [n]")
        has_offset = offset is not None
        b = self._as(offset) if has_offset else torch.zeros_like(y)
        if b.shape != y.shape:
            raise ValueError("offset must match y's shape")
        n, d = X.shape
        span = torch.clamp(X.max(0).values - X.min(0).values, min=1e-6)
        fixed_noise = self._noise is not None
        # rho starts at its least-squares value against the offset
        # regressor (the joint likelihood is multimodal in rho), the mean
        # at the residual mean, the noise at 10% of the residual sd (a tiny
        # start sits in the basin of the zero-noise interpolation optimum)
        if has_offset:
            bc = b - b.mean()
            rho0 = bc @ (y - y.mean()) / torch.clamp(bc @ bc, min=1e-12)
        else:
            rho0 = torch.zeros((), dtype=self._dtype, device=self._device)
        r0 = y - rho0 * b
        r_sd = torch.clamp(r0.std(unbiased=False), min=1e-12)
        params = [torch.log(0.3 * span),                                  # log_ls [d]
                  torch.log(r_sd),                                        # log_sf
                  (torch.log(self._as(self._noise)) if fixed_noise
                   else torch.log(0.1 * r_sd)),                           # log_sn
                  r0.mean(),                                              # mean
                  rho0.clone()]                                           # rho
        params = [p.detach().clone() for p in params]
        free = [0, 1, 3] + ([] if fixed_noise else [2]) + ([4] if has_offset else [])
        for i in free:
            params[i].requires_grad_(True)
        opt = adam(learning_rate)([params[i] for i in sorted(free)])
        kernel = self._kernel
        # dtype-aware jitter scaled by the signal variance: 1e-10 is below
        # float32 resolution, where a smooth kernel's Cholesky fails
        jit_eps = 1e-10 if torch.finfo(self._dtype).bits >= 64 else 1e-5
        eye = torch.eye(n, dtype=self._dtype, device=self._device)
        log_2pi = math.log(2.0 * math.pi)

        def nll(p):
            log_ls, log_sf, log_sn, mean, rho = p
            K = kernel(X, X, log_ls, log_sf)
            K = K + (torch.exp(2.0 * log_sn)
                     + jit_eps * torch.exp(2.0 * log_sf)) * eye
            L = torch.linalg.cholesky(K)
            r = y - mean - rho * b
            alpha = torch.cholesky_solve(r[:, None], L)[:, 0]
            val = (0.5 * r @ alpha + torch.log(torch.diagonal(L)).sum()
                   + 0.5 * n * log_2pi)
            return val, L, alpha

        t0 = time.perf_counter()
        nlls = []
        for _ in range(n_steps):
            opt.zero_grad()
            val, _, _ = nll(params)
            val.backward()
            opt.step()
            nlls.append(val.detach())
        with torch.no_grad():
            params = [p.detach() for p in params]
            _, L, alpha = nll(params)              # final factorization
        self._state = dict(X=X, params=params, L=L, alpha=alpha)
        self.nll_trace = (torch.stack(nlls).cpu().numpy().astype(np.float64)
                          if nlls else np.zeros(0))
        self.wall_s = time.perf_counter() - t0
        if nlls and not np.isfinite(self.nll_trace[-1]):
            raise FloatingPointError(
                "marginal-likelihood optimization diverged — scale the "
                "inputs/outputs or fix the noise level")
        return self

    def predict(self, Xs, include_noise: bool = False):
        """Posterior mean and sd of the residual model at Xs [m, d], as
        numpy. With an ``offset`` fit, add ``rho * offset(Xs)`` yourself —
        :class:`MultilevelGP` does."""
        if self._state is None:
            raise RuntimeError("fit() first")
        st = self._state
        Xs = self._as(Xs)
        log_ls, log_sf, log_sn, mean, _ = st["params"]
        with torch.no_grad():
            Ks = self._kernel(Xs, st["X"], log_ls, log_sf)       # [m, n]
            mu = mean + Ks @ st["alpha"]
            V = torch.linalg.solve_triangular(st["L"], Ks.T, upper=False)  # [n, m]
            var = torch.exp(2.0 * log_sf) - (V * V).sum(0)
            if include_noise:
                var = var + torch.exp(2.0 * log_sn)
            sd = torch.sqrt(torch.clamp(var, min=1e-30))
        return mu.cpu().numpy(), sd.cpu().numpy()

    @property
    def hyperparameters(self):
        log_ls, log_sf, log_sn, mean, rho = (
            p.cpu().numpy() for p in self._state["params"])
        return {"lengthscales": np.exp(np.asarray(log_ls)),
                "signal_sd": float(np.exp(log_sf)),
                "noise_sd": float(np.exp(log_sn)),
                "mean": float(mean), "rho": float(rho)}


class MultilevelGP:
    """Recursive autoregressive cokriging (Kennedy-O'Hagan 2000, Le
    Gratiet 2014): level l's data is regressed as ``y_l = rho_l *
    m_{l-1}(X_l) + delta_l(X_l)`` where ``m_{l-1}`` is the already fitted
    previous emulator's posterior mean (a known offset regressor, so
    ``rho_l`` is learned in the same marginal-likelihood fit) and
    ``delta_l ~ GP``.

    Predictions compose recursively: ``mean_l = rho_l mean_{l-1} +
    delta-mean``, ``var_l = rho_l^2 var_{l-1} + delta-var``. Designs need
    not be nested.
    """

    def __init__(self, kernel="rbf", noise: Optional[float] = None,
                 dtype=torch.float64, device=None):
        self._kernel_name = kernel
        self._noise = noise
        self._dtype = dtype
        self._device = resolve_device(device)
        self.gps = []
        self.rhos = []

    def fit(self, levels: Sequence, n_steps: int = 250,
            learning_rate: float = 0.05):
        """:param levels: list of (X_l [n_l, d], y_l [n_l]) pairs,
        coarse first."""
        if len(levels) < 1:
            raise ValueError("need at least one level")
        t0 = time.perf_counter()
        self.gps, self.rhos = [], []
        for lev, (X, y) in enumerate(levels):
            gp = GP(self._kernel_name, self._noise, self._dtype, self._device)
            if lev == 0:
                gp.fit(X, y, n_steps=n_steps,
                       learning_rate=learning_rate)
                self.rhos.append(0.0)
            else:
                m_prev, _ = self.predict(np.asarray(X, np.float64),
                                         upto=lev)
                gp.fit(X, y, offset=m_prev, n_steps=n_steps,
                       learning_rate=learning_rate)
                self.rhos.append(gp.hyperparameters["rho"])
            self.gps.append(gp)
        self.wall_s = time.perf_counter() - t0
        return self

    def predict(self, Xs, upto: Optional[int] = None):
        """Finest-level posterior mean/sd at Xs (or the composition of
        the first ``upto`` levels)."""
        if not self.gps:
            raise RuntimeError("fit() first")
        upto = len(self.gps) if upto is None else upto
        mu, var = None, None
        for lev in range(upto):
            m, s = self.gps[lev].predict(Xs)
            if lev == 0:
                mu, var = m, s ** 2
            else:
                rho = self.rhos[lev]
                mu = rho * mu + m
                var = rho * rho * var + s ** 2
        return mu, np.sqrt(var)


def bayes_opt(fn, bounds, n_init: int = 8, n_iter: int = 25,
              seed: int = 0, kernel="matern52",
              noise: Optional[float] = None, n_candidates: int = 4096,
              xi: float = 0.01, fit_steps: int = 200, dtype=torch.float64,
              device=None, scrambles=None):
    """Bayesian optimization: minimize an expensive black box over a box
    domain with a GP surrogate and the expected-improvement acquisition
    (Jones-Schonlau-Welch 1998).

    Per iteration: refit the GP on all data, score EI on an
    Owen-scrambled Sobol' candidate set (``ops.sobol``; a fresh scrambling
    each round), evaluate the argmax, append. Round ``it`` (0 the initial
    design) scrambles with ``sobol.scramble_seeds(seed, it, 1, d)``.

    :param fn: ``x [d] -> scalar`` objective (called on one point at a
        time — it is the expensive model).
    :param bounds: [d, 2] array of (lo, hi) per dimension.
    :param noise: observation noise sd — None learns it; pass a small
        float (e.g. 1e-6) for noiseless computer experiments.
    :param xi: EI exploration offset (in units of the observed y sd).
    :param device: where the GP and the candidates run (None: the
        current CUDA device)
    :param scrambles: ``it -> [d]`` uint32 scramble words in place of the
        keyed ones
    :return: dict with ``x_best`` [d], ``y_best``, ``X`` [n, d] /
        ``y`` [n] (all evaluations), ``ei_trace``, ``wall_s``.
    """
    bounds = np.asarray(bounds, np.float64)
    if bounds.ndim != 2 or bounds.shape[1] != 2 or np.any(
            bounds[:, 1] <= bounds[:, 0]):
        raise ValueError("bounds must be [d, 2] with hi > lo")
    d = bounds.shape[0]
    device = resolve_device(device)
    lo, span = bounds[:, 0], bounds[:, 1] - bounds[:, 0]
    dv = sobol.direction_numbers(d)
    scrambles = scrambles or (lambda it: sobol.scramble_seeds(seed, it, 1, d, device)[0])

    def draw(it, n):
        u = sobol.sobol_uniforms(dv, 0, n, seeds=scrambles(it), dtype=dtype,
                                 device=device)
        return lo[None, :] + span[None, :] * u.cpu().numpy().astype(np.float64)

    def evaluate(x):
        return float(fn(torch.as_tensor(x).to(device, dtype)))

    t0 = time.perf_counter()
    X = draw(0, n_init)
    y = np.array([evaluate(x) for x in X])
    ei_trace = []
    for it in range(1, n_iter + 1):
        gp = GP(kernel, noise, dtype, device).fit(X, y, n_steps=fit_steps)
        cand = draw(it, n_candidates)
        mu, sd = gp.predict(cand)
        y_best = y.min()
        imp = y_best - mu - xi * y.std()
        z = imp / np.maximum(sd, 1e-12)
        # closed-form EI for minimization
        phi = np.exp(-0.5 * z * z) / np.sqrt(2 * np.pi)
        Phi = 0.5 * (1.0 + _erf_np(z / np.sqrt(2.0)))
        ei = imp * Phi + sd * phi
        j = int(np.argmax(ei))
        ei_trace.append(float(ei[j]))
        x_new = cand[j]
        y_new = evaluate(x_new)
        X = np.vstack([X, x_new[None, :]])
        y = np.append(y, y_new)
    i = int(np.argmin(y))
    return {"x_best": X[i], "y_best": float(y[i]), "X": X, "y": y,
            "ei_trace": np.asarray(ei_trace),
            "wall_s": time.perf_counter() - t0}


def _erf_np(x):
    """Vectorized erf without scipy (math.erf elementwise; the candidate
    sets are small host arrays)."""
    return np.vectorize(math.erf)(x)
