"""Sequential data assimilation: ensemble Kalman filtering (counterpart of
``mlmc_tpu/filter.py``).

Given ``x_{t+1} = M(x_t, w_t)``, ``y_t = h(x_t) + v_t``, ``v_t ~ N(0, R)``,
the ensemble Kalman filter (Evensen 1994) propagates a J-member ensemble
through the model and assimilates each observation with a Kalman update
built from ensemble statistics. Two analysis schemes:

* ``method="perturbed"``: the stochastic perturbed-observation update,
  ES-MDA's update at inflation alpha = 1 (``eki._esmda_update``);
* ``method="etkf"``: the deterministic ensemble transform filter
  (Bishop-Etherton-Majumdar 2001), a symmetric square root in ensemble
  space.

Also produced: the innovation log-likelihood ``sum_t log N(y_t;
h_mean_forecast, H P_f H' + R)`` (ensemble plug-in), validated against
the closed-form :func:`kalman_filter`. :func:`multilevel_enkf` telescopes
filtered expectations over a transition hierarchy (Hoel, Law & Tempone,
SIAM J. Numer. Anal. 54, 2016) with R independent replicates per level as
a leading axis.

**Batch contract.** ``transition(x [N, d], keys, t) -> x' [N, d]`` with
``keys`` the ``random.keyed.SampleKeys`` of the step's members (draw model
noise from ``keys.normals(n, dtype)``); ``observe(x [N, d]) -> [N, K]``;
``phi(x [N, d]) -> [N, q]``. Each filter step is a Python loop iteration
of tensor operations on the device; the trajectory statistics stay there
until one fetch at the end.

**Draws.** Member j's draws at step t of level l are keyed by (seed, l, t,
j) as in ``particle``: tag 0 the initial state, 1 the propagation, 2 the
perturbed observations' normals. ``multilevel_enkf``'s replicate r holds
the members ``r J .. r J + J - 1``; its fine and coarse filters share the
propagation and the perturbation draws. ``draws=`` takes an object with
``init``, ``propagate`` and ``perturbation`` in their place (a test hands
in JAX's).
"""
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.eki import _esmda_update
from mlmc_tpu_torch.particle import _island_se, _word
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["enkf", "multilevel_enkf", "kalman_filter", "lorenz96_step",
           "FilterDraws"]


def kalman_filter(M, H, Q, R, m0, P0, data):
    """Exact Kalman filter for ``x' = M x + w``, ``y = H x + v``
    (host numpy, the validation reference).

    :return: dict with ``means`` [T, d], ``covs`` [T, d, d] (filtered),
        ``loglik`` (the exact innovation log-likelihood).
    """
    M, H = np.asarray(M, np.float64), np.asarray(H, np.float64)
    Q, R = np.asarray(Q, np.float64), np.asarray(R, np.float64)
    m, P = np.asarray(m0, np.float64), np.asarray(P0, np.float64)
    data = np.asarray(data, np.float64)
    K_obs = H.shape[0]
    means, covs, loglik = [], [], 0.0
    for y in data:
        m = M @ m
        P = M @ P @ M.T + Q
        S = H @ P @ H.T + R
        innov = y - H @ m
        sol = np.linalg.solve(S, innov)
        loglik += -0.5 * (K_obs * np.log(2 * np.pi)
                          + np.linalg.slogdet(S)[1] + innov @ sol)
        K = P @ H.T @ np.linalg.inv(S)
        m = m + K @ innov
        P = (np.eye(len(m)) - K @ H) @ P
        means.append(m.copy())
        covs.append(P.copy())
    return {"means": np.array(means), "covs": np.array(covs),
            "loglik": float(loglik)}


class FilterDraws:
    """The draws of a filter level from its members' identities.

    ``init(r)`` the ``SampleKeys`` of replicate r's J initial members,
    ``propagate(t)`` of all R J members at step t, ``perturbation(t)`` the
    [R, J, K] normals of the perturbed observations."""

    def __init__(self, seed, n_ens, n_obs, n_replicates=1, level=0,
                 dtype=torch.float64, device=None):
        self.seed, self.level, self.dtype = int(seed), int(level), dtype
        self.J, self.K, self.R = int(n_ens), int(n_obs), int(n_replicates)
        self._idx = torch.arange(self.R * self.J, dtype=torch.int64,
                                 device=resolve_device(device))

    def _keys(self, tag, t, idx):
        return SampleKeys(self.seed, _word(tag, self.level, t), idx)

    def init(self, r=0):
        return self._keys(0, 0, self._idx[r * self.J:(r + 1) * self.J])

    def propagate(self, t):
        return self._keys(1, t, self._idx)

    def perturbation(self, t):
        xi = self._keys(2, t, self._idx).normals(self.K, self.dtype)
        return xi.reshape(self.R, self.J, self.K)


def _etkf_update(x, hx, y, noise):
    """Deterministic ensemble-transform analysis (symmetric square root):
    x [..., J, d], hx [..., J, K], y [K], diagonal noise [K].

    Worked in observation space via the thin SVD of the scaled obs
    anomalies S [J, K]: with S = U diag(s) V^T,

        (I + S S^T/(J-1))^-1    = I - U diag(t/(1+t)) U^T,
        (I + S S^T/(J-1))^-1/2  = I + U diag((1+t)^-1/2 - 1) U^T,

    t = s^2/(J-1). Both operators fix the ones-vector (S^T 1 = 0), so the
    transform keeps the anomaly mean at zero. Only ``U diag(.) U^T``
    enters, which does not depend on the signs of the singular vectors."""
    J = x.shape[-2]
    xm = x.mean(-2)
    hm = hx.mean(-2)
    A = x - xm[..., None, :]                              # [..., J, d]
    S = (hx - hm[..., None, :]) / noise                   # [..., J, K]
    U, s, _ = torch.linalg.svd(S, full_matrices=False)    # U [..., J, r]
    t = s * s / (J - 1)
    d_scaled = (y - hm) / noise                           # [..., K]
    Sd = (S @ d_scaled[..., None])[..., 0] / (J - 1)      # [..., J]
    # mean update: xm + A^T (I+C)^-1 Sd
    proj = (U.mT @ Sd[..., None])[..., 0]
    wbar = Sd - (U @ ((t / (1.0 + t)) * proj)[..., None])[..., 0]
    xm_a = xm + (A.mT @ wbar[..., None])[..., 0]
    # anomaly transform: A + U ((1+t)^-1/2 - 1) U^T A
    A_a = A + U @ ((1.0 / torch.sqrt(1.0 + t) - 1.0)[..., :, None] * (U.mT @ A))
    return xm_a[..., None, :] + A_a - A_a.mean(-2, keepdim=True)


def _inflate(x, infl):
    xm = x.mean(-2, keepdim=True)
    return xm + infl * (x - xm)


def enkf(transition: Callable, observe: Callable, data, noise_std,
         n_ens: int, d: int, seed: int = 0, x0=None,
         x0_sampler: Optional[Callable] = None, inflation: float = 1.0,
         method: str = "perturbed", jitter: float = 1e-9,
         dtype=torch.float64, device=None, draws=None):
    """Run the ensemble Kalman filter over ``data`` [T, K].

    :param transition: ``(x [J, d], keys, t) -> x' [J, d]``
    :param observe: ``x [J, d] -> obs [J, K]`` observation operator
    :param noise_std: observation noise sd (scalar or [K], diagonal R)
    :param x0 / x0_sampler: initial ensemble [J, d], or ``keys -> [J, d]``
        (default N(0, I))
    :param inflation: multiplicative anomaly inflation (> 1 combats
        covariance collapse in chaotic models)
    :param method: "perturbed" (stochastic update, ES-MDA's) or "etkf"
        (deterministic square-root transform)
    :param device: where the ensemble runs; None = ``x0``'s device, else
        the current CUDA device
    :param draws: a :class:`FilterDraws`-like object in place of
        ``FilterDraws(seed, n_ens, K)``
    :return: dict with ``means`` [T, d] (analysis means), ``spread`` [T]
        (mean analysis ensemble sd), ``forecast_means`` [T, d], ``loglik``
        (ensemble innovation log-likelihood), ``ensemble`` [J, d] final,
        ``wall_s``
    """
    if method not in ("perturbed", "etkf"):
        raise ValueError(f"unknown method {method!r}; "
                         "choose 'perturbed' or 'etkf'")
    if inflation < 1.0:
        raise ValueError("inflation must be >= 1")
    device = resolve_device(device, like=x0)
    data = torch.tensor(np.asarray(data, np.float64)).to(device, dtype)
    T, K = data.shape
    noise = torch.broadcast_to(torch.as_tensor(noise_std, dtype=dtype).to(device), (K,))
    draws = draws or FilterDraws(seed, n_ens, K, 1, 0, dtype, device)
    t0 = time.perf_counter()
    if x0 is None:
        keys = draws.init(0)
        x0 = x0_sampler(keys) if x0_sampler is not None else keys.normals(d, dtype)
    x = torch.as_tensor(x0).to(device, dtype)
    infl = float(np.sqrt(inflation))
    log_2pi = float(np.log(2 * np.pi))
    am, fm, spread, lls = [], [], [], []
    for t in range(T):
        y = data[t]
        x = _inflate(transition(x, draws.propagate(t), t), infl)
        hx = observe(x)
        # innovation loglik at the forecast (ensemble plug-in)
        hm = hx.mean(0)
        hc = hx - hm
        S = hc.T @ hc / (n_ens - 1) + torch.diag(noise ** 2)
        innov = y - hm
        sol = torch.linalg.solve(S, innov)
        lls.append(-0.5 * (K * log_2pi + torch.linalg.slogdet(S)[1] + innov @ sol))
        fm.append(x.mean(0))
        if method == "perturbed":
            xi = draws.perturbation(t)[0].to(device, dtype)
            x = _esmda_update(x, hx, y, noise, 1.0, xi, jitter)
        else:
            x = _etkf_update(x, hx, y, noise)
        am.append(x.mean(0))
        spread.append(x.std(0, unbiased=True).mean())
    x_np, am, fm, spread, ll = (v.cpu().numpy() for v in (
        x, torch.stack(am), torch.stack(fm), torch.stack(spread),
        torch.stack(lls).sum()))
    wall = time.perf_counter() - t0
    return {"means": am, "forecast_means": fm,
            "spread": spread, "loglik": float(ll),
            "ensemble": x_np, "wall_s": wall}


def multilevel_enkf(transition_level: Callable, observe: Callable,
                    data, noise_std, n_levels: int, d: int,
                    n_ens=64, seed: int = 0,
                    x0_sampler: Optional[Callable] = None,
                    inflation: float = 1.0, method: str = "etkf",
                    n_replicates: int = 8,
                    phi: Optional[Callable] = None,
                    jitter: float = 1e-9, dtype=torch.float64, device=None,
                    draws=None):
    """Multilevel ensemble Kalman filter (Hoel, Law & Tempone 2016):
    filtered expectations telescoped over a transition-kernel hierarchy,

        E_L[phi_t] = E_0[phi_t] + sum_l (E_l[phi_t] - E_{l-1}[phi_t]),

    each correction from a coupled pair of EnKFs: fine and coarse kernels
    take the same propagation keys, and the analysis couples by
    construction (ETKF is deterministic in the ensemble; the perturbed
    update shares its perturbation draw within the pair). Identical
    fine/coarse kernels give exactly zero corrections under "etkf".

    Error bars: ensemble members interact through the gain, so the error
    unit is an independent filter replicate: ``n_replicates`` pairs run
    per level (a leading axis) and the across-replicate scatter is
    reported.

    :param transition_level: ``level -> (x [N, d], keys, t) -> x' [N, d]``
        factory, coarsest 0; same-key fine/coarse propagations must be
        pathwise close
    :param n_ens: ensemble size per replicate, int or per-level list
    :param x0_sampler: ``(keys, J) -> [J, d]`` one replicate's initial
        ensemble (default N(0, I))
    :param phi: ``x [N, d] -> [N, q]`` test function (default identity)
    :param draws: one :class:`FilterDraws`-like object per level in place
        of ``FilterDraws(seed, J_l, K, R, level)``
    :return: dict with ``means`` [T, q] telescoped, ``means_se`` (levels
        combined in quadrature), ``level_means`` / ``level_ses``,
        ``correction_l1`` [n_levels-1], ``wall_s``
    """
    if n_levels < 1:
        raise ValueError("n_levels must be >= 1")
    if method not in ("perturbed", "etkf"):
        raise ValueError(f"unknown method {method!r}")
    device = resolve_device(device)
    data = torch.tensor(np.asarray(data, np.float64)).to(device, dtype)
    T, K = data.shape
    noise = torch.broadcast_to(torch.as_tensor(noise_std, dtype=dtype).to(device), (K,))
    n_per = ([int(n_ens)] * n_levels if np.isscalar(n_ens) else list(n_ens))
    if len(n_per) != n_levels:
        raise ValueError(f"n_ens gives {len(n_per)} levels, expected "
                         f"{n_levels}")
    phi = phi if phi is not None else (lambda x: x)
    R = int(n_replicates)
    infl = float(np.sqrt(max(inflation, 1.0)))
    draws = draws or [FilterDraws(seed, n_per[lev], K, R, lev, dtype, device)
                      for lev in range(n_levels)]
    t0 = time.perf_counter()

    def analysis(x, y, xi):
        """The replicates' analysis update, [R, J, d]."""
        hx = observe(x.reshape(-1, d)).reshape(R, x.shape[1], -1)
        if method == "etkf":
            return _etkf_update(x, hx, y, noise)
        return _esmda_update(x, hx, y, noise, 1.0, xi, jitter)

    def prop(f, x, keys, t):
        J = x.shape[1]
        return _inflate(f(x.reshape(R * J, d), keys, t).reshape(R, J, d), infl)

    def run_level(lev):
        """Level 0's plain filter or a coupled pair: per-step replicate
        means of phi, [T, R, q] each."""
        J = n_per[lev]
        dr = draws[lev]
        fine = transition_level(lev)
        coarse = transition_level(lev - 1) if lev > 0 else None
        x0 = []
        for r in range(R):
            keys = dr.init(r)
            x0.append(x0_sampler(keys, J) if x0_sampler is not None
                      else keys.normals(d, dtype))
        xf = xc = torch.stack([torch.as_tensor(v).to(device, dtype) for v in x0])
        mfs, mcs = [], []
        for t in range(T):
            y = data[t]
            keys = dr.propagate(t)
            xi = dr.perturbation(t).to(device, dtype) if method == "perturbed" else None
            xf = analysis(prop(fine, xf, keys, t), y, xi)
            mfs.append(phi(xf.reshape(R * J, d)).reshape(R, J, -1).mean(1))
            if coarse is not None:
                xc = analysis(prop(coarse, xc, keys, t), y, xi)
                mcs.append(phi(xc.reshape(R * J, d)).reshape(R, J, -1).mean(1))
        mf = torch.stack(mfs).cpu().numpy().astype(np.float64)
        return mf, (torch.stack(mcs).cpu().numpy().astype(np.float64)
                    if mcs else mf)

    level_means, level_ses, corr_l1 = [], [], []
    for lev in range(n_levels):
        mf, mc = run_level(lev)
        vals = mf if lev == 0 else mf - mc                     # [T, R, q]
        mean, se = _island_se(np.swapaxes(vals, 0, 1))
        level_means.append(mean)
        level_ses.append(se)
        if lev > 0:
            corr_l1.append(float(np.mean(np.abs(mean))))

    means = np.sum(level_means, axis=0)
    means_se = np.sqrt(np.sum(np.square(level_ses), axis=0))
    return {"means": means, "means_se": means_se,
            "level_means": level_means, "level_ses": level_ses,
            "correction_l1": np.asarray(corr_l1),
            "wall_s": time.perf_counter() - t0}


def lorenz96_step(dt: float = 0.05, forcing: float = 8.0,
                  model_noise: float = 0.0):
    """The Lorenz-96 transition (RK4, one assimilation window per call),
    the standard chaotic EnKF testbed.

    :return: ``(x [J, d], keys, t) -> x' [J, d]`` for :func:`enkf`
    """
    def rhs(x):
        return ((torch.roll(x, -1, dims=-1) - torch.roll(x, 2, dims=-1))
                * torch.roll(x, 1, dims=-1) - x + forcing)

    def transition(x, keys, t):
        k1 = rhs(x)
        k2 = rhs(x + 0.5 * dt * k1)
        k3 = rhs(x + 0.5 * dt * k2)
        k4 = rhs(x + dt * k3)
        x = x + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        if model_noise > 0.0:
            x = x + model_noise * keys.normals(x.shape[-1], x.dtype)
        return x

    return transition
