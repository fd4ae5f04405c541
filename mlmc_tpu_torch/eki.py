"""Ensemble Kalman inversion (counterpart of ``mlmc_tpu/eki.py``).

A derivative-free Bayesian calibration: where MCMC (``mcmc.py``) gives
asymptotically exact posteriors at many forward solves, the ensemble
Kalman family gives an approximation from a few dozen forward evaluations
per iteration (Iglesias, Law & Stuart, "Ensemble Kalman methods for
inverse problems", Inverse Problems 29, 2013).

* **ES-MDA** (Emerick & Reynolds, "Ensemble smoother with multiple data
  assimilation", Computers & Geosciences 55, 2013): T damped Kalman
  updates with inflation factors ``alpha_t``, ``sum 1/alpha_t = 1``. For a
  linear forward map and Gaussian prior and noise it samples the exact
  posterior as the ensemble grows.
* **Hierarchical schedule**: the early, large-step updates run on coarse
  models and only the last ones on the fine model.

**Batch contract.** ``forward(theta [J, d]) -> obs [J, K]`` evaluates the
whole ensemble at once, where ``mlmc_tpu`` vmaps a per-theta function
(``mcmc.make_darcy_inverse``'s ``forward`` is such a batch function). Each
update is two anomaly products and a Cholesky solve in observation space
(K x K), a Python loop over the steps on the device; the per-step misfits
stay on the device until one fetch at the end.

**Draws.** The initial ensemble and the perturbations are keyed by
identity (``mcmc.KeyedChainDraws``): member j's initial state is the
initial state of chain j on ``stream``, its perturbation at step t the
normals of chain j at step t on ``stream + 1``. ``draws=`` takes any object
with ``init()`` -> [J, d] and ``draws(t)`` -> xi [J, K] in their place (a
test hands in JAX's).
"""
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.mcmc import KeyedChainDraws
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["esmda", "hierarchical_esmda", "EnsembleDraws"]


def _as_alphas(n_steps, alphas, validate=True):
    if alphas is None:
        alphas = [float(n_steps)] * int(n_steps)
    alphas = [float(a) for a in alphas]
    if len(alphas) != int(n_steps):
        raise ValueError(
            f"len(alphas) = {len(alphas)} must equal n_steps = "
            f"{n_steps} — a shorter schedule would silently drop the "
            "tail updates")
    s = sum(1.0 / a for a in alphas)
    if validate and abs(s - 1.0) > 1e-8:
        raise ValueError(
            "ES-MDA inflation factors must satisfy sum(1/alpha) = 1 "
            f"(got {s:.6f}); e.g. alphas=[4,4,4,4]")
    return alphas


class EnsembleDraws:
    """The draws of an ensemble run from its identities: ``init()`` the
    [J, d] initial ensemble (chain initial states on ``stream``),
    ``draws(t)`` the [J, K] perturbations of step t (``stream + 1``)."""

    def __init__(self, seed, n_ens, d, n_obs, dtype=torch.float64, device=None,
                 stream=0):
        self._init = KeyedChainDraws(seed, n_ens, d, dtype, device, stream)
        self._xi = KeyedChainDraws(seed, n_ens, n_obs, dtype, device, stream + 1)

    def init(self):
        return self._init.init(0)

    def __call__(self, t):
        return self._xi((t,))[0]


def _esmda_update(theta, G, data, noise, alpha, xi, jitter):
    """One damped Kalman update of the ensemble (leading batch dimensions
    run independent ensembles).

    theta [..., J, d], G [..., J, K] forward values, data [K], noise [K]
    (diagonal observation noise sd), xi [..., J, K] standard normals."""
    J = theta.shape[-2]
    th_c = theta - theta.mean(-2, keepdim=True)
    g_c = G - G.mean(-2, keepdim=True)
    c_tg = th_c.mT @ g_c / (J - 1)                     # [..., d, K]
    c_gg = g_c.mT @ g_c / (J - 1)                      # [..., K, K]
    K = G.shape[-1]
    eye = torch.eye(K, dtype=G.dtype, device=G.device)
    A = c_gg + alpha * torch.diag(noise ** 2)
    trace = A.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = A + jitter * trace / K * eye
    # perturbed observations, inflated by sqrt(alpha)
    y_pert = data + float(np.sqrt(alpha)) * noise * xi
    resid = y_pert - G                                 # [..., J, K]
    L = torch.linalg.cholesky(A)
    sol = torch.cholesky_solve(resid.mT, L)            # [..., K, J]
    return theta + (c_tg @ sol).mT


def _rms(G, data, noise):
    return torch.sqrt((((G - data) / noise) ** 2).mean())


def esmda(forward: Callable, data, noise_std, n_ens: int = 64,
          n_steps: int = 4, alphas: Optional[Sequence[float]] = None,
          prior_sampler: Optional[Callable] = None, d: Optional[int] = None,
          seed: int = 0, theta0=None, jitter: float = 1e-9,
          dtype=torch.float64, final_obs: bool = True, device=None,
          draws=None, stream: int = 0, _validate_alphas: bool = True):
    """Ensemble smoother with multiple data assimilation.

    :param forward: ``theta [J, d] -> obs [J, K]``
    :param data: observed values [K]
    :param noise_std: observation noise sd (scalar or [K])
    :param alphas: inflation schedule with ``sum 1/alpha = 1`` (default:
        ``n_steps`` equal factors)
    :param prior_sampler: ``keys -> theta [J, d]`` drawing the prior
        ensemble from the members' ``SampleKeys`` (seed, stream, j); default
        standard normal (requires ``d``)
    :param theta0: explicit initial ensemble [J, d] (overrides both)
    :param final_obs: evaluate the forward once more on the final ensemble
        for ``obs`` and the closing ``misfit`` entry
    :param device: where the ensemble runs; None = ``theta0``'s device, else
        the current CUDA device
    :param draws: ``init()`` / ``draws(t)`` in place of
        :class:`EnsembleDraws` (seed, ..., stream)
    :return: dict with ``theta`` [J, d] final ensemble, ``mean``/``std``
        [d], ``obs`` [J, K] final forward values (None when
        ``final_obs=False``), ``misfit`` per-step RMS data misfit in noise
        sds (the post-update misfit only with ``final_obs``),
        ``n_forward``, ``wall_s``
    """
    alphas = _as_alphas(n_steps, alphas, validate=_validate_alphas)
    device = resolve_device(device, like=theta0)
    data = torch.tensor(np.asarray(data, np.float64)).to(device, dtype)
    noise = torch.broadcast_to(torch.as_tensor(noise_std, dtype=dtype).to(device),
                               data.shape)
    t0 = time.perf_counter()
    if theta0 is None:
        if prior_sampler is not None:
            theta0 = prior_sampler(SampleKeys(
                int(seed), int(stream),
                torch.arange(int(n_ens), dtype=torch.int64, device=device)))
        elif d is None and draws is None:
            raise ValueError("need d (or prior_sampler/theta0)")
    if draws is None:
        J = n_ens if theta0 is None else len(theta0)
        d_ = d if theta0 is None else torch.as_tensor(theta0).shape[-1]
        draws = EnsembleDraws(seed, J, d_, data.shape[0], dtype, device, stream)
    theta = (draws.init() if theta0 is None
             else torch.as_tensor(theta0)).to(device, dtype)
    rms = []
    for t, alpha in enumerate(alphas):
        G = forward(theta)
        rms.append(_rms(G, data, noise))
        theta = _esmda_update(theta, G, data, noise, alpha,
                              draws(t).to(device, dtype), jitter)
    G = forward(theta) if final_obs else None
    if final_obs:
        rms.append(_rms(G, data, noise))
    theta_np = theta.cpu().numpy()
    misfit = [float(v) for v in torch.stack(rms).cpu().numpy()] if rms else []
    G_np = G.cpu().numpy() if final_obs else None
    wall = time.perf_counter() - t0
    return {"theta": theta_np,
            "mean": theta_np.mean(axis=0),
            "std": theta_np.std(axis=0, ddof=1),
            "obs": G_np,
            "misfit": misfit,
            "n_forward": (len(alphas) + int(final_obs)) * theta_np.shape[0],
            "wall_s": wall}


def hierarchical_esmda(forwards: Sequence[Callable], data, noise_std,
                       steps_per_level: Optional[Sequence[int]] = None,
                       n_ens: int = 64, n_steps: int = 4, seed: int = 0,
                       alphas: Optional[Sequence[float]] = None,
                       prior_sampler: Optional[Callable] = None,
                       d: Optional[int] = None, theta0=None,
                       jitter: float = 1e-9, dtype=torch.float64,
                       device=None, draws=None):
    """ES-MDA over a model hierarchy: the early inflated updates run on the
    coarse forwards, only the final ones on the fine model.

    One alpha schedule (``sum 1/alpha = 1`` overall) is split across the
    levels, coarsest first. This mixes models inside one schedule, so the
    exact linear-Gaussian limit holds only when the models agree.

    :param forwards: per-level ``theta [J, d] -> obs [J, K]``, coarsest
        first
    :param steps_per_level: how many of the ``n_steps`` updates each level
        takes (default: spread evenly with the remainder on the coarse
        end, but always at least one fine step)
    :param draws: one :func:`esmda` ``draws`` object per level (default:
        level l's identities on stream ``2 (l + 1)``)
    :return: the :func:`esmda` result of the final (fine) stage with
        ``misfit`` concatenated across stages and ``n_forward`` per level
    """
    L = len(forwards)
    if L < 1:
        raise ValueError("need at least one forward model")
    if steps_per_level is None:
        base = n_steps // L
        steps_per_level = [base] * L
        for i in range(n_steps - base * L):
            steps_per_level[i] += 1
        if steps_per_level[-1] == 0:
            steps_per_level[-1] = 1
            steps_per_level[0] -= 1
    if len(steps_per_level) != L or sum(steps_per_level) != n_steps \
            or steps_per_level[-1] < 1 or min(steps_per_level) < 0:
        raise ValueError("steps_per_level must sum to n_steps with >=1 "
                         "fine step")
    alphas = _as_alphas(n_steps, alphas)
    device = resolve_device(device, like=theta0)
    draws = draws or [None] * L
    theta = theta0
    misfit, n_forward = [], []
    out = None
    pos = 0
    last_lvl = max(lv for lv, t in enumerate(steps_per_level) if t > 0)
    for lvl, (fwd, t) in enumerate(zip(forwards, steps_per_level)):
        if t == 0:
            n_forward.append(0)
            continue
        # this stage runs its alpha slice; sum(1/alpha) over all stages=1
        stage_alphas = alphas[pos:pos + t]
        pos += t
        out = esmda(fwd, data, noise_std, n_ens=n_ens, n_steps=t,
                    alphas=stage_alphas, _validate_alphas=False,
                    seed=seed, theta0=theta, d=d,
                    prior_sampler=prior_sampler, jitter=jitter,
                    dtype=dtype, final_obs=(lvl == last_lvl), device=device,
                    draws=draws[lvl], stream=2 * (lvl + 1))
        theta = out["theta"]
        misfit.extend(out["misfit"])
        n_forward.append(out["n_forward"])
    out["misfit"] = misfit
    out["n_forward"] = n_forward
    return out
