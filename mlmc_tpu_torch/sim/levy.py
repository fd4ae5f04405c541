"""Variance-gamma Levy MLMC (counterpart of ``mlmc_tpu/sim/levy.py``).

The variance-gamma process (Madan, Carr & Seneta 1998): Brownian motion
with drift ``theta`` and volatility ``sigma`` time-changed by a gamma
subordinator ``G_t ~ Gamma(t/nu, nu)``,

    ln S_t = ln S_0 + (r + omega) t + theta G_t + sigma W_{G_t},
    omega = ln(1 - theta nu - sigma^2 nu / 2) / nu.

Increments are exact at every grid, so the coarse path is the fine path
restricted to every m-th node: what MLMC telescopes is the monitoring
frequency of path payoffs (Asian averages, extrema); the terminal value
is the same on both levels. Validation anchor: the COS price
(``tool/fourier_pricing``).

Draws of a sample (``_from_draws``): the subordinator increments
``g [B, n_fine]`` (already times ``nu``) and the standard normals
``z [B, n_fine]``.
Departure from ``mlmc_tpu``: each gamma draw is a Marsaglia-Tsang sampler
with a fixed budget of ``GAMMA_PROPOSALS`` proposals, on numbers keyed by
the sample's identity (``jax.random.gamma`` draws from a key); a shape
``a < 1`` is boosted, ``G(a) = G(a + 1) U^{1/a}``, in log space (``U^50``
underflows float32). Acceptance is at least 0.95 at shape >= 1, so the
budget runs out with probability below 1e-15 per draw; exhaustion raises,
it is never clamped. Keyed layout per sample: 7 Philox calls per fine
step j (calls 7j .. 7j + 6): 3 calls of proposal normals, 3 of acceptance
uniforms, one with the boost uniform (word 0) and the step's normal
(words 2, 3).
"""
import dataclasses

import numpy as np
import torch

from mlmc_tpu_torch.random.keyed import _normal_pairs, keyed_words
from mlmc_tpu_torch.sim.sde import PathFunctionals, SDESimulation, _grid
from mlmc_tpu_torch.sim.simulation import config_dtype
from mlmc_tpu_torch.tool.fourier_pricing import cf_vg, cos_price, vg_omega

__all__ = ["VarianceGamma", "variance_gamma", "coupled_vg_functionals",
           "VarianceGammaSimulation", "vg_call_price", "gamma_marsaglia_tsang"]

#: proposals per gamma draw (acceptance >= 0.95: exhaustion < 1e-15)
GAMMA_PROPOSALS = 12
#: Philox calls per fine step of a keyed sample
CALLS_PER_STEP = 7


@dataclasses.dataclass(frozen=True)
class VarianceGamma:
    """Risk-neutral VG exponent: ``rate`` drift (plus the martingale
    compensator omega), Brownian ``theta``/``sigma`` over a gamma clock of
    variance rate ``nu``."""
    rate: float = 0.05
    sigma: float = 0.12
    theta: float = -0.14
    nu: float = 0.2
    s0: float = 1.0


def variance_gamma(rate=0.05, sigma=0.12, theta=-0.14, nu=0.2, s0=1.0):
    """Madan-Carr-Seneta-shaped defaults; checks the martingale
    constraint ``theta nu + sigma^2 nu / 2 < 1``."""
    vg_omega(sigma, theta, nu)
    return VarianceGamma(rate=rate, sigma=sigma, theta=theta, nu=nu, s0=s0)


def vg_call_price(s0, strike, rate, sigma, theta, nu, T, n_terms=1024):
    """European VG call by the COS method (host)."""
    cf = cf_vg(rate, sigma, theta, nu, T)
    return cos_price(cf, s0, strike, rate, T, c1=cf.cumulants[0],
                     c2=cf.cumulants[1], c4=cf.cumulants[2],
                     n_terms=n_terms)


def gamma_marsaglia_tsang(shape, x, u, u_boost):
    """Gamma(shape, 1) variates by Marsaglia-Tsang with a fixed budget.

    :param shape: the gamma shape ``a > 0`` (a Python float)
    :param x: proposal standard normals [..., K]
    :param u: acceptance uniforms in (0, 1) [..., K]
    :param u_boost: uniforms in (0, 1) [...] (used when a < 1)
    :return: float64 variates [...]; raises if a draw rejects all K
        proposals
    """
    a = float(shape)
    if not a > 0.0:
        raise ValueError("gamma shape must be > 0, got %r" % (a,))
    boost = a < 1.0
    d = (a + 1.0 if boost else a) - 1.0 / 3.0
    c = 1.0 / np.sqrt(9.0 * d)
    x = x.to(torch.float64)
    v = (1.0 + c * x) ** 3
    ok = v > 0
    log_v = torch.log(torch.where(ok, v, torch.ones_like(v)))
    accept = ok & (torch.log(u.to(torch.float64))
                   < 0.5 * x * x + d - d * v + d * log_v)
    if not bool(accept.any(dim=-1).all()):
        raise RuntimeError(
            "a gamma draw rejected all %d Marsaglia-Tsang proposals "
            "(probability < 1e-15 per draw at shape %g)" % (x.shape[-1], a))
    first = torch.argmax(accept.to(torch.int8), dim=-1, keepdim=True)
    log_g = torch.log(d * torch.gather(v, -1, first)[..., 0])
    if boost:
        log_g = log_g + torch.log(u_boost.to(torch.float64)) / a
    return torch.exp(log_g)


def coupled_vg_functionals(config, draws):
    """Integrate a coupled (fine, coarse-monitoring) VG level batch.

    :param config: dict with ``model`` (:class:`VarianceGamma`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0)
    :param draws: (g, z): subordinator increments (times ``nu``) and
        standard normals, each [B, n_fine]
    :return: (fine, coarse | None) as ``PathFunctionals``: one exact path,
        monitored at n_fine vs n_coarse nodes
    """
    model = config["model"]
    if not isinstance(model, VarianceGamma):
        raise ValueError("model must be a VarianceGamma")
    T, n_f, n_c, is_l0, m, trips, dt_f, dt_c = _grid(config)
    g, z = draws
    dtype, B = g.dtype, g.shape[0]
    omega = vg_omega(model.sigma, model.theta, model.nu)
    drift = (model.rate + omega) * dt_f
    s0 = torch.full((B,), model.s0, dtype=dtype, device=g.device)
    s, sm, mx, mn = s0, torch.zeros_like(s0), s0, s0
    csm, cmx, cmn = torch.zeros_like(s0), s0, s0
    for c in range(trips):
        for j in range(c * m, (c + 1) * m):
            logi = drift + model.theta * g[:, j] \
                + model.sigma * torch.sqrt(g[:, j]) * z[:, j]
            s = s * torch.exp(logi)
            sm = sm + s
            mx = torch.maximum(mx, s)
            mn = torch.minimum(mn, s)
        if not is_l0:
            csm, cmx, cmn = csm + s, torch.maximum(cmx, s), torch.minimum(cmn, s)
    fine = PathFunctionals(terminal=s, average=(s0 + sm) / (n_f + 1),
                           maximum=mx, minimum=mn)
    if is_l0:
        return fine, None
    return fine, PathFunctionals(terminal=s, average=(s0 + csm) / (n_c + 1),
                                 maximum=cmx, minimum=cmn)


class VarianceGammaSimulation(SDESimulation):
    """VG MLMC under the Simulation contract: exact increments, a
    monitoring-frequency telescope. Config keys: ``model``
    (:class:`VarianceGamma`, default :func:`variance_gamma`),
    ``total_time``, ``payoff``, ``qoi``, ``dtype``; ``scheme``,
    ``antithetic``, ``path_extras`` and ``drift_shift`` do not apply."""

    def __init__(self, config=None):
        config = dict(config or {})
        config.setdefault("model", variance_gamma())
        if not isinstance(config["model"], VarianceGamma):
            raise ValueError("model must be a VarianceGamma")
        for opt in ("antithetic", "path_extras", "drift_shift"):
            if config.get(opt):
                raise ValueError(f"{opt} does not apply to the exact "
                                 "pure-jump VG increments")
        if config.get("scheme", "exact") not in ("exact", "euler"):
            raise ValueError("VG increments are exact; no scheme "
                             "choice applies")
        config["scheme"] = "euler"     # the parent's validation placeholder
        super().__init__(config)

    @staticmethod
    def _paths(config, draws):
        pf_f, pf_c = coupled_vg_functionals(config, draws)
        return pf_f, None, pf_c

    @staticmethod
    def _increments(config, x, u, u_boost, z, dtype):
        model = config["model"]
        shape = float(config["total_time"]) / int(config["n_fine"]) / model.nu
        g = model.nu * gamma_marsaglia_tsang(shape, x, u, u_boost)
        return g.to(dtype), z.to(dtype)

    @classmethod
    def _sample_draws(cls, config, generator, n, device):
        n_f, K = int(config["n_fine"]), GAMMA_PROPOSALS
        kw = dict(generator=generator, device=generator.device, dtype=torch.float64)
        x = torch.randn((int(n), n_f, K), **kw).to(device)
        u = (1.0 - torch.rand((int(n), n_f, K + 1), **kw)).to(device)  # (0, 1]
        z = torch.randn((int(n), n_f), **kw).to(device)
        return cls._increments(config, x, u[..., :K], u[..., K], z,
                               config_dtype(config))

    @classmethod
    def _keyed_draws(cls, config, seed, level_id, indices, attempts):
        n_f, K = int(config["n_fine"]), GAMMA_PROPOSALS
        w = keyed_words(seed, level_id, indices, attempts, CALLS_PER_STEP * n_f)
        w = w.reshape(-1, n_f, CALLS_PER_STEP * 4)
        normals = _normal_pairs(w[..., :K].reshape(-1, K // 4, 4))
        x = normals.reshape(w.shape[0], n_f, K)
        u = (w[..., K:2 * K + 1].to(torch.float64) + 0.5) * 2.0 ** -32
        z = _normal_pairs(w[..., 2 * K:2 * K + 4].reshape(-1, 1, 4))[:, 0, 1, 0]
        return cls._increments(config, x, u[..., :K], u[..., K],
                               z.reshape(w.shape[0], n_f),
                               config_dtype(config))
