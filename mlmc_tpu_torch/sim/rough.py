"""Rough volatility: exact-Gaussian rBergomi MLMC (counterpart of
``mlmc_tpu/sim/rough.py``).

The rBergomi model (Bayer, Friz & Gatheral, Quant. Finance 16(6), 2016):

    v_t = xi0 exp(eta Y_t - eta^2/2 t^(2H)),
    dS  = S sqrt(v_t) (rho dW + sqrt(1 - rho^2) dZ),

with ``Y_t = sqrt(2H) int_0^t (t-s)^(H-1/2) dW_s`` the Riemann-Liouville
fractional Brownian motion. The vector ``(Y_{t_1..t_n}, DW_1..DW_n)`` is
jointly Gaussian with a closed-form covariance; its Cholesky factor is
built once on the host in float64 (numpy and scipy, the same numbers as
``mlmc_tpu``'s) and every path batch is one ``[B, 2n] x [2n, 2n]``
product, in full precision (TF32 refused on a card). The coarse path
restricts the fine one: the same Y at the coarse times, the sums of the
fine increments.

Draws of a sample (``_from_draws``): ``z [B, 2 n_fine]`` standard normals
(the joint factor's input) and ``dz [B, n_fine]`` orthogonal driver
increments already scaled by ``sqrt(h)``. Keyed: the sample's 3 n_fine
normals, ``z`` first.
"""
import dataclasses
from typing import List

import numpy as np
import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.sim.sde import PathBatchEntryPoints, brownian_bridge_increments
from mlmc_tpu_torch.sim.simulation import (Simulation, level_cached,
                                           require_full_precision)

__all__ = ["RBergomi", "rbergomi", "rl_fbm_cov", "rl_fbm_w_cov",
           "joint_cholesky", "joint_pca_factor",
           "coupled_rbergomi_paths", "rbergomi_qmc_level_fns",
           "RBergomiSimulation"]


@dataclasses.dataclass(frozen=True)
class RBergomi:
    """rBergomi parameters: flat forward variance ``xi0``, vol-of-vol
    ``eta``, Hurst ``hurst``, spot/vol correlation ``rho``, spot ``s0``."""
    xi0: float = 0.235 ** 2
    eta: float = 1.9
    hurst: float = 0.1
    rho: float = -0.9
    s0: float = 1.0


def rbergomi(xi0=0.235 ** 2, eta=1.9, hurst=0.1, rho=-0.9, s0=1.0):
    """The Bayer-Friz-Gatheral calibration-shaped parameter set."""
    if not 0.0 < hurst < 1.0:
        raise ValueError("hurst must be in (0, 1)")
    if not -1.0 <= rho <= 1.0:
        raise ValueError("rho must be in [-1, 1]")
    return RBergomi(xi0=xi0, eta=eta, hurst=hurst, rho=rho, s0=s0)


def rl_fbm_cov(times, hurst):
    """Exact covariance of the Riemann-Liouville fBm at ``times`` (host
    float64, scipy ``hyp2f1``):
    ``Cov[Y_s, Y_t] = 2H s^(H+1/2) t^(H-1/2) / (H+1/2) 2F1(1, 1/2-H;
    H+3/2; s/t)`` for s <= t, diagonal ``t^(2H)``."""
    from scipy.special import hyp2f1
    t = np.asarray(times, np.float64)
    n = t.shape[0]
    H = float(hurst)
    g = H + 0.5
    C = np.empty((n, n))
    for i in range(n):
        s = t[i]
        tt = t[i:]
        C[i, i:] = (2.0 * H * s ** g * tt ** (H - 0.5) / g
                    * hyp2f1(1.0, 0.5 - H, H + 1.5, s / tt))
        C[i:, i] = C[i, i:]
        C[i, i] = s ** (2.0 * H)
    return C


def rl_fbm_w_cov(times, grid, hurst):
    """``Cov[Y_{t_i}, DW_j]`` for the Brownian increments over ``grid``,
    from ``Cov[Y_t, W_s] = sqrt(2H)/(H+1/2) (t^(H+1/2) - (t -
    min(s,t))^(H+1/2))`` (host float64)."""
    t = np.asarray(times, np.float64)[:, None]
    g = float(hurst) + 0.5

    def c(tv, sv):
        m = np.minimum(sv[None, :], tv)
        return np.sqrt(2.0 * float(hurst)) / g \
            * (tv ** g - (tv - m) ** g)

    grid = np.asarray(grid, np.float64)
    return c(t, grid[1:]) - c(t, grid[:-1])


def _joint_cov(n, total_time, hurst):
    """Joint covariance of ``(Y_{t_1..t_n}, DW_1..DW_n)`` on the uniform
    grid ``t_i = i T / n`` (host float64)."""
    T = float(total_time)
    times = T / n * np.arange(1, n + 1)
    grid = T / n * np.arange(0, n + 1)
    S = np.empty((2 * n, 2 * n))
    S[:n, :n] = rl_fbm_cov(times, hurst)
    S[:n, n:] = rl_fbm_w_cov(times, grid, hurst)
    S[n:, :n] = S[:n, n:].T
    S[n:, n:] = T / n * np.eye(n)
    return S, times


def joint_cholesky(n, total_time, hurst):
    """Cholesky factor (host float64) of the joint (Y, DW) covariance, and
    the grid times."""
    S, times = _joint_cov(n, total_time, hurst)
    # tiny symmetric jitter guards the float64 factorization at large n
    w, _ = np.linalg.eigh(S)
    jitter = max(0.0, -w.min()) + 1e-14 * S.diagonal().max()
    return np.linalg.cholesky(S + jitter * np.eye(2 * n)), times


def joint_pca_factor(n, total_time, hurst):
    """PCA factor ``F = U sqrt(lam)`` (descending eigenvalues) of the joint
    (Y, DW) covariance: the same law as the Cholesky factor, with the
    largest-variance directions leading (for QMC points)."""
    S, times = _joint_cov(n, total_time, hurst)
    w, U = np.linalg.eigh(S)
    w = np.clip(w[::-1], 0.0, None)
    return U[:, ::-1] * np.sqrt(w)[None, :], times


def _product(x, mat_np, cache, key):
    """``x @ mat`` in full precision, the matrix on x's device once."""
    require_full_precision(x, "the rBergomi paths")
    k = (key, x.device, x.dtype)
    if k not in cache:
        cache[k] = torch.tensor(mat_np).to(x.device, x.dtype)
    return torch.matmul(x, cache[k])


def _paths_from_gaussians(model, T, n_f, n_c, times_np, yw, dz, dtype):
    """Shared integration core: ``yw [B, 2n]`` the correlated (Y, DW)
    vector, ``dz [B, n]`` the orthogonal driver increments (scaled by
    sqrt(h)): -> (s_fine [B], s_coarse [B] | None)."""
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    B = yw.shape[0]
    h_f = T / n_f
    t2h = torch.tensor(times_np ** (2.0 * model.hurst), dtype=dtype, device=yw.device)
    eta, rho, xi0 = model.eta, model.rho, model.xi0
    rho_p = float(np.sqrt(max(1.0 - rho * rho, 0.0)))
    y, dw = yw[:, :n_f], yw[:, n_f:]

    def integrate(y_nodes, dws, dzs, h, t2h_nodes):
        """Euler log-S over one grid: v frozen at the left node of each
        step (v at t=0 is xi0)."""
        v_nodes = xi0 * torch.exp(eta * y_nodes - 0.5 * eta * eta * t2h_nodes)
        v_left = torch.cat([torch.full((B, 1), xi0, dtype=dtype, device=yw.device),
                            v_nodes[:, :-1]], dim=1)
        sq = torch.sqrt(v_left)
        logs = torch.sum(-0.5 * v_left * h + sq * (rho * dws + rho_p * dzs), dim=1)
        return model.s0 * torch.exp(logs)

    s_f = integrate(y, dw, dz, h_f, t2h[None, :])
    if is_l0:
        return s_f, None
    y_c = y[:, m - 1::m]
    dw_c = dw.reshape(B, n_c, m).sum(dim=2)
    dz_c = dz.reshape(B, n_c, m).sum(dim=2)
    s_c = integrate(y_c, dw_c, dz_c, h_f * m, t2h[None, m - 1::m])
    return s_f, s_c


def coupled_rbergomi_paths(config, z, dz):
    """Integrate a coupled (fine, coarse) rBergomi level batch.

    :param config: dict with ``model`` (:class:`RBergomi`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0); the
        Cholesky factor is built once per level and kept in the config
    :param z: standard normals [B, 2 n_fine]
    :param dz: orthogonal driver increments [B, n_fine] (scaled by sqrt(h))
    :return: ``(s_fine [B], s_coarse [B] | None)`` terminal spots
    """
    model = config["model"]
    if not isinstance(model, RBergomi):
        raise ValueError("model must be an RBergomi")
    T = float(config["total_time"])
    n_f = int(config["n_fine"])
    n_c = int(config["n_coarse"])
    if n_c and n_f % n_c:
        raise ValueError("n_fine=%d must be a multiple of n_coarse=%d"
                         % (n_f, n_c))
    L_np, times_np = level_cached(
        config, "joint_cholesky", lambda: joint_cholesky(n_f, T, model.hurst))
    yw = _product(z, L_np.T, config.setdefault("_cache", {}), "L")
    return _paths_from_gaussians(model, T, n_f, n_c, times_np, yw, dz, z.dtype)


def rbergomi_qmc_level_fns(model, total_time, levels, payoff,
                           dtype=torch.float32):
    """MLQMC level functions for rBergomi: per level the point maps
    through ``[joint (Y, DW) PCA | Brownian-bridge dz]`` (both products in
    full precision).

    :param levels: list of ``(n_fine, n_coarse)`` pairs (coarse 0 on
        level 0)
    :return: ``(level_fns, dims)`` for ``qmc.MLQMC`` (``dims[l] = 3
        n_fine``)
    """
    if not isinstance(model, RBergomi):
        raise ValueError("model must be an RBergomi")
    T = float(total_time)
    fns, dims = [], []
    for n_f, n_c in levels:
        n_f, n_c = int(n_f), int(n_c)
        if n_c and (n_f % n_c or n_f <= n_c):
            raise ValueError("fine grid must refine the coarse grid "
                             "by an integer factor > 1")
        F, times_np = joint_pca_factor(n_f, T, model.hurst)
        Rb = brownian_bridge_increments(n_f).T * np.sqrt(T / n_f)
        cache = {}

        def qfn(u, Ft=F.T, Rb=Rb, n_f=n_f, n_c=n_c, times_np=times_np,
                cache=cache):
            z = torch.special.ndtri(u).to(dtype)
            yw = _product(z[:, :2 * n_f], Ft, cache, "F")
            dz = _product(z[:, 2 * n_f:], Rb, cache, "R")
            s_f, s_c = _paths_from_gaussians(model, T, n_f, n_c, times_np,
                                             yw, dz, dtype)
            pf = payoff(s_f)
            return pf, (payoff(s_c) if s_c is not None else torch.zeros_like(pf))

        fns.append(qfn)
        dims.append(3 * n_f)
    return fns, dims


class RBergomiSimulation(PathBatchEntryPoints, Simulation):
    """rBergomi MLMC under the Simulation contract: level parameters are
    time steps ``[h]``, the coupling is the exact-Gaussian restriction, the
    stored QoI is ``payoff(S_T)`` (the terminal spot by default).

    Config keys: ``model`` (:class:`RBergomi`, default :func:`rbergomi`),
    ``total_time`` (1.0), ``payoff`` (``s_T [B] -> [B]``), ``dtype``.
    """

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        config.setdefault("model", rbergomi())
        if not isinstance(config["model"], RBergomi):
            raise ValueError("model must be an RBergomi")
        config.setdefault("total_time", 1.0)
        config.setdefault("payoff", None)
        self.config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        T = float(self.config["total_time"])
        n_f = int(round(T / float(fine_level_params[0])))
        h_c = float(coarse_level_params[0])
        n_c = 0 if h_c == 0 else int(round(T / h_c))
        if n_f < 1 or (n_c and (n_f % n_c or n_f <= n_c)):
            raise ValueError(
                "fine step must refine the coarse step by an integer "
                "factor > 1 (got n_fine=%d, n_coarse=%d)" % (n_f, n_c))
        config = dict(self.config, n_fine=n_f, n_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config,
                               task_size=T / float(fine_level_params[0]),
                               nan_result_is_failure=False)

    @staticmethod
    def _n_normals(config):
        return 3 * int(config["n_fine"])

    @staticmethod
    def _from_draws(config, draws):
        n_f = int(config["n_fine"])
        h_f = float(config["total_time"]) / n_f
        s_f, s_c = coupled_rbergomi_paths(config, draws[:, :2 * n_f],
                                          draws[:, 2 * n_f:] * np.sqrt(h_f))
        payoff = config.get("payoff") or (lambda s: s)
        fine = payoff(s_f)[:, None]
        coarse = torch.zeros_like(fine) if s_c is None else payoff(s_c)[:, None]
        return fine, coarse, torch.zeros(fine.shape[0], dtype=torch.bool,
                                         device=fine.device)

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        return [QuantitySpec(name="payoff", unit="1", shape=(1,),
                             times=[T], locations=["-"])]
