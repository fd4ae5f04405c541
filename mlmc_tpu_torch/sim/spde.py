"""SPDE MLMC: 1-D stochastic reaction-diffusion with space-time white
noise (counterpart of ``mlmc_tpu/sim/spde.py``).

The model on [0, 1] with homogeneous Dirichlet boundaries:

    du = ( nu u_xx + f(u) ) dt + sigma dW(t, x),

``W`` space-time white noise, ``f`` a pointwise reaction term (none: the
stochastic heat equation; ``u - u^3``: stochastic Allen-Cahn).
Discretization: cell-centered finite differences (N cells), semi-implicit
Euler: the Laplacian is implicit and solved exactly per step in its
DST-II eigenbasis, applied as two ``[B, N] x [N, N]`` products in full
float32 (or float64) precision whatever the process's TF32 setting; the
reaction term and the noise are explicit.

Noise: per cell-time box ``DW_i^n ~ N(0, dt/dx)``. Levels couple by box
aggregation: the coarse increment over an ``(m_x dx) x (m_t dt)`` box is
the sum of its fine sub-box increments divided by ``m_x``, summed in a
fixed order (the same bits however the level is cut into batches).
Level parameters are ``[dx, dt]`` pairs.

Draws of a sample (``_from_draws``): ``z [B, n_fine * N_fine]`` standard
normals, fine step by fine step (``mlmc_tpu`` draws coarse step c's
``(m_t, N_f)`` block from ``fold_in(key, c)``; the port's keyed stream
takes normal ``j`` of a sample from its Philox call ``j // 4``).
"""
import dataclasses
from typing import Callable, List, Optional

import numpy as np
import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.sim.sde import PathBatchEntryPoints, _row_sum
from mlmc_tpu_torch.sim.simulation import Simulation, ieee_float32_matmuls, level_cached

__all__ = ["SPDE1D", "stochastic_heat", "allen_cahn",
           "coupled_spde_paths", "SPDESimulation",
           "heat_spde_l2_moment", "discrete_heat_l2_moment"]


@dataclasses.dataclass(frozen=True)
class SPDE1D:
    """``du = (nu u_xx + f(u)) dt + sigma dW`` on [0, 1], Dirichlet.

    :param nu: diffusivity.
    :param sigma: noise amplitude.
    :param reaction: pointwise tensor callable ``u -> f(u)`` or None.
    :param ic: initial condition ``x -> u0(x)`` on numpy cell centers, or
        None (zero).
    """
    nu: float = 1.0
    sigma: float = 1.0
    reaction: Optional[Callable] = None
    ic: Optional[Callable] = None


def stochastic_heat(nu=1.0, sigma=1.0):
    """The additive-noise stochastic heat equation: closed-form Gaussian
    laws at both the discrete and the continuum level."""
    return SPDE1D(nu=nu, sigma=sigma, reaction=None, ic=None)


def allen_cahn(nu=0.01, sigma=0.5, ic=None):
    """Stochastic Allen-Cahn ``f(u) = u - u^3``."""
    if ic is None:
        ic = lambda x: np.sin(np.pi * x)
    return SPDE1D(nu=nu, sigma=sigma, reaction=lambda u: u - u ** 3, ic=ic)


def heat_spde_l2_moment(nu, sigma, T, n_terms=100_000):
    """Continuum ``E ||u(T)||_{L2}^2`` of the zero-IC stochastic heat
    equation: ``sum_k sigma^2 (1 - e^(-2 nu (k pi)^2 T)) / (2 nu (k pi)^2)``."""
    k = np.arange(1, n_terms + 1, dtype=np.float64)
    lam = (k * np.pi) ** 2
    return float(np.sum(sigma ** 2 * -np.expm1(-2.0 * nu * lam * T)
                        / (2.0 * nu * lam)))


def discrete_heat_l2_moment(nu, sigma, T, n_cells, n_steps):
    """Exact ``E ||u(T)||^2 = dx E sum_i u_i^2`` of the semi-implicit
    zero-IC scheme itself: in the DST-II basis each mode is an AR(1)
    ``a' = (a + eta) r_k`` with ``eta ~ N(0, sigma^2 dt/dx)`` and
    ``r_k = 1/(1 + dt nu lam_k)``."""
    N, n = int(n_cells), int(n_steps)
    dx, dt = 1.0 / N, float(T) / n
    k = np.arange(1, N + 1, dtype=np.float64)
    lam = 4.0 * np.sin(k * np.pi / (2 * N)) ** 2 / dx ** 2
    r2 = 1.0 / (1.0 + dt * nu * lam) ** 2
    var = sigma ** 2 * dt / dx * r2 * (1.0 - r2 ** n) / (1.0 - r2)
    return float(dx * np.sum(var))


def _dst_basis(N):
    """Orthonormal DST-II rows ``sin(k pi (i+1/2)/N)`` and the eigenvalues
    of ``-u_xx`` (host float64)."""
    i = np.arange(N)
    k = np.arange(1, N + 1)
    S = np.sin((i[None, :] + 0.5) * k[:, None] * np.pi / N)
    S /= np.linalg.norm(S, axis=1, keepdims=True)
    lam = 4.0 * np.sin(k * np.pi / (2 * N)) ** 2 * N * N
    return S, lam


def _grid(config):
    """(T, N_f, n_f, N_c, n_c, is_l0, m_x, m_t, trips)."""
    model = config["model"]
    if not isinstance(model, SPDE1D):
        raise ValueError("model must be an SPDE1D")
    T = float(config["total_time"])
    N_f, n_f = int(config["n_cells_fine"]), int(config["n_steps_fine"])
    N_c, n_c = int(config["n_cells_coarse"]), int(config["n_steps_coarse"])
    is_l0 = N_c == 0 and n_c == 0
    if not is_l0:
        if N_c == 0 or n_c == 0:
            raise ValueError("coarse cells/steps must both be 0 (level 0) or "
                             "both be positive")
        if N_f % N_c or n_f % n_c:
            raise ValueError("fine grid must refine the coarse grid by integer "
                             "factors (cells %d/%d, steps %d/%d)"
                             % (N_f, N_c, n_f, n_c))
    m_x = 1 if is_l0 else N_f // N_c
    m_t = 1 if is_l0 else n_f // n_c
    return T, N_f, n_f, N_c, n_c, is_l0, m_x, m_t, (n_f if is_l0 else n_c)


def _stepper(config, N, dt, device, dtype):
    """One semi-implicit step ``u, dw -> u'`` on N cells: the forward and
    the weighted backward DST-II matrices live on the device once per
    level."""
    model = config["model"]

    def build():
        S, lam = _dst_basis(N)
        r = 1.0 / (1.0 + dt * model.nu * lam)
        return (torch.tensor(S.T).to(device, dtype),
                torch.tensor((S.T * r[None, :]).T).to(device, dtype))

    fwd, bwd = level_cached(config, ("dst", N, dt, device, dtype), build)
    sigma, f = model.sigma, model.reaction

    def step(u, dw):
        rhs = u + sigma * dw
        if f is not None:
            rhs = rhs + dt * f(u)
        return torch.matmul(torch.matmul(rhs, fwd), bwd)

    return step


def coupled_spde_paths(config, z):
    """Integrate a coupled (fine, coarse) SPDE level batch.

    :param config: dict with ``model`` (:class:`SPDE1D`), ``total_time``,
        ``n_cells_fine``, ``n_steps_fine``, ``n_cells_coarse``,
        ``n_steps_coarse`` (0, 0 on level 0)
    :param z: standard normals [B, n_steps_fine * n_cells_fine], fine step
        by fine step, in the batch's dtype
    :return: ``(u_fine [B, N_f], u_coarse [B, N_c] | None)`` terminal
        fields (cell averages)
    """
    T, N_f, n_f, N_c, n_c, is_l0, m_x, m_t, trips = _grid(config)
    model = config["model"]
    B, dtype, device = z.shape[0], z.dtype, z.device
    dx_f, dt_f = 1.0 / N_f, T / n_f
    dw_all = float(np.sqrt(dt_f / dx_f)) * z.reshape(B, trips, m_t, N_f)
    with ieee_float32_matmuls():
        step_f = _stepper(config, N_f, dt_f, device, dtype)
        step_c = None if is_l0 else _stepper(config, N_c, dt_f * m_t, device, dtype)
        if model.ic is None:
            uf = torch.zeros((B, N_f), dtype=dtype, device=device)
            uc = None if is_l0 else torch.zeros((B, N_c), dtype=dtype, device=device)
        else:
            xf = (np.arange(N_f) + 0.5) * dx_f
            uf = torch.tensor(model.ic(xf)).to(device, dtype).expand(B, N_f)
            uc = None
            if not is_l0:
                xc = (np.arange(N_c) + 0.5) * dx_f * m_x
                uc = torch.tensor(model.ic(xc)).to(device, dtype).expand(B, N_c)
        for c in range(trips):
            dw = dw_all[:, c]                       # [B, m_t, N_f]
            for j in range(m_t):
                uf = step_f(uf, dw[:, j])
            if not is_l0:
                box = _row_sum(_row_sum(dw).reshape(B, N_c, m_x).transpose(1, 2))
                uc = step_c(uc, box / m_x)
    return uf, uc


class SPDESimulation(PathBatchEntryPoints, Simulation):
    """SPDE MLMC under the Simulation contract: level parameters are
    ``[dx, dt]`` pairs, the coupling is box-aggregated shared noise, and
    the stored QoI is a functional of the terminal field.

    Config keys: ``model`` (:class:`SPDE1D`, default
    :func:`stochastic_heat`), ``total_time`` (0.5), ``qoi``: ``'l2sq'``
    (default, ``dx sum u_i^2``), ``'point'`` (the cell containing
    ``qoi_x``, default 0.5), or a callable ``(u [B, N], dx) -> [B] or
    [B, M]``; ``dtype`` ('float32' | 'float64').
    """

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        config.setdefault("model", stochastic_heat())
        if not isinstance(config["model"], SPDE1D):
            raise ValueError("model must be an SPDE1D")
        config.setdefault("total_time", 0.5)
        config.setdefault("qoi", "l2sq")
        config.setdefault("qoi_x", 0.5)
        if isinstance(config["qoi"], str) and config["qoi"] not in ("l2sq", "point"):
            raise ValueError("qoi must be 'l2sq', 'point' or callable")
        self.config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        T = float(self.config["total_time"])
        dx_f, dt_f = (float(p) for p in fine_level_params[:2])
        N_f, n_f = int(round(1.0 / dx_f)), int(round(T / dt_f))
        if coarse_level_params and float(coarse_level_params[0]) != 0:
            dx_c, dt_c = (float(p) for p in coarse_level_params[:2])
            N_c, n_c = int(round(1.0 / dx_c)), int(round(T / dt_c))
        else:
            N_c = n_c = 0
        config = dict(self.config, n_cells_fine=N_f, n_steps_fine=n_f,
                      n_cells_coarse=N_c, n_steps_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config, task_size=float(N_f * n_f),
                               nan_result_is_failure=False)

    @staticmethod
    def _assemble(config, u):
        qoi = config["qoi"]
        N = u.shape[1]
        dx = 1.0 / N
        if qoi == "l2sq":
            return (dx * (u * u).sum(dim=1))[:, None]
        if qoi == "point":
            i = min(int(float(config["qoi_x"]) * N), N - 1)
            return u[:, i][:, None]
        v = qoi(u, dx)
        return v[:, None] if v.dim() == 1 else v

    @staticmethod
    def _n_normals(config):
        return int(config["n_steps_fine"]) * int(config["n_cells_fine"])

    @classmethod
    def _from_draws(cls, config, draws):
        """(fine [B, M], coarse [B, M], failed [B]) from a batch's normals."""
        uf, uc = coupled_spde_paths(config, draws)
        fine = cls._assemble(config, uf)
        coarse = torch.zeros_like(fine) if uc is None else cls._assemble(config, uc)
        return fine, coarse, torch.zeros(fine.shape[0], dtype=torch.bool,
                                         device=fine.device)

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        name = self.config["qoi"] if isinstance(self.config["qoi"], str) else "qoi"
        return [QuantitySpec(name=name, unit="1", shape=(1,), times=[T],
                             locations=["-"])]
