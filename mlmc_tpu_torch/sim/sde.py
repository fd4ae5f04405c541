"""SDE path simulation (counterpart of ``mlmc_tpu/sim/sde.py``): the
workload multilevel Monte Carlo was invented for (Giles, "Multilevel Monte
Carlo path simulation", Oper. Res. 56(3), 2008), under the same Simulation
contract as the other simulations.

The model is ``dS = a(S, t) dt + b(S, t) dW`` on [0, T]; level l
integrates with ``n_l = round(T / h_l)`` steps and the MLMC coupling
shares one Brownian path: each coarse increment is the sum of its
``m = n_fine / n_coarse`` fine increments.

A level batch advances as ``[B]`` state tensors in a Python loop over the
coarse steps (the ``m`` fine substeps unrolled), so a batch costs a few
kernel launches per step: the loop is launch-bound on a card. The path
functionals (terminal, running average, maximum, minimum) accumulate in
the loop; ``path_extras`` adds the continuous-monitoring corrections (the
Broadie-Glasserman-Kou shifted extrema, the Brownian-bridge barrier
survival, the conditional digital smoothing); ``antithetic`` adds the
Giles-Szpruch twin that reverses each coarse interval's fine increments;
``drift_shift`` is a Girsanov tilt with its exact log likelihood ratio.

Randomness: a batch is a function of its standard normals ``z [B,
n_fine]`` (``_from_draws``), drawn from an explicit generator
(``calculate_batch``) or from the sample's identity (``calculate_keyed_batch``:
``random/keyed`` normals, normal j of a sample is fine step j, so a
sample's path does not depend on how its level is cut into batches).

Departures from ``mlmc_tpu``: ``precision='df64'`` integrates in float64
(the state, the sums and the outputs), where ``mlmc_tpu`` keeps a
double-float pair on float32 hardware; the default dtype is the config's
(``config_dtype``: float32 unless ``dtype='float64'``); the per-step
draws of the keys path come from Philox by sample identity, not from
``normal(fold_in(key, step))``. The Brownian-bridge product of the QMC
adapter must run in full float32, never TF32.
"""
import dataclasses
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.random.keyed import keyed_normals
from mlmc_tpu_torch.sim.simulation import (Simulation, config_dtype, generator_on,
                                           require_full_precision)

__all__ = [
    "SDEModel", "gbm", "ornstein_uhlenbeck", "cir",
    "PathFunctionals", "european_call", "european_put", "asian_call",
    "lookback_call", "digital_call", "terminal_value",
    "lookback_call_bb", "barrier_call_down_out", "digital_call_smoothed",
    "black_scholes_call", "black_scholes_digital", "lookback_call_price",
    "barrier_down_out_call_price", "BGK_BETA", "gbm_call_shift",
    "SDESimulation", "sde_qmc_level_fns",
    "brownian_bridge_increments",
    "SDESystem", "heston", "heston_call_price", "SDESystemSimulation",
    "coupled_path_functionals", "coupled_system_functionals",
    "PathBatchEntryPoints",
]


# ---------------------------------------------------------------------- #
# models
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SDEModel:
    """Scalar SDE ``dS = drift(S, t) dt + diffusion(S, t) dW``.

    :param drift/diffusion: tensor callables ``(s, t) -> value``
    :param diffusion_ds: ``d diffusion / d s``, required by Milstein
    :param s0: initial value
    """

    drift: Callable
    diffusion: Callable
    diffusion_ds: Optional[Callable] = None
    s0: float = 1.0


def gbm(mu=0.05, sigma=0.2, s0=1.0):
    """Geometric Brownian motion ``dS = mu S dt + sigma S dW`` (the
    Black-Scholes asset)."""
    return SDEModel(drift=lambda s, t: mu * s,
                    diffusion=lambda s, t: sigma * s,
                    diffusion_ds=lambda s, t: torch.full_like(s, sigma),
                    s0=s0)


def ornstein_uhlenbeck(kappa=1.0, theta=0.0, sigma=0.5, s0=1.0):
    """Mean-reverting OU ``dS = kappa (theta - S) dt + sigma dW``."""
    return SDEModel(drift=lambda s, t: kappa * (theta - s),
                    diffusion=lambda s, t: torch.full_like(s, sigma),
                    diffusion_ds=lambda s, t: torch.zeros_like(s),
                    s0=s0)


def cir(kappa=1.0, theta=1.0, sigma=0.5, s0=1.0):
    """Cox-Ingersoll-Ross ``dS = kappa (theta - S) dt + sigma sqrt(S) dW``
    in the full-truncation Euler form (coefficients see ``max(S, 0)``);
    use Euler (Milstein's ``b b'`` blows up at 0)."""
    return SDEModel(drift=lambda s, t: kappa * (theta - torch.clamp(s, min=0.0)),
                    diffusion=lambda s, t: sigma * torch.sqrt(torch.clamp(s, min=0.0)),
                    diffusion_ds=None,
                    s0=s0)


# ---------------------------------------------------------------------- #
# payoffs
# ---------------------------------------------------------------------- #
class PathFunctionals(NamedTuple):
    """Per-sample path functionals over the discrete grid (incl. S0).

    ``shifted_minimum`` / ``shifted_maximum`` (BGK continuity correction),
    ``log_survival`` (barrier bridge survival), ``digital_mu`` /
    ``digital_sd`` (the one-step conditional law of the terminal value)
    are set under ``path_extras=True`` only; ``log_weight`` under
    ``drift_shift`` only (see ``mlmc_tpu.sim.sde.PathFunctionals``).
    """

    terminal: torch.Tensor
    average: torch.Tensor
    maximum: torch.Tensor
    minimum: torch.Tensor
    shifted_minimum: Optional[torch.Tensor] = None
    shifted_maximum: Optional[torch.Tensor] = None
    log_survival: Optional[torch.Tensor] = None
    digital_mu: Optional[torch.Tensor] = None
    digital_sd: Optional[torch.Tensor] = None
    #: Girsanov log likelihood ratio under ``drift_shift`` (else None)
    log_weight: Optional[torch.Tensor] = None


#: Broadie-Glasserman-Kou continuity-correction constant -zeta(1/2)/sqrt(2 pi)
BGK_BETA = 0.5825971579390107


def european_call(strike, discount=1.0):
    return lambda pf: discount * torch.clamp(pf.terminal - strike, min=0.0)


def european_put(strike, discount=1.0):
    return lambda pf: discount * torch.clamp(strike - pf.terminal, min=0.0)


def asian_call(strike, discount=1.0):
    """Arithmetic-average Asian call on the discrete grid average."""
    return lambda pf: discount * torch.clamp(pf.average - strike, min=0.0)


def lookback_call(discount=1.0):
    """Floating-strike lookback: ``S_T - min_t S_t``."""
    return lambda pf: discount * (pf.terminal - pf.minimum)


def digital_call(strike, discount=1.0):
    """Cash-or-nothing: pays 1 if ``S_T > K`` (discontinuous: MLMC variance
    decays at beta ~ 1/2)."""
    return lambda pf: discount * (pf.terminal > strike).to(pf.terminal.dtype)


def terminal_value():
    return lambda pf: pf.terminal


def _need_extras(pf, who):
    if pf.shifted_minimum is None:
        raise ValueError(
            f"{who} needs the continuous-monitoring functionals — set "
            "path_extras=True (and 'barrier' for knock-outs) in the "
            "SDE config")


def lookback_call_bb(discount=1.0):
    """Floating-strike lookback on the continuous minimum via the
    BGK-shifted grid minimum. Needs ``path_extras=True``."""

    def payoff(pf):
        _need_extras(pf, "lookback_call_bb")
        return discount * (pf.terminal - pf.shifted_minimum)

    return payoff


def barrier_call_down_out(strike, discount=1.0):
    """Down-and-out call under continuous monitoring: ``(S_T - K)+`` times
    the product of the per-step bridge survival probabilities. Needs
    ``path_extras=True`` and the ``barrier`` config key."""

    def payoff(pf):
        _need_extras(pf, "barrier_call_down_out")
        if pf.log_survival is None:
            raise ValueError("barrier_call_down_out needs the "
                             "'barrier' config key")
        return (discount * torch.clamp(pf.terminal - strike, min=0.0)
                * torch.exp(pf.log_survival))

    return payoff


def digital_call_smoothed(strike, discount=1.0):
    """Cash-or-nothing call by conditional expectation over the final
    step, ``Phi((mu - K)/sd)`` (Giles 2008 §5.3). Needs
    ``path_extras=True``; refuses ``drift_shift``."""

    def payoff(pf):
        _need_extras(pf, "digital_call_smoothed")
        if pf.digital_mu is None:
            raise ValueError(
                "digital_call_smoothed is incompatible with drift_shift: "
                "the likelihood ratio depends on the final increment "
                "that the smoothing integrates out, so the weighted "
                "smoothed payoff would be biased — use digital_call (the "
                "raw indicator weights exactly) or drop the shift")
        z = (pf.digital_mu - strike) / pf.digital_sd
        return discount * 0.5 * (1.0 + torch.erf(z * (1.0 / np.sqrt(2.0))))

    return payoff


def black_scholes_call(s0, strike, rate, sigma, T):
    """Closed-form Black-Scholes European call price (host)."""
    import scipy.stats as st

    if sigma <= 0 or T <= 0:
        return max(s0 - strike * np.exp(-rate * T), 0.0)
    d1 = (np.log(s0 / strike) + (rate + 0.5 * sigma ** 2) * T) \
        / (sigma * np.sqrt(T))
    d2 = d1 - sigma * np.sqrt(T)
    return float(s0 * st.norm.cdf(d1)
                 - strike * np.exp(-rate * T) * st.norm.cdf(d2))


def black_scholes_digital(s0, strike, rate, sigma, T):
    """Closed-form cash-or-nothing call price ``exp(-rT) Phi(d2)``."""
    import scipy.stats as st

    d2 = ((np.log(s0 / strike) + (rate - 0.5 * sigma ** 2) * T)
          / (sigma * np.sqrt(T)))
    return float(np.exp(-rate * T) * st.norm.cdf(d2))


def lookback_call_price(s0, rate, sigma, T):
    """Closed-form floating-strike lookback call (Goldman-Sosin-Gatto
    1979), continuous monitoring."""
    import scipy.stats as st

    a1 = (rate + 0.5 * sigma ** 2) * np.sqrt(T) / sigma
    a2 = a1 - sigma * np.sqrt(T)
    k = 2.0 * rate / sigma ** 2
    return float(s0 * (st.norm.cdf(a1)
                       - np.exp(-rate * T) * st.norm.cdf(a2)
                       - st.norm.cdf(-a1) / k
                       + np.exp(-rate * T) * st.norm.cdf(a2) / k))


def barrier_down_out_call_price(s0, strike, barrier, rate, sigma, T):
    """Closed-form down-and-out call (continuous barrier ``B <= K``,
    ``B < s0``; Merton 1973)."""
    if not (barrier < s0 and barrier <= strike):
        raise ValueError("formula needs barrier < s0 and "
                         "barrier <= strike")
    lam = 1.0 - 2.0 * rate / sigma ** 2
    return float(black_scholes_call(s0, strike, rate, sigma, T)
                 - (s0 / barrier) ** lam * black_scholes_call(
                     barrier ** 2 / s0, strike, rate, sigma, T))


# ---------------------------------------------------------------------- #
# coupled-path loop
# ---------------------------------------------------------------------- #
def gbm_call_shift(mu, sigma, s0, strike, total_time):
    """Girsanov ``drift_shift`` centering a GBM's log-terminal at the
    strike (the deep out-of-the-money tilt, Glasserman 2004 §4.6):
    ``theta = (ln(K/s0) - (mu - sigma^2/2) T) / (sigma T)``."""
    T = float(total_time)
    return float((np.log(strike / s0) - (mu - 0.5 * sigma ** 2) * T)
                 / (sigma * T))


def _scheme_increment(model, scheme, s, t, dw, dt):
    """One integration increment of a [B] state batch."""
    a = model.drift(s, t)
    b = model.diffusion(s, t)
    incr = a * dt + b * dw
    if scheme == "milstein":
        bp = model.diffusion_ds(s, t)
        incr = incr + 0.5 * b * bp * (dw * dw - dt)
    return incr


def _extras_step(model, ex, s_node, s_new, t, dt, cfg):
    """Advance the continuous-monitoring accumulators over one substep
    (``s_node`` -> ``s_new``): BGK-shifted extrema at the new node, the
    barrier bridge log-survival over the interval, the penultimate node."""
    prev, smn, smx, lsv = ex
    sqrt_dt, barrier, bdir = cfg
    b_new = torch.abs(model.diffusion(s_new, t + dt))
    shift = BGK_BETA * sqrt_dt * b_new
    smn = torch.minimum(smn, s_new - shift)
    smx = torch.maximum(smx, s_new + shift)
    if barrier is not None:
        # the relu product is 0 when either node is past the barrier, so
        # p = 1 - exp(0) = 0 there by construction (log -> -inf)
        b = model.diffusion(s_node, t)
        b2 = torch.clamp(b * b, min=1e-30)
        d0 = torch.relu(bdir * (s_node - barrier))
        d1 = torch.relu(bdir * (s_new - barrier))
        p = 1.0 - torch.exp(-2.0 * d0 * d1 / (b2 * dt))
        lsv = lsv + torch.log(p)
    return (s_node, smn, smx, lsv)


def _run_substeps(model, scheme, state, dws, t0, dt, m, reverse, extras_cfg=None):
    """Advance (s, sum, max, min[, extras]) through ``m`` substeps fed by
    the [B, m] increment block (reversed for the antithetic twin)."""
    ex = None
    if extras_cfg is not None:
        state, ex = state[:-4], state[-4:]
    s, sm, mx, mn = state
    for i in range(m):
        dw = dws[:, m - 1 - i] if reverse else dws[:, i]
        t = t0 + i * dt
        s_new = s + _scheme_increment(model, scheme, s, t, dw, dt)
        if ex is not None:
            ex = _extras_step(model, ex, s, s_new, t, dt, extras_cfg)
        s = s_new
        sm = sm + s
        mx = torch.maximum(mx, s)
        mn = torch.minimum(mn, s)
    out = (s, sm, mx, mn)
    return out if ex is None else out + ex


def _row_sum(x):
    """Sum of the few columns of ``x`` [B, m, ...], left to right: each
    sample's sum in a fixed order, whatever the batch's size (a reduction
    kernel may pick its order by the tensor's shape)."""
    out = x[:, 0]
    for j in range(1, x.shape[1]):
        out = out + x[:, j]
    return out


def _grid(config):
    """(T, n_fine, n_coarse, is_l0, m, trips, dt_fine, dt_coarse)."""
    T = float(config["total_time"])
    n_f = int(config["n_fine"])
    n_c = int(config["n_coarse"])
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    if not is_l0 and n_f != m * n_c:
        raise ValueError("n_fine=%d must be a multiple of n_coarse=%d"
                         % (n_f, n_c))
    dt_f = T / n_f
    return T, n_f, n_c, is_l0, m, (n_f if is_l0 else n_c), dt_f, dt_f * m


def coupled_path_functionals(config, z):
    """Integrate a coupled (fine, coarse) level batch from its standard
    normals and return its path functionals.

    :param config: dict with ``model`` (SDEModel), ``scheme`` ('euler' |
        'milstein'), ``total_time``, ``n_fine``, ``n_coarse`` (0 on level
        0), optional ``antithetic``, ``precision`` ('float' | 'df64': a
        float64 state, sums and outputs), ``drift_shift`` (Girsanov tilt
        theta; ``log_weight = -theta W_T - theta^2 T / 2``),
        ``path_extras``, ``barrier``, ``barrier_type``
    :param z: standard-normal increments [B, n_fine]
    :return: (fine, fine_antithetic | None, coarse | None) as
        :class:`PathFunctionals`
    """
    model = config["model"]
    scheme = config.get("scheme", "euler")
    if scheme not in ("euler", "milstein"):
        raise ValueError("scheme must be 'euler' or 'milstein'")
    if scheme == "milstein" and model.diffusion_ds is None:
        raise ValueError("Milstein needs SDEModel.diffusion_ds")
    precision = config.get("precision", "float")
    if precision not in ("float", "df64"):
        raise ValueError("precision must be 'float' or 'df64'")
    T, n_f, n_c, is_l0, m, trips, dt_f, dt_c = _grid(config)
    anti = bool(config.get("antithetic", False)) and m > 1
    theta = float(config.get("drift_shift", 0.0) or 0.0)
    if not np.isfinite(theta):
        raise ValueError("drift_shift must be finite")
    if z.dim() != 2 or z.shape[1] != n_f:
        raise ValueError("z must be [B, n_fine=%d], got %s"
                         % (n_f, tuple(z.shape)))
    if precision == "df64":
        z = z.to(torch.float64)
    dtype, B = z.dtype, z.shape[0]
    sqrt_dt = float(np.sqrt(dt_f))

    extras = bool(config.get("path_extras", False))
    barrier = config.get("barrier")
    if barrier is not None and not extras:
        raise ValueError("'barrier' needs path_extras=True")
    bdir = {"down": 1.0, "up": -1.0}[config.get("barrier_type", "down")]

    s0 = torch.full((B,), model.s0, dtype=dtype, device=z.device)
    zero = torch.zeros_like(s0)
    init = (s0, zero, s0, s0)    # (state, sum of nodes, max, min)
    if extras:
        def init_ex(sq):
            shift0 = BGK_BETA * sq * torch.abs(model.diffusion(s0, 0.0))
            return init + (s0, s0 - shift0, s0 + shift0, zero)

        cfg_f = (float(np.sqrt(dt_f)), barrier, bdir)
        cfg_c = (float(np.sqrt(dt_c)), barrier, bdir)
        fine, coarse = init_ex(cfg_f[0]), init_ex(cfg_c[0])
    else:
        cfg_f = cfg_c = None
        fine = coarse = init
    fine_a, dwh, wsum = fine, zero, zero

    for c in range(trips):
        dws = sqrt_dt * z[:, c * m:(c + 1) * m]          # [B, m]
        if theta:
            # simulate under the shifted drift a + b theta by feeding
            # dW + theta dt into the scheme; the raw-increment sum carries
            # the exact log likelihood ratio, shared by fine, coarse and
            # the antithetic twin
            wsum = wsum + _row_sum(dws)
            dws = dws + theta * dt_f
        t0 = c * dt_c
        fine = _run_substeps(model, scheme, fine, dws, t0, dt_f, m, False, cfg_f)
        if anti:
            fine_a = _run_substeps(model, scheme, fine_a, dws, t0, dt_f, m, True, cfg_f)
        if not is_l0:
            coarse = _run_substeps(model, scheme, coarse, _row_sum(dws)[:, None],
                                   t0, dt_c, 1, False, cfg_c)
            if extras and c == trips - 1:
                # the fine increment over the first m-1 substeps of the
                # last coarse step conditions the coarse digital smoothing
                dwh = _row_sum(dws[:, :m - 1])
    logw = None
    if theta:
        logw = -theta * wsum - 0.5 * theta * theta * T

    def functionals(st, n_nodes, dt, dw_head=None):
        ex = None
        if extras:
            st, ex = st[:-4], st[-4:]
        s, sm, mx, mn = st
        kw = {}
        if ex is not None:
            prev, smn, smx, lsv = ex
            # the terminal's law given the penultimate node (and, for the
            # coarse path, the fine increments of its last step but one
            # substep): both smoothing widths are |b| sqrt(h_fine)
            t_pen = T - dt
            b_pen = model.diffusion(prev, t_pen)
            mu = prev + model.drift(prev, t_pen) * dt
            if dw_head is not None:
                mu = mu + b_pen * dw_head
            sd = torch.abs(b_pen) * np.sqrt(dt_f)
            kw = dict(shifted_minimum=smn, shifted_maximum=smx,
                      log_survival=lsv if barrier is not None else None,
                      digital_mu=mu, digital_sd=torch.clamp(sd, min=1e-30))
            if theta:
                # the smoothing integrates out the final increment, which
                # the likelihood ratio also depends on
                kw["digital_mu"] = kw["digital_sd"] = None
        return PathFunctionals(terminal=s, average=(s0 + sm) / (n_nodes + 1),
                               maximum=mx, minimum=mn, log_weight=logw, **kw)

    return (functionals(fine, n_f, dt_f),
            functionals(fine_a, n_f, dt_f) if anti else None,
            None if is_l0 else functionals(coarse, n_c, dt_c, dwh))


# ---------------------------------------------------------------------- #
# Simulation integration
# ---------------------------------------------------------------------- #
class PathBatchEntryPoints:
    """The entry points of the path simulations (SDE, system, jumps,
    variance gamma, rBergomi). A class that mixes them in says how many
    standard normals a sample draws (``_n_normals``) and computes a batch
    from them (``_from_draws(config, draws)`` -> (fine, coarse, failed));
    a class whose samples draw more extends ``_sample_draws`` and
    ``_keyed_draws``."""

    @classmethod
    def _sample_draws(cls, config, generator, n, device):
        """The draws of ``n`` samples from ``generator``, on ``device``."""
        return torch.randn((int(n), cls._n_normals(config)), generator=generator,
                           device=generator.device,
                           dtype=config_dtype(config)).to(device)

    @classmethod
    def _keyed_draws(cls, config, seed, level_id, indices, attempts):
        """The draws of the samples (seed, level, index, attempt): normal j
        of a sample comes from its Philox call j // 4."""
        return keyed_normals(seed, level_id, indices, attempts,
                             cls._n_normals(config), config_dtype(config))

    @classmethod
    def calculate(cls, config, seed, device=None):
        """One sample from an integer seed, computed on ``device`` (None:
        the current CUDA device): -> (fine [M], coarse [M]) as numpy. The
        draws come from a host generator, so a seed names the same sample
        on every device."""
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(int(seed))
        fine, coarse, _ = cls.calculate_batch(config, generator, 1, device=device)
        return fine[0].cpu().numpy(), coarse[0].cpu().numpy()

    @classmethod
    def calculate_batch(cls, config, generator, n, device=None):
        """Level batch drawn from ``generator``: -> (fine [n, M], coarse
        [n, M], failed [n]) on ``device`` (None: the generator's; with no
        generator the current CUDA device and a fresh generator there,
        seeded by the system)."""
        device = resolve_device(device, like=generator)
        generator = generator_on(device) if generator is None else generator
        return cls._from_draws(config, cls._sample_draws(config, generator, n, device))

    @classmethod
    def calculate_keyed_batch(cls, config, seed, level_id, indices, attempts):
        """Level batch from sample identities (``random/keyed``): a
        sample's path does not depend on how its level is batched."""
        return cls._from_draws(config, cls._keyed_draws(
            config, seed, level_id, indices, attempts))


class SDESimulation(PathBatchEntryPoints, Simulation):
    """MLMC over SDE paths: level parameters are time steps ``[h]``,
    ``n_l = round(T / h_l)``, the coupling shares one Brownian path, and
    the payoff (or the raw path functionals) is the stored QoI.

    Config keys: ``model`` (:class:`SDEModel` or ``'gbm' | 'ou' | 'cir'``),
    ``total_time`` (1.0), ``scheme`` ('euler' | 'milstein'), ``payoff``
    (``PathFunctionals -> [B]``, default the terminal value),
    ``antithetic`` (payoff QoIs only), ``qoi`` ('payoff' | 'functionals':
    terminal, average, maximum, minimum and, under ``drift_shift``, the
    log weight), ``drift_shift``, ``path_extras``, ``barrier``,
    ``precision``, ``dtype`` ('float32' | 'float64').
    """

    _MODELS = {"gbm": gbm, "ou": ornstein_uhlenbeck, "cir": cir}

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        model = config.get("model", "gbm")
        if isinstance(model, str):
            model = self._MODELS[model.lower()]()
        config["model"] = model
        config.setdefault("total_time", 1.0)
        config.setdefault("scheme", "euler")
        config.setdefault("payoff", terminal_value())
        config.setdefault("antithetic", False)
        config.setdefault("qoi", "payoff")
        if config["qoi"] not in ("payoff", "functionals"):
            raise ValueError("qoi must be 'payoff' or 'functionals'")
        if config["qoi"] == "functionals" and config["antithetic"]:
            raise ValueError(
                "antithetic applies to payoff QoIs: the twin paths must be "
                "averaged AFTER the payoff, which post-hoc composition "
                "cannot do")
        self.config = config
        self.need_workspace = False

    # -------------------------------------------------------------- #
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
                               task_size=self.n_ops_estimate(fine_level_params[0]),
                               nan_result_is_failure=False)

    # -------------------------------------------------------------- #
    @staticmethod
    def _assemble(config, pf, pf_anti):
        """Apply the payoff (averaging the antithetic twin, weighting by the
        Girsanov factor) or stack the functionals: a [B, M] block."""
        if config["qoi"] == "payoff":
            payoff = config["payoff"]
            v = payoff(pf)
            if pf_anti is not None:
                v = 0.5 * (v + payoff(pf_anti))
            if pf.log_weight is not None:
                v = v * torch.exp(pf.log_weight)
            return v[:, None]
        cols = [pf.terminal, pf.average, pf.maximum, pf.minimum]
        if pf.log_weight is not None:
            cols.append(pf.log_weight)
        return torch.stack(cols, dim=1)

    @staticmethod
    def _paths(config, draws):
        return coupled_path_functionals(config, draws)

    @staticmethod
    def _n_normals(config):
        return int(config["n_fine"])

    @classmethod
    def _from_draws(cls, config, draws):
        """(fine [B, M], coarse [B, M], failed [B]) from a batch's draws.
        NaN/inf results (a model escaping its domain) are stored and
        masked at estimation, never failed samples."""
        pf_f, pf_fa, pf_c = cls._paths(config, draws)
        fine = cls._assemble(config, pf_f, pf_fa)
        coarse = (torch.zeros_like(fine) if pf_c is None
                  else cls._assemble(config, pf_c, None))
        return fine, coarse, torch.zeros(fine.shape[0], dtype=torch.bool,
                                         device=fine.device)

    # -------------------------------------------------------------- #
    def n_ops_estimate(self, step):
        return float(self.config["total_time"]) / float(step)

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        if self.config["qoi"] == "payoff":
            return [QuantitySpec(name="payoff", unit="1", shape=(1,),
                                 times=[T], locations=["-"])]
        names = ["terminal", "average", "maximum", "minimum"]
        if self.config.get("drift_shift"):
            names.append("log_weight")
        return [QuantitySpec(name=n, unit="1", shape=(1,), times=[T],
                             locations=["-"])
                for n in names]


# ---------------------------------------------------------------------- #
# multi-dimensional systems
# ---------------------------------------------------------------------- #
@dataclasses.dataclass(frozen=True)
class SDESystem:
    """Vector SDE ``dS = drift(S, t) dt + diffusion(S, t) dW`` with state
    ``S in R^dim`` and ``n_drivers`` independent Brownian drivers
    (correlations live inside the diffusion matrix).

    :param drift: ``(s [B, dim], t) -> [B, dim]``
    :param diffusion: ``(s [B, dim], t) -> [B, dim, n_drivers]``
    :param s0: initial state, length ``dim``
    """

    drift: Callable
    diffusion: Callable
    s0: Tuple = (1.0,)
    n_drivers: int = 1

    @property
    def dim(self):
        return len(self.s0)


def heston(mu=0.05, kappa=2.0, theta=0.04, xi=0.3, rho=-0.7,
           s0=1.0, v0=0.04):
    """Heston stochastic-volatility model in full-truncation Euler form;
    the driver correlation is folded into the diffusion matrix. Validate
    against :func:`heston_call_price`."""
    sq1 = float(np.sqrt(1.0 - rho ** 2))

    def drift(s, t):
        v = torch.clamp(s[..., 1], min=0.0)
        return torch.stack([mu * s[..., 0], kappa * (theta - v)], dim=-1)

    def diffusion(s, t):
        sv = torch.sqrt(torch.clamp(s[..., 1], min=0.0))
        zero = torch.zeros_like(sv)
        row_s = torch.stack([sv * s[..., 0], zero], dim=-1)
        row_v = torch.stack([xi * rho * sv, xi * sq1 * sv], dim=-1)
        return torch.stack([row_s, row_v], dim=-2)      # [B, 2, 2]

    return SDESystem(drift=drift, diffusion=diffusion, s0=(s0, v0),
                     n_drivers=2)


def heston_call_price(s0, strike, rate, kappa, theta, xi, rho, v0, T):
    """Semi-analytic Heston European call (Gil-Pelaez inversion of the
    'little Heston trap' characteristic function; host)."""
    from scipy.integrate import quad

    def phi(u, j):
        a = kappa * theta
        b = kappa - rho * xi if j == 1 else kappa
        up = 0.5 if j == 1 else -0.5
        d = np.sqrt((rho * xi * 1j * u - b) ** 2
                    - xi ** 2 * (2 * up * 1j * u - u ** 2))
        g = (b - rho * xi * 1j * u - d) / (b - rho * xi * 1j * u + d)
        exp_dT = np.exp(-d * T)
        C = (rate * 1j * u * T + a / xi ** 2 * (
            (b - rho * xi * 1j * u - d) * T
            - 2 * np.log((1 - g * exp_dT) / (1 - g))))
        D = ((b - rho * xi * 1j * u - d) / xi ** 2
             * (1 - exp_dT) / (1 - g * exp_dT))
        return np.exp(C + D * v0 + 1j * u * np.log(s0))

    def prob(j):
        integrand = lambda u: (np.exp(-1j * u * np.log(strike))
                               * phi(u, j) / (1j * u)).real
        return 0.5 + quad(integrand, 1e-10, 200.0, limit=400)[0] / np.pi

    return float(s0 * prob(1) - strike * np.exp(-rate * T) * prob(2))


def _system_step(model, s, t, dw, dt):
    """Euler-Maruyama step of a [B, dim] state; dw [B, n_drivers]. The
    diffusion product is elementwise (no matmul, so no TF32)."""
    a = model.drift(s, t)
    b = model.diffusion(s, t)
    return s + a * dt + (b * dw[:, None, :]).sum(dim=-1)


def coupled_system_functionals(config, z):
    """Vector analogue of :func:`coupled_path_functionals` (Euler; [B,
    dim] leaves). The antithetic twin reverses each coarse interval's
    [refine, n_drivers] increment block in time.

    :param z: standard normals [B, n_fine, n_drivers] (fine step major)
    """
    model = config["model"]
    if config.get("drift_shift"):
        raise ValueError("drift_shift (Girsanov importance sampling) is "
                         "scalar-SDE only for now")
    T, n_f, n_c, is_l0, m, trips, dt_f, dt_c = _grid(config)
    anti = bool(config.get("antithetic", False)) and m > 1
    nd = model.n_drivers
    if z.dim() != 3 or z.shape[1:] != (n_f, nd):
        raise ValueError("z must be [B, n_fine=%d, n_drivers=%d], got %s"
                         % (n_f, nd, tuple(z.shape)))
    dtype, B = z.dtype, z.shape[0]
    sqrt_dt = float(np.sqrt(dt_f))
    s0 = torch.tensor(model.s0, dtype=dtype, device=z.device).expand(B, model.dim)
    init = (s0, torch.zeros_like(s0), s0, s0)

    def substeps(state, dws, t0, reverse):
        s, sm, mx, mn = state
        for i in range(m):
            dw = dws[:, m - 1 - i] if reverse else dws[:, i]
            s = _system_step(model, s, t0 + i * dt_f, dw, dt_f)
            sm = sm + s
            mx = torch.maximum(mx, s)
            mn = torch.minimum(mn, s)
        return (s, sm, mx, mn)

    fine = fine_a = coarse = init
    for c in range(trips):
        dws = sqrt_dt * z[:, c * m:(c + 1) * m]           # [B, m, nd]
        t0 = c * dt_c
        fine = substeps(fine, dws, t0, False)
        if anti:
            fine_a = substeps(fine_a, dws, t0, True)
        if not is_l0:
            s, sm, mx, mn = coarse
            s = _system_step(model, s, t0, _row_sum(dws), dt_c)
            coarse = (s, sm + s, torch.maximum(mx, s), torch.minimum(mn, s))

    def functionals(st, n_nodes):
        s, sm, mx, mn = st
        return PathFunctionals(terminal=s, average=(s0 + sm) / (n_nodes + 1),
                               maximum=mx, minimum=mn)

    return (functionals(fine, n_f),
            functionals(fine_a, n_f) if anti else None,
            None if is_l0 else functionals(coarse, n_c))


class SDESystemSimulation(SDESimulation):
    """MLMC over vector SDE paths (Euler-Maruyama): ``model`` is an
    :class:`SDESystem` and payoffs act on [B, dim]-leaved
    :class:`PathFunctionals` (e.g. ``lambda pf: torch.clamp(
    pf.terminal[:, 0] - K, min=0)``); ``qoi='functionals'`` stores the four
    functionals of every component (4 * dim quantities). A sample draws
    ``n_fine * n_drivers`` normals, fine step major."""

    _MODELS = {"heston": heston}

    def __init__(self, config=None):
        config = dict(config or {})
        config.setdefault("scheme", "euler")
        if config["scheme"] != "euler":
            raise ValueError(
                "systems integrate with Euler-Maruyama (general Milstein "
                "needs Levy areas; use the scalar SDESimulation for "
                "scalar Milstein)")
        super().__init__(config)

    @staticmethod
    def _assemble(config, pf, pf_anti):
        if config["qoi"] == "payoff":
            payoff = config["payoff"]
            v = payoff(pf)
            if pf_anti is not None:
                v = 0.5 * (v + payoff(pf_anti))
            return v[:, None]
        return torch.cat([pf.terminal, pf.average, pf.maximum, pf.minimum], dim=1)

    @staticmethod
    def _paths(config, draws):
        z = draws.reshape(draws.shape[0], int(config["n_fine"]),
                          config["model"].n_drivers)
        return coupled_system_functionals(config, z)

    @staticmethod
    def _n_normals(config):
        return int(config["n_fine"]) * config["model"].n_drivers

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        if self.config["qoi"] == "payoff":
            return [QuantitySpec(name="payoff", unit="1", shape=(1,),
                                 times=[T], locations=["-"])]
        dim = self.config["model"].dim
        return [QuantitySpec(name=n, unit="1", shape=(dim,), times=[T],
                             locations=["-"])
                for n in ("terminal", "average", "maximum", "minimum")]


# ---------------------------------------------------------------------- #
# quasi-Monte Carlo adapter
# ---------------------------------------------------------------------- #
def brownian_bridge_increments(n):
    """Brownian-bridge construction matrix ``R [n, n]`` (host numpy): for
    bridge-ordered standard normals ``z`` (dimension 0 the terminal value,
    then breadth-first midpoints), ``z @ R.T`` are the n standard-normal
    path increments; ``R @ R.T = I``."""
    n = int(n)
    rows = np.zeros((n + 1, n))       # W(t_i)/sqrt(dt) as combos of z
    rows[n, 0] = np.sqrt(n)
    k = 1
    queue = deque([(0, n)])
    while queue:
        lo, hi = queue.popleft()
        if hi - lo < 2:
            continue
        mid = (lo + hi) // 2
        rows[mid] = ((hi - mid) * rows[lo] + (mid - lo) * rows[hi]) \
            / (hi - lo)
        rows[mid, k] += np.sqrt((mid - lo) * (hi - mid) / (hi - lo))
        k += 1
        queue.append((lo, mid))
        queue.append((mid, hi))
    return np.diff(rows, axis=0)


def sde_qmc_level_fns(sim, level_parameters, bridge=True):
    """QMC level functions for :class:`SDESimulation` (``qoi='payoff'``):
    each point dimension drives one Brownian increment of the fine path
    (the coarse path takes their sums), through the Brownian-bridge matrix
    by default so the leading dimensions set the large-scale path shape.
    The bridge product runs in full precision (TF32 refused on a card).

    :return: (level_fns, dims) for :class:`~mlmc_tpu_torch.qmc.MLQMC`
    """
    if sim.config["qoi"] != "payoff":
        raise ValueError("QMC drives scalar payoffs; build the sim with "
                         "qoi='payoff'")
    fns, dims = [], []
    for lev, params in enumerate(level_parameters):
        coarse = [0] if lev == 0 else level_parameters[lev - 1]
        cfg = sim.level_instance(params, coarse).config_dict
        n_f = cfg["n_fine"]
        Rt = torch.tensor(brownian_bridge_increments(n_f).T) if bridge else None
        cache = {}

        def fn(u, cfg=cfg, Rt=Rt, cache=cache):
            z = torch.special.ndtri(u)
            if Rt is not None:
                require_full_precision(z, "the Brownian-bridge QMC paths")
                key = (z.device, z.dtype)
                if key not in cache:
                    cache[key] = Rt.to(z.device, z.dtype)
                z = torch.matmul(z, cache[key])
            pf_f, pf_fa, pf_c = coupled_path_functionals(cfg, z)
            fine = SDESimulation._assemble(cfg, pf_f, pf_fa)[:, 0]
            if pf_c is None:
                return fine, torch.zeros_like(fine)
            return fine, SDESimulation._assemble(cfg, pf_c, None)[:, 0]

        fns.append(fn)
        dims.append(n_f)
    return fns, dims
