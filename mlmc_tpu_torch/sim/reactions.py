"""Stochastic reaction networks: coupled tau-leaping MLMC and the exact
SSA (counterpart of ``mlmc_tpu/sim/reactions.py``; Anderson & Higham,
"Multilevel Monte Carlo for continuous time Markov chains, with
applications in biochemical kinetics", SIAM MMS 10(1), 2012).

The model is a CTMC on integer species counts ``x in Z^S``: reaction
channel ``k`` fires at propensity ``a_k(x)`` and shifts the state by the
stoichiometric vector ``nu_k``. Two integrators:

* :func:`tau_leap` / :func:`coupled_tau_leap` — explicit tau-leaping, per
  step each channel fires ``Poisson(a_k(x) tau)`` times. The coupling is
  the Anderson-Higham split: over each coarse step the coarse
  propensities ``a_c`` are frozen at the step-start state, and per fine
  substep and channel the common intensity ``b = min(a_f, a_c)`` drives a
  shared count plus two independent remainder counts
  ``Poisson((a_f - b) tau_f)`` / ``Poisson((a_c - b) tau_f)``;
* :func:`ssa_exact` — Gillespie's direct method, batched over a static
  event budget with per-lane done masking; a lane still live after the
  budget is reported in ``overran``: a failed sample, never data.

Counts are carried as floats (integer-valued); propensities are clamped
at 0 before sampling.

Draws (``_from_draws``): one uniform ``v`` in (0, 1] per (fine substep,
stream, channel), ``[B, n_fine, S, R]`` float64, with ``S = 1`` on level 0
and the three streams (common, fine remainder, coarse remainder) on a
coupled level. Departure from ``mlmc_tpu``: the Poisson mean ``a(x) tau``
depends on the state, so a count is the exact inversion of its uniform at
that mean (:func:`poisson_from_uniforms`: ``N = #{k : v <= P(N > k)}``,
float64 regularized incomplete gamma, the search started at a normal
approximation of the quantile), keyed by the sample's identity where
``jax.random.poisson`` draws from a key. The SSA takes one exponential
and R Gumbel variates per candidate event (the Gumbel-max form of
``jax.random.categorical``), from open 53-bit uniforms.
"""
import dataclasses
import math
from typing import Callable, List, Optional

import numpy as np
import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.random.keyed import keyed_words
from mlmc_tpu_torch.sim.sde import PathBatchEntryPoints
from mlmc_tpu_torch.sim.simulation import Simulation, config_dtype

__all__ = ["ReactionNetwork", "mass_action", "immigration_death",
           "dimerization", "schlogl", "tau_leap", "coupled_tau_leap",
           "ssa_exact", "ReactionSimulation", "immigration_death_moments",
           "poisson_from_uniforms"]

#: steps the Poisson inversion may take from its starting guess before it
#: raises (a state that blew up far past any mean the guess tracks)
POISSON_SEARCH_STEPS = 10_000


@dataclasses.dataclass(frozen=True)
class ReactionNetwork:
    """CTMC reaction system.

    :param stoich: ``[n_reactions, n_species]`` integer state changes.
    :param propensity: tensor callable ``x [..., n_species] ->
        a [..., n_reactions]``.
    :param x0: ``[n_species]`` initial counts.
    :param species: optional names (defaults ``X0..``).
    """
    stoich: tuple
    propensity: Callable
    x0: tuple
    species: Optional[tuple] = None

    @property
    def n_species(self):
        return len(self.x0)

    @property
    def n_reactions(self):
        return len(self.stoich)

    @property
    def species_names(self):
        if self.species is not None:
            return list(self.species)
        return ["X%d" % i for i in range(self.n_species)]


def mass_action(rate_constants, reactants):
    """Stochastic mass-action propensities ``a_k(x) = c_k prod_i ff(x_i,
    r_ki)`` with ``ff(x, 0) = 1``, ``ff(x, 1) = x``, ``ff(x, 2) = x (x - 1)
    / 2``; orders above 2 are rejected.

    :return: tensor propensity callable
    """
    c = np.asarray(rate_constants, np.float64)
    r = np.asarray(reactants, np.int64)
    if r.max(initial=0) > 2:
        raise ValueError("mass_action supports reactant orders <= 2")
    if c.shape[0] != r.shape[0]:
        raise ValueError("one rate constant per reaction required")

    def propensity(x):
        xs = x[..., None, :]                           # [..., 1, S]
        ro = torch.as_tensor(r, device=x.device)       # [R, S]
        cs = torch.as_tensor(c, device=x.device).to(x.dtype)
        term = torch.where(ro == 0, torch.ones_like(xs),
                           torch.where(ro == 1, xs, 0.5 * xs * (xs - 1.0)))
        return cs * torch.prod(term, dim=-1)           # [..., R]

    return propensity


def immigration_death(birth=10.0, death=1.0, x0=0):
    """Immigration-death ``0 -> X`` (rate ``birth``), ``X -> 0`` (rate
    ``death * x``): the linear validation network."""
    return ReactionNetwork(stoich=((1,), (-1,)),
                           propensity=mass_action([birth, death], [[0], [1]]),
                           x0=(float(x0),), species=("X",))


def immigration_death_moments(birth, death, x0, t):
    """Exact (mean, var) of the immigration-death count at time t."""
    p = math.exp(-death * t)
    mean = birth / death * (1.0 - p) + x0 * p
    var = birth / death * (1.0 - p) + x0 * p * (1.0 - p)
    return mean, var


def dimerization(c_bind=0.005, c_unbind=0.5, a0=400, b0=0):
    """Reversible dimerization ``2A -> B`` / ``B -> 2A``."""
    return ReactionNetwork(stoich=((-2, 1), (2, -1)),
                           propensity=mass_action([c_bind, c_unbind], [[2, 0], [0, 1]]),
                           x0=(float(a0), float(b0)), species=("A", "B"))


def schlogl(c1=3e-7, c2=1e-4, c3=1e-3, c4=3.5, x0=250):
    """Schlögl's bistable network with the buffered species folded into
    the rate constants (Gillespie 2001's parameter set)."""
    n1, n2 = 1e5, 2e5

    def propensity(x):
        v = x[..., 0]
        return torch.stack([c1 * n1 * v * (v - 1.0) / 2.0,
                            c2 * v * (v - 1.0) * (v - 2.0) / 6.0,
                            torch.full_like(v, c3 * n2),
                            c4 * v], dim=-1)

    return ReactionNetwork(stoich=((1,), (-1,), (1,), (-1,)),
                           propensity=propensity, x0=(float(x0),), species=("X",))


# ---------------------------------------------------------------------- #
# draws
# ---------------------------------------------------------------------- #
def poisson_from_uniforms(v, mean):
    """Poisson(mean) counts by exact inversion of uniforms ``v`` in
    (0, 1]: ``N = #{k : v <= P(N > k)}``, elementwise, any mean >= 0.

    ``P(N > k)`` is the regularized lower incomplete gamma ``P(k + 1,
    mean)`` in float64 (``exp(-mean)`` underflows float32 past mean 87).
    The search starts at the Cornish-Fisher quantile ``mean + sqrt(mean) z
    + (z^2 - 1) / 6``, ``z = -ndtri(v)``, and steps one count at a time
    until ``P(N > k) < v <= P(N > k - 1)``; it raises after
    ``POISSON_SEARCH_STEPS`` steps.

    :return: float64 counts shaped like ``v``
    """
    v = v.to(torch.float64)
    lam = torch.as_tensor(mean, dtype=torch.float64, device=v.device).expand_as(v)
    z = -torch.special.ndtri(v)
    guess = lam + torch.sqrt(lam) * z + (z * z - 1.0) / 6.0
    k = torch.floor(torch.nan_to_num(guess, nan=0.0, posinf=0.0, neginf=0.0)).clamp(min=0.0)
    k = torch.where(lam > 0, k, torch.zeros_like(k))
    for _ in range(POISSON_SEARCH_STEPS):
        up = torch.special.gammainc(k + 1.0, lam) >= v          # P(N > k) >= v
        down = ~up & (k > 0) & (torch.special.gammainc(k, lam) < v)
        if not bool((up | down).any()):
            return k
        k = k + up.to(k.dtype) - down.to(k.dtype)
    raise RuntimeError("Poisson inversion did not settle in %d steps (mean up to %g)"
                       % (POISSON_SEARCH_STEPS, float(lam.max())))


def _uniforms53(words, open_interval=False):
    """53-bit uniforms from word pairs [..., 2]: in (0, 1], or with
    ``open_interval`` in (0, 1) (centers of the 2^53 cells)."""
    hi, lo = words[..., 0], words[..., 1]
    top = ((hi << 21) | (lo >> 11)).to(torch.float64)
    return (top + (0.5 if open_interval else 1.0)) * 2.0 ** -53


def _keyed_uniforms53(seed, level_id, indices, attempts, n, open_interval=False):
    """[B, n] 53-bit uniforms of the samples' keyed streams (two Philox
    words each)."""
    words = keyed_words(seed, level_id, indices, attempts, -(-2 * int(n) // 4))
    return _uniforms53(words[:, :2 * int(n)].reshape(-1, int(n), 2), open_interval)


# ---------------------------------------------------------------------- #
# integrators
# ---------------------------------------------------------------------- #
def _clamped(network, x):
    return torch.clamp(network.propensity(x), min=0.0)


def _stoich(network, x):
    return torch.as_tensor(np.asarray(network.stoich, np.float64)).to(x.device, x.dtype)


def _grid(config):
    network = config["network"]
    if not isinstance(network, ReactionNetwork):
        raise ValueError("network must be a ReactionNetwork")
    T = float(config["total_time"])
    n_f, n_c = int(config["n_fine"]), int(config["n_coarse"])
    is_l0 = n_c == 0
    m = 1 if is_l0 else n_f // n_c
    if not is_l0 and n_f != m * n_c:
        raise ValueError("n_fine=%d must be a multiple of n_coarse=%d" % (n_f, n_c))
    return network, T, n_f, is_l0, m, (n_f if is_l0 else n_c)


def coupled_tau_leap(config, v):
    """Integrate a coupled (fine, coarse) tau-leap level batch.

    :param config: dict with ``network`` (:class:`ReactionNetwork`),
        ``total_time``, ``n_fine``, ``n_coarse`` (0 on level 0); optional
        ``dtype`` of the counts
    :param v: uniforms in (0, 1] [B, n_fine, S, R] (S = 1 on level 0, 3 on
        a coupled level: common, fine remainder, coarse remainder)
    :return: ``(x_fine [B, S], x_coarse [B, S] | None)`` terminal counts
    """
    network, T, n_f, is_l0, m, trips = _grid(config)
    streams = 1 if is_l0 else 3
    if v.dim() != 4 or v.shape[1:] != (n_f, streams, network.n_reactions):
        raise ValueError("draws must be [B, %d, %d, %d], got %s"
                         % (n_f, streams, network.n_reactions, tuple(v.shape)))
    tau_f = T / n_f
    dtype = config_dtype(config)
    B = v.shape[0]
    x0 = torch.tensor(network.x0, dtype=dtype, device=v.device).expand(B, -1)
    nu = _stoich(network, x0)

    def poi(vs, lam):
        return poisson_from_uniforms(vs, lam.to(torch.float64) * tau_f).to(dtype)

    xf = xc = x0
    for c in range(trips):
        a_c = None if is_l0 else _clamped(network, xc)
        for j in range(m):
            vj = v[:, c * m + j]
            a_f = _clamped(network, xf)
            if is_l0:
                xf = xf + poi(vj[:, 0], a_f) @ nu
            else:
                b = torch.minimum(a_f, a_c)
                n_com = poi(vj[:, 0], b)
                xf = xf + (n_com + poi(vj[:, 1], a_f - b)) @ nu
                xc = xc + (n_com + poi(vj[:, 2], a_c - b)) @ nu
    return xf, (None if is_l0 else xc)


def tau_leap(network, total_time, n_steps, keys, dtype=None):
    """Plain explicit tau-leaping: terminal counts ``[B, S]`` after
    ``n_steps`` leaps of ``total_time / n_steps``.

    :param keys: ``random.keyed.SampleKeys`` of the B samples
    """
    cfg = dict(network=network, total_time=float(total_time), n_fine=int(n_steps),
               n_coarse=0)
    if dtype is not None:
        cfg["dtype"] = str(dtype).replace("torch.", "")
    idx = keys.indices
    draws = ReactionSimulation._keyed_draws(cfg, keys.seed, keys.level, idx,
                                            torch.zeros_like(idx))
    return coupled_tau_leap(cfg, draws)[0]


def _ssa_from_draws(network, total_time, e, g, dtype):
    """Gillespie's direct method over the candidate events of the draws.

    :param e: [B, max_steps] standard exponentials (the waiting times)
    :param g: [B, max_steps, R] standard Gumbel variates (the channel:
        ``argmax(g + log a)``)
    :return: ``(x_T [B, S], overran [B] bool)``
    """
    T = float(total_time)
    B, max_steps = e.shape
    x = torch.tensor(network.x0, dtype=dtype, device=e.device).expand(B, -1)
    nu = _stoich(network, x)
    t = torch.zeros(B, dtype=dtype, device=e.device)
    done = torch.zeros(B, dtype=torch.bool, device=e.device)
    tiny = torch.finfo(dtype).tiny
    past = torch.tensor(2.0 * T + 1.0, dtype=dtype, device=e.device)
    for i in range(max_steps):
        a = _clamped(network, x)
        a0 = a.sum(dim=-1)
        dt = e[:, i].to(dtype) / torch.clamp(a0, min=tiny)
        t_new = torch.where(a0 > 0, t + dt, past)          # absorbed: past T
        r = torch.argmax(g[:, i].to(dtype) + torch.log(torch.clamp(a, min=tiny)), dim=-1)
        fire = (t_new <= T) & ~done
        x = torch.where(fire[:, None], x + nu[r], x)
        t = torch.where(fire, t_new, t)
        done = done | ~fire
    return x, ~done


def ssa_exact(network, total_time, keys, max_steps, dtype=None):
    """Batched exact SSA (Gillespie direct method) over a static budget of
    ``max_steps`` candidate events; a lane that is still live after it is
    flagged in ``overran`` (a failed sample, never data).

    :param keys: ``random.keyed.SampleKeys``: event i of a sample takes its
        uniforms 2 (1 + R) i .. from the sample's keyed stream
    :return: ``(x_T [B, S], overran [B] bool)``
    """
    if not isinstance(network, ReactionNetwork):
        raise ValueError("network must be a ReactionNetwork")
    dtype = torch.float32 if dtype is None else dtype
    R, n = network.n_reactions, int(max_steps)
    idx = keys.indices
    u = _keyed_uniforms53(keys.seed, keys.level, idx, torch.zeros_like(idx),
                          n * (1 + R), open_interval=True).reshape(-1, n, 1 + R)
    e = -torch.log(u[..., 0])
    g = -torch.log(-torch.log(u[..., 1:]))
    return _ssa_from_draws(network, total_time, e, g, dtype)


# ---------------------------------------------------------------------- #
# Simulation adapter
# ---------------------------------------------------------------------- #
class ReactionSimulation(PathBatchEntryPoints, Simulation):
    """Tau-leap MLMC over a reaction network: level parameters are leap
    sizes ``[tau]``, ``n_l = round(T / tau_l)``, the coupling is the
    Anderson-Higham split, and the stored QoI is the terminal count vector
    (or a ``qoi`` callable over it).

    Config keys: ``network`` (default :func:`dimerization`), ``total_time``
    (1.0), ``qoi`` (callable ``x [B, S] -> [B] or [B, M]``; default every
    species count), ``dtype`` of the counts ('float32' | 'float64').
    """

    def __init__(self, config=None):
        super().__init__()
        config = dict(config or {})
        config.setdefault("network", dimerization())
        if not isinstance(config["network"], ReactionNetwork):
            raise ValueError("network must be a ReactionNetwork")
        config.setdefault("total_time", 1.0)
        config.setdefault("qoi", None)
        self.config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        T = float(self.config["total_time"])
        n_f = int(round(T / float(fine_level_params[0])))
        tau_c = float(coarse_level_params[0])
        n_c = 0 if tau_c == 0 else int(round(T / tau_c))
        if n_f < 1 or (n_c and (n_f % n_c or n_f <= n_c)):
            raise ValueError("fine leap must refine the coarse leap by an integer "
                             "factor > 1 (got n_fine=%d, n_coarse=%d)" % (n_f, n_c))
        config = dict(self.config, n_fine=n_f, n_coarse=n_c,
                      res_format=self.result_format())
        return LevelSimulation(config_dict=config,
                               task_size=T / float(fine_level_params[0]),
                               nan_result_is_failure=False)

    @staticmethod
    def _draws_shape(config):
        streams = 1 if int(config["n_coarse"]) == 0 else 3
        return int(config["n_fine"]), streams, config["network"].n_reactions

    @classmethod
    def _sample_draws(cls, config, generator, n, device):
        v = 1.0 - torch.rand((int(n),) + cls._draws_shape(config), generator=generator,
                             device=generator.device, dtype=torch.float64)
        return v.to(device)                                     # (0, 1]

    @classmethod
    def _keyed_draws(cls, config, seed, level_id, indices, attempts):
        shape = cls._draws_shape(config)
        v = _keyed_uniforms53(seed, level_id, indices, attempts, int(np.prod(shape)))
        return v.reshape((-1,) + shape)

    @staticmethod
    def _assemble(config, x):
        qoi = config.get("qoi")
        if qoi is None:
            return x
        v = qoi(x)
        return v[:, None] if v.dim() == 1 else v

    @classmethod
    def _from_draws(cls, config, draws):
        xf, xc = coupled_tau_leap(config, draws)
        fine = cls._assemble(config, xf)
        coarse = torch.zeros_like(fine) if xc is None else cls._assemble(config, xc)
        return fine, coarse, torch.zeros(fine.shape[0], dtype=torch.bool,
                                         device=fine.device)

    def result_format(self) -> List[QuantitySpec]:
        T = self.config["total_time"]
        names = (self.config["network"].species_names if self.config.get("qoi") is None
                 else ["qoi"])
        return [QuantitySpec(name=n, unit="count", shape=(1,), times=[T],
                             locations=["-"])
                for n in names]
