"""Unbiased randomized MLMC (Rhee-Glynn) (counterpart of
``mlmc_tpu/unbiased.py``).

Rhee & Glynn ("Unbiased estimation with square root convergence for SDE
models", Oper. Res. 63(5), 2015) randomize the truncation level: with
level corrections ``Delta_l`` (``Delta_0 = f_0``) and a level distribution
``p_l > 0`` on all of N,

* single-term estimator:  ``Z = Delta_L / p_L``,  ``L ~ p``
* coupled-sum estimator:  ``Z = sum_{l<=N} Delta_l / tail_l``,
  ``tail_l = P(N >= l)``, ``N ~ p``

both satisfy ``E[Z] = lim_l E[f_l]`` exactly.

Level counts are drawn on the host by exact sequential conditioning
(binomials, no per-draw arrays); each level extends its stream of
positions [start, stop) in chunks with the positions outside masked, so
the realized counts stay exact; sample ``i`` of level ``l`` is the
identity (seed, l, i), and a sample mesh splits each chunk over its
shards without changing it. The estimator variance comes from closed
forms in the per-level moment sums.

Level contract: ``level_fn(level, keys) -> Delta_l [C]`` with ``keys`` a
``random.keyed.SampleKeys``; the fine/coarse coupling lives inside the
function (one identity, the same randomness for both resolutions).
"""
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.parallel.mesh import chunk_indices, single_device_mesh
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["GeometricLevels", "UnbiasedMLMC", "synth_unbiased_level_fn",
           "sde_unbiased_level_fn"]


class GeometricLevels:
    """Geometric level distribution ``p_l = (1 - r) r^l`` on l = 0, 1, ...

    The Rhee-Glynn optimum for ``E[Delta_l^2] ~ 2^{-beta l}``,
    ``C_l ~ 2^{gamma l}`` is ``r = 2^{-(beta+gamma)/2}`` (``from_rates``);
    finite variance and finite expected cost both exist iff beta > gamma.
    """

    def __init__(self, r: float):
        r = float(r)
        if not 0.0 < r < 1.0:
            raise ValueError("geometric ratio r must be in (0, 1)")
        self.r = r

    @classmethod
    def from_rates(cls, beta: float, gamma: float):
        if beta <= gamma:
            raise ValueError(
                "beta=%.3g <= gamma=%.3g: no geometric ratio gives finite "
                "variance AND finite expected cost (Rhee-Glynn needs the "
                "level variances to decay faster than costs grow); use a "
                "higher-order coupling (e.g. Milstein) or truncated MLMC"
                % (beta, gamma))
        return cls(2.0 ** (-(beta + gamma) / 2.0))

    def p(self, levels):
        """``p_l`` for an int array of levels."""
        lv = np.asarray(levels)
        return (1.0 - self.r) * self.r ** lv

    def tail(self, levels):
        """``P(L >= l) = r^l``."""
        return self.r ** np.asarray(levels)


class _LevelState:
    __slots__ = ("n", "sum", "sum_sq", "elapsed")

    def __init__(self):
        self.n = 0
        self.sum = 0.0
        self.sum_sq = 0.0
        self.elapsed = 0.0


class UnbiasedMLMC:
    """Adaptive unbiased randomized MLMC over an infinite level hierarchy.

    :param level_fn: ``f(level, keys) -> Delta_l [C]``
    :param levels: a ``GeometricLevels`` (or an object with ``p(l)`` and
        ``tail(l)`` over int arrays)
    :param estimator: ``'single'`` (single-term) or ``'coupled'``
        (coupled-sum); both unbiased
    :param seed: the seed of every sample's identity; the count draws use
        an independent numpy generator seeded from it
    :param cost_fn: optional ``level -> relative cost``; measured wall
        time per sample otherwise
    :param chunk_size: samples per loop step: an int, or ``level -> int``
        (counts are not rounded up: the mask keeps them exact)
    :param dtype: accumulation dtype
    :param max_level: optional hard cap; a count draw beyond it raises
        (truncating would bring back the bias)
    :param mesh: a ``parallel.SampleMesh``: each chunk's positions split
        over the shards (chunk_size must divide by the device count) and
        the two sums summed over the mesh
    :param device: where the chunks run without a mesh; None = the
        current CUDA device
    """

    def __init__(self, level_fn: Callable, levels: GeometricLevels,
                 estimator: str = "single", seed: int = 0,
                 cost_fn: Optional[Callable] = None,
                 chunk_size=1 << 12, dtype=torch.float64,
                 max_level: Optional[int] = None, mesh=None, device=None):
        if estimator not in ("single", "coupled"):
            raise ValueError("estimator must be 'single' or 'coupled'")
        self._fn = level_fn
        self._dist = levels
        self._mode = estimator
        if callable(chunk_size):
            self._chunk_fn = lambda lv: int(chunk_size(lv))
        else:
            self._chunk_fn = lambda lv, c=int(chunk_size): c
        self._chunk = self._chunk_fn(0)
        self._mesh = mesh if mesh is not None else single_device_mesh(device)
        if self._chunk % self._mesh.n_devices:
            raise ValueError(
                "chunk_size=%d must divide by the mesh's %d devices"
                % (self._chunk, self._mesh.n_devices))
        self._dtype = dtype
        self._seed = int(seed)
        self._rng = np.random.default_rng(np.uint32(seed) ^ 0x5DEECE66)
        self._cost_fn = cost_fn
        self._max_level = None if max_level is None else int(max_level)
        self._states = {}
        self.n_draws = 0              # total randomized draws B

    # -------------------------------------------------------------- #
    def _state(self, level):
        st = self._states.get(level)
        if st is None:
            st = self._states[level] = _LevelState()
        return st

    def _shard_sums(self, level, chunk, shard, device, start, stop):
        """Kahan-compensated (sum, sum^2) of Delta_level over this shard's
        part of the chunks that cover positions [start, stop), with the
        positions outside masked."""
        dtype = self._dtype
        z = torch.zeros((), dtype=dtype, device=device)
        s, cs, s2, cs2 = z, z, z, z
        for c in range(start // chunk, -(-stop // chunk)):
            idx = chunk_indices(self._mesh, shard, chunk, c, device)
            d = self._fn(level, SampleKeys(self._seed, level, idx)).to(dtype)
            d = torch.where((idx >= start) & (idx < stop), d,
                            torch.zeros_like(d))
            y = d.sum() - cs
            t = s + y
            s, cs = t, (t - s) - y
            y = (d * d).sum() - cs2
            t = s2 + y
            s2, cs2 = t, (t - s2) - y
        return s - cs, s2 - cs2

    def _extend(self, level, n_add):
        """Evaluate ``n_add`` more Delta_level draws, continuing the
        level's stream; accumulates (n, sum, sum^2) on the host."""
        if n_add <= 0:
            return
        st = self._state(level)
        chunk = self._chunk_fn(level)
        if chunk < 1:
            raise ValueError("chunk_size(level=%d) must be >= 1" % level)
        if chunk % self._mesh.n_devices:
            raise ValueError(
                "chunk_size(level=%d)=%d must divide by the mesh's %d "
                "devices" % (level, chunk, self._mesh.n_devices))
        if st.n + n_add >= (1 << 32) - chunk:
            raise OverflowError("level %d stream exceeds uint32 positions"
                                % level)
        t0 = time.perf_counter()
        s, s2 = self._mesh.reduce([
            self._shard_sums(level, chunk, sh, d, st.n, st.n + int(n_add))
            for sh, d in self._mesh.local_shards()])
        s, s2 = float(s), float(s2)
        st.elapsed += time.perf_counter() - t0
        if not (np.isfinite(s) and np.isfinite(s2)):
            raise FloatingPointError(
                "level %d produced non-finite values" % level)
        st.sum += s
        st.sum_sq += s2
        st.n += int(n_add)

    # -------------------------------------------------------------- #
    def _draw_counts(self, n_draws):
        """Host-side exact level counts for ``n_draws`` randomized draws.

        single: multinomial over the infinite support by sequential
        conditioning, ``N_l ~ Binomial(B_rem, p_l / tail_l)``.
        coupled: survivor counts, ``M_0 = B``,
        ``M_{l+1} ~ Binomial(M_l, tail_{l+1} / tail_l)``.
        Returns a dense list ``counts[l]`` up to the last positive count.
        """
        counts = []
        lv = 0
        if self._mode == "single":
            rem = int(n_draws)
            while rem > 0:
                q = float(self._dist.p(lv) / self._dist.tail(lv))
                n_l = int(self._rng.binomial(rem, min(q, 1.0)))
                counts.append(n_l)
                rem -= n_l
                lv += 1
                self._check_level(lv, rem > 0)
        else:
            m = int(n_draws)
            while m > 0:
                counts.append(m)
                lv += 1
                q = float(self._dist.tail(lv) / self._dist.tail(lv - 1))
                m = int(self._rng.binomial(m, min(q, 1.0)))
                self._check_level(lv, m > 0)
        return counts

    def _check_level(self, level, active):
        if active and self._max_level is not None \
                and level > self._max_level:
            raise RuntimeError(
                "a draw exceeded max_level=%d (probability ~%.2g); raising "
                "rather than truncating, which would bias the estimator"
                % (self._max_level, float(self._dist.tail(level))))

    def sample(self, n_draws):
        """Run ``n_draws`` more randomized draws (batched into per-level
        extensions of the level streams)."""
        for lv, n_l in enumerate(self._draw_counts(n_draws)):
            self._extend(lv, n_l)
        self.n_draws += int(n_draws)

    # -------------------------------------------------------------- #
    def _level_moments(self):
        levels = sorted(lv for lv, st in self._states.items() if st.n)
        n = np.array([self._states[lv].n for lv in levels], dtype=float)
        s = np.array([self._states[lv].sum for lv in levels])
        s2 = np.array([self._states[lv].sum_sq for lv in levels])
        mu = s / n
        m2 = s2 / n
        return np.array(levels), n, mu, m2

    def estimates(self):
        """Point estimate, per-draw variance and expected per-draw cost.

        ``est = (1/B) sum_l w_l sum_i Delta_{l,i}`` with ``w_l = 1/p_l``
        (single) or ``1/tail_l`` (coupled), so ``Var(est) = Var(Z)/B``:

        * single-term: ``Var(Z) = sum_l E[Delta_l^2]/p_l - mu^2``;
        * coupled-sum: ``Var(Z) = sum_l V_l/tail_l + sum_{l,k} mu_l mu_k
          (tail_max(l,k)/(tail_l tail_k) - 1)``, with the diagonal
          ``mu_l^2`` debiased to ``max(mu_hat^2 - V_hat/n, 0)``.

        :return: dict(mean, var, var_per_draw, cost_per_draw, levels,
            level_means, level_m2, n_samples, n_draws)
        """
        levels, n, mu, m2 = self._level_moments()
        if len(levels) == 0:
            raise ValueError("no draws yet — call sample() first")
        if self._mode == "single":
            w = 1.0 / self._dist.p(levels)
            total = float(np.sum(mu * n * w)) / self.n_draws
            var_z = float(np.sum(m2 * w)) - total ** 2
        else:
            tails = self._dist.tail(levels)
            w = 1.0 / tails
            total = float(np.sum(mu * n * w)) / self.n_draws
            v = np.maximum(m2 - mu * mu, 0.0)
            var_z = float(np.sum(v / tails))
            # P(N >= l, N >= k) is the tail of the later level
            t_joint = np.minimum(tails[:, None], tails[None, :])
            cross = (t_joint / (tails[:, None] * tails[None, :])) - 1.0
            diag = np.diag(cross).copy()
            np.fill_diagonal(cross, 0.0)
            var_z += float(mu @ cross @ mu)
            v_bessel = v * (n / np.maximum(n - 1, 1))
            mu2 = np.where(n >= 2,
                           np.maximum(mu * mu - v_bessel / n, 0.0), 0.0)
            var_z += float(np.sum(mu2 * diag))
        var_z = max(var_z, 0.0)
        costs = self._level_costs(levels)
        if self._mode == "single":
            cost = float(np.sum(self._dist.p(levels) * costs))
        else:
            cost = float(np.sum(self._dist.tail(levels) * costs))
        return dict(mean=total, var=var_z / self.n_draws, var_per_draw=var_z,
                    cost_per_draw=cost, levels=levels, level_means=mu,
                    level_m2=m2, n_samples=n.astype(int),
                    n_draws=self.n_draws)

    def _level_costs(self, levels):
        if self._cost_fn is not None:
            return np.array([float(self._cost_fn(int(lv))) for lv in levels])
        measured = np.array([self._states[int(lv)].elapsed
                             / max(self._states[int(lv)].n, 1)
                             for lv in levels])
        if not np.all(measured > 0):
            measured = np.ones(len(levels))
        return measured

    # -------------------------------------------------------------- #
    def run(self, target_var, n_init: int = None, max_rounds: int = 20,
            growth_cap: float = 16.0):
        """Adaptive loop: grow the draw count until ``Var(Z)/B`` meets the
        target. The level distribution stays fixed (reweighting mid-run
        would break the aggregate estimator).

        :return: the ``estimates`` dict + rounds/target_met
        """
        n_init = int(n_init or 4 * self._chunk)
        if self.n_draws == 0:
            self.sample(n_init)
        rounds = 0
        while rounds < max_rounds:
            est = self.estimates()
            if est["var"] <= target_var:
                break
            need = int(np.ceil(est["var_per_draw"] / target_var)) \
                - self.n_draws
            need = min(need, int(growth_cap * self.n_draws))
            # stay inside the uint32 stream guard (the coupled estimator
            # touches level 0 on every draw)
            headroom = (1 << 32) - 2 * self._chunk - self.n_draws
            need = min(need, headroom)
            if need <= 0:
                break
            self.sample(max(need, self._chunk))
            rounds += 1
        est = self.estimates()
        est.update(rounds=rounds, target_met=bool(est["var"] <= target_var))
        return est


# ---------------------------------------------------------------------- #
# adapters
# ---------------------------------------------------------------------- #
def synth_unbiased_level_fn(mean=1.0, c=0.5, rate=1.0, noise=1.0):
    """Synthetic hierarchy with a closed-form limit and exact moments:
    ``f_l = mean + noise Z + c 2^{-rate l} (1 + A)`` with (Z, A) the two
    keyed normals of a sample, so

        ``Delta_0 = mean + noise Z + c (1 + A)``,
        ``Delta_l = c (2^{-rate l} - 2^{-rate (l-1)}) (1 + A)``,

    ``sum_l E[Delta_l] = mean`` exactly and ``E[Delta_l^2] = 2 d_l^2``
    for l >= 1 with ``d_l = c (2^{-rate l} - 2^{-rate(l-1)})``.

    :return: (level_fn, exact_mean)
    """

    def fn(level, keys):
        za = keys.normals(2).to(torch.float64)
        z, a = za[:, 0], za[:, 1]
        if level == 0:
            return mean + noise * z + c * (1.0 + a)
        d = c * (2.0 ** (-rate * level) - 2.0 ** (-rate * (level - 1)))
        return d * (1.0 + a)

    return fn, float(mean)


def sde_unbiased_level_fn(sim, n0: int = 2, refine: int = 2,
                          precision: str = "df64"):
    """Level-correction function for an ``sim.sde.SDESimulation``
    (``qoi='payoff'``): level l integrates with ``n0 * refine^l`` steps,
    fine and coarse sharing one Brownian path, so the estimate targets the
    continuous-time expectation with no discretization bias.

    Milstein's beta ~ 2 > gamma = 1 puts the estimator in its square-root
    regime (``r = 2^{-3/2}`` optimal); Euler's beta ~ gamma is borderline.

    Level l draws ``n0 * refine^l`` keyed normals per sample; the keyed
    stream gives a sample at most 2^22, and raises beyond (a level the
    ladder reaches with probability ``r^l``).

    :param precision: ``'df64'`` (default): the paths integrate in float64
        (``mlmc_tpu`` keeps a double-float state on float32 hardware);
        ``'float'``: in the config's dtype
    :return: ``level_fn(level, keys)`` for :class:`UnbiasedMLMC`
    """
    if sim.config["qoi"] != "payoff":
        raise ValueError("unbiased estimation drives scalar payoffs; "
                         "build the sim with qoi='payoff'")
    T = float(sim.config["total_time"])
    n0 = int(n0)
    refine = int(refine)
    if n0 < 1 or refine < 2:
        raise ValueError("need n0 >= 1 and refine >= 2")
    configs = {}

    def fn(level, keys):
        cfg = configs.get(level)
        if cfg is None:
            n_f = n0 * refine ** level
            fine = [T / n_f]
            coarse = [0.0] if level == 0 else [T / (n_f // refine)]
            cfg = dict(sim.level_instance(fine, coarse).config_dict,
                       precision=precision)
            configs[level] = cfg
        fine_v, coarse_v, _ = type(sim).calculate_keyed_batch(
            cfg, keys.seed, keys.level, keys.indices, torch.zeros_like(keys.indices))
        return fine_v[:, 0] - coarse_v[:, 0]

    return fn
