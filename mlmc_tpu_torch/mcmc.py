"""Multilevel Markov chain Monte Carlo (counterpart of ``mlmc_tpu/mcmc.py``).

Posterior expectations E[Q | y] over a discretization hierarchy
(Dodwell, Ketelsen, Scheichl & Teckentrup, "A hierarchical multilevel
Markov chain Monte Carlo algorithm with applications to uncertainty
quantification in subsurface flow", SIAM/ASA JUQ 3, 2015):

* **pCN Metropolis-Hastings** (Cotter, Roberts, Stuart & White, Stat. Sci.
  28, 2013): for a standard-Gaussian prior the proposal ``theta' =
  sqrt(1-beta^2) theta + beta xi`` is prior-reversible, so the acceptance
  ratio is the likelihood ratio alone.
* **Two-level coupled kernel**, ``mode="crn"`` (exact): two pCN chains,
  one per level posterior, joined by the reflection-maximal coupling of
  their proposals and a shared acceptance uniform (Jacob, O'Leary &
  Atchade, JRSS-B 82, 2020); each chain alone is an exact pCN chain, and
  chains that meet stay glued between rare accept/reject mismatches.
  ``mode="dodwell"`` (Dodwell et al. Alg. 3): the fine proposal is the
  state of a free-running coarse chain advanced ``subsample`` sub-steps
  (biased O(rho^subsample) at finite subsampling; offered for parity).
* **Telescoping estimator** ``E_{pi_L}[Q_L] = E_{pi_0}[Q_0] + sum_l (
  E_{pi_l}[Q_l] - E_{pi_{l-1}}[Q_{l-1}])``, one coupled chain per
  correction (:class:`MLMCMC`); coupled-pair debiasing (:func:`run_unbiased`)
  and multilevel delayed acceptance (:func:`run_mlda`).

**Batch contract.** ``loglik_qoi(theta [B, d]) -> (loglik [B], qoi [B,
q])`` evaluates a whole batch of chains at once, where ``mlmc_tpu`` vmaps
a per-theta function: a forward model whose solver runs a data-dependent
loop (CG stopping per sample) cannot go under ``torch.vmap``.
:func:`make_darcy_inverse` returns such batch functions.

**Steps.** Every chain runs as a Python loop over steps on ``[B, d]``
states (``mlmc_tpu`` runs one jitted ``lax.scan``): accept/reject is a
``torch.where`` mask, the Robbins-Monro step size stays a device scalar,
the QoI series stays on the device, and one host fetch ends the run.

**Draws.** Step ``s`` of chain ``b`` draws from the identity (seed,
counter, stream << 32 | b): Philox words keyed by the seed at the counter
(chain low word, stream, WIDE | step counter, call) (``random/keyed``);
``ceil(d/2)`` calls give the innovation ``xi`` (Box-Muller on 52-bit
uniforms) and one more the uniforms (u, w), in (0, 1). Where ``mlmc_tpu``
folds the step into its run key (``fold_in(k_run, step)``, then
``split``), a chain function here takes ``draws``: an object whose
``init(i)`` returns initial state ``i`` [B, d] and whose call on a step's
path returns ``(xi [B, d], u [B], w [B])``. ``KeyedChainDraws`` is the
default; a test hands in JAX's draws to replay ``mlmc_tpu``'s chains.
"""
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops.cuda_kernels import key_words, philox4x32_10
from mlmc_tpu_torch.random.keyed import WIDE
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation, _wave_vectors_2d

__all__ = ["run_pcn", "run_coupled", "run_mlda", "run_unbiased",
           "MLMCMC", "ChainResult", "CoupledResult", "ess",
           "split_rhat", "make_darcy_inverse", "gaussian_loglik",
           "KeyedChainDraws"]


# ---------------------------------------------------------------------- #
# diagnostics (host-side numpy: small [n_out, B] arrays)
# ---------------------------------------------------------------------- #
def ess(series):
    """Effective sample size of an MCMC series by Geyer's initial positive
    sequence, summed over chains.

    :param series: [n, B] per-step values of B chains
    :return: scalar ESS estimate (<= n*B)
    """
    x = np.asarray(series, dtype=np.float64)
    if x.ndim == 1:
        x = x[:, None]
    n, B = x.shape
    x = x - x.mean(axis=0, keepdims=True)
    var = (x * x).mean(axis=0)          # [B]
    total = 0.0
    for b in range(B):
        if var[b] <= 0:
            total += n
            continue
        # autocovariance via FFT
        m = 1 << int(np.ceil(np.log2(2 * n)))
        f = np.fft.rfft(x[:, b], m)
        acov = np.fft.irfft(f * np.conj(f), m)[:n].real / n
        rho = acov / acov[0]
        # Geyer: sum consecutive pairs while positive
        tau = 1.0
        for k in range(1, n - 1, 2):
            pair = rho[k] + rho[k + 1]
            if pair <= 0:
                break
            tau += 2.0 * pair
        total += n / max(tau, 1.0)
    return total


def split_rhat(series):
    """Split-chain Gelman-Rubin potential scale reduction factor: each
    chain is split in half (2B half-chains of length n//2).

    :param series: [n, B]
    """
    x = np.asarray(series, dtype=np.float64)
    n, B = x.shape
    h = n // 2
    if h < 2:
        return 1.0          # too short to diagnose
    halves = np.concatenate([x[:h], x[h:2 * h]], axis=1)   # [h, 2B]
    cm = halves.mean(axis=0)                               # [2B]
    cw = halves.var(axis=0, ddof=1)                        # [2B]
    W = cw.mean()
    Bvar = h * cm.var(ddof=1)
    if W <= 0:
        return 1.0
    var_plus = (h - 1) / h * W + Bvar / h
    return float(np.sqrt(var_plus / W))


# ---------------------------------------------------------------------- #
# draws
# ---------------------------------------------------------------------- #
#: the step counter of the initial states
INIT_STEP = (1 << 31) - 1
#: consecutive steps of a stream whose words one Philox evaluation makes
STEP_BLOCK = 64


class KeyedChainDraws:
    """The draws of B chains from their identities.

    Path ``(s, j_1, ..., j_k)`` (a step and its sub-steps) takes stream
    ``stream + k`` and the counter ``(((s * fanout[0]) + j_1) * fanout[1]
    + j_2) ...``: chain b's words are Philox of (seed; b, stream + k, WIDE |
    counter, call). Calls ``0 .. ceil(d/2) - 1`` give ``xi`` (Box-Muller,
    two normals per call), the next call ``u`` and ``w``. ``init(i)`` is
    the counter ``INIT_STEP`` of ``stream``, calls from ``i * ceil(d/2)``.
    The words of ``STEP_BLOCK`` consecutive counters of a stream are made
    at once (Philox is counter-based: the same words as one at a time).

    :param fanout: sub-steps per step at each depth of a path
    """

    def __init__(self, seed, n_chains, d, dtype=torch.float64, device=None,
                 stream=0, fanout=()):
        self.d, self.dtype = int(d), dtype
        self.device = resolve_device(device)
        self.stream, self.fanout = int(stream), tuple(int(f) for f in fanout)
        self._key = key_words(seed)
        self._chains = torch.arange(int(n_chains), dtype=torch.int64, device=self.device)
        self._calls = -(-self.d // 2)
        self._blocks = {}

    def _words(self, stream, first, n_counters, n_calls, first_call=0):
        """[n_counters, B, 4 * n_calls] words of counters first .. first +
        n_counters - 1 of ``stream``."""
        shape = (n_counters, self._chains.shape[0], n_calls)
        c0 = self._chains[None, :, None].expand(shape)
        c1 = torch.full(shape, int(stream), dtype=torch.int64, device=self.device)
        c2 = (WIDE | (first + torch.arange(n_counters, device=self.device)))[:, None, None]
        c3 = first_call + torch.arange(n_calls, device=self.device)[None, None, :]
        words = philox4x32_10((c0, c1, c2.expand(shape), c3.expand(shape)), self._key)
        return torch.stack(words, dim=-1).reshape(n_counters, shape[1], 4 * n_calls)

    @staticmethod
    def _uniforms(words):
        """(k + 1/2) / 2^52 from the top 26 bits of a word pair, in (0, 1)."""
        w = words.reshape(words.shape[:-1] + (-1, 2))
        k = (w[..., 0] >> 6) * (1 << 26) + (w[..., 1] >> 6)
        return (k.to(torch.float64) + 0.5) * 2.0 ** -52

    def _normals(self, words):
        u = self._uniforms(words).reshape(words.shape[:-1] + (-1, 2))
        r = torch.sqrt(-2.0 * torch.log(u[..., 0]))
        ang = 2.0 * np.pi * u[..., 1]
        z = torch.stack((r * torch.cos(ang), r * torch.sin(ang)), dim=-1)
        return z.reshape(words.shape[:-1] + (-1,))[..., :self.d].to(self.dtype)

    def init(self, i=0):
        """Initial state ``i`` of the chains: [B, d] standard normals."""
        return self._normals(self._words(self.stream, INIT_STEP, 1, self._calls,
                                         i * self._calls)[0])

    def __call__(self, path):
        """``(xi [B, d], u [B], w [B])`` of the step at ``path``."""
        counter = int(path[0])
        for f, j in zip(self.fanout, path[1:]):
            counter = counter * f + int(j)
        if not 0 <= counter < INIT_STEP:
            raise ValueError("a chain takes at most 2^31 - 1 steps per stream")
        stream = self.stream + len(path) - 1
        first = counter - counter % STEP_BLOCK
        block = self._blocks.get(stream)
        if block is None or block[0] != first:
            n = min(STEP_BLOCK, INIT_STEP - first)
            words = self._words(stream, first, n, self._calls + 1)
            u = self._uniforms(words[..., 4 * self._calls:]).to(self.dtype)
            block = (first, self._normals(words[..., :4 * self._calls]), u[..., 0],
                     u[..., 1])
            self._blocks[stream] = block
        k = counter - first
        return block[1][k], block[2][k], block[3][k]


def _start(theta0, draws, i, dtype, device):
    if theta0 is None:
        return draws.init(i).to(device, dtype)
    return torch.as_tensor(theta0).to(device, dtype)


def _fetch(*tensors):
    """Device tensors to numpy at the end of a run."""
    return [t.cpu().numpy() for t in tensors]


# ---------------------------------------------------------------------- #
# single-level pCN
# ---------------------------------------------------------------------- #
class ChainResult:
    """Output of :func:`run_pcn` (and :func:`run_mlda`).

    Attributes: ``qoi`` [n_out, B, q] post-burn thinned QoI series, ``mean``
    [q], ``se`` [q] (across-chain CLT), ``acc_rate``, ``beta``
    (post-adaptation), ``theta`` [B, d] final states, ``ll`` [B] final
    log-likelihoods, ``ess``, ``rhat`` (first QoI component),
    ``n_forward`` forward evaluations performed.
    """

    def __init__(self, qoi, acc_rate, beta, theta, ll, n_forward):
        self.qoi = qoi
        self.acc_rate = float(acc_rate)
        self.beta = float(beta)
        self.theta = theta
        self.ll = ll
        self.n_forward = int(n_forward)
        chain_means = qoi.mean(axis=0)               # [B, q]
        self.mean = chain_means.mean(axis=0)
        B = qoi.shape[1]
        self.se = chain_means.std(axis=0, ddof=1) / np.sqrt(B)
        self.ess = ess(qoi[:, :, 0])
        self.rhat = split_rhat(qoi[:, :, 0])


def _pcn_propose(theta, xi, beta):
    return torch.sqrt(1.0 - beta * beta) * theta + beta * xi


def _rm_beta(beta, acc_mean, step, burn, target=0.234, rate=0.5):
    """Robbins-Monro step-size adaptation on logit(beta), frozen after
    burn-in. The acceptance signal is a whole-batch mean, nearly
    noiseless, so a large gain is safe: beta must be able to fall an order
    of magnitude within the burn-in for concentrated posteriors."""
    if step >= burn:
        return beta
    logit = torch.log(beta) - torch.log1p(-beta)
    gamma = rate / np.sqrt(1.0 + 0.1 * step)
    return 1.0 / (1.0 + torch.exp(-(logit + gamma * (acc_mean - target))))


def _mh(accept, new, old):
    """Keep ``new`` where ``accept`` ([B]), ``old`` elsewhere."""
    return torch.where(accept.view((-1,) + (1,) * (new.dim() - 1)), new, old)


def run_pcn(loglik_qoi: Callable, d: int, n_steps: int, n_chains: int = 32,
            beta: float = 0.3, seed: int = 0, burn: Optional[int] = None,
            thin: int = 1, adapt: bool = True, theta0=None,
            dtype=torch.float64, device=None, draws=None,
            stream: int = 0) -> ChainResult:
    """Run B parallel pCN chains targeting ``prior N(0, I_d) x likelihood``.

    :param loglik_qoi: ``theta [B, d] -> (loglik [B], qoi [B, q])``
    :param d: latent dimension
    :param burn: burn-in steps dropped from the series (default
        ``n_steps // 3``); beta adapts only during burn-in
    :param theta0: optional [B, d] initial states (default: prior draws)
    :param seed: the seed of the chains' identities (``KeyedChainDraws``)
    :param device: where the chains run; None = ``theta0``'s device, else
        the current CUDA device
    :param draws: the draws to take in place of ``KeyedChainDraws(seed,
        ..., stream)``: ``init(0)`` and ``draws((step,))``
    :param stream: the stream of the chains' identities
    :return: :class:`ChainResult`
    """
    device = resolve_device(device, like=theta0)
    if burn is None:
        burn = n_steps // 3
    draws = draws or KeyedChainDraws(seed, n_chains, d, dtype, device, stream)
    theta = _start(theta0, draws, 0, dtype, device)
    ll, qoi = loglik_qoi(theta)
    beta_c = torch.tensor(float(beta), dtype=dtype, device=device)
    acc_sum = torch.zeros((), dtype=dtype, device=device)
    series = []
    for step in range(n_steps):
        xi, u, _ = draws((step,))
        prop = _pcn_propose(theta, xi, beta_c)
        ll_p, qoi_p = loglik_qoi(prop)
        accept = torch.log(u) < (ll_p - ll)
        theta, ll, qoi = _mh(accept, prop, theta), _mh(accept, ll_p, ll), _mh(accept, qoi_p, qoi)
        acc_mean = accept.to(dtype).mean()
        if adapt:
            beta_c = _rm_beta(beta_c, acc_mean, step, burn)
        acc_sum = acc_sum + acc_mean
        series.append(qoi)
    qoi_np, acc_np, beta_np, theta_np, ll_np = _fetch(
        torch.stack(series), acc_sum, beta_c, theta, ll)
    return ChainResult(qoi_np[burn::thin], acc_np / n_steps, beta_np, theta_np,
                       ll_np, n_forward=n_steps * theta.shape[0])


# ---------------------------------------------------------------------- #
# two-level coupled kernel (Dodwell et al. Alg. 3)
# ---------------------------------------------------------------------- #
class CoupledResult:
    """Output of :func:`run_coupled`.

    ``diff`` [n_out, B, q] per-step coupled differences ``Q_f(theta^f) -
    Q_c(theta^c)``; ``mean``/``se`` across-chain CLT on the difference;
    ``acc_rate`` fine-chain acceptance; ``acc_rate_coarse`` the coarse
    chain's (crn) / sub-chain's (dodwell); ``mismatch_rate`` the fraction
    of steps on which exactly one of the two crn chains accepted (equal to
    the dodwell fine-rejection rate there); ``glued_rate`` the fraction of
    (step, chain) pairs whose states were equal (crn; None for dodwell);
    ``qoi_f``/``qoi_c`` the two marginal series."""

    glued_rate = None

    def __init__(self, qoi_f, qoi_c, acc_rate, acc_rate_coarse, beta,
                 mismatch_rate, n_forward_f, n_forward_c):
        self.qoi_f = qoi_f
        self.qoi_c = qoi_c
        self.diff = qoi_f - qoi_c
        self.acc_rate = float(acc_rate)
        self.acc_rate_coarse = float(acc_rate_coarse)
        self.beta = float(beta)
        self.mismatch_rate = float(mismatch_rate)
        self.n_forward_f = int(n_forward_f)
        self.n_forward_c = int(n_forward_c)
        chain_means = self.diff.mean(axis=0)         # [B, q]
        self.mean = chain_means.mean(axis=0)
        B = self.diff.shape[1]
        self.se = chain_means.std(axis=0, ddof=1) / np.sqrt(B)
        self.ess = ess(self.diff[:, :, 0])
        self.rhat = split_rhat(self.diff[:, :, 0])


def _reflection_coupling(th_x, th_y, xi, w, beta, s):
    """The y chain's proposal under the reflection-maximal coupling of
    N(s th_x, beta^2) and N(s th_y, beta^2): the x proposal itself with the
    maximal-coupling probability (``log w < log ratio``), else the
    reflection of the shared innovation across the gap direction."""
    prop_x = s * th_x + beta * xi
    # log N(prop_x; s th_y) - log N(prop_x; s th_x)
    #   = (|beta xi|^2 - |beta xi + z|^2) / (2 beta^2),  z = s(th_x - th_y)
    z = s * (th_x - th_y)
    bxi = beta * xi
    log_ratio = ((bxi * bxi).sum(1) - ((bxi + z) ** 2).sum(1)) / (2 * beta ** 2)
    met = torch.log(w) < log_ratio
    z_norm = torch.sqrt((z * z).sum(1, keepdim=True))
    e = z / torch.where(z_norm > 0, z_norm, 1.0)
    xi_refl = xi - 2.0 * (xi * e).sum(1, keepdim=True) * e
    return prop_x, _mh(met, prop_x, s * th_y + beta * xi_refl)


def run_coupled(loglik_qoi_f: Callable, loglik_qoi_c: Callable, d: int,
                n_steps: int, n_chains: int = 32, beta: float = 0.3,
                subsample: int = 4, seed: int = 0, burn: Optional[int] = None,
                thin: int = 1, adapt: bool = True, theta0=None,
                mode: str = "crn", dtype=torch.float64, device=None,
                draws=None, stream: int = 0) -> CoupledResult:
    """Coupled two-level chain estimating ``E_f[Q_f] - E_c[Q_c]``.

    ``mode="crn"`` (default): both chains take a pCN step every step from
    the same innovation ``xi`` (reflected when the maximal coupling fails,
    ``w``) and the same acceptance uniform ``u``; one fine and one coarse
    solve per chain per step; ``subsample`` is ignored.

    ``mode="dodwell"``: a free-running coarse chain advanced ``subsample``
    sub-steps (paths ``(step, j)``) per step feeds the fine chain's
    proposals, accepted against the step's ``u``.

    With identical level likelihoods both modes are exact fixed points: the
    coupled difference is identically zero.

    :param draws: as in :func:`run_pcn`; ``KeyedChainDraws(..., stream,
        fanout=(subsample,))`` by default (sub-steps on ``stream + 1``)
    """
    if mode not in ("crn", "dodwell"):
        raise ValueError("mode must be 'crn' or 'dodwell'")
    device = resolve_device(device, like=theta0)
    if burn is None:
        burn = n_steps // 3
    draws = draws or KeyedChainDraws(seed, n_chains, d, dtype, device, stream,
                                     fanout=(subsample,))
    theta0 = _start(theta0, draws, 0, dtype, device)
    B = theta0.shape[0]
    beta_c = torch.tensor(float(beta), dtype=dtype, device=device)
    zero = torch.zeros((), dtype=dtype, device=device)
    series_f, series_c = [], []
    if mode == "crn":
        th_f, th_c = theta0, theta0
        ll_f, qoi_f = loglik_qoi_f(theta0)
        ll_c, qoi_c = loglik_qoi_c(theta0)
        acc_f_sum = acc_c_sum = mis_sum = met_sum = zero
        for step in range(n_steps):
            xi, u, w = draws((step,))
            log_u = torch.log(u)
            s = torch.sqrt(1.0 - beta_c * beta_c)
            prop_f, prop_c = _reflection_coupling(th_f, th_c, xi, w, beta_c, s)
            ll_pf, qoi_pf = loglik_qoi_f(prop_f)
            ll_pc, qoi_pc = loglik_qoi_c(prop_c)
            acc_f = log_u < (ll_pf - ll_f)
            acc_c = log_u < (ll_pc - ll_c)
            th_f, ll_f, qoi_f = _mh(acc_f, prop_f, th_f), _mh(acc_f, ll_pf, ll_f), \
                _mh(acc_f, qoi_pf, qoi_f)
            th_c, ll_c, qoi_c = _mh(acc_c, prop_c, th_c), _mh(acc_c, ll_pc, ll_c), \
                _mh(acc_c, qoi_pc, qoi_c)
            acc_fm, acc_cm = acc_f.to(dtype).mean(), acc_c.to(dtype).mean()
            acc_f_sum = acc_f_sum + acc_fm
            acc_c_sum = acc_c_sum + acc_cm
            mis_sum = mis_sum + (acc_f ^ acc_c).to(dtype).mean()
            met_sum = met_sum + (th_f == th_c).all(1).to(dtype).mean()
            if adapt:
                beta_c = _rm_beta(beta_c, 0.5 * (acc_fm + acc_cm), step, burn)
            series_f.append(qoi_f)
            series_c.append(qoi_c)
        qf, qc, af, ac, mis, met, beta_np = _fetch(
            torch.stack(series_f), torch.stack(series_c), acc_f_sum, acc_c_sum,
            mis_sum, met_sum, beta_c)
        res = CoupledResult(qf[burn::thin], qc[burn::thin], af / n_steps, ac / n_steps,
                            beta_np, mismatch_rate=mis / n_steps,
                            n_forward_f=n_steps * B, n_forward_c=n_steps * B)
        res.glued_rate = float(met / n_steps)
        return res

    th_c = th_f = theta0
    ll_c, qoi_c = loglik_qoi_c(theta0)
    ll_fc = ll_c                                   # the fine state's coarse ll
    ll_ff, qoi_f = loglik_qoi_f(theta0)
    acc_sum = acc_sub_sum = zero
    for step in range(n_steps):
        accs = []
        for j in range(subsample):
            xi, u, _ = draws((step, j))
            prop = _pcn_propose(th_c, xi, beta_c)
            ll_p, qoi_p = loglik_qoi_c(prop)
            accept = torch.log(u) < (ll_p - ll_c)
            th_c, ll_c, qoi_c = _mh(accept, prop, th_c), _mh(accept, ll_p, ll_c), \
                _mh(accept, qoi_p, qoi_c)
            accs.append(accept.to(dtype).mean())
        _, u, _ = draws((step,))
        ll_pf, qoi_pf = loglik_qoi_f(th_c)
        accept = torch.log(u) < (ll_pf - ll_ff) - (ll_c - ll_fc)
        th_f, ll_ff = _mh(accept, th_c, th_f), _mh(accept, ll_pf, ll_ff)
        ll_fc, qoi_f = _mh(accept, ll_c, ll_fc), _mh(accept, qoi_pf, qoi_f)
        acc_sub = torch.stack(accs).mean()
        acc_sum = acc_sum + accept.to(dtype).mean()
        acc_sub_sum = acc_sub_sum + acc_sub
        if adapt:
            beta_c = _rm_beta(beta_c, acc_sub, step, burn)
        series_f.append(qoi_f)
        series_c.append(qoi_c)
    qf, qc, acc_np, accs_np, beta_np = _fetch(
        torch.stack(series_f), torch.stack(series_c), acc_sum, acc_sub_sum, beta_c)
    return CoupledResult(qf[burn::thin], qc[burn::thin], acc_np / n_steps,
                         accs_np / n_steps, beta_np, mismatch_rate=1.0 - acc_np / n_steps,
                         n_forward_f=n_steps * B, n_forward_c=n_steps * subsample * B)


# ---------------------------------------------------------------------- #
# Unbiased MCMC: coupled-pair debiasing (Jacob-O'Leary-Atchade 2020)
# ---------------------------------------------------------------------- #
def run_unbiased(loglik_qoi: Callable, d: int, k: int = 50,
                 m: Optional[int] = None, n_pairs: int = 64,
                 beta: float = 0.3, n_max: Optional[int] = None,
                 seed: int = 0, theta0_sampler: Optional[Callable] = None,
                 dtype=torch.float64, device=None, draws=None, stream: int = 0):
    """Unbiased posterior expectations by coupled-chain debiasing (Jacob,
    O'Leary & Atchade, JRSS-B 82, 2020): a lag-1 pair of pCN chains
    (X_t, Y_{t-1}) of the same kernel, joined by the reflection-maximal
    proposal coupling and a shared acceptance uniform, meets at a random
    time tau and stays glued; the estimator

        H = mean_{t=k..m} Q(X_t)
            + sum_{t=k+1..tau-1} min(1, (t-k)/(m-k+1)) (Q(X_t) - Q(Y_{t-1}))

    has ``E[H] = E[Q | data]`` at any k. The loop runs to ``n_max``; pairs
    with ``tau > n_max`` are truncated, reported as ``frac_unmet`` with a
    warning. The kernel stays fixed (no adaptation): tune ``beta`` on a
    pilot :func:`run_pcn`.

    :param loglik_qoi: ``theta [B, d] -> (loglik [B], qoi [B, q])``
    :param k / m: burn-in and averaging horizon (m defaults to 5k)
    :param n_max: steps >= m (default ``m + 4 k``), the truncation bound
    :param theta0_sampler: ``i -> [n_pairs, d]`` initial state of chain
        ``i`` (0: X, 1: Y); default ``draws.init(i)``, N(0, I)
    :param draws: as in :func:`run_pcn`: X's solo step is the path ``(0,)``,
        step t of the pair ``(t,)``
    :return: dict with ``mean`` [q], ``se`` [q] (iid across-pair CLT),
        ``H`` [n_pairs, q], ``tau`` [n_pairs] meeting times, ``frac_unmet``,
        ``acc_rate``, ``n_forward``, ``wall_s``
    """
    if m is None:
        m = 5 * k
    if n_max is None:
        n_max = m + 4 * k
    if not 1 <= k <= m or n_max < m:
        raise ValueError(f"need 1 <= k <= m <= n_max, got "
                         f"k={k}, m={m}, n_max={n_max}")
    if not 0.0 < beta < 1.0:
        raise ValueError("beta must be in (0, 1)")
    device = resolve_device(device)
    B = int(n_pairs)
    draws = draws or KeyedChainDraws(seed, B, d, dtype, device, stream)
    sampler = theta0_sampler or draws.init
    x0, y = (torch.as_tensor(sampler(i)).to(device, dtype) for i in (0, 1))
    beta_c = torch.tensor(float(beta), dtype=dtype, device=device)
    s = torch.sqrt(1.0 - beta_c * beta_c)
    kk, mm = float(k), float(m)
    t0 = time.perf_counter()

    llx, qx = loglik_qoi(x0)
    lly, qy = loglik_qoi(y)
    # X takes one solo step: the pair is (X_1, Y_0) entering t=1
    xi, u, _ = draws((0,))
    prop = s * x0 + beta_c * xi
    ll_p, q_p = loglik_qoi(prop)
    acc = torch.log(u) < (ll_p - llx)
    x, llx, qx = _mh(acc, prop, x0), _mh(acc, ll_p, llx), _mh(acc, q_p, qx)
    S = torch.zeros_like(qx)
    BC = torch.zeros_like(qx)
    tau = torch.full((B,), -1.0, dtype=dtype, device=device)
    acc_sum = torch.zeros((), dtype=dtype, device=device)
    for t in range(1, n_max + 1):
        tf = float(t)
        # accumulate at time t using (X_t, Y_{t-1})
        if kk <= tf <= mm:
            S = S + qx
        if tf >= kk + 1.0:
            BC = BC + min(1.0, (tf - kk) / (mm - kk + 1.0)) * (qx - qy)
        tau = torch.where((tau < 0) & (x == y).all(1), tf, tau)
        xi, u, w = draws((t,))
        log_u = torch.log(u)
        prop_x, prop_y = _reflection_coupling(x, y, xi, w, beta_c, s)
        ll_px, q_px = loglik_qoi(prop_x)
        ll_py, q_py = loglik_qoi(prop_y)
        acc_x = log_u < (ll_px - llx)
        acc_y = log_u < (ll_py - lly)
        x, llx, qx = _mh(acc_x, prop_x, x), _mh(acc_x, ll_px, llx), _mh(acc_x, q_px, qx)
        y, lly, qy = _mh(acc_y, prop_y, y), _mh(acc_y, ll_py, lly), _mh(acc_y, q_py, qy)
        acc_sum = acc_sum + acc_x.to(dtype).mean()
    # the t = n_max state never accumulated; close the window
    t_end = float(n_max + 1)
    if kk <= t_end <= mm:
        S = S + qx
    BC = BC + min(1.0, (t_end - kk) / (mm - kk + 1.0)) * (qx - qy)
    tau = torch.where((tau < 0) & (x == y).all(1), t_end, tau)
    H = S / (mm - kk + 1.0) + BC
    H, tau, acc = _fetch(H.to(torch.float64), tau.to(torch.float64), acc_sum / n_max)
    wall = time.perf_counter() - t0
    unmet = tau < 0
    if np.any(unmet):
        warnings.warn(
            f"{int(unmet.sum())}/{B} chain pairs did not meet within "
            f"n_max={n_max}; the estimator is truncation-biased — "
            "raise n_max or beta-tune on a pilot", RuntimeWarning)
    return {"mean": H.mean(axis=0),
            "se": H.std(axis=0, ddof=1) / np.sqrt(B),
            "H": H, "tau": tau, "frac_unmet": float(unmet.mean()),
            "acc_rate": float(acc),
            "n_forward": B * (2 * n_max + 3),
            "wall_s": wall}


# ---------------------------------------------------------------------- #
# MLDA: multilevel delayed acceptance (exact fine-posterior sampler)
# ---------------------------------------------------------------------- #
def run_mlda(loglik_qoi_fns: Sequence[Callable], d: int, n_steps: int,
             n_chains: int = 32, subsamples=4, beta: float = 0.3,
             seed: int = 0, burn: Optional[int] = None, thin: int = 1,
             theta0=None, dtype=torch.float64, device=None, draws=None,
             stream: int = 0) -> ChainResult:
    """Multilevel delayed acceptance: exact sampling of the finest posterior
    with most proposals screened by the coarse hierarchy (Lykkegaard,
    Dodwell et al., SIAM/ASA JUQ 11, 2023). The level-l proposal is the end
    state of a level-(l-1) sub-chain of ``subsamples[l-1]`` steps started
    at the current level-l state (pCN at level 0); each sub-chain kernel is
    reversible for its own posterior, so the proposal density cancels and
    the fine marginal is exactly invariant at any subsampling. Step sizes
    are not adapted.

    :param subsamples: int or one per correction (length L-1 for L levels)
    :param draws: as in :func:`run_pcn`; the top level's step s is the path
        ``(s,)``, its sub-steps ``(s, j)``, theirs ``(s, j, j2)``, down to
        level 0, whose steps use ``xi`` (the levels above use ``u``);
        ``KeyedChainDraws(..., stream, fanout=subsamples from the top)`` by
        default (level l on stream ``stream + L - 1 - l``)
    :return: :class:`ChainResult` for the finest level (``acc_rate`` is the
        top-level acceptance)
    """
    L = len(loglik_qoi_fns)
    if L < 2:
        raise ValueError("MLDA needs at least two levels")
    if np.isscalar(subsamples):
        subsamples = [int(subsamples)] * (L - 1)
    subsamples = [int(t) for t in subsamples]
    if len(subsamples) != L - 1:
        raise ValueError("subsamples must be scalar or one per correction")
    device = resolve_device(device, like=theta0)
    if burn is None:
        burn = n_steps // 3
    draws = draws or KeyedChainDraws(seed, n_chains, d, dtype, device, stream,
                                     fanout=subsamples[::-1])
    theta = _start(theta0, draws, 0, dtype, device)
    beta_c = torch.tensor(float(beta), dtype=dtype, device=device)
    fns = list(loglik_qoi_fns)

    def step(level, theta, lls, path):
        """One level-``level`` step: (theta', lls' [0..level], accept,
        the proposal's QoI)."""
        if level == 0:
            xi, u, _ = draws(path)
            prop = _pcn_propose(theta, xi, beta_c)
            ll_p, _ = fns[0](prop)
            accept = torch.log(u) < (ll_p - lls[0])
            return _mh(accept, prop, theta), [_mh(accept, ll_p, lls[0])], accept, None
        prop, sub = theta, lls[:level]
        for j in range(subsamples[level - 1]):
            prop, sub, _, _ = step(level - 1, prop, sub, path + (j,))
        ll_p, qoi_p = fns[level](prop)
        _, u, _ = draws(path)
        # the proposal kernel is pi_{l-1}-reversible: the MH ratio
        accept = torch.log(u) < (ll_p - lls[level]) - (sub[-1] - lls[level - 1])
        new = [_mh(accept, a, b) for a, b in zip(sub, lls[:level])]
        return _mh(accept, prop, theta), new + [_mh(accept, ll_p, lls[level])], accept, qoi_p

    lls, qoi = [], None
    for fn in fns:
        ll, qoi = fn(theta)
        lls.append(ll)
    acc_sum = torch.zeros((), dtype=dtype, device=device)
    series = []
    for s_ in range(n_steps):
        theta, lls, accept, qoi_p = step(L - 1, theta, lls, (s_,))
        qoi = _mh(accept, qoi_p, qoi)
        acc_sum = acc_sum + accept.to(dtype).mean()
        series.append(qoi)
    qoi_np, acc_np, theta_np, ll_np = _fetch(torch.stack(series), acc_sum, theta, lls[-1])
    n_sub = int(np.prod([1] + subsamples))
    return ChainResult(qoi_np[burn::thin], acc_np / n_steps, float(beta), theta_np, ll_np,
                       n_forward=n_steps * theta.shape[0] * (1 + n_sub))


# ---------------------------------------------------------------------- #
# the multilevel driver
# ---------------------------------------------------------------------- #
class MLMCMC:
    """Multilevel MCMC estimator of a posterior expectation.

    :param loglik_qoi_fns: one batch function ``theta [B, d] -> (loglik
        [B], qoi [B, q])`` per level, coarsest first, all on the same latent
        parametrization (resolution-independent coordinates, e.g. random
        Fourier feature weights)
    :param d: latent dimension

    ``run`` estimates ``E_{pi_L}[Q_L]`` by the telescoped sum of a pCN chain
    on level 0 and one coupled chain per correction; the standard error
    combines the L independent across-chain errors in quadrature.
    """

    def __init__(self, loglik_qoi_fns: Sequence[Callable], d: int,
                 subsample: int = 4, beta: float = 0.3, mode: str = "crn"):
        if len(loglik_qoi_fns) < 1:
            raise ValueError("need at least one level")
        self.fns = list(loglik_qoi_fns)
        self.d = int(d)
        self.subsample = int(subsample)
        self.beta = float(beta)
        self.mode = mode

    def run(self, n_steps, n_chains=32, seed=7, burn=None, thin=1, adapt=True,
            dtype=torch.float64, device=None, draws=None):
        """:param n_steps: int or per-level list (coarser levels are cheaper:
            give them more steps)
        :param seed: the seed of every level's chains; level l draws on
            streams ``2 l`` and ``2 l + 1``
        :param draws: optional per-level list of draws (as in
            :func:`run_pcn` / :func:`run_coupled`)
        :return: dict with ``mean`` [q], ``se`` [q], ``level_means``,
            ``level_ses``, ``results`` (the per-level Chain/Coupled result
            objects), ``acc_rates``, ``wall_s``"""
        L = len(self.fns)
        if np.isscalar(n_steps):
            n_steps = [int(n_steps)] * L
        if len(n_steps) != L:
            raise ValueError("n_steps must be scalar or one per level")
        draws = draws or [None] * L
        kw = dict(n_chains=n_chains, beta=self.beta, seed=seed, burn=burn, thin=thin,
                  adapt=adapt, dtype=dtype, device=device)
        t0 = time.perf_counter()
        results = [run_pcn(self.fns[0], self.d, n_steps[0], draws=draws[0], stream=0, **kw)]
        for lv in range(1, L):
            results.append(run_coupled(
                self.fns[lv], self.fns[lv - 1], self.d, n_steps[lv], mode=self.mode,
                subsample=self.subsample, draws=draws[lv], stream=2 * lv, **kw))
        wall = time.perf_counter() - t0
        level_means = np.stack([r.mean for r in results])     # [L, q]
        level_ses = np.stack([r.se for r in results])
        return {
            "mean": level_means.sum(axis=0),
            "se": np.sqrt((level_ses ** 2).sum(axis=0)),
            "level_means": level_means,
            "level_ses": level_ses,
            "results": results,
            "acc_rates": [r.acc_rate for r in results],
            "wall_s": wall,
        }


# ---------------------------------------------------------------------- #
# forward-model adapters
# ---------------------------------------------------------------------- #
def gaussian_loglik(obs, data, noise_std):
    """Gaussian misfit ``-||data - obs||^2 / (2 noise^2)`` of each row of
    ``obs`` [B, K]: -> [B]."""
    r = (torch.as_tensor(data).to(obs) - obs) / noise_std
    return -0.5 * (r * r).sum(-1)


def make_darcy_inverse(level_ns: Sequence[int], n_modes: int = 32,
                       sigma: float = 1.0, corr_length: float = 0.2,
                       model: str = "gauss", obs_points=None,
                       noise_std: float = 0.02, modes_seed: int = 0,
                       wave_vectors=None):
    """Bayesian Darcy inversion: the log-conductivity field from noisy
    pressure observations.

    Latent parametrization: theta [2M] are random-Fourier-feature weights,
    ``G(x) = sqrt(1/M) sum_m theta_c[m] cos(k_m x) + theta_s[m] sin(k_m x)``
    (a standard-Gaussian prior on theta gives the stationary GRF, the same
    realization at every resolution); ``K = exp(sigma G)`` at the cell
    centers, one ``[B, 2M] @ [2M, n^2]`` product for a batch; the pressure
    from ``DiffusionSimulation._solve_pressure`` (spectral-preconditioned
    CG, each sample stopping on its own); the observations a gather of the
    bilinear interpolation of cell-center pressures at ``obs_points``.

    :param level_ns: grid sizes per level, coarsest first
    :param modes_seed: the seed of the wave-vector draw (a host generator)
    :param wave_vectors: [n_modes, 2] in place of the draw, e.g.
        ``convert.darcy_inverse_from_jax``'s
    :return: dict with ``loglik_qoi_fns(data)`` (the per-level batch
        functions for observed data), ``forward(theta [B, d], n)`` -> (obs
        [B, K], flux [B]), ``d``, ``synthetic(seed, theta_true=None,
        device=None)`` -> (theta_true, clean_obs, noisy_data) as numpy,
        ``observe_points``, ``wave_vectors``, ``level_ns``
    """
    if obs_points is None:
        g = np.linspace(0.2, 0.8, 3)
        obs_points = np.array([[x, y] for x in g for y in g])
    obs_points = np.asarray(obs_points, dtype=float)
    if wave_vectors is None:
        wave_vectors = _wave_vectors_2d(model, corr_length, n_modes,
                                        seed=modes_seed).numpy()
    k_vec = np.asarray(wave_vectors, np.float64)
    n_modes = k_vec.shape[0]
    d = 2 * n_modes
    solve_cfg = {"precond": "spectral"}
    cache = {}

    def consts(n, device, dtype):
        """The [2M, n^2] mode matrix and the observation gather of grid n."""
        key = (n, str(device), dtype)
        if key not in cache:
            h = 1.0 / n
            centers = (np.arange(n) + 0.5) * h
            X, Y = np.meshgrid(centers, centers, indexing="ij")
            ang = np.stack([X.ravel(), Y.ravel()], axis=1) @ k_vec.T     # [n*n, M]
            modes = np.concatenate([np.cos(ang), np.sin(ang)], axis=1).T  # [2M, n*n]
            fi = np.clip(obs_points / h - 0.5, 0.0, n - 1.0)
            i0 = np.clip(np.floor(fi).astype(np.int64), 0, n - 2)
            w = fi - i0
            ix, iy = i0[:, 0], i0[:, 1]
            wx, wy = w[:, 0], w[:, 1]
            flat = np.stack([ix * n + iy, (ix + 1) * n + iy, ix * n + iy + 1,
                             (ix + 1) * n + iy + 1])                       # [4, K]
            wts = np.stack([(1 - wx) * (1 - wy), wx * (1 - wy), (1 - wx) * wy, wx * wy])
            cache[key] = (torch.as_tensor(modes).to(device, dtype),
                          torch.as_tensor(flat).to(device),
                          torch.as_tensor(wts).to(device, dtype))
        return cache[key]

    def forward(theta, n):
        modes, flat, wts = consts(int(n), theta.device, theta.dtype)
        g = (theta @ modes) / np.sqrt(n_modes)                 # [B, n*n]
        K = torch.exp(sigma * g).reshape(-1, n, n)
        p, _ = DiffusionSimulation._solve_pressure(solve_cfg, K)
        flux = (2.0 * K[:, :, -1] * p[:, :, -1]).sum(-1)
        obs = (p.reshape(p.shape[0], -1)[:, flat] * wts).sum(1)   # [B, K]
        return obs, flux

    def loglik_qoi_fns(data):
        data = torch.tensor(np.asarray(data, np.float64))
        fns = []
        for n in level_ns:
            def fn(theta, n=n):
                obs, flux = forward(theta, n)
                return gaussian_loglik(obs, data, noise_std), flux[:, None]
            fns.append(fn)
        return fns

    def synthetic(seed, theta_true=None, device=None):
        device = resolve_device(device)
        gen = torch.Generator().manual_seed(int(seed))
        if theta_true is None:
            theta_true = torch.randn(d, generator=gen, dtype=torch.float64)
        theta_true = torch.as_tensor(theta_true, dtype=torch.float64)
        obs, _ = forward(theta_true[None].to(device), level_ns[-1])
        obs = obs[0].cpu()
        noise = noise_std * torch.randn(obs.shape, generator=gen, dtype=torch.float64)
        return theta_true.numpy(), obs.numpy(), (obs + noise).numpy()

    return {"loglik_qoi_fns": loglik_qoi_fns, "forward": forward,
            "observe_points": obs_points, "wave_vectors": k_vec, "d": d,
            "synthetic": synthetic, "level_ns": list(level_ns)}
