"""Risk measures and optimization under uncertainty (counterpart of
``mlmc_tpu/risk.py``).

* **Multilevel VaR/CVaR** (:func:`cvar_mlmc`): VaR from the multilevel
  CDF's quantile (``cdf_estimate.MultilevelCDF``), then the
  Rockafellar-Uryasev tail expectation

      CVaR_a(X) = t + E[(X - t)+] / (1 - a)   at  t = VaR_a(X)

  telescoped across the levels. Its integrand is Lipschitz, so the
  corrections decay at the coupling's strong rate without smoothing, and
  the objective is stationary at t = VaR: a O(se) quantile error moves
  CVaR at O(se^2); the reported error adds the realized first-order
  residual ``|1 - p_tail/(1-a)| * se_t``.
* **Differentiable MLMC** (:func:`mlmc_gradient`,
  :func:`optimize_expectation`, :func:`optimize_cvar`): pathwise gradients
  of telescoped expectations by ``torch.autograd`` on ``theta`` alone (the
  paths are drawn from their identities and need no graph), and stochastic
  gradient descent on them, one Python step per iteration with the values
  kept on the device and fetched once at the end. The optimizer is a
  factory ``params -> optimizer`` (``step()``, ``zero_grad()``), a
  ``torch.optim`` one included; the default is :class:`Adam`, optax's
  ``adam(0.05)`` on plain tensors (betas 0.9 / 0.999, eps 1e-8), where
  ``mlmc_tpu`` takes an optax transformation. CVaR optimization uses the
  joint program ``min_{theta,t} t + E[spp_delta(f(theta) - t)]/(1-a)``
  with the softplus-smoothed positive part (bias <= delta*log2).

Level contract: ``pair_fn(level, keys) -> (fine [C], coarse [C], valid
[C])`` with ``keys`` a ``random.keyed.SampleKeys`` (coarse ignored at
level 0); the gradient drivers take ``obj_fn(level, theta, keys)`` with
the same return. Identities: the quantile grid's pilot is (seed, 10001,
i), the CDF stage (seed + 1, level, i), the tail stage (seed + 2, level,
i), each as JAX's ``fold_in`` chain; the gradient drivers draw step s of
level l as (seed, s << 8 | l, i) (JAX: ``fold_in(fold_in(fold_in(key,
l), s), i)``). The tail sums are float64 over per-sample rows gathered in
index order, so a sample mesh gives one device's result bit for bit.
"""
import time
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.cdf_estimate import MultilevelCDF
from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.parallel.mesh import chunk_rows, single_device_mesh
from mlmc_tpu_torch.random.keyed import SampleKeys

__all__ = ["cvar_empirical", "cvar_mlmc", "mlmc_gradient",
           "optimize_expectation", "optimize_cvar"]

#: level id of the quantile grid's pilot samples
PILOT_STREAM = 10_001
#: the gradient drivers key step s of level l as ``s << STEP_SHIFT | l``
STEP_SHIFT = 8


def _check_alpha(alpha):
    if not 0.0 < alpha < 1.0:
        raise ValueError(f"alpha must be in (0, 1), got {alpha}")


def cvar_empirical(samples, alpha: float):
    """Single-level empirical VaR/CVaR with CLT standard errors.

    :return: dict(var, cvar, cvar_se, n_tail)
    """
    _check_alpha(alpha)
    x = np.sort(np.asarray(samples, np.float64).ravel())
    n = x.size
    if n < 2:
        raise ValueError("need >= 2 samples")
    t = x[min(int(np.ceil(alpha * n)) - 1, n - 1)]
    tail = np.maximum(x - t, 0.0)
    m = tail.mean()
    se = tail.std(ddof=1) / np.sqrt(n) / (1.0 - alpha)
    return {"var": float(t), "cvar": float(t + m / (1.0 - alpha)),
            "cvar_se": float(se), "n_tail": int(np.sum(x > t))}


def _tail_sums(pair_fn, level, chunk, dtype, seed, mesh, t, start, n_chunks):
    """[sum, sum^2, n_valid] of ``(fine - t)+ - (coarse - t)+`` over chunks
    [start, start + n_chunks) of the level's identities (seed, level, i)."""
    is_l0 = level == 0

    def rows(idx):
        fine, coarse, valid = pair_fn(level, SampleKeys(seed, level, idx))
        fine = fine.to(dtype)
        valid = valid & torch.isfinite(fine)
        d = torch.clamp(fine - t, min=0.0)
        if not is_l0:
            coarse = coarse.to(dtype)
            valid = valid & torch.isfinite(coarse)
            d = d - torch.clamp(coarse - t, min=0.0)
        return torch.where(valid, d, 0.0), valid

    acc = torch.zeros(3, dtype=torch.float64, device=mesh.devices[0])
    for c in range(start, start + n_chunks):
        d, valid = chunk_rows(mesh, chunk, c, rows)
        d = d.to(torch.float64)
        acc = acc + torch.stack([d.sum(), (d * d).sum(), valid.sum().to(torch.float64)])
    return acc.cpu().numpy()


def cvar_mlmc(pair_fn: Callable, n_levels: int, alpha: float,
              target_se: float, bandwidth, quantile_grid=None,
              seed: int = 0, cost_fn: Optional[Callable] = None,
              chunk_size: int = 1 << 12, n_pilot: int = 1 << 14,
              max_rounds: int = 20, kernel_order: int = 2,
              dtype=torch.float64, mesh=None, device=None):
    """Multilevel VaR + CVaR of the finest-level QoI distribution.

    Stage 1 estimates ``VaR_alpha`` with ``MultilevelCDF`` (grid placed from
    a level-0 pilot unless ``quantile_grid`` is given); stage 2 telescopes
    the tail expectation ``E[(X - VaR)+]`` with sqrt(V/C) allocation to
    ``target_se`` (the CVaR standard error: the tail term's CLT and the
    realized first-order quantile residual).

    :param bandwidth: CDF smoothing delta(s) (the O(delta^kernel_order) VaR
        bias)
    :param cost_fn: optional ``level -> relative cost`` for both stages
    :param mesh: a ``parallel.SampleMesh`` for both stages (each chunk split
        over the shards; the result equals one device's bit for bit)
    :param device: where the chunks run without a mesh; None = the current
        CUDA device
    :return: dict(var, var_se, cvar, cvar_se, tail_mean, tail_se,
        level_corrections, n_per_level, rounds, wall_s, cdf)
    """
    _check_alpha(alpha)
    if n_levels < 1:
        raise ValueError("need n_levels >= 1")
    mesh = mesh if mesh is not None else single_device_mesh(device)
    home = mesh.devices[0]
    t0 = time.perf_counter()

    # ---- stage 0: pilot at level 0 to place the quantile grid ------ #
    if quantile_grid is None:
        keys = SampleKeys(int(seed), PILOT_STREAM,
                          torch.arange(int(n_pilot), dtype=torch.int64, device=home))
        f0, _, v0 = pair_fn(0, keys)
        f0 = f0.to(torch.float64).cpu().numpy()
        v0 = v0.cpu().numpy().astype(bool)
        f0 = f0[v0 & np.isfinite(f0)]
        if f0.size < 64:
            raise RuntimeError("pilot produced too few valid samples "
                               "to place the quantile grid")
        q = np.quantile(f0, alpha)
        spread = max(np.quantile(f0, 0.99) - np.quantile(f0, 0.5), 1e-12)
        quantile_grid = np.linspace(q - 1.5 * spread, q + 1.5 * spread, 129)

    # ---- stage 1: multilevel quantile ------------------------------ #
    cdf = MultilevelCDF(pair_fn, n_levels, quantile_grid, bandwidth,
                        kernel_order=kernel_order, seed=seed + 1,
                        cost_fn=cost_fn, chunk_size=chunk_size,
                        dtype=dtype, mesh=mesh)
    # the quantile's se needs ~target_se * (1-alpha) CDF accuracy there
    # (delta method: se_q = se_F / pdf)
    cdf.run(target_var=(target_se * (1.0 - alpha)) ** 2, max_rounds=max_rounds)
    (t_hat,), (t_se,) = cdf.quantiles([alpha])
    t_hat, t_se = float(t_hat), float(t_se)

    # ---- stage 2: telescoped tail expectation ---------------------- #
    sums = np.zeros(n_levels)
    sums2 = np.zeros(n_levels)
    nval = np.zeros(n_levels)
    ndrawn = np.zeros(n_levels, dtype=np.int64)
    elapsed = np.zeros(n_levels)
    if chunk_size % mesh.n_devices:
        raise ValueError("chunk_size=%d must divide by the mesh's %d devices"
                         % (chunk_size, mesh.n_devices))

    def extend(lv, n_add):
        n_chunks = -(-int(n_add) // chunk_size)
        if n_chunks <= 0:
            return
        tt = time.perf_counter()
        flat = _tail_sums(pair_fn, lv, chunk_size, dtype, int(seed) + 2, mesh,
                          t_hat, int(ndrawn[lv] // chunk_size), n_chunks)
        elapsed[lv] += time.perf_counter() - tt
        sums[lv] += flat[0]
        sums2[lv] += flat[1]
        nval[lv] += flat[2]
        ndrawn[lv] += n_chunks * chunk_size

    for lv in range(n_levels):
        extend(lv, max(chunk_size, n_pilot // 4))

    rounds = 0
    for rounds in range(1, max_rounds + 1):
        mean_l = sums / np.maximum(nval, 1)
        var_l = np.maximum(sums2 / np.maximum(nval, 1) - mean_l ** 2, 1e-30)
        tail_var = np.sum(var_l / np.maximum(nval, 1))
        if np.sqrt(tail_var) / (1.0 - alpha) <= target_se * 0.9:
            break
        cost = (np.array([cost_fn(lv) for lv in range(n_levels)])
                if cost_fn is not None
                else np.maximum(elapsed / np.maximum(ndrawn, 1), 1e-12))
        target_tail_var = (target_se * 0.9 * (1.0 - alpha)) ** 2
        lam = np.sum(np.sqrt(var_l * cost)) / target_tail_var
        n_opt = np.ceil(lam * np.sqrt(var_l / cost)).astype(np.int64)
        added = False
        for lv in range(n_levels):
            add = min(n_opt[lv] - ndrawn[lv],
                      8 * chunk_size * 2 ** max(0, n_levels - 1 - lv))
            if add > 0:
                extend(lv, add)
                added = True
        if not added:
            break

    mean_l = sums / np.maximum(nval, 1)
    var_l = np.maximum(sums2 / np.maximum(nval, 1) - mean_l ** 2, 0.0)
    tail_mean = float(np.sum(mean_l))
    tail_se = float(np.sqrt(np.sum(var_l / np.maximum(nval, 1))))
    # realized tail probability for the first-order quantile residual:
    # dCVaR/dt = 1 - P(X > t)/(1-alpha) -> 0 at the true quantile
    est = cdf.estimates()
    p_tail = 1.0 - float(np.interp(t_hat, est["x"], est["cdf"]))
    resid = abs(1.0 - p_tail / (1.0 - alpha)) * t_se
    cvar_se = float(np.hypot(tail_se / (1.0 - alpha), resid))
    return {"var": t_hat, "var_se": t_se,
            "cvar": t_hat + tail_mean / (1.0 - alpha),
            "cvar_se": cvar_se, "tail_mean": tail_mean,
            "tail_se": tail_se, "level_corrections": mean_l,
            "n_per_level": ndrawn.copy(), "rounds": rounds,
            "wall_s": time.perf_counter() - t0, "cdf": est}


# --------------------------------------------------------------------- #
# Differentiable MLMC
# --------------------------------------------------------------------- #
def _leaves(theta, dtype, device):
    """``theta`` (a tensor / array, or a tuple or list of them) as a tuple
    of float leaves on ``device``, and a function rebuilding its
    structure."""
    def leaf(a):
        t = a.detach() if torch.is_tensor(a) else torch.tensor(np.asarray(a, np.float64))
        return t.to(device, dtype).clone()

    if isinstance(theta, (tuple, list)):
        kind = type(theta)
        return tuple(leaf(a) for a in theta), lambda ls: kind(ls)
    return (leaf(theta),), lambda ls: ls[0]


def _level_keys(seed, level, step, n, device):
    return SampleKeys(int(seed), (int(step) << STEP_SHIFT) | int(level),
                      torch.arange(int(n), dtype=torch.int64, device=device))


def _level_value_and_grad(obj_fn, level, leaves, rebuild, keys, dtype):
    """Mean correction and its pathwise gradient (one tensor per leaf) at
    one level, with the second moment and the valid count; invalid samples
    are masked out of both (mean over the valid ones)."""
    params = [p.detach().requires_grad_(True) for p in leaves]
    fine, coarse, valid = obj_fn(level, rebuild(params), keys)
    d = fine.to(dtype)
    valid = valid & torch.isfinite(d)
    if level > 0:
        c = coarse.to(dtype)
        valid = valid & torch.isfinite(c)
        d = d - c
    d = torch.where(valid, d, 0.0)
    nv = torch.clamp(valid.to(dtype).sum(), min=1.0)
    val = d.sum() / nv
    grads = torch.autograd.grad(val, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    m2 = (d * d).sum().detach() / nv
    return val.detach(), grads, m2 - val.detach() ** 2, nv


def _per_level(n_per_level, n_levels):
    n_per = ([int(n_per_level)] * n_levels if np.isscalar(n_per_level)
             else [int(n) for n in n_per_level])
    if len(n_per) != n_levels:
        raise ValueError(f"n_per_level gives {len(n_per)} levels, "
                         f"expected {n_levels}")
    return n_per


def _host(leaves, rebuild):
    return rebuild([p.detach().cpu().numpy() for p in leaves])


def mlmc_gradient(obj_fn: Callable, theta, n_levels: int, n_per_level,
                  seed: int = 0, dtype=torch.float64, device=None):
    """Telescoped value and pathwise gradient of ``E[f_L(theta)]``.

    :param obj_fn: ``(level, theta, keys) -> (fine [C], coarse [C], valid
        [C])``, differentiable in ``theta`` (coarse ignored at level 0); the
        shared identities are the coupling
    :param theta: a tensor or array, or a tuple or list of them
    :param n_per_level: int or per-level sequence of sample counts
    :param seed: the seed of the identities (seed, 0 << 8 | level, i)
    :param device: where the levels run; None = the current CUDA device
    :return: dict(value, grad (numpy, theta's structure), level_values,
        level_variances, n_valid); the variances are of the value
        corrections
    """
    device = resolve_device(device)
    n_per = _per_level(n_per_level, n_levels)
    leaves, rebuild = _leaves(theta, dtype, device)
    vals, varis, nvs, total = [], [], [], None
    for lv in range(n_levels):
        keys = _level_keys(seed, lv, 0, n_per[lv], device)
        v, g, s2, nv = _level_value_and_grad(obj_fn, lv, leaves, rebuild, keys, dtype)
        vals.append(v)
        varis.append(s2)
        nvs.append(nv)
        total = g if total is None else [a + b for a, b in zip(total, g)]
    flat = torch.stack(vals + varis + nvs).to(torch.float64).cpu().numpy()
    return {"value": float(np.sum(flat[:n_levels])),
            "grad": _host(total, rebuild),
            "level_values": flat[:n_levels],
            "level_variances": flat[n_levels:2 * n_levels],
            "n_valid": flat[2 * n_levels:]}


class Adam:
    """``optax.adam(lr)``'s update on plain tensors: ``scale_by_adam`` then
    ``scale_by_learning_rate``, in optax's order of operations,

        mu = (1 - b1) g + b1 mu,   nu = (1 - b2) g^2 + b2 nu,   t += 1,
        p += -lr * (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps),

    with ``step()`` reading every parameter's ``.grad`` and ``zero_grad()``
    clearing them. Each operation is one ``torch._foreach_*`` call over all
    the parameters (14 launches a step on the card); IEEE addition
    commutes, so ``b1 mu + (1 - b1) g`` rounds as optax's ``(1 - b1) g +
    b1 mu``. Not a ``torch.optim.Optimizer``: its constructor imports
    ``torch._dynamo``, whose config reads the working directory, so a
    process whose working directory was removed could not build one."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params, lr: float = 0.05):
        self.params = list(params)
        self.lr = float(lr)
        self.count = 0
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self):
        self.count += 1
        g, mu, nu = [p.grad for p in self.params], self.mu, self.nu
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1 - self.b1))
        g2 = torch._foreach_mul(g, g)
        torch._foreach_mul_(g2, 1 - self.b2)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, g2)
        den = torch._foreach_div(nu, 1 - self.b2 ** self.count)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu, 1 - self.b1 ** self.count)
        torch._foreach_div_(upd, den)
        torch._foreach_mul_(upd, -self.lr)
        torch._foreach_add_(self.params, upd)

    def zero_grad(self):
        for p in self.params:
            p.grad = None


def adam(lr: float = 0.05):
    """``optax.adam(lr)`` (betas 0.9 / 0.999, eps 1e-8) as an optimizer
    factory: ``params -> Adam``."""
    return lambda params: Adam(params, lr=lr)


def optimize_expectation(obj_fn: Callable, theta0, n_levels: int,
                         n_per_level, n_steps: int = 200, optimizer=None,
                         seed: int = 0, dtype=torch.float64, device=None):
    """Minimize ``E[f_L(theta)]`` by stochastic gradient descent on MLMC
    pathwise gradients: step s (1-based) draws every level's identities
    (seed, s << 8 | level, i), sums the levels' values and gradients and
    takes one optimizer step. Values and gradient norms stay on the device
    until the end.

    :param optimizer: a factory ``params -> optimizer`` with ``step()``
        reading the params' ``.grad`` (a ``torch.optim`` class does;
        default :func:`adam` (0.05), optax's ``adam(0.05)`` rule), where
        ``mlmc_tpu`` takes an optax transformation
    :param device: where the levels run; None = the current CUDA device
    :return: dict(theta (numpy, theta0's structure), values [n_steps] (the
        MLMC estimate of the current objective at each step), grad_norms
        [n_steps], wall_s)
    """
    device = resolve_device(device)
    n_per = _per_level(n_per_level, n_levels)
    leaves, rebuild = _leaves(theta0, dtype, device)
    params = [p.requires_grad_(False) for p in leaves]
    opt = (optimizer or adam(0.05))(params)
    t0 = time.perf_counter()
    vals, gnorms = [], []
    for s in range(1, n_steps + 1):
        val = torch.zeros((), dtype=dtype, device=device)
        grad = None
        for lv in range(n_levels):
            keys = _level_keys(seed, lv, s, n_per[lv], device)
            v, g, _, _ = _level_value_and_grad(obj_fn, lv, params, rebuild, keys, dtype)
            val = val + v
            grad = g if grad is None else [a + b for a, b in zip(grad, g)]
        for p, g in zip(params, grad):
            p.grad = g
        opt.step()
        vals.append(val)
        gnorms.append(torch.sqrt(sum((g * g).sum() for g in grad)))
    out = torch.stack(vals + gnorms).to(torch.float64).cpu().numpy()
    return {"theta": _host(params, rebuild), "values": out[:n_steps],
            "grad_norms": out[n_steps:], "wall_s": time.perf_counter() - t0}


def optimize_cvar(obj_fn: Callable, theta0, alpha: float,
                  n_levels: int, n_per_level, n_steps: int = 300,
                  smoothing: float = 0.05, optimizer=None, seed: int = 0,
                  t0_init: float = 0.0, dtype=torch.float64, device=None):
    """Minimize ``CVaR_alpha[f_L(theta)]`` through the joint
    Rockafellar-Uryasev program ``min_{theta, t} t + E[spp_delta(f - t)]
    / (1 - alpha)`` with ``spp_delta(x) = delta*log(1+exp(x/delta))``
    (smoothing bias <= delta*log2; the exact kink has no pathwise
    derivative at the VaR). At the optimum ``t`` is a smoothed VaR.

    :param optimizer: as in :func:`optimize_expectation`
    :return: dict(theta, t (the VaR estimate), cvar (the last step's
        objective estimate), values, grad_norms, wall_s)
    """
    _check_alpha(alpha)
    if smoothing <= 0:
        raise ValueError("smoothing must be positive")
    delta = float(smoothing)

    def spp(x, t):
        z = (x - t) / delta
        return delta * torch.logaddexp(z, torch.zeros_like(z))

    def ru_obj(level, aug, keys):
        theta, t = aug
        fine, coarse, valid = obj_fn(level, theta, keys)
        f = t + spp(fine, t) / (1.0 - alpha)
        c = (t + spp(coarse, t) / (1.0 - alpha)) if level > 0 else coarse
        return f, c, valid

    out = optimize_expectation(
        ru_obj, (theta0, np.asarray(t0_init, np.float64)), n_levels, n_per_level,
        n_steps=n_steps, optimizer=optimizer, seed=seed, dtype=dtype, device=device)
    theta, t = out["theta"]
    return {"theta": theta, "t": float(np.asarray(t)),
            "cvar": float(out["values"][-1]),
            "values": out["values"], "grad_norms": out["grad_norms"],
            "wall_s": out["wall_s"]}
