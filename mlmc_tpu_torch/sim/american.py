"""American/Bermudan option pricing by Longstaff-Schwartz regression
(counterpart of ``mlmc_tpu/sim/american.py``).

A Bermudan claim may be exercised at any of N dates; its value is a
backward dynamic program over the continuation value ``E[V_{i+1} |
S_i]``, estimated by least-squares regression of realized discounted
cashflows onto centered monomials of the state (Longstaff & Schwartz,
Rev. Fin. Stud. 14, 2001), restricted to in-the-money paths by default.
Per date the fit is a QR factorization of the column-equilibrated
weighted panel with ridge rows (cond(G), not the normal equations'
cond(G)^2). With a ``mesh`` the paths shard over its devices as a TSQR:
a QR per shard, the ``[K, K]`` R factors and projected right-hand sides
gathered through ``SampleMesh.gather``, and one stacked QR solved to the
pooled fit. The stopping rule is fit on one path set and frozen on an
independent one (``price``, the honest lower bound); the in-sample value
rides along.

Companions: :func:`lsmc_dual_bound` (Rogers' martingale upper bound),
:func:`lsmc_dual_bound_ml` (its inner-sample count telescoped across
levels), :func:`lsmc_swing` (multiple stopping), :func:`bermudan_binomial`
(the CRR tree reference).

Randomness: every path's normals come from its keyed Philox stream
(``random/keyed``): path ``b`` of pass ``p`` is the identity (seed, p, b),
and date i's normals start at its Philox call ``i * ceil(m / 4)`` (m
normals per date). ``mlmc_tpu`` splits a JAX key per date instead, and
salts each shard's key with its mesh position (``fold_in(kr,
axis_index)``), so its mesh run draws other paths than its one-device
run; here the paths are keyed by their index and a mesh run draws the
one-device paths. Exercise decisions ``take = (ex > 0) & (ex > cont)`` are
discontinuous: a coefficient that moves by a rounding error can flip a
path on the boundary, so a mesh run equals the one-device run up to the
paths whose decision flipped. The products run in full float32 (or
float64) precision whatever the process's TF32 setting. ``key`` arguments
become ``seed: int``; ``device`` (None: the current CUDA device) says
where a run without a mesh computes.
"""
import time
from math import comb as _comb
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.parallel.mesh import single_device_mesh
from mlmc_tpu_torch.pce import total_degree_indices
from mlmc_tpu_torch.random.keyed import keyed_normals
from mlmc_tpu_torch.sim.sde import _scheme_increment, _system_step
from mlmc_tpu_torch.sim.simulation import ieee_float32_matmuls

__all__ = ["lsmc_price", "lsmc_dual_bound", "lsmc_dual_bound_ml",
           "lsmc_swing", "put_payoff", "call_payoff", "bermudan_binomial"]


def put_payoff(strike):
    return lambda s: torch.clamp(strike - s, min=0.0)


def call_payoff(strike):
    return lambda s: torch.clamp(s - strike, min=0.0)


def _poly_basis(x, degree):
    """Monomials of the normalized state, [B] -> [B, degree + 1]."""
    return torch.stack([x ** k for k in range(degree + 1)], dim=1)


def _poly_basis_multi(x, indices):
    """Total-degree monomials of a [B, dim] state: ``G[b, p] = prod_k
    x[b, k] ** indices[p, k]`` -> [B, P]."""
    return torch.prod(x[:, None, :] ** indices[None, :, :], dim=-1)


def _normal_eq(G, y):
    """``(G^T G, G^T y)`` in float64, whatever G's dtype (the counterpart of
    ``mlmc_tpu``'s ``_blocked_normal_eq``, whose bounded float32
    accumulation windows float64 sums make unnecessary). y [B] or [B, Q]."""
    G64 = G.to(torch.float64)
    return G64.T @ G64, G64.T @ y.to(torch.float64)


def _equilibrated_solve(A, b, eps):
    """Solve the normal equations after Jacobi equilibration ``D A D
    (x / D) = D b``, D = diag(A)^-1/2, with ridge ``eps`` on the unit
    diagonal (float64)."""
    d = torch.rsqrt(torch.clamp(torch.diagonal(A), min=1e-30))
    Ae = A * d[:, None] * d[None, :] + eps * torch.eye(A.shape[0], dtype=A.dtype,
                                                      device=A.device)
    be = b * (d[:, None] if b.dim() == 2 else d)
    x = torch.linalg.solve(Ae, be)
    return x * (d[:, None] if b.dim() == 2 else d)


def _ridge_eps(dtype):
    return 1e-6 if torch.finfo(dtype).bits < 64 else 1e-12


def bermudan_binomial(s0, strike, rate, sigma, T, n_dates, n_steps=4096, kind="put"):
    """Host CRR binomial Bermudan price (exercise only at the ``n_dates``
    equispaced dates h, 2h, ..., T); ``n_steps`` a multiple of
    ``n_dates``."""
    if n_steps % n_dates:
        raise ValueError("n_steps must be a multiple of n_dates")
    if kind not in ("put", "call"):
        raise ValueError("kind must be 'put' or 'call'")
    dt = T / n_steps
    u = np.exp(sigma * np.sqrt(dt))
    d = 1.0 / u
    disc = np.exp(-rate * dt)
    p = (np.exp(rate * dt) - d) / (u - d)
    j = np.arange(n_steps + 1)
    s = s0 * u ** j * d ** (n_steps - j)
    v = np.maximum(strike - s, 0.0) if kind == "put" else np.maximum(s - strike, 0.0)
    per_date = n_steps // n_dates
    for step in range(n_steps - 1, -1, -1):
        v = disc * (p * v[1:] + (1 - p) * v[:-1])
        if step and step % per_date == 0:
            s = s0 * u ** j[:step + 1] * d ** (step - j[:step + 1])
            ex = (np.maximum(strike - s, 0.0) if kind == "put"
                  else np.maximum(s - strike, 0.0))
            v = np.maximum(v, ex)
    return float(v[0])


# ---------------------------------------------------------------------- #
# dynamics
# ---------------------------------------------------------------------- #
class _Dynamics:
    """How a path moves from date to date and how its state enters the
    regression basis.

    ``per_date`` normals move a path one date: exact GBM (1), an
    ``SDEModel`` with ``n_sub`` Euler/Milstein substeps (n_sub), or an
    ``SDESystem`` (n_sub * n_drivers, substep-major).
    """

    def __init__(self, s0, rate, T, n_dates, sigma, model, scheme, n_sub, degree,
                 scale, dtype, who):
        if (sigma is None) == (model is None):
            raise ValueError("pass exactly one of sigma (exact GBM) / model")
        self.h = T / n_dates
        self.disc = float(np.exp(-rate * self.h))
        self.dtype = dtype
        self.is_system = model is not None and hasattr(model, "n_drivers")
        self.model, self.scheme, self.n_sub, self.sigma = model, scheme, int(n_sub), sigma
        self.dt = self.h / self.n_sub
        if self.is_system:
            if scheme != "euler":
                raise ValueError("SDESystem %s integrate with Euler substeps; pass "
                                 "scheme='euler'" % who)
            self.dim = model.dim
            sc = np.asarray(scale if scale is not None else model.s0, np.float64).ravel()
            if sc.shape != (self.dim,):
                raise ValueError("scale must have %d components" % self.dim)
            self.sc = np.where(sc == 0.0, 1.0, np.abs(sc))
            self.basis_idx = total_degree_indices(self.dim, degree)
            self.per_date = self.n_sub * model.n_drivers
            self.s0_state = tuple(float(v) for v in model.s0)
        else:
            if model is not None and scheme == "milstein" and model.diffusion_ds is None:
                raise ValueError("Milstein needs SDEModel.diffusion_ds")
            self.dim = 1
            self.sc = float(scale if scale is not None else s0)
            self.per_date = 1 if sigma is not None else self.n_sub
            self.s0_state = float(s0 if sigma is not None else model.s0)
            if sigma is not None:
                self.drift_h = float((rate - 0.5 * sigma ** 2) * self.h)
                self.vol_h = float(sigma * np.sqrt(self.h))
        self.degree = degree
        self.K = (len(self.basis_idx) if self.is_system else degree + 1)

    def initial(self, b, device):
        if self.is_system:
            return torch.tensor(self.s0_state, dtype=self.dtype,
                                device=device).expand(b, -1).contiguous()
        return torch.full((b,), self.s0_state, dtype=self.dtype, device=device)

    def basis(self, s):
        if self.is_system:
            sc = torch.tensor(self.sc, dtype=s.dtype, device=s.device)
            idx = torch.tensor(self.basis_idx, dtype=s.dtype, device=s.device)
            return _poly_basis_multi(s / sc - 1.0, idx)
        return _poly_basis(s / self.sc - 1.0, self.degree)

    def step(self, s, z, i):
        """Advance states ``s`` over date interval i (0-based) with normals
        ``z [..., per_date]`` (any leading shape matching ``s``'s)."""
        if self.sigma is not None:
            return s * torch.exp(self.drift_h + self.vol_h * z[..., 0])
        dw = float(np.sqrt(self.dt)) * z
        if self.is_system:
            lead = s.shape[:-1]
            flat = s.reshape(-1, self.dim)
            dw = dw.reshape(-1, self.n_sub, self.model.n_drivers)
            for j in range(self.n_sub):
                flat = _system_step(self.model, flat, i * self.h + j * self.dt,
                                    dw[:, j], self.dt)
            return flat.reshape(lead + (self.dim,))
        for j in range(self.n_sub):
            s = s + _scheme_increment(self.model, self.scheme, s, i * self.h + j * self.dt,
                                      dw[..., j], self.dt)
        return s


def _keyed_date_normals(seed, stream, idx, per_date, date, dtype):
    """[b, per_date] normals of date ``date`` of paths ``idx`` (identity
    (seed, stream, index)), from Philox call ``date * ceil(per_date / 4)``."""
    calls = -(-int(per_date) // 4)
    return keyed_normals(seed, stream, idx, torch.zeros_like(idx), per_date, dtype,
                         first_call=date * calls)


# ---------------------------------------------------------------------- #
# Longstaff-Schwartz
# ---------------------------------------------------------------------- #
def _tsqr_fit(mesh, parts, K, dtype):
    """Pooled weighted least squares over the mesh's shards by TSQR.

    :param parts: per local shard ``(Gw [b, K], yw [b] or [b, Q])``
    :return: coefficients [K] or [K, Q] on the mesh's first device
    """
    cn = mesh.reduce([(Gw * Gw).sum(dim=0) for Gw, _ in parts])
    d = torch.rsqrt(torch.clamp(cn, min=1e-30))
    rs, cs = [], []
    for Gw, yw in parts:
        q, r = torch.linalg.qr(Gw * d.to(Gw.device)[None, :])
        rs.append(r)
        cs.append(q.T @ yw)
    r = mesh.gather(rs)
    c = mesh.gather(cs)
    home = r.device
    eps = _ridge_eps(dtype)
    rr = torch.cat([r, float(np.sqrt(eps)) * torch.eye(K, dtype=dtype, device=home)])
    cc = torch.cat([c, torch.zeros((K,) + tuple(c.shape[1:]), dtype=dtype, device=home)])
    q2, r2 = torch.linalg.qr(rr)
    rhs = q2.T @ cc
    x = torch.linalg.solve_triangular(r2, rhs[:, None] if rhs.dim() == 1 else rhs,
                                      upper=True)
    x = x[:, 0] if rhs.dim() == 1 else x
    d = d.to(home)
    return x * (d if x.dim() == 1 else d[:, None])


def _lsmc(payoff, dyn, n_dates, B, itm_only, normals, mesh, keep_paths=False,
          frozen=None):
    """Two-pass Longstaff-Schwartz over the mesh's shards.

    :param normals: ``normals(pass_id, idx) -> [b, n_dates, per_date]``,
        pass 0 the fit, pass 1 the frozen evaluation
    :param frozen: a coefficient stack [n_dates - 1, K] to evaluate in
        place of the fit pass's (the in-sample figures are then the
        evaluation's)
    :return: (result dict, per-path dict when ``keep_paths``: the
        discounted values and the stopping dates of both passes)
    """
    disc, dtype = dyn.disc, dyn.dtype
    mesh.check_divides(B, "n_paths")
    shards = mesh.local_shards()

    def panels(pass_id):
        out = []
        for shard, device in shards:
            lo, hi = mesh.bounds(B, shard)
            z = normals(pass_id, torch.arange(lo, hi, dtype=torch.int64, device=device))
            s = dyn.initial(hi - lo, device)
            dates = []
            for i in range(n_dates):
                s = dyn.step(s, z[:, i], i)
                dates.append(s)
            out.append(dates)
        return out

    def run(pass_id, coefs):
        fit = coefs is None
        paths = panels(pass_id)
        v = [payoff(p[-1]) for p in paths]
        stop = [torch.full_like(x, n_dates, dtype=torch.int64) for x in v]
        takes = [torch.zeros((), dtype=torch.float64, device=x.device) for x in v]
        cs = [None] * (n_dates - 1)
        for i in range(n_dates - 2, -1, -1):
            G = [dyn.basis(p[i]) for p in paths]
            ex = [payoff(p[i]) for p in paths]
            v = [disc * x for x in v]
            if fit:
                w = [(e > 0).to(dtype) if itm_only else torch.ones_like(e) for e in ex]
                cs[i] = _tsqr_fit(mesh, [(g * wi[:, None], y * wi)
                                         for g, wi, y in zip(G, w, v)], dyn.K, dtype)
            else:
                cs[i] = coefs[i]
            for k in range(len(paths)):
                cont = G[k] @ cs[i].to(G[k].device)
                take = (ex[k] > 0) & (ex[k] > cont)
                v[k] = torch.where(take, ex[k], v[k])
                stop[k] = torch.where(take, i + 1, stop[k])
                takes[k] = takes[k] + take.to(torch.float64).mean()
        price = [disc * x for x in v]
        euro = [(disc ** n_dates) * payoff(p[-1]) for p in paths]
        stats = mesh.reduce([torch.stack([x.sum(), (x * x).sum(), e.sum(), t])
                             .to(torch.float64) for x, e, t in zip(price, euro, takes)])
        return (stats.cpu().numpy(), (torch.stack(cs) if n_dates > 1 else None),
                price, stop)

    t0 = time.perf_counter()
    with ieee_float32_matmuls():
        if n_dates == 1 or frozen is not None:
            rows = ([] if n_dates == 1 else
                    [torch.tensor(np.asarray(c, np.float64)).to(mesh.devices[0], dtype)
                     for c in frozen])
            stats, coefs, price_e, stop_e = run(1, rows)
            price_i, stop_i, stats_in = price_e, stop_e, stats
        else:
            stats_in, coefs, price_i, stop_i = run(0, None)
            stats, _, price_e, stop_e = run(1, [c for c in coefs])
    s_sum, s_sq, e_sum, takes = [float(x) for x in stats]
    price = s_sum / B
    se = float(np.sqrt(max(s_sq / B - price ** 2, 0.0) / B))
    res = {"price": price, "price_se": se,
           "price_insample": float(stats_in[0]) / B,
           "european": e_sum / B,
           "coef": (np.zeros((0, dyn.K)) if coefs is None
                    else coefs.cpu().numpy().astype(np.float64)),
           "exercise_frac": (0.0 if n_dates == 1
                             else takes / mesh.n_devices / max(n_dates - 1, 1)),
           "wall_s": time.perf_counter() - t0}
    if not keep_paths:
        return res, None
    return res, {"value_insample": mesh.gather(price_i),
                 "stop_insample": mesh.gather(stop_i),
                 "value": mesh.gather(price_e), "stop": mesh.gather(stop_e)}


def lsmc_price(payoff: Callable, s0: float, rate: float, T: float, n_dates: int,
               sigma: Optional[float] = None, model=None, scheme: str = "euler",
               n_sub: int = 1, degree: int = 3, n_paths: int = 1 << 16, seed: int = 0,
               scale: Optional[float] = None, itm_only: bool = True, dtype=None,
               mesh=None, device=None):
    """Price a Bermudan claim ``payoff(S_t)`` exercisable at ``h, 2h, ...,
    T`` (h = T / n_dates) by Longstaff-Schwartz regression.

    Dynamics: exact GBM transitions under the risk-neutral drift when
    ``sigma`` is given, an ``SDEModel`` with ``n_sub`` Euler/Milstein
    substeps per date, or an ``SDESystem`` (e.g. Heston) regressed on the
    total-degree monomials of its whole state.

    :param payoff: ``s [B] -> [B]`` (scalar) or ``s [B, dim] -> [B]``
    :param degree: regression degree in ``s / scale - 1``
    :param seed: the paths' identities: path b of the fit pass is (seed,
        0, b), of the evaluation pass (seed, 1, b)
    :param itm_only: regress on in-the-money paths only
    :param dtype: the paths' and the fit's dtype (default float32)
    :param mesh: optional ``SampleMesh``: paths shard over its devices, the
        per-date fit is the pooled TSQR; the one-device paths are drawn
    :param device: where a run without a mesh computes (None: the card)
    :return: dict with ``price`` (out of sample), ``price_se``,
        ``price_insample``, ``european``, ``coef`` [n_dates - 1, K],
        ``exercise_frac``, ``wall_s``
    """
    if n_dates < 1:
        raise ValueError("n_dates must be >= 1")
    dtype = torch.float32 if dtype is None else dtype
    dyn = _Dynamics(s0, rate, T, n_dates, sigma, model, scheme, n_sub, degree, scale,
                    dtype, "pricing")
    mesh = single_device_mesh(device) if mesh is None else mesh
    return _lsmc(payoff, dyn, n_dates, int(n_paths), itm_only,
                 _keyed_panel_normals(seed, dyn, n_dates), mesh)[0]


def _keyed_panel_normals(seed, dyn, n_dates):
    """``normals(pass_id, idx) -> [b, n_dates, per_date]`` of the keyed
    paths (seed, pass_id, index)."""
    def normals(pass_id, idx):
        return torch.stack([_keyed_date_normals(seed, pass_id, idx, dyn.per_date, i,
                                                dyn.dtype) for i in range(n_dates)], dim=1)

    return normals


# ---------------------------------------------------------------------- #
# dual upper bounds
# ---------------------------------------------------------------------- #
def _frozen_surface(dyn, coef, n_dates):
    """(continuation C_i(s), value V_i(s)) of a frozen coefficient stack
    [n_dates - 1, K]; date n_dates reuses the last row as its continuation
    (used there only as a control variate) and its value is the payoff."""
    def cont(s, i, payoff):
        row = coef[min(i - 1, coef.shape[0] - 1)]
        flat = s.reshape((-1, dyn.dim) if dyn.is_system else (-1,))
        return (dyn.basis(flat) @ row).reshape(s.shape[:-1] if dyn.is_system else s.shape)

    def value(s, i, payoff):
        ex = payoff(s)
        if i == n_dates:
            return ex
        return torch.maximum(ex, cont(s, i, payoff))

    return cont, value


def _dual_gbm(payoff, s0, rate, T, n_dates, coef_np, dyn, n_inner, B, normals, device):
    """The GBM dual with the closed-form control variate (see
    :func:`lsmc_dual_bound`). ``normals(i) -> (z [B], zh [n_inner/2, B])``."""
    dtype, K, degree = dyn.dtype, dyn.K, dyn.degree
    disc, drift_h, vol_h = dyn.disc, dyn.drift_h, dyn.vol_h
    coef = torch.tensor(coef_np).to(device, dtype)
    cont, value = _frozen_surface(dyn, coef, n_dates)
    ks = np.arange(K)
    raw_mom = np.exp(ks * drift_h + 0.5 * (ks * vol_h) ** 2)
    Q = np.zeros((K, K))
    for k in range(K):
        for l in range(k + 1):
            Q[k, l] = sum(_comb(k, j) * (-1.0) ** (k - j) * _comb(j, l) * raw_mom[j]
                          for j in range(l, k + 1))
    cv_w = torch.tensor(Q.T @ coef_np.T).to(device, dtype)     # [K, n_dates - 1]
    s = torch.full((B,), float(s0), dtype=dtype, device=device)
    M = torch.zeros_like(s)
    best = payoff(s)
    for i in range(1, n_dates + 1):
        z, zh = normals(i)
        s_prev = s
        s = s_prev * torch.exp(drift_h + vol_h * z)
        d_i = disc ** i
        v_here = d_i * value(s, i, payoff)
        exact_ec = _poly_basis(s_prev / dyn.sc - 1.0, degree) @ cv_w[:, min(i - 1, cv_w.shape[1] - 1)]
        zi = torch.cat([zh, -zh], dim=0)
        s_in = s_prev[None, :] * torch.exp(drift_h + vol_h * zi)
        resid = value(s_in, i, payoff) - cont(s_in, i, payoff)
        M = M + v_here - d_i * (exact_ec + resid.mean(dim=0))
        best = torch.maximum(best, d_i * payoff(s) - M)
    return best


def _dual_model_paths(payoff, dyn, n_dates, coef, Bl, nl, coupled, normals, device):
    """Pathwise nested duals under model dynamics: ``best [m, Bl]`` for the
    full-``nl`` estimator and, on a coupled level, its two halves.
    ``normals(i) -> (outer [Bl, per_date], inner [nl / 2, Bl, per_date])``;
    a coupled level's inner block is the two quarter blocks qa, qb."""
    disc = dyn.disc
    _, value = _frozen_surface(dyn, coef, n_dates)
    m = 3 if coupled else 1
    s = dyn.initial(Bl, device)
    M = torch.zeros((m, Bl), dtype=dyn.dtype, device=device)
    best = payoff(s)[None].expand(m, Bl).clone()
    for i in range(1, n_dates + 1):
        outer, inner = normals(i)
        s_prev = s
        s = dyn.step(s_prev, outer, i - 1)
        d_i = disc ** i
        v_here = d_i * value(s, i, payoff)
        if coupled:
            q = nl // 4
            qa, qb = inner[:q], inner[q:]
            zs = torch.cat([qa, -qa, qb, -qb], dim=0)
        else:
            zs = torch.cat([inner, -inner], dim=0)
        s_rep = s_prev[None].expand((nl,) + tuple(s_prev.shape))
        v_in = value(dyn.step(s_rep, zs, i - 1), i, payoff)
        if coupled:
            e_a, e_b = v_in[:nl // 2].mean(dim=0), v_in[nl // 2:].mean(dim=0)
            e = torch.stack([0.5 * (e_a + e_b), e_a, e_b])
        else:
            e = v_in.mean(dim=0)[None]
        M = M + (v_here[None] - d_i * e)
        best = torch.maximum(best, (d_i * payoff(s))[None] - M)
    return best


def _model_degree(K, model, degree):
    """The basis degree of a frozen stack with K columns."""
    if hasattr(model, "n_drivers"):
        if degree is None:
            degree = next((p for p in range(1, 16)
                           if len(total_degree_indices(model.dim, p)) == K), None)
            if degree is None:
                raise ValueError("no total degree matches K=%d in dim %d; pass degree "
                                 "explicitly" % (K, model.dim))
        if len(total_degree_indices(model.dim, degree)) != K:
            raise ValueError("degree/coef mismatch: total degree %d has %d terms, coef "
                             "has %d" % (degree, len(total_degree_indices(model.dim,
                                                                          degree)), K))
        return degree
    degree = K - 1 if degree is None else degree
    if degree + 1 != K:
        raise ValueError("degree+1 must match coef's second dim")
    return degree


def _inner_normals(seed, stream, idx, per_date, n_half, date, dtype):
    """(outer [b, per_date], inner [n_half, b, per_date]) of one date: each
    path's ``per_date * (1 + n_half)`` keyed normals, outer first."""
    z = _keyed_date_normals(seed, stream, idx, per_date * (1 + n_half), date, dtype)
    outer = z[:, :per_date]
    inner = z[:, per_date:].reshape(-1, n_half, per_date).transpose(0, 1)
    return outer, inner


def lsmc_dual_bound(payoff: Callable, s0: float, rate: float, T: float, n_dates: int,
                    coef, sigma: Optional[float] = None, model=None,
                    scheme: str = "euler", n_sub: int = 1, degree: Optional[int] = None,
                    scale: Optional[float] = None, n_paths: int = 1 << 14,
                    n_inner: int = 64, seed: int = 1, dtype=None, device=None):
    """True upper bound on the Bermudan price by the dual (martingale)
    method (Rogers, Math. Finance 12, 2002) with the martingale of the
    frozen surface ``coef`` of :func:`lsmc_price` (fit it with
    ``itm_only=False``):

        price <= E[ max_i ( disc^i h(S_i) - M_i ) ].

    The one-step conditional expectations take ``n_inner`` antithetic
    inner samples per (path, date); under exact GBM (``sigma``) the
    continuation polynomial is an exact control variate (closed-form
    lognormal moments of the centered basis); under an ``SDEModel`` or
    ``SDESystem`` (the fit's ``n_sub``) plain antithetic nested MC.

    :param coef: [n_dates - 1, K] frozen coefficients (numpy)
    :param seed: path b is the identity (seed, 0, b); date i's outer and
        inner normals follow one another in its stream
    :return: dict with ``upper``, ``upper_se``, ``wall_s``
    """
    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    coef_np = np.asarray(coef, np.float64)
    K = coef_np.shape[1]
    if n_inner % 2:
        raise ValueError("n_inner must be even (antithetic pairs)")
    B, half = int(n_paths), int(n_inner) // 2
    idx = torch.arange(B, dtype=torch.int64, device=device)
    t0 = time.perf_counter()
    if model is not None:
        degree = _model_degree(K, model, degree)
        dyn = _Dynamics(s0, rate, T, n_dates, None, model, scheme, n_sub, degree, scale,
                        dtype, "duals")
        normals = lambda i: _inner_normals(seed, 0, idx, dyn.per_date, half, i - 1, dtype)
        with ieee_float32_matmuls():
            best = _dual_model_paths(payoff, dyn, n_dates,
                                     torch.tensor(coef_np).to(device, dtype), B,
                                     int(n_inner), False, normals, device)[0]
    else:
        degree = K - 1 if degree is None else degree
        if degree + 1 != K:
            raise ValueError("degree+1 must match coef's second dim")
        dyn = _Dynamics(s0, rate, T, n_dates, sigma, None, scheme, n_sub, degree, scale,
                        dtype, "duals")

        def normals(i):
            outer, inner = _inner_normals(seed, 0, idx, 1, half, i - 1, dtype)
            return outer[:, 0], inner[..., 0]

        with ieee_float32_matmuls():
            best = _dual_gbm(payoff, s0, rate, T, n_dates, coef_np, dyn, int(n_inner), B,
                             normals, device)
    return _upper(best, B, t0)


def _upper(best, B, t0):
    b = best.to(torch.float64)
    sm, sq = float(b.sum()), float((b * b).sum())
    upper = sm / B
    return {"upper": upper, "upper_se": float(np.sqrt(max(sq / B - upper ** 2, 0.0) / B)),
            "wall_s": time.perf_counter() - t0}


def _dual_ml(payoff, s0, rate, T, n_dates, coef, model, scheme, n_sub, degree, scale,
             n0_inner, n_levels, paths, dtype, device, level_normals):
    """The multilevel nested dual over ``level_normals(l, nl, Bl, coupled)
    -> normals(i)`` (see :func:`lsmc_dual_bound_ml`)."""
    coef_np = np.asarray(coef, np.float64)
    degree = _model_degree(coef_np.shape[1], model, degree)
    dyn = _Dynamics(s0, rate, T, n_dates, None, model, scheme, n_sub, degree, scale, dtype,
                    "duals")
    coef_t = torch.tensor(coef_np).to(device, dtype)
    t0 = time.perf_counter()
    levels, upper, var_sum, last_mean = [], 0.0, 0.0, 0.0
    for l in range(n_levels + 1):
        nl, Bl = n0_inner << l, paths[l]
        with ieee_float32_matmuls():
            best = _dual_model_paths(payoff, dyn, n_dates, coef_t, Bl, nl, l > 0,
                                     level_normals(l, nl, Bl, l > 0), device)
        y = (best[0] - 0.5 * (best[1] + best[2])) if l > 0 else best[0]
        y = y.to(torch.float64)
        sm, sq = float(y.sum()), float((y * y).sum())
        mean = sm / Bl
        var = max(sq / Bl - mean ** 2, 0.0)
        levels.append({"n_inner": nl, "n_paths": Bl, "mean": mean, "var": var,
                       "cost": Bl * nl * n_dates})
        upper += mean
        var_sum += var / Bl
        last_mean = mean
    return {"upper": upper, "upper_se": float(np.sqrt(var_sum)),
            "bias_indicator": abs(last_mean), "levels": levels,
            "inner_evals": sum(lv["cost"] for lv in levels),
            "single_level_evals": paths[0] * (n0_inner << n_levels) * n_dates,
            "wall_s": time.perf_counter() - t0}


def lsmc_dual_bound_ml(payoff: Callable, s0: float, rate: float, T: float,
                       n_dates: int, coef, model, scheme: str = "euler", n_sub: int = 1,
                       degree: Optional[int] = None, scale=None, n0_inner: int = 8,
                       n_levels: int = 4, n_paths=1 << 13, min_paths: int = 256,
                       seed: int = 1, dtype=None, device=None):
    """Multilevel nested dual: the Rogers upper bound of
    :func:`lsmc_dual_bound` (model dynamics) with the inner-sample count
    telescoped (Giles & Goda; Belomestny et al.): level l uses ``n_l =
    n0_inner 2^l`` inner transitions, and its correction ``U(n_l) -
    (U_A(n_l/2) + U_B(n_l/2)) / 2`` splits the fine inner draws into two
    antithetic halves on the same outer paths.

    :param n_paths: outer paths at level 0 (halved per level, floored at
        ``min_paths``), or an explicit ``n_levels + 1``-long sequence
    :param seed: path b of level l is the identity (seed, l, b)
    :return: dict with ``upper``, ``upper_se``, ``bias_indicator``,
        ``levels``, ``inner_evals``, ``single_level_evals``, ``wall_s``
    """
    if n0_inner < 2 or n0_inner % 2:
        raise ValueError("n0_inner must be even and >= 2")
    if n_levels < 0:
        raise ValueError("n_levels must be >= 0")
    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    if np.isscalar(n_paths) or np.ndim(n_paths) == 0:
        paths = [max(int(n_paths) >> l, int(min_paths)) for l in range(n_levels + 1)]
    else:
        paths = [int(p) for p in n_paths]
        if len(paths) != n_levels + 1:
            raise ValueError("n_paths must have %d entries" % (n_levels + 1))
    per_date = int(n_sub) * (model.n_drivers if hasattr(model, "n_drivers") else 1)

    def level_normals(l, nl, Bl, coupled):
        idx = torch.arange(Bl, dtype=torch.int64, device=device)
        return lambda i: _inner_normals(seed, l, idx, per_date, nl // 2, i - 1, dtype)

    return _dual_ml(payoff, s0, rate, T, n_dates, coef, model, scheme, n_sub, degree,
                    scale, int(n0_inner), int(n_levels), paths, dtype, device,
                    level_normals)


# ---------------------------------------------------------------------- #
# swing options
# ---------------------------------------------------------------------- #
def _swing(payoff, s0, rate, T, n_dates, n_rights, sigma, degree, B, scale, dtype,
           device, normals, frozen=None):
    """Two-pass swing LSMC over ``normals(pass_id) -> [B, n_dates]``; a
    ``frozen`` stack [n_dates - 1, Q, K] replaces the fit pass."""
    scale_f = float(scale if scale is not None else s0)
    h = T / n_dates
    disc = float(np.exp(-rate * h))
    drift_h = float((rate - 0.5 * sigma ** 2) * h)
    vol_h = float(sigma * np.sqrt(h))
    K, Q = degree + 1, int(n_rights)
    eps = _ridge_eps(dtype)

    def fit(G, y):
        d = torch.rsqrt(torch.clamp((G * G).sum(dim=0), min=1e-30))
        q, r = torch.linalg.qr(G * d[None, :])
        c = q.T @ y
        rr = torch.cat([r, float(np.sqrt(eps)) * torch.eye(K, dtype=dtype, device=device)])
        cc = torch.cat([c, torch.zeros((K, y.shape[1]), dtype=dtype, device=device)])
        q2, r2 = torch.linalg.qr(rr)
        return torch.linalg.solve_triangular(r2, q2.T @ cc, upper=True) * d[:, None]

    def run(pass_id, coefs):
        z = normals(pass_id)
        s = torch.full((B,), float(s0), dtype=dtype, device=device)
        panel = []
        for i in range(n_dates):
            s = s * torch.exp(drift_h + vol_h * z[:, i])
            panel.append(s)
        cf = payoff(panel[-1])[None].expand(Q, B)
        zero = torch.zeros((1, B), dtype=dtype, device=device)
        cs = [None] * (n_dates - 1)
        for i in range(n_dates - 2, -1, -1):
            cf = disc * cf
            G = _poly_basis(panel[i] / scale_f - 1.0, degree)
            cs[i] = fit(G, cf.T).T if coefs is None else coefs[i]
            cont = cs[i] @ G.T                                  # [Q, B]
            ex = payoff(panel[i])
            cont_below = torch.cat([zero, cont[:-1]], dim=0)
            cf_below = torch.cat([zero, cf[:-1]], dim=0)
            take = (ex > 0) & (ex[None, :] + cont_below > cont)
            cf = torch.where(take, ex[None, :] + cf_below, cf)
        values = (disc * cf).to(torch.float64)
        return values.sum(dim=1), (values * values).sum(dim=1), cs

    t0 = time.perf_counter()
    with ieee_float32_matmuls():
        if frozen is None:
            sum_in, _, coefs = run(0, None)
        else:
            coefs = [torch.tensor(np.asarray(c, np.float64)).to(device, dtype) for c in frozen]
        sums, sqs, _ = run(1, coefs)
        if frozen is not None:
            sum_in = sums
    sums, sqs = sums.cpu().numpy(), sqs.cpu().numpy()
    prices = sums / B
    ses = np.sqrt(np.maximum(sqs / B - prices ** 2, 0.0) / B)
    coef = (torch.stack(coefs).cpu().numpy().astype(np.float64) if n_dates > 1
            else np.zeros((0, Q, K)))
    return {"price": float(prices[-1]), "price_se": float(ses[-1]),
            "price_insample": float(sum_in[-1]) / B,
            "prices_by_rights": prices, "prices_by_rights_se": ses,
            "coef": coef, "wall_s": time.perf_counter() - t0}


def lsmc_swing(payoff: Callable, s0: float, rate: float, T: float, n_dates: int,
               n_rights: int, sigma: float, degree: int = 3, n_paths: int = 1 << 16,
               seed: int = 0, scale: Optional[float] = None, dtype=None, device=None):
    """Swing (multiple-stopping) option: up to ``n_rights`` exercises, at
    most one per date (Meinshausen & Hambly, Math. Finance 14, 2004, LSMC
    form), one continuation surface per remaining-rights count q:

        V_{i,q} = max( C_{i,q},  h(S_i) + C_{i,q-1} ).

    Exact GBM dynamics, global regression, two-pass (fit on pass 0,
    frozen on pass 1).

    :return: dict with ``price``, ``price_se``, ``price_insample``,
        ``prices_by_rights`` [Q] and their ``_se``, ``coef`` [n_dates - 1,
        Q, K], ``wall_s``
    """
    if n_dates < 1 or not 1 <= n_rights <= n_dates:
        raise ValueError("need n_dates >= 1 and 1 <= n_rights <= n_dates")
    dtype = torch.float32 if dtype is None else dtype
    device = resolve_device(device)
    B = int(n_paths)
    idx = torch.arange(B, dtype=torch.int64, device=device)

    def normals(pass_id):
        return torch.stack([_keyed_date_normals(seed, pass_id, idx, 1, i, dtype)[:, 0]
                            for i in range(n_dates)], dim=1)

    return _swing(payoff, s0, rate, T, n_dates, n_rights, sigma, degree, B, scale, dtype,
                  device, normals)
