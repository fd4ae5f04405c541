"""Polynomial chaos expansion (counterpart of ``mlmc_tpu/pce.py``):
spectral surrogates with closed-form statistics.

Expands a QoI in an orthonormal polynomial basis of the random inputs
(Wiener 1938; Ghanem & Spanos 1991; Xiu & Karniadakis 2002),

    f(theta) ~ sum_alpha c_alpha Psi_alpha(theta),
    Psi_alpha(theta) = prod_k psi_{alpha_k}(theta_k),

with psi orthonormal under the input law: probabilists' Hermite for
N(0,1) inputs, Legendre for U(-1,1). Orthonormality turns the
coefficients into the statistics: ``mean = c_0``, ``var = sum_{alpha != 0}
c_alpha^2``, and Sobol' indices are coefficient-group sums (Sudret 2008).
The fitted expansion is itself a batch surrogate ``theta [N, d] -> [N]``:
an MFMC low-fidelity model or a control variate with an exact mean.

Fits: least squares on samples (``fit_regression``), LASSO by FISTA with
k-fold cross-validation (``fit_sparse``), spectral projection on a Smolyak
grid (``fit_projection``). The three-term recurrences build all 1-D values
in one pass ([N, d, p+1]); the design matrix is a gather and a product,
each fit a batched linear solve or a loop of two [N, P] products on the
device.

**Draws.** ``fit_sparse``'s folds come from a permutation of ``arange(N)
% n_folds`` drawn by a ``torch.Generator`` seeded with ``seed`` (``folds=``
takes them in its place; a test hands in JAX's).
:func:`pce_control_variate`'s sample i of part k (0 the beta fit, 1 the
estimate) is ``SampleKeys(seed, k, i)``'s normals (hermite) or ``2u - 1``
of its uniforms (legendre); ``draws=`` takes ``(k, c, m) -> theta [m, d]``
for chunk c in their place.
"""
import itertools
import math
from typing import Callable, Optional

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.random.keyed import SampleKeys, keyed_uniforms

__all__ = ["PCE", "total_degree_indices", "pce_control_variate"]


def total_degree_indices(d: int, degree: int) -> np.ndarray:
    """All multi-indices alpha in N^d with |alpha| <= degree,
    graded-lexicographically ordered; shape [P, d], P = C(d+p, p)."""
    out = []
    for total in range(degree + 1):
        for c in itertools.combinations_with_replacement(range(d), total):
            alpha = [0] * d
            for k in c:
                alpha[k] += 1
            out.append(alpha)
    return np.asarray(out, dtype=np.int32)


def _orthonormal_1d_all(x, degree, basis):
    """All orthonormal 1-D polynomial values up to `degree`:
    x [...,] -> [..., degree+1]."""
    vals = [torch.ones_like(x)]
    if degree >= 1:
        vals.append(x)
    if basis == "hermite":
        # He_{n+1} = x He_n - n He_{n-1}; orthonormal: He_n / sqrt(n!)
        for n in range(1, degree):
            vals.append(x * vals[n] - n * vals[n - 1])
        scale = [1.0 / math.sqrt(math.factorial(n))
                 for n in range(degree + 1)]
    elif basis == "legendre":
        # (n+1) P_{n+1} = (2n+1) x P_n - n P_{n-1}; orthonormal under
        # the uniform probability measure on [-1,1]: sqrt(2n+1) P_n
        for n in range(1, degree):
            vals.append(((2 * n + 1) * x * vals[n] - n * vals[n - 1])
                        / (n + 1))
        scale = [math.sqrt(2 * n + 1) for n in range(degree + 1)]
    else:
        raise ValueError(f"unknown basis {basis!r}; "
                         "choose 'hermite' or 'legendre'")
    return torch.stack([v * s for v, s in zip(vals, scale)], dim=-1)


class PCE:
    """Total-degree polynomial chaos expansion.

    :param d: input dimension.
    :param degree: total polynomial degree p (P = C(d+p, p) terms).
    :param basis: "hermite" (theta ~ N(0,1)^d) or "legendre"
        (theta ~ U(-1,1)^d).
    :param indices: optional explicit multi-index set [P, d] overriding
        the total-degree set.
    :param dtype: the coefficients' dtype
    :param device: where the fits and the surrogate run (None: the
        current CUDA device)
    """

    def __init__(self, d: int, degree: int, basis: str = "hermite",
                 indices: Optional[np.ndarray] = None, dtype=torch.float64,
                 device=None):
        if d < 1 or degree < 0:
            raise ValueError("need d >= 1 and degree >= 0")
        if basis not in ("hermite", "legendre"):
            raise ValueError(f"unknown basis {basis!r}; "
                             "choose 'hermite' or 'legendre'")
        self.d, self.degree, self.basis = d, degree, basis
        self.indices = (total_degree_indices(d, degree)
                        if indices is None
                        else np.asarray(indices, dtype=np.int32))
        if self.indices.ndim != 2 or self.indices.shape[1] != d:
            raise ValueError("indices must be [P, d]")
        self.n_terms = len(self.indices)
        self.dtype = dtype
        self.device = resolve_device(device)
        self._idx = torch.as_tensor(self.indices, dtype=torch.int64, device=self.device)
        self.coefficients = None          # [P, q] tensor after a fit

    def _as(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
            self.device, self.dtype)

    # ---- design matrix -------------------------------------------
    def design_matrix(self, theta):
        """Psi [N, P] for theta [N, d]."""
        theta = torch.atleast_2d(self._as(theta))
        H = _orthonormal_1d_all(theta, int(self.indices.max(initial=0)),
                                self.basis)            # [N, d, p+1]
        # gather g[n, p, k] = H[n, k, indices[p, k]], product over k
        ks = torch.arange(self.d, device=self.device)[None, :]
        g = H[:, ks, self._idx]
        return g.prod(dim=-1)                          # [N, P]

    # ---- fits ------------------------------------------------------
    def fit_regression(self, theta, y, reg: float = 0.0):
        """Least-squares fit from samples theta [N, d], y [N] or [N, q].
        N >= n_terms required (use `reg` > 0 to ridge-stabilize)."""
        theta = torch.atleast_2d(self._as(theta))
        yv = self._as(y)
        y2 = yv[:, None] if yv.ndim == 1 else yv
        if theta.shape[0] < self.n_terms and reg == 0.0:
            raise ValueError(
                f"regression needs N >= P = {self.n_terms} samples "
                f"(got {theta.shape[0]}); pass reg > 0 to ridge")
        Psi = self.design_matrix(theta)
        if reg > 0.0:
            A = Psi.T @ Psi + reg * torch.eye(self.n_terms, dtype=Psi.dtype,
                                              device=self.device)
            self.coefficients = torch.linalg.solve(A, Psi.T @ y2)
        else:
            self.coefficients = torch.linalg.lstsq(Psi, y2).solution
        self._scalar = yv.ndim == 1
        return self

    def fit_sparse(self, theta, y, lam: Optional[float] = None,
                   lam_grid=None, n_folds: int = 5,
                   max_iter: int = 400, debias: bool = True,
                   seed: int = 0, folds=None):
        """Compressive-sensing fit: LASSO on the PCE coefficients (Doostan
        & Owhadi, JCP 230, 2011), which recovers a sparse expansion from
        fewer model evaluations than basis terms:

            min_c  1/(2N) ||Psi c - y||^2 + lam ||c_{alpha != 0}||_1

        (the constant term is never penalized), solved by FISTA
        (Beck-Teboulle 2009) on the device with the step from a
        power-method bound of ||Psi^T Psi||/N. When ``lam`` is None it is
        selected by k-fold cross-validation over ``lam_grid`` (default
        lam_max * logspace(-4, -0.5, 16)); every (lambda, fold) cell runs
        in one batched FISTA. With ``debias`` the selected support is
        refit by restricted least squares.

        :param y: scalar samples [N]
        :param folds: [N] fold number of each sample in place of the
            seeded permutation
        :return: self; diagnostics in ``self.sparse_info`` (chosen
            ``lam``, ``cv_rmse`` per grid point, ``support_size``).
        """
        theta = torch.atleast_2d(self._as(theta))
        yv = self._as(y)
        if yv.ndim != 1:
            raise ValueError("fit_sparse targets one scalar QoI: y [N]")
        if n_folds < 2:
            raise ValueError("n_folds must be >= 2")
        N = theta.shape[0]
        P = self.n_terms
        dtype = yv.dtype
        pen = torch.as_tensor(self.indices.sum(axis=1) > 0).to(self.device, dtype)
        Psi = self.design_matrix(theta)                 # [N, P]

        def power_L(Pw):
            """||Pw^T Pw|| / N by 24 power steps, Pw [B, N, P] -> [B]."""
            v = torch.full((Pw.shape[0], P, 1), 1.0 / np.sqrt(P), dtype=dtype,
                           device=self.device)
            for _ in range(24):
                w = Pw.mT @ (Pw @ v)
                v = w / torch.linalg.vector_norm(w, dim=1, keepdim=True)
            return (v * (Pw.mT @ (Pw @ v))).sum((1, 2)) / N

        def fista(lam, w):
            """Weighted-sample LASSO, batched: lam [B], w [B, N] in {0,1}
            masking CV folds -> c [B, P]."""
            nw = torch.clamp(w.sum(1), min=1.0)[:, None, None]          # [B, 1, 1]
            Pw = Psi * w[:, :, None]                                     # [B, N, P]
            L = power_L(Pw)[:, None, None] * (N / nw) + 1e-12
            thr = lam[:, None, None] * pen[:, None] / L                  # [B, P, 1]
            c = z = torch.zeros(w.shape[0], P, 1, dtype=dtype, device=self.device)
            t = torch.ones((), dtype=dtype, device=self.device)
            for _ in range(max_iter):
                grad = Pw.mT @ (Psi @ z - yv[:, None]) / nw
                u = z - grad / L
                c_new = torch.sign(u) * torch.clamp(torch.abs(u) - thr, min=0.0)
                t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
                z = c_new + ((t - 1.0) / t_new) * (c_new - c)
                c, t = c_new, t_new
            return c[:, :, 0]

        if lam is None:
            lam_max = float((torch.abs(Psi.T @ yv) * pen).max() / N)
            grid = (np.asarray(lam_grid, np.float64) if lam_grid
                    is not None else
                    lam_max * np.logspace(-4, -0.5, 16))
            if folds is None:
                gen = torch.Generator().manual_seed(int(seed))
                folds = (np.arange(N) % n_folds)[torch.randperm(N, generator=gen).numpy()]
            folds = np.asarray(folds)
            fold_masks = torch.as_tensor(np.stack(
                [(folds != f).astype(float) for f in range(n_folds)])).to(self.device, dtype)
            lam_rep = torch.as_tensor(grid).to(self.device, dtype).repeat_interleave(n_folds)
            w_rep = fold_masks.repeat(len(grid), 1)
            c = fista(lam_rep, w_rep)                                    # [G F, P]
            r = ((Psi @ c.T).T - yv) * (1.0 - w_rep)
            errs = (r * r).sum(1) / torch.clamp((1.0 - w_rep).sum(1), min=1.0)
            errs = errs.reshape(len(grid), n_folds).mean(1).cpu().numpy()
            lam = float(grid[int(np.argmin(errs))])
            cv_rmse = np.sqrt(errs)
        else:
            grid, cv_rmse = np.array([lam]), None

        ones = torch.ones(1, N, dtype=dtype, device=self.device)
        c = fista(torch.full((1,), float(lam), dtype=dtype, device=self.device), ones)[0]
        if debias:
            m = (torch.abs(c) > 1e-12 * torch.clamp(torch.abs(c).max(), min=1e-300)) \
                | (pen == 0)
            if int(m.sum()) <= N:   # refit only when well-posed
                mf = m.to(dtype)
                A = (Psi.T @ Psi) * torch.outer(mf, mf) + torch.diag(1.0 - mf)
                b = mf * (Psi.T @ yv)
                c = mf * torch.linalg.solve(A, b)
        self.coefficients = c[:, None]
        self._scalar = True
        self.sparse_info = {
            "lam": float(lam), "lam_grid": np.asarray(grid),
            "cv_rmse": cv_rmse,
            "support_size": int((torch.abs(c) > 0).sum()),
        }
        return self

    def fit_projection(self, fn: Callable, level: int,
                       rule: Optional[str] = None, grid=None):
        """Spectral projection ``c = Psi(nodes)^T (w * f(nodes))`` on a
        Smolyak grid of the matching rule, ``fn(theta [N, d]) -> [N]`` or
        ``[N, q]``. Exact when the grid integrates degree ``degree(fn) +
        self.degree`` (Gauss-Hermite: level w is exact to total degree
        2w+1)."""
        from mlmc_tpu_torch.collocation import SparseGrid
        if grid is None:
            rule = rule or ("gauss-hermite" if self.basis == "hermite"
                            else "gauss-legendre")
            grid = SparseGrid(self.d, level, rule=rule)
        nodes = self._as(grid.nodes)
        w = self._as(grid.weights)
        y = fn(nodes)
        self._scalar = y.ndim == 1
        y2 = y[:, None] if y.ndim == 1 else y
        self.coefficients = self.design_matrix(nodes).T @ (w[:, None] * y2)
        return self

    # ---- surrogate + statistics -----------------------------------
    def _need_fit(self):
        if self.coefficients is None:
            raise RuntimeError("fit the expansion first "
                               "(fit_regression / fit_projection)")

    def __call__(self, theta):
        """Surrogate evaluation: theta [d] or [N, d] -> [q]/[N, q]
        (scalar squeezed when fitted on scalar y), a tensor on the
        expansion's device."""
        self._need_fit()
        theta = self._as(theta)
        single = theta.ndim == 1
        out = self.design_matrix(theta) @ self.coefficients
        if self._scalar:
            out = out[:, 0]
        return out[0] if single else out

    def _zero_mask(self):
        """Rows of the index set that are the alpha = 0 (constant)
        term — not guaranteed present/first for custom index sets."""
        return self.indices.sum(axis=1) == 0

    def _coef(self):
        return self.coefficients.cpu().numpy().astype(np.float64)

    def mean(self):
        self._need_fit()
        z = self._zero_mask()
        c = self._coef()
        c0 = c[z].sum(axis=0) if z.any() else np.zeros(c.shape[1:])
        return float(c0[0]) if self._scalar else c0

    def var(self):
        self._need_fit()
        z = self._zero_mask()
        v = (self._coef()[~z] ** 2).sum(axis=0)
        return float(v[0]) if self._scalar else v

    def sobol(self):
        """Closed-form Sobol' indices from the coefficient groups
        (Sudret 2008): dict with ``first_order`` [d(, q)],
        ``total_effect``, ``mean``, ``variance``. The alpha=0 term is
        excluded from all variance sums."""
        self._need_fit()
        c2 = self._coef() ** 2                           # [P, q]
        nz = self.indices > 0                            # [P, d]
        active = nz.sum(axis=1)
        var = c2[active > 0].sum(axis=0)
        var = np.where(var > 0, var, np.inf)             # S := 0 if flat
        first = np.empty((self.d,) + c2.shape[1:])
        total = np.empty_like(first)
        for k in range(self.d):
            only_k = nz[:, k] & (active == 1)
            first[k] = c2[only_k].sum(axis=0) / var
            total[k] = c2[nz[:, k]].sum(axis=0) / var
        if self._scalar:
            first, total = first[:, 0], total[:, 0]
        return {"first_order": first, "total_effect": total,
                "mean": self.mean(), "variance": self.var()}


def _keyed_inputs(seed, basis, d, dtype, device):
    def draws(part, c, m, chunk):
        idx = c * chunk + torch.arange(m, dtype=torch.int64, device=device)
        if basis == "hermite":
            return SampleKeys(int(seed), part, idx).normals(d, dtype)
        u = keyed_uniforms(int(seed), part, idx, torch.zeros_like(idx), d, dtype)
        return 2.0 * u - 1.0
    return draws


def pce_control_variate(f_fn: Callable, pce: PCE, n: int, seed: int = 0,
                        split: float = 0.5, chunk_size: int = 1 << 13,
                        dtype=torch.float64, draws=None):
    """Estimate ``E[f]`` with the fitted expansion as a control variate
    whose mean is exact:

        est = mean_n[ f(theta) - beta (g(theta) - E[g]) ],

    ``g`` the PCE surrogate and ``E[g] = c_0`` from the coefficients.
    ``beta = Cov(f, g)/Var(g)`` is fitted on the first ``split`` fraction
    of the samples and frozen on the rest, so the estimate is exactly
    unbiased. The chunks run on the expansion's device; their moments are
    summed in float64 on the host.

    :param f_fn: ``theta [C, d] -> [C]``
    :param pce: a fitted scalar :class:`PCE` (its basis fixes the input
        law: hermite -> N(0,1)^d, legendre -> U(-1,1)^d)
    :param n: total model evaluations (split between beta fit and
        estimate)
    :param draws: ``(part, chunk, m) -> theta [m, d]`` in place of the
        keyed inputs
    :return: dict with ``mean``, ``se``, ``beta``, ``rho`` (fit-half
        correlation), ``var_reduction`` (plain-MC variance of the
        evaluation half / CV variance), ``n_fit``, ``n_eval``
    """
    pce._need_fit()
    if not pce._scalar:
        raise ValueError("control variates target one scalar QoI")
    if not 0.0 < split < 1.0:
        raise ValueError("split must be in (0, 1)")
    device = pce.device
    keyed = _keyed_inputs(seed, pce.basis, pce.d, dtype, device)
    draw = draws or (lambda part, c, m: keyed(part, c, m, chunk_size))
    g_mean = float(pce.mean())
    n_fit = max(int(n * split), 2)
    n_eval = max(int(n) - n_fit, 2)

    def accumulate(part, m, stats):
        total, done, c = 0.0, 0, 0
        while done < m:
            take = min(chunk_size, m - done)
            theta = draw(part, c, take).to(device, dtype)
            f = f_fn(theta).to(dtype)
            g = pce(theta).to(dtype)
            total = total + torch.stack(stats(f, g)).to(torch.float64).cpu().numpy()
            done += take
            c += 1
        return total, done

    (sf, sg, sfg, sff, sgg), m = accumulate(
        0, n_fit, lambda f, g: [f.sum(), g.sum(), (f * g).sum(), (f * f).sum(),
                                (g * g).sum()])
    mf, mg = sf / m, sg / m
    cov = sfg / m - mf * mg
    var_g = max(sgg / m - mg * mg, 1e-300)
    var_f = max(sff / m - mf * mf, 1e-300)
    beta = cov / var_g
    rho = cov / np.sqrt(var_f * var_g)

    def cv_stats(f, g):
        z = f - beta * (g - g_mean)
        return [z.sum(), (z * z).sum(), f.sum(), (f * f).sum()]

    (sz, szz, sf2, sff2), done = accumulate(1, n_eval, cv_stats)
    mean = sz / done
    var_z = max(szz / done - mean * mean, 0.0)
    var_plain = max(sff2 / done - (sf2 / done) ** 2, 1e-300)
    return {"mean": float(mean),
            "se": float(np.sqrt(var_z / done)),
            "beta": float(beta), "rho": float(rho),
            "var_reduction": float(var_plain / max(var_z, 1e-300)),
            "n_fit": int(m), "n_eval": int(done)}
