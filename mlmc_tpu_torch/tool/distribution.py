"""Legacy maxent solver: size continuation + exact trust-region Newton
(counterpart of ``mlmc_tpu/tool/distribution.py``; host numpy and scipy).

Independent re-design of reference mlmc/tool/distribution.py:6-456. Same
density model as SimpleDistribution,

    rho(x) = exp(-sum_i lambda_i phi_i(x) / sigma_i),

but fitted by the legacy strategy:

* geometric size-continuation schedule (approximation sizes growing ~1.2x,
  kept odd, reference :96-124) with zero-padded warm-started multipliers
  between stages (``extend_size``, :234-250),
* an EXACT trust-region Newton (the reference uses scipy ``trust-exact``,
  maxiter 200, :134-141): here the trust-region subproblem is solved by the
  More-Sorensen secular equation on the Hessian eigendecomposition
  (R <= ~60, so the eigh is microseconds),
* optional quadratic regularization of the non-constant multipliers
  (``reg_param``) stabilizing badly conditioned high moment counts,
* a root-solver path ``estimate_density`` (reference :159-181) solving the
  moment-matching conditions grad F(lambda) = 0 directly.

Quadrature: the module-level h-adaptive Gauss panel builder shared with
SimpleDistribution (adaptive_panels / panels_to_quadrature), refreshed under
the reference's accuracy guard ||d lambda|| * ||grad|| < quad_tol.
"""
import numpy as np
import scipy.optimize

from mlmc_tpu_torch.tool.simple_distribution import (
    adaptive_panels, panels_to_quadrature)

_EXP_CLIP = 200.0


def _tr_subproblem(gradient, hessian, radius):
    """Nearly-exact trust-region step (More-Sorensen via eigh).

    Minimizes g^T p + p^T H p / 2 subject to |p| <= radius.
    :return: step p
    """
    w, Q = np.linalg.eigh(hessian)
    gq = Q.T @ gradient

    if w[0] > 1e-12:
        newton = Q @ (-gq / w)
        if np.linalg.norm(newton) <= radius:
            return newton

    def boundary_norm(shift):
        return np.linalg.norm(gq / (w + shift))

    lo = max(0.0, -w[0]) + 1e-12
    if boundary_norm(lo + 1e-12) <= radius:
        # hard case: gradient ~ orthogonal to the lowest eigenvector; move
        # along it until the boundary
        p = Q @ (-gq / np.maximum(w + lo, 1e-12))
        gap = radius ** 2 - np.dot(p, p)
        if gap > 0:
            p = p + np.sqrt(gap) * Q[:, 0]
        return p

    hi = lo + max(1.0, abs(w[0])) + np.linalg.norm(gq) / radius
    for _ in range(100):
        if boundary_norm(hi) < radius:
            break
        hi *= 2.0
    shift = scipy.optimize.brentq(
        lambda s: boundary_norm(s) - radius, lo + 1e-15, hi, xtol=1e-14)
    return Q @ (-gq / (w + shift))


class Distribution:
    """Continuation + exact-trust-region maxent fit (legacy API)."""

    def __init__(self, moments_obj, moment_data, domain=None,
                 force_decay=(True, True), verbose=False):
        if domain is None:
            domain = moments_obj.domain
        self.domain = domain
        self.decay_penalty = force_decay
        self._verbose = verbose
        self.moment_means = np.asarray(moment_data[:, 0], dtype=float)
        self.moment_errs = np.sqrt(np.asarray(moment_data[:, 1], dtype=float))
        self.moments_fn = moments_obj
        self.approx_size = len(self.moment_means)
        self.multipliers = None

        self._max_iter = 200  # reference trust-exact maxiter (:134-141)
        self._quad_tol = 1e-10
        self._max_panels = 256
        self._reg_param = 0.0
        # fitted-size state (set per continuation stage)
        self._size = None

    # ------------------------------------------------------------------ #
    # public evaluation API (same surface as the reference class)
    # ------------------------------------------------------------------ #
    def eval_moments(self, x):
        size = self._size or self.approx_size
        return np.asarray(self.moments_fn.eval_all_np(
            np.asarray(x, dtype=float), size))

    def density(self, value):
        value = np.atleast_1d(np.asarray(value, dtype=float))
        moms = self.eval_moments(value)
        errs = self.moment_errs[:moms.shape[-1]]
        power = -np.sum(moms * self.multipliers / errs, axis=-1)
        return np.exp(np.clip(power, -_EXP_CLIP, _EXP_CLIP))

    def cdf(self, values):
        import scipy.integrate as integrate

        values = np.atleast_1d(values).astype(float)
        out = np.empty(len(values))
        last_x, last_y = self.domain[0], 0.0
        # ascending evaluation, results scattered to the INPUT positions
        for i in np.argsort(values, kind="stable"):
            val = values[i]
            if val <= self.domain[0]:
                last_y = 0.0
            elif val >= self.domain[1]:
                last_y = 1.0
            else:
                last_y += integrate.fixed_quad(self.density, last_x, val, n=10)[0]
                last_x = val
            out[i] = last_y
        return out

    # ------------------------------------------------------------------ #
    # continuation schedule + warm start
    # ------------------------------------------------------------------ #
    @staticmethod
    def size_schedule(final_size, start=5, factor=1.2):
        """Geometric, odd-valued continuation sizes (reference :96-124)."""
        sizes = []
        s = start
        while s < final_size:
            s_odd = s if s % 2 == 1 else s + 1
            if not sizes or s_odd > sizes[-1]:
                sizes.append(min(s_odd, final_size))
            s = int(np.ceil(s * factor))
        if not sizes or sizes[-1] != final_size:
            sizes.append(final_size)
        return sizes

    def extend_size(self, multipliers, new_size):
        """Warm-start padding with zeros (reference :234-250)."""
        out = np.zeros(new_size)
        if multipliers is not None:
            out[:len(multipliers)] = multipliers
        return out

    # ------------------------------------------------------------------ #
    # objective machinery on the current panel grid
    # ------------------------------------------------------------------ #
    def _refresh_quadrature(self, multipliers, force=False):
        if not force:
            d_mult = np.linalg.norm(multipliers - self._grid_multipliers)
            if d_mult * np.linalg.norm(self._grid_gradient) < self._quad_tol:
                return
        errs = self.moment_errs[:self._size]

        def rho_phi_last(x):
            moms = np.asarray(self.moments_fn.eval_all_np(x, self._size))
            power = -np.sum(moms * multipliers / errs, axis=-1)
            return (np.exp(np.clip(power, -_EXP_CLIP, _EXP_CLIP))
                    * np.abs(moms[..., -1]))

        breaks, _ = adaptive_panels(rho_phi_last, self.domain[0],
                                    self.domain[1], tol=self._quad_tol,
                                    max_panels=self._max_panels)
        pts, wts = panels_to_quadrature(breaks)
        self._q_pts = pts
        self._q_wts = wts
        self._q_moms = np.asarray(
            self.moments_fn.eval_all_np(pts, self._size)) / errs[None, :]
        self._grid_multipliers = np.array(multipliers)
        _, g, _ = self._objective(multipliers, order=1)
        self._grid_gradient = g

    #: reference penalty strength (reference distribution.py:47)
    PENALTY_COEF = 10.0

    def _objective(self, lam, order=2):
        """(F, grad, hess) on the current grid; ``order`` limits the work."""
        mu = self.moment_means[:self._size] / self.moment_errs[:self._size]
        power = -self._q_moms @ lam
        rho_w = np.exp(np.clip(power, -_EXP_CLIP, _EXP_CLIP)) * self._q_wts

        reg = self._reg_param
        F = float(mu @ lam + rho_w.sum() + reg * np.dot(lam[1:], lam[1:]))

        # endpoint decay penalty (reference :340-412): where force_decay is
        # set, density GROWTH toward the boundary (end_diff > 0) is
        # penalized with |F|-scaled quadratic terms; per the reference, |F|
        # acts as a frozen scale (its own derivative is ignored)
        rows = self._end_rows
        active = None
        if rows is not None:
            end_diff = rows @ lam
            active = np.maximum(end_diff, 0.0)
            F = F + abs(F) * self.PENALTY_COEF * float(np.sum(active ** 2))
        if order < 1:
            return F, None, None

        grad = mu - self._q_moms.T @ rho_w
        if reg:
            grad = grad + 2 * reg * np.concatenate([[0.0], lam[1:]])
        if rows is not None:
            grad = grad + abs(F) * self.PENALTY_COEF * 2.0 * (active @ rows)
        if order < 2:
            return F, grad, None

        hess = (self._q_moms.T * rho_w) @ self._q_moms
        if reg:
            hess = hess + 2 * reg * np.diag([0.0] + [1.0] * (self._size - 1))
        if rows is not None:
            for side in range(rows.shape[0]):
                if active[side] > 0:
                    hess = hess + abs(F) * self.PENALTY_COEF * 2.0 * np.outer(
                        rows[side], rows[side])
        return F, grad, hess

    # ------------------------------------------------------------------ #
    def _solve_stage(self, lam0, tol):
        """Exact-trust-region Newton on one continuation stage."""
        lam = np.array(lam0, dtype=float)
        # endpoint decay rows for this stage's size (None = no penalty)
        self._end_rows = (self.end_point_derivatives()
                          if any(self.decay_penalty) else None)
        self._grid_multipliers = lam
        self._grid_gradient = np.ones(self._size)
        self._refresh_quadrature(lam, force=True)

        radius = 1.0
        n_it = 0
        F, grad, hess = self._objective(lam)
        for n_it in range(1, self._max_iter + 1):
            gnorm = np.linalg.norm(grad)
            if gnorm < tol:
                break
            step = _tr_subproblem(grad, hess, radius)
            predicted = -(grad @ step + 0.5 * step @ hess @ step)
            trial = lam + step
            F_new = self._objective(trial, order=0)[0]
            ratio = (F - F_new) / predicted if predicted > 0 else -1.0

            if ratio < 0.25:
                radius = max(0.25 * radius, 1e-12)
            elif ratio > 0.75 and np.linalg.norm(step) > 0.9 * radius:
                radius = min(2.0 * radius, 1e4)
            if ratio > 1e-4:
                lam = trial
                self._refresh_quadrature(lam)
                F, grad, hess = self._objective(lam)
        return lam, np.linalg.norm(grad), n_it

    def estimate_density_minimize(self, tol=1e-7, reg_param=0.0):
        """Fit with size continuation; returns a scipy-like result object."""
        self._reg_param = float(reg_param)
        multipliers = None
        gnorm, total_it = np.inf, 0
        for size in self.size_schedule(self.approx_size):
            self._size = size
            lam0 = self.extend_size(multipliers, size)
            if multipliers is None:
                # uniform-density start (lambda_0 fixes normalization)
                lam0[0] = -np.log(1.0 / (self.domain[1] - self.domain[0])) \
                    * self.moment_errs[0]
            multipliers, gnorm, n_it = self._solve_stage(lam0, tol)
            total_it += n_it
            if self._verbose:
                print("stage size={} |grad|={:.3e} iters={}".format(
                    size, gnorm, n_it))
        self.multipliers = multipliers
        self._size = self.approx_size

        # normalization fix: lambda_0 -= log(m_0) (reference :82-86 analogue)
        m0 = float(np.dot(
            np.exp(np.clip(-self._q_moms @ multipliers, -_EXP_CLIP, _EXP_CLIP)),
            self._q_wts))
        self.multipliers = multipliers + np.concatenate(
            [[np.log(m0) * self.moment_errs[0]], np.zeros(self._size - 1)])

        return scipy.optimize.OptimizeResult(
            x=self.multipliers, success=bool(gnorm < max(tol * 100, 1e-5)),
            fun=None, nit=total_it, gnorm=gnorm)

    def estimate_density(self, tol=1e-7):
        """Root-solver path (reference :159-181): solve grad F(lambda) = 0
        with the analytic Jacobian (= Hessian), warm-started from a short
        continuation run."""
        self.estimate_density_minimize(tol=max(tol, 1e-5))
        self._size = self.approx_size

        # damped Newton on the residual, on a FROZEN grid per outer round
        # (a mid-solve grid rebuild would make the residual discontinuous);
        # the objective is convex, so lstsq-Newton with |grad| line search
        # converges to machine precision in a couple of steps
        lam = np.array(self.multipliers)
        gnorm = np.inf
        n_it = 0
        for _outer in range(3):
            self._refresh_quadrature(lam, force=True)
            for _ in range(50):
                n_it += 1
                _, grad, hess = self._objective(lam)
                gnorm = np.linalg.norm(grad)
                if gnorm < tol:
                    break
                step = np.linalg.lstsq(hess, -grad, rcond=None)[0]
                t = 1.0
                for _ls in range(30):
                    g_try = self._objective(lam + t * step, order=1)[1]
                    if np.linalg.norm(g_try) < gnorm:
                        break
                    t *= 0.5
                lam = lam + t * step
            if gnorm < tol:
                break
        self.multipliers = lam
        return scipy.optimize.OptimizeResult(
            x=lam, success=bool(gnorm < max(tol, 1e-10) * 100),
            fun=self._objective(lam, order=1)[1], nit=n_it)

    def end_point_derivatives(self):
        """Endpoint moment-derivative rows (decay-penalty hook, :240-252)."""
        eps = 1e-10
        size = self._size or self.approx_size
        left = right = np.zeros(size)
        if self.decay_penalty[0]:
            left = (self.eval_moments(self.domain[0] + eps)
                    - self.eval_moments(self.domain[0]))[0]
        if self.decay_penalty[1]:
            right = (self.eval_moments(self.domain[1] - eps)
                     - self.eval_moments(self.domain[1]))[0]
        return np.stack([left, right]) / eps / self.moment_errs[None, :size]
