"""Fourier option pricing: the COS method and a characteristic-function
library (counterpart of ``mlmc_tpu/tool/fourier_pricing.py``, host numpy
as there): the closed-form anchors of the price-process simulations, in
particular of variance gamma (``sim/levy.py``), whose density is known
only through its characteristic function.

The COS method (Fang & Oosterlee, SIAM J. Sci. Comput. 31(2), 2008)
expands the density of ``y = ln(S_T / K)`` in a cosine series on a
cumulant-sized interval and integrates the payoff against each cosine in
closed form. Characteristic functions are of ``X = ln(S_T / S_0)``
including the risk-neutral drift (``cf(-1j) = e^{rT}``).
"""
import numpy as np

__all__ = ["cos_price", "cumulants_from_cf", "cf_gbm", "cf_merton",
           "cf_vg", "cf_heston", "vg_omega"]


def cumulants_from_cf(cf, h=5e-3):
    """(c1, c2) of X from central log-CF differences:
    ``log cf(u) = i c1 u - c2 u^2/2 + O(u^3)``. Used only to size the
    COS truncation interval, so ~1% accuracy is ample."""
    lp = np.log(cf(np.array([h, -h])))
    c1 = float((lp[0] - lp[1]).imag / (2.0 * h))
    c2 = float(-(lp[0] + lp[1]).real / (h * h))
    return c1, max(c2, 1e-12)


def cos_price(cf, s0, strike, rate, T, kind="call", c1=None, c2=None,
              c4=0.0, n_terms=512, interval_width=12.0):
    """European option price by the COS method.

    :param cf: characteristic function of ``X = ln(S_T/S_0)`` (vector
        callable, risk-neutral drift included).
    :param kind: ``'call'`` or ``'put'``.
    :param c1/c2/c4: cumulants of X for the truncation interval
        ``[c1 +- L sqrt(c2 + sqrt(c4))]``; numerical if omitted.
    :param n_terms: cosine terms (exponential convergence).
    :param interval_width: L.
    """
    if kind not in ("call", "put"):
        raise ValueError("kind must be 'call' or 'put'")
    if c1 is None or c2 is None:
        c1, c2 = cumulants_from_cf(cf)
    x = float(np.log(s0 / strike))
    L = float(interval_width)
    half = L * np.sqrt(c2 + np.sqrt(max(c4, 0.0)))
    a, b = x + c1 - half, x + c1 + half
    k = np.arange(n_terms)
    u = k * np.pi / (b - a)

    def chi(c, d):
        uc, ud = u * (c - a), u * (d - a)
        return (np.cos(ud) * np.exp(d) - np.cos(uc) * np.exp(c)
                + u * (np.sin(ud) * np.exp(d)
                       - np.sin(uc) * np.exp(c))) / (1.0 + u * u)

    def psi(c, d):
        out = np.empty_like(u)
        out[0] = d - c
        out[1:] = (np.sin(u[1:] * (d - a))
                   - np.sin(u[1:] * (c - a))) / u[1:]
        return out

    if kind == "call":
        if b <= 0:
            return 0.0
        lo = max(a, 0.0)                   # payoff support within [a, b]
        V = strike * (chi(lo, b) - psi(lo, b))
    else:
        if a >= 0:
            return 0.0
        hi = min(b, 0.0)
        V = strike * (psi(a, hi) - chi(a, hi))
    V *= 2.0 / (b - a)
    phi_y = cf(u) * np.exp(1j * u * x)     # cf of y = X + ln(s0/K)
    terms = np.real(phi_y * np.exp(-1j * u * a)) * V
    terms[0] *= 0.5
    return float(np.exp(-rate * T) * np.sum(terms))


def cf_gbm(rate, sigma, T):
    """GBM: ``X ~ N((r - sigma^2/2)T, sigma^2 T)``; cumulants
    attached as ``.cumulants = (c1, c2, c4)``."""
    mu = (rate - 0.5 * sigma ** 2) * T

    def cf(u):
        return np.exp(1j * u * mu - 0.5 * sigma ** 2 * T * u * u)

    cf.cumulants = (mu, sigma ** 2 * T, 0.0)
    return cf


def cf_merton(rate, sigma, lam, jump_mean, jump_std, T):
    """Merton jump-diffusion (compensated drift, cf.
    sim/jumps.py:merton): lognormal jump sizes at Poisson intensity
    ``lam``."""
    kappa = np.expm1(jump_mean + 0.5 * jump_std ** 2)
    mu = (rate - lam * kappa - 0.5 * sigma ** 2) * T

    def cf(u):
        jump = np.exp(1j * u * jump_mean
                      - 0.5 * jump_std ** 2 * u * u) - 1.0
        return np.exp(1j * u * mu - 0.5 * sigma ** 2 * T * u * u
                      + lam * T * jump)

    jm, jv = jump_mean, jump_std
    cf.cumulants = (mu + lam * T * jm,
                    (sigma ** 2 + lam * (jm ** 2 + jv ** 2)) * T,
                    lam * T * (jm ** 4 + 6 * jm ** 2 * jv ** 2
                               + 3 * jv ** 4))
    return cf


def vg_omega(sigma, theta, nu):
    """Martingale (compensator) drift correction of the variance-gamma
    exponent: ``omega = ln(1 - theta nu - sigma^2 nu / 2) / nu`` (must
    have ``theta nu + sigma^2 nu/2 < 1``)."""
    arg = 1.0 - theta * nu - 0.5 * sigma ** 2 * nu
    if arg <= 0.0:
        raise ValueError("VG parameters violate theta*nu + "
                         "sigma^2*nu/2 < 1 (no martingale measure)")
    return float(np.log(arg) / nu)


def cf_vg(rate, sigma, theta, nu, T):
    """Variance gamma (Madan, Carr & Seneta): Brownian motion with
    drift ``theta`` and volatility ``sigma`` time-changed by a gamma
    subordinator of variance rate ``nu``, risk-neutral drift
    ``r + omega``."""
    omega = vg_omega(sigma, theta, nu)

    def cf(u):
        return (np.exp(1j * u * (rate + omega) * T)
                * (1.0 - 1j * u * theta * nu
                   + 0.5 * sigma ** 2 * nu * u * u) ** (-T / nu))

    cf.cumulants = ((rate + omega + theta) * T,
                    (sigma ** 2 + nu * theta ** 2) * T,
                    3.0 * (sigma ** 4 * nu + 2 * theta ** 4 * nu ** 3
                           + 4 * sigma ** 2 * theta ** 2 * nu ** 2) * T)
    return cf


def cf_heston(rate, kappa, theta, xi, rho, v0, T):
    """Heston CF of ``ln(S_T/S_0)`` in the 'little trap' form
    (Albrecher et al. 2007) — the same formulation as
    sim/sde.py:heston_call_price's j=2 measure, kept as an independent
    pricing path so COS and Gil-Pelaez cross-validate."""

    def cf(u):
        u = np.asarray(u, np.complex128)
        b = kappa
        d = np.sqrt((rho * xi * 1j * u - b) ** 2
                    - xi ** 2 * (-1j * u - u ** 2))
        g = (b - rho * xi * 1j * u - d) / (b - rho * xi * 1j * u + d)
        exp_dT = np.exp(-d * T)
        C = (rate * 1j * u * T + kappa * theta / xi ** 2 * (
            (b - rho * xi * 1j * u - d) * T
            - 2.0 * np.log((1.0 - g * exp_dT) / (1.0 - g))))
        D = ((b - rho * xi * 1j * u - d) / xi ** 2
             * (1.0 - exp_dT) / (1.0 - g * exp_dT))
        return np.exp(C + D * v0)

    return cf
