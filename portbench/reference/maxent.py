"""The maximum-entropy density of a set of estimated moments, in NumPy.

The moment functions are the Legendre polynomials phi_0 .. phi_{R-1} of the
domain. As GeoMop/MLMC's ``construct_ortogonal_moments`` does, the basis is
first orthogonalised under the estimated moment covariance: the covariance
centred by its first column is decomposed, and the eigenvectors whose
eigenvalues exceed ``orth_tol`` span the kept functions. The density is
rho(x) = exp(-sum_j beta_j psi_j(x)) over that span, with int psi rho = the
estimated moments of psi; it is found by Newton's method on the dual on a
fixed Gauss-Legendre grid. The solution depends only on the span and the
moments, not on the basis chosen inside the span.
"""
import numpy as np

PANELS, NODES = 128, 16


def kept_span(cov, orth_tol):
    """[R, K] orthonormal basis of the kept span in coefficient space."""
    R = cov.shape[0]
    center = np.eye(R)
    center[:, 0] = -cov[:, 0]
    vals, vecs = np.linalg.eigh(center @ cov @ center.T)
    cut = int(np.argmax(vals > orth_tol))
    q, _ = np.linalg.qr(center.T @ vecs[:, cut:])
    return q


def _grid(domain):
    a, b = domain
    x, w = np.polynomial.legendre.leggauss(NODES)
    edges = np.linspace(a, b, PANELS + 1)
    half = 0.5 * np.diff(edges)
    mid = 0.5 * (edges[1:] + edges[:-1])
    return ((mid[:, None] + half[:, None] * x).ravel(),
            (half[:, None] * w).ravel())


def legendre(x, domain, R):
    a, b = domain
    return np.polynomial.legendre.legvander((x - a) * 2.0 / (b - a) - 1.0, R - 1)


def density(cov, mean, domain, orth_tol=1e-4, tol=1e-12, max_iter=200):
    """rho as a function of x, and (Newton iterations, final |gradient|)."""
    R = cov.shape[0]
    span = kept_span(cov, orth_tol)
    target = span.T @ mean
    x, w = _grid(domain)
    psi = legendre(x, domain, R) @ span                      # [Q, K]
    beta = np.zeros(span.shape[1])

    def dual(beta):
        rho = np.exp(np.clip(-psi @ beta, -700, 700))
        return beta @ target + w @ rho, rho

    value, rho = dual(beta)
    for it in range(max_iter):
        grad = target - psi.T @ (w * rho)
        if np.linalg.norm(grad) <= tol:
            break
        hess = psi.T @ (psi * (w * rho)[:, None])
        step = -np.linalg.solve(hess, grad)
        t = 1.0
        while True:
            new_value, new_rho = dual(beta + t * step)
            if new_value <= value + 1e-4 * t * (grad @ step) or t < 1e-10:
                break
            t *= 0.5
        beta, value, rho = beta + t * step, new_value, new_rho
    else:
        raise RuntimeError("reference maxent: |gradient| %.3g after %d Newton steps"
                           % (np.linalg.norm(grad), max_iter))

    def rho_of(points):
        phi = legendre(np.asarray(points, dtype=float), domain, R) @ span
        return np.exp(np.clip(-phi @ beta, -700, 700))

    return rho_of, (it, float(np.linalg.norm(grad)))
