"""Darcy flow through a log-normal conductivity on the unit square, in plain
PyTorch (GeoMop/MLMC ``test/01_cond_field``, as BASELINE config 5 runs it).

* The log-conductivity G is a stationary Gaussian field with covariance
  exp(-|d|^2 / corr_length^2) at the centres of the n x n cells of the
  finest grid of a sample, drawn exactly by circulant embedding on the
  doubled torus: G = Re(FFT(sqrt(eig) (w_r + i w_i))) / sqrt(M), cropped;
  w_r, w_i are the sample's white noise (``philox.wide_normals``). The
  coarse grid takes the fine cells nearest its own centres.
* K = exp(sigma G). Cell-centred finite volumes with harmonic face
  conductivities, p = 1 on the left edge and 0 on the right through half
  cells (transmissibility 2K), no flow through top and bottom.
* The QoI is the outflow through the right edge, sum_i 2 K_i p_i.

The pressure is solved by conjugate gradients preconditioned by the exact
inverse of the unit-conductivity operator (sine and cosine transforms) and
the diagonal scaling, in float64 to a relative residual of ``TOL``.
"""
import numpy as np
import torch

from reference import philox

TOL = 1e-12
MAX_ITER = 20000


def embedding_eigenvalues(n, corr_length):
    """Eigenvalues (float64 numpy [2n, 2n], negatives clipped) of the
    covariance on the torus of twice the grid, spacing 1/n."""
    m = 2 * n
    ix = np.arange(m)
    dist = np.minimum(ix, m - ix) / n
    sq = dist[:, None] ** 2 + dist[None, :] ** 2
    eig = np.fft.fft2(np.exp(-sq / corr_length ** 2)).real
    return np.maximum(eig, 0.0)


def coarse_index(fine_n, n):
    """Fine cells nearest the centres of an n-cell coarse row."""
    stride = fine_n // n
    idx = np.round((np.arange(n) + 0.5) * stride - 0.5).astype(np.int64)
    return np.clip(idx, 0, fine_n - 1)


def log_field(noise, eig):
    """G on the fine grid [B, n, n] from noise [B, 2, 2n, 2n]."""
    sqrt_eig = torch.sqrt(torch.as_tensor(eig, device=noise.device, dtype=noise.dtype))
    w = torch.complex(noise[:, 0], noise[:, 1])
    g = torch.fft.fftn(sqrt_eig * w, dim=(-2, -1)).real / np.sqrt(eig.size)
    n = eig.shape[0] // 2
    return g[:, :n, :n]


def _faces(K):
    Kx = 2.0 * K[:, :, :-1] * K[:, :, 1:] / (K[:, :, :-1] + K[:, :, 1:])
    Ky = 2.0 * K[:, :-1, :] * K[:, 1:, :] / (K[:, :-1, :] + K[:, 1:, :])
    return Kx, Ky, 2.0 * K[:, :, 0], 2.0 * K[:, :, -1]


def _apply(p, Kx, Ky, Kl, Kr):
    """The finite-volume operator (outflow of each cell) on pressures p."""
    fx = Kx * (p[:, :, 1:] - p[:, :, :-1])
    fy = Ky * (p[:, 1:, :] - p[:, :-1, :])
    out = torch.zeros_like(p)
    out[:, :, :-1] -= fx
    out[:, :, 1:] += fx
    out[:, :-1, :] -= fy
    out[:, 1:, :] += fy
    out[:, :, 0] += Kl * p[:, :, 0]
    out[:, :, -1] += Kr * p[:, :, -1]
    return out


def _unit_inverse(n, device, dtype):
    """Bases and eigenvalues of the unit-conductivity operator: sine modes
    across (Dirichlet half cells), cosine modes along (no flow)."""
    j = np.arange(n) + 0.5
    k = np.arange(1, n + 1)
    S = np.sin(np.outer(k, j) * np.pi / n) * np.where(k[:, None] == n, np.sqrt(1 / n),
                                                      np.sqrt(2 / n))
    m = np.arange(n)
    C = np.cos(np.outer(m, j) * np.pi / n) * np.where(m[:, None] == 0, np.sqrt(1 / n),
                                                      np.sqrt(2 / n))
    lam = (4 * np.sin(m * np.pi / (2 * n)) ** 2)[:, None] + (4 * np.sin(k * np.pi / (2 * n)) ** 2)[None, :]
    diag = np.full(n, 2.0)[:, None] + np.full(n, 2.0)[None, :]
    diag[0, :] -= 1
    diag[-1, :] -= 1
    diag[:, 0] += 1
    diag[:, -1] += 1
    return [torch.as_tensor(a, device=device, dtype=dtype) for a in (S, C, lam, diag)]


def outflow(K, tol=TOL, max_iter=MAX_ITER):
    """Outflow [B] of conductivities K [B, n, n] (float64 solve); raises
    if a sample does not reach ``tol``."""
    K = K.double()
    B, n, _ = K.shape
    Kx, Ky, Kl, Kr = _faces(K)
    diag = torch.zeros_like(K)
    diag[:, :, :-1] += Kx
    diag[:, :, 1:] += Kx
    diag[:, :-1, :] += Ky
    diag[:, 1:, :] += Ky
    diag[:, :, 0] += Kl
    diag[:, :, -1] += Kr
    S, C, lam, cdiag = _unit_inverse(n, K.device, K.dtype)
    w = torch.sqrt(cdiag / diag)

    def precondition(r):
        return w * (C.T @ ((C @ (w * r) @ S.T) / lam) @ S)

    b = torch.zeros_like(K)
    b[:, :, 0] = Kl
    x = torch.zeros_like(K)
    r = b.clone()
    z = precondition(r)
    p = z.clone()
    rz = (r * z).sum((1, 2))
    bb = (b * b).sum((1, 2))
    for it in range(max_iter):
        rr = (r * r).sum((1, 2))
        if it % 8 == 0 and bool((rr <= tol * tol * bb).all()):
            break
        Ap = _apply(p, Kx, Ky, Kl, Kr)
        alpha = (rz / (p * Ap).sum((1, 2)))[:, None, None]
        x = x + alpha * p
        r = r - alpha * Ap
        z = precondition(r)
        rz_new = (r * z).sum((1, 2))
        p = z + (rz_new / rz)[:, None, None] * p
        rz = rz_new
    else:
        raise RuntimeError("reference CG: no convergence to %g in %d iterations"
                           % (tol, max_iter))
    return (Kr * x[:, :, -1]).sum(-1)


def sample_fluxes(seed, level, indices, grids, corr_length, sigma, values):
    """(fine, coarse) outflows [B] of samples ``indices`` on ``level``:
    grids[level] cells per side on the fine grid, grids[level - 1] on the
    coarse (None on level 0). The noise, field and conductivity take the
    ``values`` dtype (rounded through it where the step has no such
    kernel); the solve runs in float64."""
    n = grids[level]
    eig = embedding_eigenvalues(n, corr_length)
    block = max(256, (1 << 22) // (n * n))
    fine, coarse = [], []
    for s in range(0, indices.shape[0], block):
        idx = indices[s:s + block]
        noise = philox.wide_normals(seed, level, idx, 2 * eig.size)
        noise = noise.to(values).reshape(-1, 2, 2 * n, 2 * n)
        fft_dtype = torch.float32 if values in (torch.bfloat16, torch.float16) else values
        g = log_field(noise.to(fft_dtype), eig).to(values)
        K = torch.exp(sigma * g)
        fine.append(outflow(K).to(values))
        if level:
            ci = torch.as_tensor(coarse_index(n, grids[level - 1]), device=K.device)
            coarse.append(outflow(K[:, ci][:, :, ci]).to(values))
    return torch.cat(fine), (torch.cat(coarse) if level else None)
