"""POD reduced-basis surrogates (counterpart of ``mlmc_tpu/pod.py``).

Proper orthogonal decomposition by the method of snapshots: collect
pressure fields from a pilot of full Darcy solves, take the dominant left
singular vectors ``V [n_cells, r]`` (plus the snapshot mean), and
approximate every further sample by the Galerkin-reduced system

    (V^T A(K) V) p_r = V^T b(K),      p ~ V p_r,

an [r, r] solve in place of a preconditioned CG iteration on the full
grid. The reduced model sees the same conductivity realization as the
full model (the same sample identity), so the (full, reduced) pair is
strongly correlated: the coupled low-fidelity model that ``MFMC`` and
``mlblue`` take.

The snapshots are one keyed batch of the port's Darcy solves
(``DiffusionSimulation._conductivity`` and ``_solve_pressure``); the SVD
and QR of the snapshot matrix run once on the host in float64. Per
surrogate sample the reduced assembly is ``A(K) V`` (r + 1 stencil
applications), one [r+1, n^2] x [n^2, r+1] product and an [r+1, r+1]
solve, batched over a chunk of samples: a chunk of C samples holds C (r+1)
n^2 values per temporary, so the samples run in chunks of ``CHUNK``.

**Contract.** ``model(keys) -> [C]`` with ``keys`` a
``random.keyed.SampleKeys`` (``multifidelity``'s): sample (seed, level, i)
draws the RFF phases ``2 pi keyed_uniforms(seed, level, i)``, as the Darcy
simulation's keyed batch does. Snapshot i is the identity (seed, 0, i)
(JAX: ``fold_in(key(seed), i)``). ``phases=`` replaces the draw
(``keys -> [C, M]`` in [0, 2 pi)); a test hands in JAX's.
"""
import time

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.random.keyed import SampleKeys
from mlmc_tpu_torch.sim.diffusion import DiffusionSimulation

__all__ = ["pod_darcy_surrogate"]

#: surrogate samples per chunk of the reduced assembly
CHUNK = 2048


def _keyed_phases(cfg):
    def phases(keys):
        return DiffusionSimulation._keyed_draws(
            cfg, keys.seed, keys.level, keys.indices,
            torch.zeros_like(keys.indices))["phases"]
    return phases


def _pod_models(cfg, n, V, dtype, device, phases):
    """(reduced model, full model) over the basis V [n^2, r+1]."""
    Sim = DiffusionSimulation
    Vt = torch.tensor(np.asarray(V, np.float64)).to(device, dtype)
    cols = Vt.T.reshape(-1, n, n)                                 # [r+1, n, n]

    def conductivity(keys):
        return Sim._conductivity(cfg, n, phases=phases(keys).to(device, dtype))

    def reduced(K):
        Kx, Ky = Sim._face_conductivities(K)
        Kleft, Kright = 2.0 * K[:, :, 0], 2.0 * K[:, :, -1]
        AV = Sim._stencil_matvec(cols[None], Kx[:, None], Ky[:, None],
                                 Kleft[:, None], Kright[:, None])  # [C, r+1, n, n]
        AV = AV.reshape(K.shape[0], -1, n * n)
        A_r = (AV @ Vt).mT                     # [C, r+1, r+1] = V^T A V
        b = torch.zeros_like(K)
        b[:, :, 0] += Kleft
        b_r = b.reshape(K.shape[0], n * n) @ Vt                    # [C, r+1]
        p_r = torch.linalg.solve(A_r, b_r[:, :, None])[:, :, 0]
        p_last = (p_r @ cols[:, :, -1])                            # [C, n]
        return (2.0 * K[:, :, -1] * p_last).sum(-1)

    def chunked(fn):
        def model(keys):
            idx = keys.indices.to(device)
            out = [fn(conductivity(SampleKeys(keys.seed, keys.level, idx[s:s + CHUNK])))
                   for s in range(0, idx.shape[0], CHUNK)]
            return torch.cat(out) if out else torch.zeros(0, dtype=dtype, device=device)
        return model

    def full(K):
        p, _ = Sim._solve_pressure(cfg, K)
        return Sim._flux(K, p)

    return chunked(reduced), chunked(full)


def pod_darcy_surrogate(config=None, n: int = 32, rank: int = 24,
                        n_snapshots: int = 64, seed: int = 1000,
                        dtype=torch.float64, device=None, phases=None,
                        wave_vectors=None):
    """Build a reduced-basis flux model for the 2-D Darcy problem.

    :param config: DiffusionSimulation config (sigma, corr_length,
        n_modes, ...: the RFF field path)
    :param n: grid resolution of the full model being reduced
    :param rank: POD basis size r (snapshot energy beyond r is the
        irreducible surrogate error)
    :param n_snapshots: pilot full solves for the basis (identities
        (seed, 0, i): keep ``seed`` apart from the estimation's)
    :param device: where the models run (None: the current CUDA device)
    :param phases: ``keys -> [C, M]`` RFF phases in place of the keyed draw
    :param wave_vectors: [M, 2] RFF wave vectors in place of the config's
        draw (e.g. ``convert.pod_from_jax``'s)
    :return: dict with ``model`` (``keys -> flux [C]``, the MFMC/MLBLUE
        surrogate), ``full_model`` (same contract, the full solve at
        resolution n), ``energy`` [S] singular-value energy fractions,
        ``rank``, ``wall_s``
    """
    device = resolve_device(device)
    cfg = dict(config or {})
    cfg["dtype"] = str(dtype).replace("torch.", "")
    cfg = DiffusionSimulation(cfg).level_instance([1.0 / n], [0]).config_dict
    if wave_vectors is not None:
        cfg["_wave_vectors"] = torch.tensor(np.asarray(wave_vectors, np.float64))
    phases = phases or _keyed_phases(cfg)
    t0 = time.perf_counter()

    # ---- snapshot pilot: full solves ------------------------------- #
    keys = SampleKeys(int(seed), 0, torch.arange(n_snapshots, dtype=torch.int64,
                                                 device=device))
    K = DiffusionSimulation._conductivity(cfg, n, phases=phases(keys).to(device, dtype))
    p, _ = DiffusionSimulation._solve_pressure(cfg, K)
    P = p.reshape(n_snapshots, -1).cpu().numpy().astype(np.float64)   # [S, n^2]
    # center on the snapshot mean so the basis spends its rank on the
    # fluctuations; the mean field re-enters as a fixed basis vector
    p_mean = P.mean(axis=0)
    U, s, _ = np.linalg.svd((P - p_mean).T, full_matrices=False)
    r = min(int(rank), U.shape[1])
    V = np.concatenate([p_mean[:, None] / max(
        np.linalg.norm(p_mean), 1e-300), U[:, :r]], axis=1)
    # re-orthonormalize (the mean is not orthogonal to the modes)
    V, _ = np.linalg.qr(V)
    energy = np.cumsum(s ** 2) / max(np.sum(s ** 2), 1e-300)
    model, full_model = _pod_models(cfg, n, V, dtype, device, phases)
    return {"model": model, "full_model": full_model,
            "energy": energy, "rank": r,
            "wall_s": time.perf_counter() - t0}
