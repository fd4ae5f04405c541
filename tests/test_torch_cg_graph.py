"""The batched CG loop over in-place buffers (``sim.diffusion._cg_loop``)
against the loop over fresh tensors it replaced, kept here as the
reference: the same solutions, iterations per sample and turns, bit for
bit, for the 2-D spectral and Jacobi and the 3-D multigrid
preconditioners, on a batch whose samples stop at different turns, one cut
at a ``maxiter`` that is not a multiple of ``CG_CHECK_EVERY``, one done at
its first check and a homogeneous one. On the CPU every turn runs eagerly
and no graph is captured. On a card (``cuda`` cases; no JAX, so they run
there with ``python -m pytest --noconftest tests/test_torch_cg_graph.py -m
cuda``) the blocks between checks replay one captured CUDA graph, and the
result is still the eager reference's, bit for bit."""
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.sim import diffusion, diffusion3d
from mlmc_tpu_torch.sim.diffusion import CG_CHECK_EVERY as E

torch.set_num_threads(1)


def _reference_cg_loop(matvec, M, b, tol, maxiter):
    """The loop as it was before its state moved into buffers: (x,
    iterations per sample, turns)."""
    dims = tuple(range(1, b.dim()))
    lead = (-1,) + (1,) * len(dims)

    def dot(u, v):
        return (u * v).sum(dim=dims)

    atol2 = tol * tol * dot(b, b)
    x = torch.zeros_like(b)
    r = b
    z = M(r)
    p = z
    gamma = dot(r, z)
    iters = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    for k in range(maxiter):
        active = dot(r, r) > atol2
        if k % E == 0 and not bool(active.any()):
            return x, iters, k
        Ap = matvec(p)
        alpha = (gamma / dot(p, Ap)).view(lead)
        a = active.view(lead)
        x = torch.where(a, x + alpha * p, x)
        r = torch.where(a, r - alpha * Ap, r)
        z = M(r)
        gamma_new = dot(r, z)
        p = torch.where(a, z + (gamma_new / gamma).view(lead) * p, p)
        gamma = torch.where(active, gamma_new, gamma)
        iters += active
    return x, iters, maxiter


def _K(shape, seed, homogeneous=False):
    """Smooth log-normal conductivities, sample 0 homogeneous (done after
    one iteration under the spectral preconditioner), float32."""
    rng = np.random.default_rng(seed)
    if homogeneous:
        return torch.full(shape, 2.0, dtype=torch.float32)
    axes = np.meshgrid(*[(np.arange(n) + 0.5) / n for n in shape[1:]], indexing="ij")
    g = sum(rng.normal(size=(shape[0],) + (1,) * len(axes))
            * np.cos(np.pi * sum(f * x for f, x in zip(freqs, axes))
                     + rng.uniform(0, 6, size=(shape[0],) + (1,) * len(axes)))
            for freqs in ((1, 0, 0), (0, 1, 1), (2, 1, 0), (1, 0, 3)))
    K = torch.tensor(np.exp(0.75 * g), dtype=torch.float32)
    K[0] = 2.0
    return K


#: solver -> (simulation, its module, precond, the batch's shape)
SOLVERS = {"spectral2d": (diffusion.DiffusionSimulation, diffusion, "spectral", (5, 16, 16)),
           "jacobi2d": (diffusion.DiffusionSimulation, diffusion, "jacobi", (5, 16, 16)),
           "mg3d": (diffusion3d.DiffusionSimulation3D, diffusion3d, "mg", (5, 8, 8, 8))}
#: case -> (homogeneous K, tol, maxiter or None for the solve's own)
CASES = {"staggered": (False, 1e-5, None),
         "cut_at_maxiter": (False, 0.0, 2 * E + 1),
         "done_at_first_check": (False, 1.0, None),
         "homogeneous": (True, 1e-5, None)}


def _solve_args(solver, case, device, monkeypatch):
    """The (matvec, M, b, tol, maxiter) the simulation's pressure solve
    hands the CG loop, with the case's tolerance and cap."""
    sim, module, precond, shape = SOLVERS[solver]
    homogeneous, tol, maxiter = CASES[case]
    K = _K(shape, seed=7, homogeneous=homogeneous).to(device)
    seen = []
    with monkeypatch.context() as m:
        m.setattr(module, "preconditioned_cg", lambda *args: seen.append(args))
        sim._solve_pressure(dict(precond=precond), K)
    matvec, M, b, _, own_maxiter = seen[0]
    return matvec, M, b, tol, maxiter or own_maxiter


def _check_against_the_reference(solver, case, device, monkeypatch):
    matvec, M, b, tol, maxiter = _solve_args(solver, case, device, monkeypatch)
    x, iters, turns, graphs, graph_turns = diffusion._cg_loop(matvec, M, b, tol, maxiter)
    x0, iters0, turns0 = _reference_cg_loop(matvec, M, b, tol, maxiter)
    assert torch.equal(x, x0) and torch.equal(iters, iters0) and turns == turns0
    if case == "staggered":
        assert len(set(iters.tolist())) > 1
    if case == "cut_at_maxiter":
        # the field's samples never reach a zero residual
        assert turns == maxiter and bool((iters[1:] == maxiter).all())
    if case == "done_at_first_check":
        assert turns == 0 and not bool(iters.any())
    if case == "homogeneous" and solver == "spectral2d":
        assert turns == E and bool((iters == 1).all())
    return turns, maxiter, graphs, graph_turns


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_in_place_loop_equals_the_loop_over_fresh_tensors(solver, case, monkeypatch):
    _, _, graphs, graph_turns = _check_against_the_reference(solver, case, "cpu", monkeypatch)
    assert graphs == graph_turns == 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_graph_replay_equals_the_eager_loop_on_the_card(solver, case, monkeypatch):
    """A solve that turns at all captures one graph (a solve done at its
    first check captures none) and replays it for every full block after
    the first; the turns past the last full block run eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs are captured only on the card")
    turns, maxiter, graphs, graph_turns = _check_against_the_reference(
        solver, case, torch.device("cuda", 0), monkeypatch)
    assert graphs == int(turns > 0)
    assert graph_turns == (E * (turns // E - 1) if graphs else 0)
    if case == "done_at_first_check":
        assert graphs == 0
    if case in ("staggered", "cut_at_maxiter"):
        assert graph_turns > 0
