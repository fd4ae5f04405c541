"""Darcy-flow diffusion simulation with GRF conductivity (counterpart of
``mlmc_tpu/sim/diffusion.py``; BASELINE.json config 5).

* unit square, regular n x n cell grid (n = 1/step),
* log-normal conductivity ``K = exp(sigma * G)`` with G a stationary GRF at
  the cell centers: ``field_method="circulant"`` samples the fine grid
  exactly by FFT circulant embedding and the coarse grid point-samples the
  same realization (one embedding FFT per sample); ``"rff"`` evaluates
  random Fourier features, fine and coarse sharing modes and phases,
* pressure solve ``-div(K grad p) = 0`` with p=1 on the left edge, p=0 on
  the right, no-flux top/bottom: 5-point finite volumes with harmonic face
  conductivities, solved by preconditioned conjugate gradients
  (``_solve_pressure``),
* QoI = total outflow flux through the right edge, which estimates the
  effective conductivity of the medium.

Every function takes a batch: conductivities and pressures are
``[B, n, n]`` tensors. The CG stops each sample on its own (a per-sample
``active`` mask applied on the device every iteration), so how often the
host asks whether any sample is still active changes the time and not the
result. Values are float32 unless the config says ``dtype="float64"``.
"""
import copy
from typing import List

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.random.keyed import keyed_normals, keyed_uniforms
from mlmc_tpu_torch.sim.simulation import (Simulation, config_dtype, generator_on,
                                           level_cached)
from mlmc_tpu_torch.tool import profiling


# CG iterations between two host checks of the active mask (each check
# waits for the device)
CG_CHECK_EVERY = 4


def preconditioned_cg(matvec, M, b, tol, maxiter):
    """Preconditioned CG on a batch of systems: ``b`` is [B, ...] (one
    grid per sample, 2-D or 3-D), ``matvec`` and ``M`` act on such batches.

    Each sample starts from x0 = 0 and stops on its own when
    ``|r|^2 <= tol^2 |b|^2`` (the rule of ``jax.scipy.sparse.linalg.cg``)
    or at ``maxiter``: its state is frozen by the ``active`` mask while the
    others iterate. The host looks at the mask every ``CG_CHECK_EVERY``
    iterations, which changes the time and never the result. On a CUDA
    device the iterations between two checks run as one CUDA graph,
    captured once per solve and replayed (``_cg_loop``); ``matvec`` and
    ``M`` must then be device ops that never wait for the host. While
    tracing, the loop's turns (``cg.turns``), the graphs captured
    (``cg.graphs``) and the turns run inside a replay (``cg.graph_turns``)
    are counted.

    :return: (solutions like ``b``, iterations taken per sample [B])
    """
    with profiling.span("sim.solve"):
        x, iters, turns, graphs, graph_turns = _cg_loop(matvec, M, b, tol, int(maxiter))
    profiling.count("cg.turns", turns)
    profiling.count("cg.graphs", graphs)
    profiling.count("cg.graph_turns", graph_turns)
    return x, iters


class _CGState:
    """The CG loop's state in buffers that each turn updates in place, so
    that a block of turns can be captured as a CUDA graph and replayed.
    ``active`` holds the mask of the next turn, which the host checks."""

    def __init__(self, matvec, M, b, tol):
        self.matvec, self.M = matvec, M
        self.dims = tuple(range(1, b.dim()))
        self.lead = (-1,) + (1,) * len(self.dims)
        self.atol2 = tol * tol * self.dot(b, b)          # [B]
        self.x = torch.zeros_like(b)
        self.r = b.clone()
        z = M(self.r)
        self.p = z.clone()
        self.gamma = self.dot(self.r, z)
        self.iters = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
        self.active = self.dot(self.r, self.r) > self.atol2

    def dot(self, u, v):
        return (u * v).sum(dim=self.dims)

    def turns(self, n):
        """``n`` turns of the loop: each value computed by the same op on
        the same operands as a loop over fresh tensors would."""
        x, r, p, gamma, active, lead = self.x, self.r, self.p, self.gamma, self.active, self.lead
        for _ in range(n):
            Ap = self.matvec(p)
            alpha = (gamma / self.dot(p, Ap)).view(lead)
            a = active.view(lead)
            torch.where(a, x + alpha * p, x, out=x)
            torch.where(a, r - alpha * Ap, r, out=r)
            z = self.M(r)
            gamma_new = self.dot(r, z)
            torch.where(a, z + (gamma_new / gamma).view(lead) * p, p, out=p)
            torch.where(active, gamma_new, gamma, out=gamma)
            self.iters += active
            torch.gt(self.dot(r, r), self.atol2, out=active)


class _DeviceGraphs:
    """What the CG's graphs share on one CUDA device: the side stream they
    are captured on, one memory pool, and the last graph captured, which
    keeps that pool alive between solves (a pool whose graphs are all gone
    cannot take a new capture)."""

    def __init__(self, device):
        self.stream = torch.cuda.Stream(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.last = None


_device_graphs = {}     # CUDA device index -> _DeviceGraphs


def _first_block_and_graph(state):
    """Run the first ``CG_CHECK_EVERY`` turns eagerly on the device's side
    stream (which also sets up cuBLAS and the allocator there), then
    capture the same turns as a CUDA graph on that stream: the capture's
    host work overlaps the first block on the device. -> the graph, whose
    ``replay()`` runs the next block on the current stream."""
    device = state.x.device
    shared = _device_graphs.get(device.index)
    if shared is None:
        shared = _device_graphs[device.index] = _DeviceGraphs(device)
    main = torch.cuda.current_stream(device)
    shared.stream.wait_stream(main)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(shared.stream):
        state.turns(CG_CHECK_EVERY)
        with profiling.span("sim.cg_capture"):
            graph.capture_begin(pool=shared.pool)
            state.turns(CG_CHECK_EVERY)
            graph.capture_end()
    main.wait_stream(shared.stream)
    shared.last = graph
    return graph


def _cg_loop(matvec, M, b, tol, maxiter):
    """The loop of ``preconditioned_cg``: (x, iterations per sample, the
    loop's turns, graphs captured, turns run inside a replay).

    The host checks the active mask before every block of
    ``CG_CHECK_EVERY`` turns. On a CUDA device, where at least two full
    blocks fit in ``maxiter``, the first block runs eagerly and is
    captured as a graph, and every later full block replays it; a solve
    done at the next check drops its graph unreplayed. Elsewhere, and for
    the turns past the last full block, the turns run eagerly."""
    state = _CGState(matvec, M, b, tol)
    graph = None
    k = graph_turns = 0
    while k < maxiter:
        with profiling.span("sim.cg_check"):
            done = not bool(state.active.any())
        if done:
            break
        n = min(CG_CHECK_EVERY, maxiter - k)
        if graph is not None and n == CG_CHECK_EVERY:
            graph.replay()
            graph_turns += n
        elif k == 0 and b.is_cuda and maxiter >= 2 * CG_CHECK_EVERY:
            graph = _first_block_and_graph(state)
        else:
            state.turns(n)
        k += n
    return state.x, state.iters, k, int(graph is not None), graph_turns


class DarcyBatchEntryPoints:
    """The entry points the Darcy simulations share (2-D, 3-D, fractured).

    A class that mixes them in says what one sample draws
    (``_draws_shape``: ('noise', shape) of standard normals, or ('phases',
    (M,)) of uniforms scaled to [0, 2 pi)) and computes a batch from those
    draws (``_calculate(config, noise=..., phases=..., **extra)`` ->
    (fine, coarse, ...)). A class whose samples draw more (a fracture
    network) extends ``_sample_draws`` and ``_keyed_draws``, which return
    ``_calculate``'s keywords.
    """

    @staticmethod
    def _draws_kwargs(kind, draws):
        if kind == "noise":
            return {"noise": (draws[:, 0], draws[:, 1])}
        return {"phases": 2 * np.pi * draws}

    @classmethod
    def _sample_draws(cls, config, generator, n, device):
        """The draws of ``n`` samples from ``generator``, on ``device``."""
        kind, shape = cls._draws_shape(config)
        fn = torch.randn if kind == "noise" else torch.rand
        draws = fn((int(n),) + shape, generator=generator,
                   device=generator.device, dtype=config_dtype(config)).to(device)
        return cls._draws_kwargs(kind, draws)

    @classmethod
    def _keyed_draws(cls, config, seed, level_id, indices, attempts):
        """The draws of the samples (seed, level, index, attempt)."""
        kind, shape = cls._draws_shape(config)
        keyed = keyed_normals if kind == "noise" else keyed_uniforms
        draws = keyed(seed, level_id, indices, attempts, int(np.prod(shape)),
                      config_dtype(config))
        return cls._draws_kwargs(kind, draws.reshape((indices.shape[0],) + shape))

    @classmethod
    def _from_draws(cls, config, draws):
        fine, coarse = cls._calculate(config, **draws)[:2]
        failed = torch.zeros(fine.shape[0], dtype=torch.bool, device=fine.device)
        return fine, coarse, failed

    @classmethod
    def calculate(cls, config, seed, device=None):
        """One sample from an integer seed, solved on ``device`` (None: the
        current CUDA device): -> (fine [1], coarse [1]) as numpy. The draws
        come from a host generator, so a seed names the same sample on
        every device."""
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(int(seed))
        fine, coarse, _ = cls.calculate_batch(config, generator, 1, device=device)
        return fine[0].cpu().numpy(), coarse[0].cpu().numpy()

    @classmethod
    def calculate_batch(cls, config, generator, n, device=None):
        """Level batch drawn from ``generator``: -> (fine [n, 1],
        coarse [n, 1], failed [n]) on ``device`` (None: the generator's;
        with no generator the current CUDA device and a fresh generator
        there, seeded by the system)."""
        device = resolve_device(device, like=generator)
        generator = generator_on(device) if generator is None else generator
        return cls._from_draws(config, cls._sample_draws(config, generator, n, device))

    @classmethod
    def calculate_keyed_batch(cls, config, seed, level_id, indices, attempts):
        """Level batch from sample identities: each sample's draws are a
        function of (seed, level, index, attempt) alone (``random/keyed``)."""
        with profiling.span("sim.draws"):
            draws = cls._keyed_draws(config, seed, level_id, indices, attempts)
        return cls._from_draws(config, draws)


def _wave_vectors_2d(model, corr_length, mode_no, seed=0):
    """2-D spectral-measure wave vectors [M, 2] (float64, host), drawn from
    a generator seeded by ``seed`` (see SpectralCorrelatedField)."""
    gen = torch.Generator().manual_seed(int(seed))
    y = torch.randn((mode_no, 2), generator=gen, dtype=torch.float64)
    if model == "exp":
        w = torch.randn((mode_no, 1), generator=gen, dtype=torch.float64) ** 2
        return y / torch.sqrt(w) / corr_length
    return y * (np.sqrt(2.0) / corr_length)


class DiffusionSimulation(DarcyBatchEntryPoints, Simulation):
    """2-D Darcy flow with random log-normal conductivity."""

    N_MODES = 256
    # relative residual target: f32 CG plateaus ~1e-7; 1e-6 is reliably
    # reachable and far below the MLMC sampling error of any config
    CG_TOL = 1e-6
    # iteration cap = factor * n; CG stops at CG_TOL long before this on
    # smooth lognormal fields, so the cap only pays when a field needs it
    CG_MAXITER_FACTOR = 10
    # default preconditioner (config key "precond" overrides): smooth
    # lognormal fields converge fastest under the scaled spectral inverse
    PRECOND = "spectral"
    # iteration cap factor under the multigrid preconditioner: MG-CG is
    # nearly n-independent, so the cap is a small multiple of n
    CG_MAXITER_FACTOR_MG = 4

    def __init__(self, config=None):
        """:param config: dict with keys
        sigma (log-field std, default 1), corr_length (default 0.2),
        model ('gauss'|'exp'), field_method ('rff'|'circulant'), n_modes,
        seed (of the rff wave vectors), precond ('spectral'|'jacobi'|'mg'),
        cg_tol, cg_maxiter_factor,
        dtype ('float32'|'float64')
        """
        super().__init__()
        self._config = dict(config or {})
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        fine_step = float(fine_level_params[0])
        coarse_step = float(coarse_level_params[0])
        config["fine_n"] = max(int(round(1.0 / fine_step)), 2)
        config["coarse_n"] = max(int(round(1.0 / coarse_step)), 2) if coarse_step > 0 else 0
        config["res_format"] = self.result_format()
        method = config.get("field_method", "rff")
        if method == "rff":
            config["_wave_vectors"] = _wave_vectors_2d(
                config.get("model", "gauss"), config.get("corr_length", 0.2),
                config.get("n_modes", self.N_MODES), seed=config.get("seed", 0))
        elif method == "circulant":
            # exact-covariance GRF on the FINE grid; the coarse grid
            # point-samples the same realization, so the coarse grid size
            # must divide the fine one
            from mlmc_tpu_torch.random.correlated_field import CirculantEmbeddingField

            if config["coarse_n"] and config["fine_n"] % config["coarse_n"]:
                raise ValueError("circulant coupling needs coarse_n | fine_n, got "
                                 "%d and %d" % (config["coarse_n"], config["fine_n"]))
            n = config["fine_n"]
            field = CirculantEmbeddingField(
                corr_exp=config.get("model", "gauss"),
                corr_length=config.get("corr_length", 0.2),
                grid_shape=(n, n), grid_step=1.0 / n, device="cpu")
            config["_circ_eig"] = field._eig_np
        else:
            raise ValueError("unknown field_method %r" % (method,))
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(fine_step))

    # ------------------------------------------------------------------ #
    # conductivity
    # ------------------------------------------------------------------ #
    @classmethod
    def _circulant_field(cls, config, wr, wi):
        """The GRF on the fine grid [B, fine_n, fine_n] from white noise
        ``wr, wi`` [B, emb, emb]: one embedding FFT per sample."""
        eig = level_cached(
            config, ("sqrt_eig", wr.device, wr.dtype),
            lambda: torch.sqrt(torch.as_tensor(
                config["_circ_eig"]).to(wr.device, wr.dtype)))
        emb_size = eig.shape[0] * eig.shape[1]
        g = torch.fft.fftn(eig * torch.complex(wr, wi), dim=(-2, -1)).real \
            / np.sqrt(emb_size)
        fine_n = config["fine_n"]
        return g[:, :fine_n, :fine_n]

    @staticmethod
    def _coarse_index(fine_n, n):
        """Fine-grid indices that the n-point coarse grid samples."""
        stride = fine_n // n
        idx = np.round((np.arange(n) + 0.5) * stride - 0.5).astype(np.int64)
        return np.clip(idx, 0, fine_n - 1)

    @classmethod
    def _conductivity(cls, config, n, noise=None, phases=None):
        """K = exp(sigma * G) at the cell centers of an n x n grid, for a
        batch: [B, n, n].

        Fine/coarse coupling: the same draws give the same underlying
        field realization on both grids.

        :param noise: circulant method: (wr, wi), each [B, emb, emb]
        :param phases: rff method: mode phases [B, M]
        """
        sigma = config.get("sigma", 1.0)
        if "_circ_eig" in config:
            if phases is not None:
                raise ValueError(
                    "phase-driven sampling needs field_method='rff'")
            g = cls._circulant_field(config, *noise)
            fine_n = config["fine_n"]
            if n < fine_n:  # coarse grid point-samples the fine realization
                idx = torch.from_numpy(cls._coarse_index(fine_n, n)).to(g.device)
                g = g[:, idx][:, :, idx]
            return torch.exp(sigma * g)
        device, dtype = phases.device, phases.dtype

        def mode_trig():
            k_vec = torch.as_tensor(config["_wave_vectors"]).to(device, dtype)
            centers = (torch.arange(n, device=device, dtype=dtype) + 0.5) / n
            X, Y = torch.meshgrid(centers, centers, indexing="ij")
            proj = torch.stack([X.reshape(-1), Y.reshape(-1)], dim=1) @ k_vec.T
            return torch.cos(proj), torch.sin(proj)          # [n*n, M]

        # cos(x.k + phi) = cos(x.k) cos(phi) - sin(x.k) sin(phi): the
        # [n*n, M] mode matrices are sample-independent
        C, S = level_cached(config, ("rff", n, device, dtype), mode_trig)
        g = np.sqrt(2.0 / C.shape[1]) * (torch.cos(phases) @ C.T
                                         - torch.sin(phases) @ S.T)
        return torch.exp(sigma * g).reshape(-1, n, n)

    @classmethod
    def _coarse_from_fine_K(cls, config, K_fine):
        """Coarse conductivity by point-sampling the FINE realization
        (exp is pointwise, so sampling K equals sampling g then exp)."""
        idx = torch.from_numpy(cls._coarse_index(
            config["fine_n"], config["coarse_n"])).to(K_fine.device)
        return K_fine[:, idx][:, :, idx]

    # ------------------------------------------------------------------ #
    # constant-coefficient operator: the spectral preconditioner's pieces
    # ------------------------------------------------------------------ #
    @staticmethod
    def _spectral_basis(n):
        """Orthonormal eigen-basis of the CONSTANT-coefficient operator.

        The unit-K 5-point system of ``_solve_pressure`` separates into
        1-D tridiagonal operators: half-cell Dirichlet in x (boundary
        transmissibility 2 -> diagonal 3) and Neumann in y (boundary
        diagonal 1).  Their exact eigenvectors are the DST-II rows
        ``sin((j+1/2) k pi/n), k=1..n`` and the DCT-II rows
        ``cos((j+1/2) l pi/n), l=0..n-1`` with eigenvalues
        ``4 sin^2(k pi / 2n)``.

        :return: (Sx [n,n] DST-II, Cy [n,n] DCT-II, lam [n,n] with
            lam[l,k] = lambda_y(l) + lambda_x(k); all float64 numpy,
            cast at use site)
        """
        j = np.arange(n)
        k = np.arange(1, n + 1)
        Sx = np.sin((j[None, :] + 0.5) * k[:, None] * np.pi / n)
        Sx *= np.where(k[:, None] == n, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
        lx = 4.0 * np.sin(k * np.pi / (2 * n)) ** 2
        ll = np.arange(n)
        Cy = np.cos((j[None, :] + 0.5) * ll[:, None] * np.pi / n)
        Cy *= np.where(ll[:, None] == 0, np.sqrt(1.0 / n), np.sqrt(2.0 / n))
        ly = 4.0 * np.sin(ll * np.pi / (2 * n)) ** 2
        return Sx, Cy, ly[:, None] + lx[None, :]

    @staticmethod
    def _const_diag(n):
        """Diagonal of the unit-K constant-coefficient 5-point operator.

        1-D Dirichlet half-cell operator in x: interior diagonal 2,
        boundary 3 (interior face + half-cell face transmissibility 2);
        1-D Neumann operator in y: interior 2, boundary 1. The 2-D
        diagonal is the sum of the two.
        """
        dx = np.full(n, 2.0)
        dx[0] += 1.0
        dx[-1] += 1.0
        dy = np.full(n, 2.0)
        dy[0] -= 1.0
        dy[-1] -= 1.0
        return dy[:, None] + dx[None, :]

    # ------------------------------------------------------------------ #
    # stencil operator pieces (shared by CG and the multigrid hierarchy);
    # every array may carry leading batch dimensions
    # ------------------------------------------------------------------ #
    @staticmethod
    def _face_conductivities(K):
        """Harmonic averages on interior faces: K [..., n, n] ->
        (Kx [..., n, n-1], Ky [..., n-1, n])."""
        Kx = 2.0 * K[..., :, :-1] * K[..., :, 1:] / (K[..., :, :-1] + K[..., :, 1:])
        Ky = 2.0 * K[..., :-1, :] * K[..., 1:, :] / (K[..., :-1, :] + K[..., 1:, :])
        return Kx, Ky

    @staticmethod
    def _stencil_matvec(p, Kx, Ky, Kleft, Kright):
        """A @ p for the 5-point FV operator given face transmissibilities.

        ``p`` is [..., n, n]; Dirichlet enters through the half-cell
        columns ``Kleft``, ``Kright`` [..., n]. Leading dimensions
        broadcast."""
        fx = Kx * (p[..., :, 1:] - p[..., :, :-1])
        fy = Ky * (p[..., 1:, :] - p[..., :-1, :])
        div = fx.new_zeros(fx.shape[:-1] + (fx.shape[-1] + 1,))
        div[..., :, :-1] += fx
        div[..., :, 1:] -= fx
        div[..., :-1, :] += fy
        div[..., 1:, :] -= fy
        div[..., :, 0] -= Kleft * p[..., :, 0]
        div[..., :, -1] -= Kright * p[..., :, -1]
        return -div

    @staticmethod
    def _stencil_diag(Kx, Ky, Kleft, Kright, n):
        diag = Kx.new_zeros(Kx.shape[:-2] + (n, n))
        diag[..., :, :-1] += Kx
        diag[..., :, 1:] += Kx
        diag[..., :-1, :] += Ky
        diag[..., 1:, :] += Ky
        diag[..., :, 0] += Kleft
        diag[..., :, -1] += Kright
        return diag

    @staticmethod
    def _galerkin_coarsen(Kx, Ky, Kleft, Kright):
        """Exact Galerkin (P^T A P) coarsening under 2x2 aggregation.

        With piecewise-constant prolongation the coarse operator is again
        a 5-point FV operator whose face transmissibilities are the SUMS
        of the fine transmissibilities crossing each aggregate interface
        (internal faces cancel; graph-Laplacian aggregation identity).
        """
        # coarse x-face (I, J)|(I, J+1) = fine faces at column 2J+1
        Kx_i = Kx[..., :, 1::2]
        Kx_c = Kx_i[..., 0::2, :] + Kx_i[..., 1::2, :]
        # coarse y-face (I, J)|(I+1, J) = fine faces at row 2I+1
        Ky_i = Ky[..., 1::2, :]
        Ky_c = Ky_i[..., :, 0::2] + Ky_i[..., :, 1::2]
        Kl_c = Kleft[..., 0::2] + Kleft[..., 1::2]
        Kr_c = Kright[..., 0::2] + Kright[..., 1::2]
        return Kx_c, Ky_c, Kl_c, Kr_c

    @classmethod
    def _mg_vcycle_preconditioner(cls, Kx, Ky, Kleft, Kright, n,
                                  nu=2, omega=0.8, coarsest=4):
        """Geometric multigrid V-cycle as a linear SPD preconditioner on a
        batch ``r [B, n, n]``.

        Smoothing is damped Jacobi (diagonal => the symmetric pre/post
        cycle with P = R^T Galerkin coarse operators is SPD, valid inside
        CG), aggregation is 2x2 piecewise-constant, the coarsest grid
        solves densely: the [c^2, c^2] matrix of each sample assembles by
        the matvec on identity columns and is inverted once in the setup,
        so the coarsest correction inside the CG loop is one batched
        matvec.
        """
        levels = []
        while n > coarsest and n % 2 == 0:
            diag = cls._stencil_diag(Kx, Ky, Kleft, Kright, n)
            levels.append((Kx, Ky, Kleft, Kright, diag, n))
            Kx, Ky, Kleft, Kright = cls._galerkin_coarsen(Kx, Ky, Kleft, Kright)
            n = n // 2
        c_n = n
        eye = torch.eye(n * n, dtype=Kx.dtype, device=Kx.device).reshape(1, n * n, n, n)
        # column j of A_c is A @ e_j; A_c is symmetric
        A_c = cls._stencil_matvec(eye, Kx[:, None], Ky[:, None], Kleft[:, None],
                                  Kright[:, None]).reshape(-1, n * n, n * n)
        A_c_inv = torch.linalg.inv(A_c.transpose(1, 2))

        def vcycle(r, lvl):
            if lvl == len(levels):
                return torch.matmul(A_c_inv, r.reshape(-1, c_n * c_n, 1)
                                    ).reshape(-1, c_n, c_n)
            Kx_l, Ky_l, Kl_l, Kr_l, diag, n_l = levels[lvl]
            mv = lambda p: cls._stencil_matvec(p, Kx_l, Ky_l, Kl_l, Kr_l)
            x = (omega / diag) * r
            for _ in range(nu - 1):
                x = x + (omega / diag) * (r - mv(x))
            res = r - mv(x)
            r_c = res.reshape(-1, n_l // 2, 2, n_l // 2, 2).sum(dim=(2, 4))
            e_c = vcycle(r_c, lvl + 1)
            x = x + e_c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
            for _ in range(nu):
                x = x + (omega / diag) * (r - mv(x))
            return x

        return lambda r: vcycle(r, 0)

    # ------------------------------------------------------------------ #
    # the solve
    # ------------------------------------------------------------------ #
    @classmethod
    def _spectral_consts(cls, config, n, device, dtype):
        """(Sx, Cy, lam, const diag) of an n x n grid as tensors, built once
        per (level, grid, device, dtype)."""
        def build():
            pieces = cls._spectral_basis(n) + (cls._const_diag(n),)
            return tuple(torch.as_tensor(a).to(device, dtype) for a in pieces)

        return level_cached(config, ("spectral", n, device, dtype), build)

    @classmethod
    def _preconditioner(cls, config, Kx, Ky, Kleft, Kright, diag, n):
        """M(r) on a batch [B, n, n] for the config's ``precond``."""
        precond = config.get("precond", cls.PRECOND)
        if precond == "mg":
            return cls._mg_vcycle_preconditioner(
                Kx, Ky, Kleft, Kright, n,
                nu=config.get("mg_nu", 2),
                omega=config.get("mg_omega", 0.8),
                coarsest=config.get("mg_coarsest", 4))
        if precond == "spectral":
            # Diagonally-scaled spectral preconditioner
            #   M = W . C_1^{-1} . W,   W = diag( sqrt(diag_C / diag_A) )
            # where C_1 is the unit-coefficient 5-point operator (exact
            # inverse = two orthogonal transforms, matmuls with the [n, n]
            # bases broadcast over the batch, and a spectral divide). The
            # spectral part removes the O(n^2) grid factor from the
            # condition number; the Jacobi-like scaling absorbs the field's
            # LOCAL contrast. Any constant reference conductivity cancels
            # algebraically (W^2 carries c, the spectral divide carries
            # 1/c). Exact for constant K by construction.
            Sx, Cy, lam, cdiag = cls._spectral_consts(config, n, diag.device,
                                                      diag.dtype)
            w = torch.sqrt(cdiag / diag)

            def M(r):
                r_hat = torch.matmul(torch.matmul(Cy, w * r), Sx.T)
                return w * torch.matmul(torch.matmul(Cy.T, r_hat / lam), Sx)

            return M
        if precond == "jacobi":
            return lambda r: r / diag
        raise ValueError("unknown precond %r" % (precond,))

    @classmethod
    def _solve_pressure(cls, config, K):
        """Preconditioned CG solve of the 5-point finite-volume system on
        the n x n grid, for a batch of conductivities ``K [B, n, n]``.

        Unknowns = cell pressures; Dirichlet p=1 at the x=0 edge and p=0
        at the x=1 edge enter through half-cell transmissibilities;
        no-flux top/bottom. All transmissibilities are per unit h.

        Each sample stops on its own (``preconditioned_cg``).

        :return: (pressures [B, n, n], iterations taken per sample [B])
        """
        n = K.shape[-1]
        Kx, Ky = cls._face_conductivities(K)
        # boundary half-faces (distance h/2 -> transmissibility 2K)
        Kleft = 2.0 * K[..., :, 0]     # [B, n]
        Kright = 2.0 * K[..., :, -1]   # [B, n]

        def matvec(p):
            return cls._stencil_matvec(p, Kx, Ky, Kleft, Kright)

        b = torch.zeros_like(K)
        b[..., :, 0] += Kleft          # p=1 on the left edge
        diag = cls._stencil_diag(Kx, Ky, Kleft, Kright, n)
        M = cls._preconditioner(config, Kx, Ky, Kleft, Kright, diag, n)

        precond = config.get("precond", cls.PRECOND)
        default_factor = (cls.CG_MAXITER_FACTOR_MG if precond == "mg"
                          else cls.CG_MAXITER_FACTOR)
        maxiter = int(config.get("cg_maxiter_factor", default_factor) * n)
        tol = config.get("cg_tol", cls.CG_TOL)
        return preconditioned_cg(matvec, M, b, tol, maxiter)

    @staticmethod
    def _flux(K, p):
        """Total outflow through the right edge == effective conductivity.

        Transmissibility of a boundary half-face is 2K (face length h over
        distance h/2, the h's cancel), so flux = sum_i 2 K_i (p_i - 0).
        Homogeneous check: K=k0 gives linear p with p_last = h/2 and
        flux = n * 2 k0 h/2 = k0, the Darcy value for a unit square."""
        return (2.0 * K[..., :, -1] * p[..., :, -1]).sum(dim=-1)

    @classmethod
    def _calculate(cls, config, noise=None, phases=None, **extra):
        """A batch from its draws (``extra``: further draws a subclass's
        ``_conductivity`` takes).

        :return: (fine [B, 1], coarse [B, 1], CG iterations of the fine
            solves [B], of the coarse solves [B] or None)
        """
        fine_n, coarse_n = config["fine_n"], config["coarse_n"]
        with profiling.span("sim.field"):
            K_fine = cls._conductivity(config, fine_n, noise=noise, phases=phases, **extra)
        p, it_fine = cls._solve_pressure(config, K_fine)
        fine = cls._flux(K_fine, p)
        if coarse_n > 0:
            with profiling.span("sim.field"):
                if "_circ_eig" in config:
                    # one embedding FFT per sample: the coarse grid
                    # point-samples the fine realization
                    K_coarse = cls._coarse_from_fine_K(config, K_fine)
                else:
                    K_coarse = cls._conductivity(config, coarse_n, phases=phases, **extra)
            del K_fine, p
            pc, it_coarse = cls._solve_pressure(config, K_coarse)
            coarse = cls._flux(K_coarse, pc)
        else:
            coarse, it_coarse = torch.zeros_like(fine), None
        return fine[:, None], coarse[:, None], it_fine, it_coarse

    @classmethod
    def _draws_shape(cls, config):
        """('noise', (2, emb, emb)) or ('phases', (M,)): what one sample
        draws."""
        if "_circ_eig" in config:
            return "noise", (2,) + tuple(np.shape(config["_circ_eig"]))
        return "phases", (len(config["_wave_vectors"]),)

    def n_ops_estimate(self, step):
        n = 1.0 / step
        return n * n * np.log(max(n, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="flux", unit="m^3/s", shape=(1,), times=[0],
                             locations=["outflow"])]
