"""Shooting ODE simulations (counterpart of ``mlmc_tpu/sim/shooting.py``;
BASELINE.json config 2).

A projectile with state (X, V) integrated by explicit Euler under a random
force field F(t), QoI = final y (1D) or final position (2D); leaving the
area borders poisons the sample with NaN (a stored result, masked during
estimation: ``nan_result_is_failure=False``).

* the random force field is a spectral GRF (random Fourier features):
  ``F(t) = sigma*sqrt(2/M) sum_m cos(k_m t + phi_m)``; the phases are the
  sample's only randomness, so fine and coarse trajectories of one sample
  share exactly the same field realization evaluated on their own time
  grids;
* by angle addition ``cos(t k + phi) = cos(tk) cos(phi) - sin(tk) sin(phi)``
  and the ``cos(tk)/sin(tk)`` matrices are sample-independent, so a whole
  level batch is one ``[B, M] @ [M, T]`` matmul;
* explicit Euler is linear in the force sequence:
  ``X_j = X0 + j dt V0 + dt^2 sum_i (j-i)_+ f_i``, a matmul with the fixed
  weight matrix ``W[j, i] = max(j-i, 0)``; for non-log fields it composes
  with the angle-addition split, so the whole trajectory batch is one
  ``[B, M] @ [M, T]`` matmul against Euler-weighted mode matrices, which
  are built once per (level, device, dtype) and kept in the level's
  config. The out-of-borders test is an ``any`` over the trajectory.

The border test is a strict comparison on the whole trajectory, so these
products must not run in TF32: PyTorch's default, which this module never
changes and ``_require_full_precision`` holds a float32 batch on a card to.
Values are float32 unless the config says ``dtype="float64"``.
"""
import copy
from typing import List

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.random.keyed import keyed_uniforms
from mlmc_tpu_torch.sim.simulation import (Simulation, config_dtype, generator_on,
                                           level_cached, require_full_precision)


def _spectral_wave_numbers(model, corr_length, mode_no, seed=0):
    """Wave numbers [M] (float64, host) of the 1-D spectral force field,
    drawn from a generator seeded by ``seed`` (see
    random/correlated_field.SpectralCorrelatedField for the derivation)."""
    gen = torch.Generator().manual_seed(int(seed))
    y = torch.randn((mode_no,), generator=gen, dtype=torch.float64)
    if model == "exp":
        w = torch.randn((mode_no,), generator=gen, dtype=torch.float64) ** 2
        return y / torch.sqrt(w) / corr_length
    return y * (np.sqrt(2.0) / corr_length)  # gauss


def _require_full_precision(x):
    """Raise if the float32 products of ``x`` on a card would run in TF32:
    a rounded product flips out-of-borders masks."""
    require_full_precision(x, "the shooting simulations")


class ShootingSimulation1D(Simulation):
    """1D shooting: QoI = final height y."""

    N_MODES = 512
    result_dim = 1
    #: independent force axes; a sample takes n_modes * N_FORCE_AXES uniforms
    N_FORCE_AXES = 1

    def __init__(self, config):
        """:param config: dict with keys
        start_position [2], start_velocity [2], area_borders [4],
        max_time, complexity (n_elements = complexity / step), n_modes,
        dtype ('float32' | 'float64'),
        fields_params: dict(model='gauss'|'exp', corr_length, sigma, log, seed)
        """
        super().__init__()
        self._config = config
        self.need_workspace = False

    def level_instance(self, fine_level_params: List[float],
                       coarse_level_params: List[float]) -> LevelSimulation:
        config = copy.deepcopy(self._config)
        config["fine"] = {"step": float(fine_level_params[0])}
        config["coarse"] = {"step": float(coarse_level_params[0])}
        config["res_format"] = self.result_format()
        config["fine"]["n_elements"] = int(config["complexity"] / config["fine"]["step"])
        if config["coarse"]["step"] > 0:
            config["coarse"]["n_elements"] = int(
                config["complexity"] / config["coarse"]["step"])
        else:
            config["coarse"]["n_elements"] = 0
        fp = config.get("fields_params", {})
        config["_wave_numbers"] = _spectral_wave_numbers(
            fp.get("model", "gauss"), fp.get("corr_length", 0.1),
            config.get("n_modes", self.N_MODES), seed=fp.get("seed", 0))
        return LevelSimulation(config_dict=config,
                               task_size=self.n_ops_estimate(fine_level_params[0]),
                               nan_result_is_failure=False)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _wave_numbers(config, device, dtype):
        return level_cached(
            config, ("k", device, dtype),
            lambda: torch.as_tensor(config["_wave_numbers"]).to(device, dtype))

    @classmethod
    def _phase_trig_from_uniforms(cls, config, u):
        """Uniforms [B, M*A] -> (cos phi, sin phi) [B, M, A]. The phases are
        the sim's only per-sample randomness."""
        M = len(config["_wave_numbers"])
        phases = 2 * np.pi * u.reshape(u.shape[0], M, cls.N_FORCE_AXES)
        return torch.cos(phases), torch.sin(phases)

    @classmethod
    def _phase_trig(cls, config, generator, n, device, dtype):
        """Per-sample phase trig drawn from ``generator``: (cos phi,
        sin phi) [n, M, A] with A independent force axes."""
        M = len(config["_wave_numbers"])
        u = torch.rand((int(n), M * cls.N_FORCE_AXES), generator=generator,
                       device=generator.device, dtype=dtype).to(device)
        return cls._phase_trig_from_uniforms(config, u)

    @classmethod
    def _force_field_batch(cls, config, trig, times):
        """Spectral GRF by angle addition: sample-independent
        ``cos(tk)/sin(tk)`` [M, T] matrices contracted with the per-sample
        phase trig. :return: [B, T, A] force values."""
        cosp, sinp = trig                                    # [B, M, A]
        k = cls._wave_numbers(config, times.device, times.dtype)
        fp = config.get("fields_params", {})
        tk = times[None, :] * k[:, None]                     # [M, T]
        field = (torch.einsum("bma,mt->bta", cosp, torch.cos(tk))
                 - torch.einsum("bma,mt->bta", sinp, torch.sin(tk)))
        field = fp.get("sigma", 1.0) * np.sqrt(2.0 / k.shape[0]) * field
        return torch.exp(field) if fp.get("log", True) else field

    @staticmethod
    def _euler_weights(n_elements, dtype, device=None):
        """Explicit Euler is linear in the force sequence: the recurrence
        ``X += dt V; V += dt f`` telescopes to
        ``X_j = X0 + j dt V0 + dt^2 sum_i (j-i)_+ f_i``, one matmul with
        the fixed weight matrix ``W[j, i] = max(j-i, 0)`` (rows j = 1..T)."""
        j = torch.arange(1, n_elements + 1, device=device)
        return (j[:, None] - j[None, :]).clamp(min=0).to(dtype)

    @classmethod
    def _finals_from_acc(cls, config, acc, n_elements):
        """Assemble trajectories from the force-integral term and apply
        the border test.

        ``acc`` [B, T, A] is ``dt^2 sum_i (j-i)_+ f_i``; A=1 applies the
        one force to both velocity components (the 1-D sim's contract),
        A=2 is per-axis; either way the A axis broadcasts against the [2]
        start vectors.
        :return: X_final [B, 2] with NaN rows where any step left the
            area borders."""
        dt = config["max_time"] / n_elements
        borders = config["area_borders"]
        kw = dict(dtype=acc.dtype, device=acc.device)
        X0 = torch.tensor(config["start_position"], **kw)
        V0 = torch.tensor(config["start_velocity"], **kw)
        j_dt = dt * torch.arange(1, n_elements + 1, **kw)
        X = (X0[None, None] + j_dt[None, :, None] * V0[None, None]
             + acc)                                          # [B, T, 2]
        oob = ((X[..., 0] < borders[0]) | (X[..., 0] > borders[1])
               | (X[..., 1] < borders[2]) | (X[..., 1] > borders[3]))
        out = oob.any(dim=1)                                 # [B]
        return torch.where(out[:, None], torch.full_like(X[:, -1], float("nan")),
                           X[:, -1])

    @classmethod
    def _trajectory_finals(cls, config, forces, n_elements):
        """Closed-form explicit Euler over a [B, T, A] force batch."""
        dt = config["max_time"] / n_elements
        W = cls._euler_weights(n_elements, forces.dtype, forces.device)
        acc = dt * dt * torch.matmul(W, forces)              # [B, T, A]
        return cls._finals_from_acc(config, acc, n_elements)

    @classmethod
    def _weighted_modes(cls, config, which, device, dtype):
        """(Cw, Sw) [M, T] = dt^2 sigma sqrt(2/M) cos/sin(t k) @ W^T of one
        grid, built once per (grid, device, dtype)."""
        def build():
            n = config[which]["n_elements"]
            fp = config.get("fields_params", {})
            k = cls._wave_numbers(config, device, dtype)
            dt = config["max_time"] / n
            scale = fp.get("sigma", 1.0) * np.sqrt(2.0 / k.shape[0]) * dt * dt
            times = torch.linspace(0.0, config["max_time"], n, dtype=dtype,
                                   device=device)
            tk = times[None, :] * k[:, None]                 # [M, T]
            W = cls._euler_weights(n, dtype, device)
            return (scale * torch.matmul(torch.cos(tk), W.T),
                    scale * torch.matmul(torch.sin(tk), W.T))

        return level_cached(config, ("modes", which, device, dtype), build)

    @classmethod
    def _calculate_level(cls, config, trig, which, generic=False):
        """One grid's results [B, result_dim] from the phase trig.

        Non-log fields keep the force linear in the phase trig, so the
        Euler weights compose with the angle-addition split:
        ``X_traj = X0 + j dt V0 + cos(phi) @ Cw - sin(phi) @ Sw``, one
        ``[B, M] x [M, T]`` matmul and no force array. Log fields (and
        ``generic=True``) evaluate the forces, then the Euler matmul.
        """
        cosp, sinp = trig
        _require_full_precision(cosp)
        n = config[which]["n_elements"]
        fp = config.get("fields_params", {})
        if not fp.get("log", True) and not generic:
            Cw, Sw = cls._weighted_modes(config, which, cosp.device, cosp.dtype)
            acc = (torch.einsum("bma,mt->bta", cosp, Cw)
                   - torch.einsum("bma,mt->bta", sinp, Sw))
            finals = cls._finals_from_acc(config, acc, n)
        else:
            times = torch.linspace(0.0, config["max_time"], n, dtype=cosp.dtype,
                                   device=cosp.device)
            forces = cls._force_field_batch(config, trig, times)
            finals = cls._trajectory_finals(config, forces, n)
        return cls._extract_result(finals)

    @classmethod
    def _extract_result(cls, X):
        return X[:, 1:2]  # final y

    @classmethod
    def _from_trig(cls, config, trig):
        """(fine, coarse, failed) of a batch from its phase trig, drawn
        once: the level coupling."""
        fine = cls._calculate_level(config, trig, "fine")
        if config["coarse"]["n_elements"] > 0:
            coarse = cls._calculate_level(config, trig, "coarse")
        else:
            coarse = torch.zeros_like(fine)
        # a NaN QoI (out of borders) is a valid stored result, masked
        # during estimation, never a failed sample
        failed = torch.zeros(fine.shape[0], dtype=torch.bool, device=fine.device)
        return fine, coarse, failed

    @classmethod
    def calculate(cls, config, seed, device=None):
        """One sample from an integer seed, computed on ``device`` (None:
        the current CUDA device): -> (fine [M], coarse [M]) as numpy. The
        phases come from a host generator, so a seed names the same sample
        on every device."""
        device = resolve_device(device)
        generator = torch.Generator().manual_seed(int(seed))
        fine, coarse, _ = cls.calculate_batch(config, generator, 1, device=device)
        return fine[0].cpu().numpy(), coarse[0].cpu().numpy()

    @classmethod
    def calculate_batch(cls, config, generator, n, device=None):
        """Level batch drawn from ``generator``: -> (fine [n, M],
        coarse [n, M], failed [n]) on ``device`` (None: the generator's;
        with no generator the current CUDA device and a fresh generator
        there, seeded by the system)."""
        device = resolve_device(device, like=generator)
        generator = generator_on(device) if generator is None else generator
        trig = cls._phase_trig(config, generator, n, device, config_dtype(config))
        return cls._from_trig(config, trig)

    @classmethod
    def calculate_keyed_batch(cls, config, seed, level_id, indices, attempts):
        """Level batch from sample identities: each sample's phases are a
        function of (seed, level, index, attempt) alone
        (``random/keyed.keyed_uniforms``)."""
        M = len(config["_wave_numbers"])
        u = keyed_uniforms(seed, level_id, indices, attempts,
                           M * cls.N_FORCE_AXES, config_dtype(config))
        return cls._from_trig(config, cls._phase_trig_from_uniforms(config, u))

    def n_ops_estimate(self, step):
        return self._config["complexity"] / step

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="target", unit="m", shape=(1,), times=[10],
                             locations=["0"])]


class ShootingSimulation2D(ShootingSimulation1D):
    """2D shooting: QoI = final position (x, y); independent force per axis."""

    result_dim = 2
    N_FORCE_AXES = 2

    @classmethod
    def _extract_result(cls, X):
        return X  # final (x, y)

    def result_format(self) -> List[QuantitySpec]:
        return [QuantitySpec(name="target", unit="m", shape=(2,), times=[10],
                             locations=["0"])]
