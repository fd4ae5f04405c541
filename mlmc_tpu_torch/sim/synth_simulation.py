"""Synthetic benchmark simulation (counterpart of
``mlmc_tpu/sim/synth_simulation.py``).

* ``sample_fn(x, h) = x + h·sqrt(1e-4 + |x|)``,
* fine and coarse share the same random draw,
* the level-0 coarse result is zeros (coarse step == 0),
* result format: 2 quantities x 3 times x 2 locations x shape (2,1);
  locations get ``result + i`` offsets,
* ``nan_fraction`` failure injection -> failed samples.

``calculate_batch`` and ``scalar_batch_fn`` compute a whole batch from an
explicit ``torch.Generator`` as tensor code on the caller's device (the
storage-free drivers). ``calculate_keyed_batch`` is the Sampler-facing
batch path of the ``DeviceBatchPool``: each sample's random input is a
function of (seed, level, index, attempt) alone, drawn with the Philox
stream of ``ops/cuda_kernels``, so how a level is cut into batches does
not change its samples.
"""
from typing import List

import numpy as np
import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.random.distributions import as_torch_distr
from mlmc_tpu_torch.sim.simulation import Simulation
from mlmc_tpu_torch.tool import profiling


class SynthSimulation(Simulation):
    """Artificial simulation: random parameter + step-dependent numerical error."""

    def __init__(self, config=None):
        """
        :param config: dict with keys
            distr: TorchDistr | scipy frozen distr | name str
            complexity: cost exponent for n_ops_estimate (default 2)
            nan_fraction: fraction of samples to fail (default 0)
        """
        super().__init__()
        if config is None:
            config = dict(distr="norm", complexity=2)
        self.config = dict(config)
        self.config.setdefault("complexity", 2)
        self.nan_fraction = float(config.get("nan_fraction", 0.0))
        self._distr = as_torch_distr(self.config["distr"])

    #: config entries that vary per level as plain scalars (the structural
    #: level-0 difference is the ``is_level0`` flag set by level_instance);
    #: eager PyTorch shares one code path across levels without them
    DYNAMIC_CONFIG = ("fine_step", "coarse_step")

    @staticmethod
    def sample_fn(x, h):
        """Simulated QoI for parameter x at step h."""
        return x + h * torch.sqrt(1e-4 + torch.abs(x))

    @staticmethod
    def sample_fn_no_error(x, h):
        return x

    @staticmethod
    def generate_random_samples(distr, seed, size):
        """Host draw of ``size`` variates shared by fine and coarse."""
        generator = torch.Generator().manual_seed(int(seed))
        y = as_torch_distr(distr).sample(generator, (int(size),))
        return y, y

    def level_instance(self, fine_level_params: List[float], coarse_level_params: List[float]):
        config = dict(
            fine_step=float(fine_level_params[0]),
            coarse_step=float(coarse_level_params[0]),
            is_level0=float(coarse_level_params[0]) == 0.0,
            distr=self._distr,
            nan_fraction=self.nan_fraction,
            res_format=self.result_format(),
        )
        return LevelSimulation(
            config_dict=config, task_size=self.n_ops_estimate(fine_level_params[0])
        )

    @staticmethod
    def _is_level0(config):
        flag = config.get("is_level0")
        if flag is None:
            flag = config["coarse_step"] == 0
        return bool(flag)

    @staticmethod
    def _expand_results(config, result):
        """Tile base results [..., size] into the flattened result format:
        per quantity, locations get ``result + i`` (plain result on level
        0), replicated over times."""
        is_l0 = SynthSimulation._is_level0(config)
        parts = []
        for q in config["res_format"]:
            locations = [result if is_l0 else result + i
                         for i in range(len(q.locations))]
            parts += locations * len(q.times)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def calculate_batch(config, generator, n, device=None):
        """Whole level batch: -> (fine [n, M], coarse [n, M], failed [n])."""
        size = int(np.prod(config["res_format"][0].shape))
        y = config["distr"].sample(generator, (int(n), size), device=device)
        fine = SynthSimulation.sample_fn(y, config["fine_step"])
        if SynthSimulation._is_level0(config):
            coarse = torch.zeros_like(fine)
        else:
            coarse = SynthSimulation.sample_fn(y, config["coarse_step"])
        nan_fraction = config.get("nan_fraction", 0.0)
        if nan_fraction > 0:
            failed = torch.rand(int(n), generator=generator, device=device) < nan_fraction
        else:
            failed = torch.zeros(int(n), dtype=torch.bool, device=device)
        return (SynthSimulation._expand_results(config, fine),
                SynthSimulation._expand_results(config, coarse), failed)

    @staticmethod
    def calculate_keyed_batch(config, seed, level_id, indices, attempts):
        """Whole level batch from sample identities.

        Sample ``i`` draws its values from Philox4x32-10 calls with key
        ``seed`` and counter (index low word, index high word, level,
        attempt << 8 | j), two normals per call j (the cosine branch of
        Box-Muller on words 0-1 and on words 2-3), and its failure flag
        from the call j = 255. Call 0 of attempt 0 has the counter of call
        ``index`` of kernel A's stream on the same level (ops/cuda_kernels).

        :param indices: int64 tensor [B] of sample indices
        :param attempts: int64 tensor [B] of retry counts (salting renewals)
        :return: (fine [B, M], coarse [B, M], failed [B]) on the indices'
            device; values float32
        """
        from mlmc_tpu_torch.ops.cuda_kernels import (
            MASK32, key_words, box_muller, philox4x32_10)

        key = key_words(seed)
        counter = (indices & MASK32, indices >> 32,
                   torch.full_like(indices, int(level_id)), attempts << 8)

        def philox(j):
            return philox4x32_10(counter[:3] + (counter[3] | j,), key)

        size = int(np.prod(config["res_format"][0].shape))
        with profiling.span("sim.draws"):
            normals = []
            for j in range(-(-size // 2)):
                w = philox(j)
                normals += [box_muller(w[0], w[1])[0], box_muller(w[2], w[3])[0]]
            y = config["distr"].from_standard_normals(
                torch.stack(normals[:size], dim=1))
        fine = SynthSimulation.sample_fn(y, config["fine_step"])
        if SynthSimulation._is_level0(config):
            coarse = torch.zeros_like(fine)
        else:
            coarse = SynthSimulation.sample_fn(y, config["coarse_step"])
        nan_fraction = config.get("nan_fraction", 0.0)
        if nan_fraction > 0:
            u = (philox(255)[0] >> 8).to(torch.float32) * (1.0 / (1 << 24))
            failed = u < nan_fraction
        else:
            failed = torch.zeros(indices.shape, dtype=torch.bool,
                                 device=indices.device)
        return (SynthSimulation._expand_results(config, fine),
                SynthSimulation._expand_results(config, coarse), failed)

    @staticmethod
    def calculate(config, seed, device=None):
        """Single-sample calculation from an integer seed: the host path
        (a card runs whole batches, ``calculate_keyed_batch``), so
        ``device`` is None or the CPU."""
        if device is not None and torch.device(device).type != "cpu":
            raise ValueError("SynthSimulation.calculate runs on the host, got "
                             "device=%s" % (device,))
        generator = torch.Generator().manual_seed(int(seed))
        fine, coarse, failed = SynthSimulation.calculate_batch(config, generator, 1)
        if bool(failed[0]):
            raise Exception("result is nan")
        return fine[0].numpy(), coarse[0].numpy()

    @staticmethod
    def scalar_batch_fn(fine_step, coarse_step, distr, nan_fraction=0.0):
        """Scalar-QoI batch simulation for the fused estimation pipeline.

        :return: ``f(generator, n, device) -> (fine [n], coarse [n],
            failed [n])``, tensor code on ``device``
        """

        def f(generator, n, device=None):
            y = distr.sample(generator, (int(n),), device=device)
            fine = SynthSimulation.sample_fn(y, fine_step)
            if coarse_step == 0:
                coarse = torch.zeros_like(fine)
            else:
                coarse = SynthSimulation.sample_fn(y, coarse_step)
            if nan_fraction > 0:
                failed = torch.rand(int(n), generator=generator, device=device) < nan_fraction
            else:
                failed = torch.zeros(int(n), dtype=torch.bool, device=device)
            return fine, coarse, failed

        return f

    def n_ops_estimate(self, step):
        return (1 / step) ** self.config["complexity"] * np.log(max(1 / step, 2.0))

    def result_format(self) -> List[QuantitySpec]:
        spec1 = QuantitySpec(name="length", unit="m", shape=(2, 1), times=[1, 2, 3],
                             locations=["10", "20"])
        spec2 = QuantitySpec(name="width", unit="mm", shape=(2, 1), times=[1, 2, 3],
                             locations=["30", "40"])
        return [spec1, spec2]
