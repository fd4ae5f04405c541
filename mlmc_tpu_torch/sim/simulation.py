"""Simulation contract (counterpart of ``mlmc_tpu/sim/simulation.py``).

A simulation provides per-level instances and two calculate entry points:

* ``calculate(config, seed)`` — single-sample host path,
* ``calculate_batch(config, generator, n, device)`` — a whole level batch
  as tensor code on ``device``, drawing from an explicit generator.
"""
from abc import ABC, abstractmethod
from typing import List

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec


class Simulation(ABC):

    @abstractmethod
    def level_instance(
        self, fine_level_params: List[float], coarse_level_params: List[float]
    ) -> LevelSimulation:
        """Create the LevelSimulation descriptor for one level."""

    @abstractmethod
    def result_format(self) -> List[QuantitySpec]:
        """Define the simulation result format."""

    @staticmethod
    @abstractmethod
    def calculate(config_dict, seed):
        """Single-sample calculation: -> (fine result, coarse result), flat arrays."""

    # batch path — override in simulations that have one
    calculate_batch = None

    @classmethod
    def has_batch_path(cls):
        return getattr(cls, "calculate_batch", None) is not None
