"""Simulation contract (counterpart of ``mlmc_tpu/sim/simulation.py``).

A simulation provides per-level instances and two calculate entry points:

* ``calculate(config, seed[, device])`` — one sample from a seed, for a
  host loop (``OneProcessPool``), returned as host arrays,
* ``calculate_batch(config, generator, n, device)`` — a whole level batch
  as tensor code on ``device``, drawing from an explicit generator.
"""
import contextlib
from abc import ABC, abstractmethod
from typing import List

import torch

from mlmc_tpu_torch.level_simulation import LevelSimulation
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec


def config_dtype(config):
    """The floating dtype a level's config asks for (``config["dtype"]``:
    'float32', the default, or 'float64')."""
    name = str(config.get("dtype", "float32")).replace("torch.", "")
    if name not in ("float32", "float64"):
        raise ValueError("dtype must be float32 or float64, got %r" % name)
    return getattr(torch, name)


def require_full_precision(x, who):
    """Raise if float32 products of ``x`` on a card would run in TF32
    (PyTorch's default leaves it off; this package never turns it on):
    ``who`` names the computation that needs full float32 products."""
    if (x.is_cuda and x.dtype == torch.float32
            and (torch.backends.cuda.matmul.allow_tf32
                 or torch.get_float32_matmul_precision() != "highest")):
        raise RuntimeError(
            "%s need full-precision float32 matmuls: leave "
            "torch.backends.cuda.matmul.allow_tf32 False and "
            "float32_matmul_precision 'highest'" % who)


@contextlib.contextmanager
def ieee_float32_matmuls():
    """Float32 matmuls in full precision inside the block, whatever the
    process has set (TF32 off; the previous setting restored on exit)."""
    saved = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(saved)


def generator_on(device):
    """A fresh generator on ``device``, seeded by the system: what a batch
    draws from when the caller hands it no generator."""
    generator = torch.Generator(device=device)
    generator.seed()
    return generator


def level_cached(config, key, build):
    """``build()`` once per ``key`` for one level: constants of a level
    (bases, weighted mode matrices, eigenvalues on a device) live in the
    level's config under ``"_cache"``."""
    cache = config.setdefault("_cache", {})
    if key not in cache:
        cache[key] = build()
    return cache[key]


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
