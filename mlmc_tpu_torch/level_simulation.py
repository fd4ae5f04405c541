"""Per-level simulation descriptor (reference mlmc/level_simulation.py:6-34).

The message a Sampler hands to a SamplingPool: per-level config, workspace
needs, relative task size, and (internal) the calculate callables.
"""
import dataclasses
from typing import List, Dict, Any, Optional

from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec


@dataclasses.dataclass
class LevelSimulation:
    config_dict: Dict[Any, Any]
    # Calculate configuration (plain data: steps, flags, the distribution).

    common_files: Optional[List[str]] = None
    # Files to copy/symlink into sample workspaces (host simulations only).

    need_sample_workspace: bool = False
    # Whether the simulation needs a filesystem workspace per sample.

    task_size: float = 0
    # Relative size of one sample at this level (batch-packing heuristic).

    nan_result_is_failure: bool = True
    # True (reference SynthSimulation: raise on NaN) -> NaN results become
    # failed samples. False (reference shooting sims: NaN = out-of-domain
    # QoI) -> NaN results are stored and masked during estimation.

    # --- set by Sampler; users do not touch these ------------------------
    calculate: Any = None
    # single-sample calculate(config, seed) -> (fine, coarse)

    calculate_batch: Any = None
    # batched calculate_batch(config, generator, n, device) -> (fine[n,M], coarse[n,M], failed[n])

    calculate_keyed_batch: Any = None
    # calculate_keyed_batch(config, seed, level_id, indices, attempts)
    # -> (fine[B,M], coarse[B,M], failed[B]); the DeviceBatchPool's path

    level_id: Optional[int] = None

    result_format: Any = None
