"""Result-schema metadata (counterpart of
``mlmc_tpu/quantity/quantity_spec.py``).

Host-side dataclasses; no device work. ``QuantitySpec`` describes the
flattened result vector a simulation produces, ``ChunkSpec`` identifies one
streamed chunk of a level's collected samples.
"""
import dataclasses
import numpy as np
from typing import List, Optional, Tuple, Union


@dataclasses.dataclass
class QuantitySpec:
    name: str
    unit: str
    shape: Tuple[int, ...]
    times: List[float]
    locations: Union[List[str], List[Tuple[float, float, float]]]

    def __eq__(self, other):
        return (
            (self.name, self.unit) == (other.name, other.unit)
            and np.array_equal(self.shape, other.shape)
            and np.array_equal(self.times, other.times)
            and not (set(map(tuple_key, self.locations)) - set(map(tuple_key, other.locations)))
        )

    def size(self) -> int:
        """Flattened length contributed by this quantity."""
        return int(np.prod(self.shape) * len(self.times) * len(self.locations))


def tuple_key(loc):
    return tuple(loc) if isinstance(loc, (list, tuple, np.ndarray)) else loc


def result_size(q_specs: List[QuantitySpec]) -> int:
    """Total flattened result-vector length M for a simulation result format."""
    return int(sum(q.size() for q in q_specs))


@dataclasses.dataclass
class ChunkSpec:
    chunk_id: Optional[int] = None
    chunk_slice: Optional[slice] = None
    level_id: Optional[int] = None
    n_samples: Optional[int] = None
