"""Result-schema metadata (counterpart of
``mlmc_tpu/quantity/quantity_spec.py``).

A host-side dataclass; no device work. ``QuantitySpec`` describes the
flattened result vector a simulation produces.
"""
import dataclasses
import numpy as np
from typing import List, Tuple, Union


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
