"""Structural QType system over the flat sample axis (counterpart of
``mlmc_tpu/quantity/quantity_types.py``).

A QType maps named / hierarchical access onto offsets into the flattened
M axis of a level chunk ``[M, N, 2]``; it is pure host metadata — the only
tensor work is ``TimeSeriesType.time_interpolation``, a blend of the two
bracketing time slices on the chunk's device.

Layout convention (shared with the storage backends): a composite type
concatenates its children along the M axis in declaration order, so
``get_key`` resolves a name/time/index to ``(child_qtype, start_offset)``
and the Quantity layer turns that into a static slice.
"""
import abc
import copy

import numpy as np
from typing import List, Tuple


def keep_dims(chunk):
    """Normalize a chunk to rank-3 ``[M, N, 2]``.

    Sub-selections can produce rank-2 (single row) or rank>3 (structured
    reshape) arrays; estimators always consume the flat [M, N, 2] layout
    (reference quantity_types.py:33-49).
    """
    if chunk.ndim == 2:
        return chunk[None, :]
    if chunk.ndim > 2:
        lead = int(np.prod(chunk.shape[:-2]))
        return chunk.reshape((lead,) + chunk.shape[-2:])
    raise ValueError("Chunk of rank {} not supported".format(chunk.ndim))


class QType(metaclass=abc.ABCMeta):
    """Base: every QType wraps a child type in ``self._qtype``."""

    def __init__(self, qtype):
        self._qtype = qtype

    def size(self) -> int:
        """Flattened length along the M axis."""
        raise NotImplementedError

    def base_qtype(self):
        """The leaf scalar kind (ScalarType or BoolType)."""
        return self._qtype.base_qtype()

    def replace_scalar(self, substitute_qtype):
        """Deep-copied type with the leaf scalar swapped for
        ``substitute_qtype`` (how the moments transform expands every
        scalar into an array of R moment values)."""
        replaced = copy.deepcopy(self)
        replaced._qtype = self._qtype.replace_scalar(substitute_qtype)
        return replaced

    # kept as a staticmethod for reference-API compatibility
    keep_dims = staticmethod(keep_dims)

    def _make_getitem_op(self, chunk, key):
        return keep_dims(chunk[key])

    def reshape(self, data):
        """Shape flat per-sample data into this type's natural form."""
        return data

    def __eq__(self, other):
        # structural equality (the reference relies on object identity)
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __hash__(self):
        return hash(type(self).__name__)

    def __repr__(self):
        return "{}(size={})".format(type(self).__name__, self.size())


class ScalarType(QType):
    """Leaf: one float per sample."""

    def __init__(self, qtype=float):
        self._qtype = qtype

    def base_qtype(self):
        if isinstance(self._qtype, BoolType):
            return self._qtype.base_qtype()
        return self

    def size(self) -> int:
        inner = getattr(self._qtype, "size", None)
        return inner() if callable(inner) else 1

    def replace_scalar(self, substitute_qtype):
        return substitute_qtype


class BoolType(ScalarType):
    """Leaf of comparison results (selection masks)."""


class ArrayType(QType):
    """Fixed-shape array of a child type."""

    def __init__(self, shape, qtype: QType):
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        self._shape = tuple(int(s) for s in shape)
        self._qtype = qtype

    def size(self) -> int:
        return int(np.prod(self._shape)) * self._qtype.size()

    def get_key(self, key):
        """Numpy-style indexing: the result type is probed by indexing a
        dummy of this shape; offsets are handled by the reshaping getitem
        op, so the returned start is always 0."""
        probe_shape = np.empty(self._shape)[key].shape
        if probe_shape == (1,):
            probe_shape = ()
        if probe_shape:
            return ArrayType(probe_shape, qtype=self._qtype), 0
        return self._qtype, 0

    def _make_getitem_op(self, chunk, key):
        shaped = chunk.reshape(self._shape + chunk.shape[-2:])
        return keep_dims(shaped[key])

    def reshape(self, data):
        if isinstance(self._qtype, ScalarType):
            return data.reshape(self._shape)
        tail = int(np.prod(data.shape)) // int(np.prod(self._shape))
        return data.reshape(self._shape + (tail,))


class TimeSeriesType(QType):
    """Child type repeated at each time point; indexed by time value."""

    def __init__(self, times, qtype):
        self._times = list(np.asarray(times).tolist())
        self._qtype = qtype

    def size(self) -> int:
        return len(self._times) * self._qtype.size()

    def get_key(self, key):
        position = self._times.index(key)
        return self._qtype, position * self._qtype.size()

    @staticmethod
    def time_interpolation(quantity, value):
        """Linear interpolation between stored time slices.

        The bracketing indices and the weight are resolved on host (the
        requested time is a plain scalar); the blend itself is tensor code
        on the chunk's device.
        """
        import mlmc_tpu_torch.quantity.quantity as q_mod

        times = np.asarray(quantity.qtype._times, dtype=float)
        inner = quantity.qtype._qtype.size()
        n_times = len(times)
        if not (times[0] <= value <= times[-1]):
            # silent extrapolation turns a typo'd time into plausible
            # garbage; the reference's interp1d raised here too
            raise ValueError(
                "time {} outside the stored range [{}, {}]".format(
                    value, times[0], times[-1]))
        lo = int(np.clip(np.searchsorted(times, value) - 1, 0,
                         max(n_times - 2, 0)))
        if n_times == 1:
            weight = 0.0
        else:
            weight = float((value - times[lo]) / (times[lo + 1] - times[lo]))

        def interp(chunk):
            series = chunk.reshape((n_times, inner) + chunk.shape[-2:])
            if n_times == 1:
                return series[0]
            return (1.0 - weight) * series[lo] + weight * series[lo + 1]

        return q_mod.Quantity(quantity_type=quantity.qtype._qtype,
                              input_quantities=[quantity], operation=interp)


class _NamedChildrenType(QType):
    """Shared machinery for name -> child lookup (Field and Dict types)."""

    def __init__(self, args: List[Tuple[str, QType]]):
        self._dict = dict(args)

    def _child_names(self):
        return list(self._dict.keys())

    def get_key(self, key):
        child = self._dict[key]
        offset = 0
        for name, qtype in self._dict.items():
            if name == key:
                break
            offset += qtype.size()
        return child, offset


class FieldType(_NamedChildrenType):
    """Named locations, all sharing one child type."""

    def __init__(self, args: List[Tuple[str, QType]]):
        super().__init__(args)
        self._qtype = args[0][1]
        assert all(q.size() == self._qtype.size() for _, q in args), \
            "all field locations must share one child type"

    def size(self) -> int:
        return len(self._dict) * self._qtype.size()

    def get_key(self, key):
        position = self._child_names().index(key)
        return self._qtype, position * self._qtype.size()


class DictType(_NamedChildrenType):
    """Ordered named sub-quantities of (possibly) different types."""

    def __init__(self, args: List[Tuple[str, QType]]):
        super().__init__(args)
        base = args[0][1].base_qtype()
        for name, qtype in args[1:]:
            if not isinstance(qtype.base_qtype(), type(base)):
                raise TypeError(
                    "sub-quantity '{}' has base {}, expected {} — all "
                    "children must share ScalarType or BoolType".format(
                        name, qtype.base_qtype(), base))

    def base_qtype(self):
        return next(iter(self._dict.values())).base_qtype()

    def size(self) -> int:
        return int(sum(q.size() for q in self._dict.values()))

    def get_qtypes(self):
        return self._dict.values()

    def replace_scalar(self, substitute_qtype):
        return DictType([(name, qtype.replace_scalar(substitute_qtype))
                         for name, qtype in self._dict.items()])
