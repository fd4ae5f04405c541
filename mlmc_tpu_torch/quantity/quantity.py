"""Lazy, typed Quantity algebra over stored MLMC samples (counterpart of
``mlmc_tpu/quantity/quantity.py``).

A Quantity is a DAG node holding a tensor operation over level chunks
``[M, N, 2]``. Chunks are PyTorch tensors on the root quantity's device
(``make_root_quantity``); constants join a chunk's device and floating
dtype when an operation meets them, so a float32 device store stays
float32.

* ``traceable()`` marks DAGs whose nodes keep the sample axis as it is;
  those compose through ``build_eval`` into one function of a leaf chunk,
  which the whole-level estimation tiers evaluate on any slice of a level.
  ``select`` removes samples and is not traceable (``mask`` is its
  traceable counterpart);
* per-chunk evaluations are memoized in a dict keyed by (level, chunk,
  size, node id), cleared by ``cache_clear()``.
"""
import collections
import functools
import itertools
import operator
from typing import List

import numpy as np
import torch

import mlmc_tpu_torch.quantity.quantity_types as qt
from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.quantity.quantity_spec import ChunkSpec, QuantitySpec

# memoization of Quantity.samples evaluations keyed by (level_id, chunk_id,
# chunk_size, node uid); LRU-bounded
_SAMPLE_CACHE = collections.OrderedDict()
_SAMPLE_CACHE_MAX = 512
_UID_COUNTER = itertools.count()


def cache_clear():
    """Drop the memoized per-chunk DAG evaluation cache."""
    _SAMPLE_CACHE.clear()


def as_tensor(x):
    """A chunk as a tensor: tensors pass, numpy becomes a CPU tensor."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _align(chunks):
    """Operands of one node as tensors on one device: the first tensor's
    device; numpy constants take the floating dtype of the first floating
    tensor operand (a float32 device store stays float32)."""
    tensors = [c for c in chunks if isinstance(c, torch.Tensor)]
    device = tensors[0].device if tensors else torch.device("cpu")
    floats = [c.dtype for c in tensors if c.is_floating_point()]
    out = []
    for c in chunks:
        if isinstance(c, torch.Tensor):
            out.append(c.to(device))
            continue
        t = as_tensor(c)
        if floats and t.is_floating_point():
            t = t.to(floats[0])
        out.append(t.to(device))
    return out


def _tensor_op(op):
    """``op`` lifted to chunk operands (numpy or tensors)."""
    def apply(*chunks):
        return op(*_align(chunks))
    return apply


def _resolve_provenance(inputs):
    """One linear pass over already-constructed inputs -> (storage, selection).

    Mixing nodes that draw from different sample populations — two storages,
    or a ``select``-ed subset with its unselected parent — is rejected: row
    ``i`` of their chunks would no longer refer to the same sample.
    """
    storage = next(
        (s for s in (q.get_quantity_storage() for q in inputs) if s is not None),
        None)
    selections = {q.selection_id() for q in inputs} - {None}
    if len(selections) > 1:
        raise ValueError(
            "cannot combine quantities drawn from different sample "
            "populations (selection ids {})".format(sorted(selections)))
    return storage, (selections.pop() if selections else None)


def _fold_conditions(conditions):
    """AND together Bool-typed condition quantities into one [N] mask node."""
    for cond in conditions:
        if not isinstance(cond.qtype.base_qtype(), qt.BoolType):
            raise TypeError(
                "condition quantity must have a Bool base type, got {}".format(
                    cond.qtype.base_qtype()))
    combined = conditions[0]
    for extra in conditions[1:]:
        combined = np.logical_and(combined, extra)  # ufunc protocol -> node
    return combined


def make_root_quantity(storage, q_specs: List[QuantitySpec], device=None):
    """Root quantity reading directly from a SampleStorage: the flat M axis
    typed Dict(name -> TimeSeries(time -> Field(location -> Array(shape)))).

    :param device: where the DAG over this root is evaluated; None = the
        storage's device (``DeviceMemory``), else the current CUDA device
        (a host ``Memory``'s chunks go to the card)
    """
    def spec_type(spec):
        leaf = qt.ArrayType(spec.shape, qt.ScalarType(float))
        per_time = qt.FieldType([(loc, leaf) for loc in spec.locations])
        return qt.TimeSeriesType(spec.times, per_time)

    if device is None:
        device = getattr(storage, "device", None)
    return QuantityStorage(
        storage, qt.DictType([(s.name, spec_type(s)) for s in q_specs]),
        resolve_device(device))


class Quantity:
    """Lazy typed node of the post-processing DAG: an operation over
    input quantities, evaluated per stored chunk."""

    def __init__(self, quantity_type, operation, input_quantities=[], traceable=True):
        """
        :param quantity_type: QType instance
        :param operation: function over input chunks (tensors or numpy)
        :param input_quantities: List[Quantity]
        :param traceable: whether the operation keeps the sample axis as it
            is (safe to evaluate on any slice of a level); operations that
            remove samples must pass False
        """
        self.qtype = quantity_type
        self._operation = operation
        self._input_quantities = input_quantities
        self._traceable = traceable
        self._uid = next(_UID_COUNTER)
        self._storage, self._selection_id = _resolve_provenance(input_quantities)

    # ------------------------------------------------------------------ #
    # DAG provenance accessors
    # ------------------------------------------------------------------ #
    def get_quantity_storage(self):
        """The QuantityStorage leaf this node reads from (None = constant)."""
        return self._storage

    def selection_id(self):
        """Identity of the sample population this node draws from: every
        ``select`` creates a fresh population; otherwise the storage leaf."""
        if self._selection_id is not None:
            return self._selection_id
        return self._storage._uid if self._storage is not None else None

    def size(self) -> int:
        """Flattened length of this quantity along the M axis."""
        return self.qtype.size()

    def traceable(self):
        """True if the whole sub-DAG keeps the sample axis as it is."""
        return self._traceable and all(q.traceable() for q in self._input_quantities)

    # ------------------------------------------------------------------ #
    # evaluation
    # ------------------------------------------------------------------ #
    def _cache_key(self, chunk_spec):
        chunk_size = None
        if chunk_spec.chunk_slice is not None:
            chunk_size = chunk_spec.chunk_slice.stop - chunk_spec.chunk_slice.start
        return (chunk_spec.level_id, chunk_spec.chunk_id, chunk_size, self._uid)

    def samples(self, chunk_spec):
        """Evaluate this node's chunk for one ChunkSpec (memoized)."""
        key = self._cache_key(chunk_spec)
        if key in _SAMPLE_CACHE:
            _SAMPLE_CACHE.move_to_end(key)
            return _SAMPLE_CACHE[key]
        chunks_quantity_level = [q.samples(chunk_spec) for q in self._input_quantities]
        result = self._operation(*chunks_quantity_level)
        _SAMPLE_CACHE[key] = result
        while len(_SAMPLE_CACHE) > _SAMPLE_CACHE_MAX:
            _SAMPLE_CACHE.popitem(last=False)
        return result

    def build_eval(self):
        """Compose the DAG into one function ``f(leaf_chunk) -> chunk``
        (valid when ``self.traceable()``), evaluated eagerly."""
        storage_q = self.get_quantity_storage()

        def node_eval(node, leaf):
            if node is storage_q:
                return leaf
            if isinstance(node, QuantityConst):
                return node._value
            inputs = [node_eval(q, leaf) for q in node._input_quantities]
            return node._operation(*inputs)

        return lambda leaf: node_eval(self, leaf)

    # ------------------------------------------------------------------ #
    # algebra construction
    # ------------------------------------------------------------------ #
    def select(self, *conditions):
        """Sample selection based on Bool-typed condition quantities.

        Removes whole samples whose mask is False; the node starts a fresh
        sample population (own selection id).
        """
        combined = _fold_conditions(conditions)

        def drop_rows(x, keep):
            x, keep = _align([x, keep])
            return x[..., keep.to(torch.bool), :]

        q = Quantity(quantity_type=self.qtype, input_quantities=[self, combined],
                     operation=drop_rows, traceable=False)
        q._selection_id = q._uid
        return q

    def mask(self, *conditions):
        """Traceable counterpart of ``select`` for estimation workloads:
        non-selected samples are NaN-poisoned in place instead of removed,
        so ``estimate_mean``'s NaN masking drops them with identical
        estimates (they count in ``n_rm_samples``)."""
        combined = _fold_conditions(conditions)

        def poison_rows(x, keep):
            x, keep = _align([x, keep])
            return torch.where(keep.to(torch.bool)[None, :, None], x,
                               torch.full_like(x, float("nan")))

        return Quantity(quantity_type=self.qtype,
                        input_quantities=[self, combined], operation=poison_rows)

    def __array_ufunc__(self, ufunc, method, *args, **kwargs):
        return Quantity._method(ufunc, method, *args, **kwargs)

    # arithmetic dunders are generated below the class body from the
    # operator module; the reference-named op aliases (add_op, ...) stay

    @staticmethod
    def create_quantity(quantities, operation):
        """Lift ``operation`` over DAG nodes; all-constant inputs fold
        eagerly to a new constant instead of a graph node."""
        live = [q for q in quantities if not isinstance(q, QuantityConst)]
        if not live:
            return QuantityConst(quantities[0].qtype,
                                 value=operation(*(q._value for q in quantities)))
        return Quantity(live[0].qtype, operation=_tensor_op(operation),
                        input_quantities=quantities)

    # ------------------------------------------------------------------ #
    # comparisons -> Bool mask quantities
    # ------------------------------------------------------------------ #
    @staticmethod
    def _process_mask(x, y, op):
        """All values of a sample (and both fine+coarse) must meet the
        condition -> [N] bool."""
        mask = op(*_align([x, y]))
        return mask.flatten(0, mask.ndim - 3).all(dim=0).all(dim=-1)

    def _mask_quantity(self, other, op):
        """Comparison node: Bool-typed, one [N] truth value per sample."""
        other = Quantity.wrap(other)
        for operand in (self, other):
            if not isinstance(operand.qtype.base_qtype(), qt.ScalarType):
                raise TypeError(
                    "only ScalarType-based quantities compare; got base "
                    "qtype {}".format(operand.qtype.base_qtype()))
        return Quantity(quantity_type=self.qtype.replace_scalar(qt.BoolType()),
                        input_quantities=[self, other], operation=op)

    def __lt__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.lt))

    def __le__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.le))

    def __gt__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.gt))

    def __ge__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.ge))

    def __eq__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.eq))

    def __ne__(self, other):
        return self._mask_quantity(other, lambda x, y: Quantity._process_mask(x, y, operator.ne))

    # ------------------------------------------------------------------ #
    # subsampling
    # ------------------------------------------------------------------ #
    def subsample(self, sample_vec, generator=None):
        """Streaming subsample: pick exactly ``sample_vec[l]`` samples of
        level l (all of them if it holds fewer), whatever the chunking.

        For each chunk of a level draw ``Hypergeom(n_remaining,
        k_remaining, chunk_n)`` columns (Vitter's method S analogue), then
        that many of the chunk's columns without replacement. The draws
        run on the host; the picked columns stay on the chunk's device.
        Eager, and not traceable: the fast tiers refuse such a quantity.

        :param generator: a CPU ``torch.Generator`` that seeds the draws;
            None takes a seed from the OS
        """
        if generator is None:
            generator = torch.Generator()
            generator.seed()
        rng = np.random.default_rng(int(torch.randint(
            0, 1 << 62, (1,), generator=generator)))
        n_collected = list(self.get_quantity_storage().n_collected())
        state = {}

        def reset(level_id):
            state[level_id] = {
                "k": min(int(sample_vec[level_id]), int(n_collected[level_id])),
                "n": int(n_collected[level_id]),
            }

        class _LevelParams:
            """Per-chunk handle delivering streaming state for its level."""

            def __init__(self, level_id, chunk_id):
                if chunk_id in (0, None) or level_id not in state:
                    reset(level_id)
                self.level_id = level_id

        params_quantity = _SubsampleParamsQuantity(_LevelParams)

        def pick_samples(chunk, level_params):
            chunk = as_tensor(chunk)
            st = state[level_params.level_id]
            n_chunk = chunk.shape[1]
            size = int(rng.hypergeometric(st["k"], st["n"] - st["k"], n_chunk)) \
                if st["n"] > 0 and n_chunk > 0 else 0
            idx = np.sort(rng.choice(n_chunk, size=size, replace=False))
            out = chunk[:, torch.from_numpy(idx).to(chunk.device), :]
            st["k"] -= size
            st["n"] -= n_chunk
            return out

        return Quantity(
            quantity_type=self.qtype.replace_scalar(qt.BoolType()),
            input_quantities=[self, params_quantity],
            operation=pick_samples,
            traceable=False,
        )

    # ------------------------------------------------------------------ #
    # structured access
    # ------------------------------------------------------------------ #
    def __getitem__(self, key):
        new_qtype, start = self.qtype.get_key(key)
        if not isinstance(self.qtype, qt.ArrayType):
            key = slice(start, start + new_qtype.size())

        def _make_getitem_op(y):
            return self.qtype._make_getitem_op(as_tensor(y), key=key)

        return Quantity(quantity_type=new_qtype, input_quantities=[self], operation=_make_getitem_op)

    def __getattr__(self, name):
        # unknown attributes forward to static QType helpers applied to
        # this quantity (e.g. q.time_interpolation(t))
        return functools.partial(getattr(self.qtype, name), self)

    @staticmethod
    def _concatenate(quantities, qtype, axis=0):
        def op_concatenate(*chunks):
            return torch.cat(_align(chunks), dim=axis)

        return Quantity(qtype, input_quantities=[*quantities], operation=op_concatenate)

    @staticmethod
    def _get_base_qtype(args_quantities):
        """ScalarType if any quantity input carries scalars, else BoolType."""
        has_scalar = any(
            type(q.qtype.base_qtype()) is qt.ScalarType
            for q in args_quantities if isinstance(q, Quantity)
        )
        return qt.ScalarType() if has_scalar else qt.BoolType()

    #: numpy ufuncs whose torch function has another name
    _TORCH_UFUNCS = {"power": torch.pow}

    @staticmethod
    def _method(ufunc, method, *args, **kwargs):
        """numpy ufunc protocol: ``__call__`` of a ufunc with a torch
        counterpart of the same name runs as tensor code on the chunks'
        device; other methods (reduce, ...) run in host numpy and come
        back as tensors on that device."""
        fn = None
        if method == "__call__" and not kwargs:
            fn = Quantity._TORCH_UFUNCS.get(ufunc.__name__,
                                            getattr(torch, ufunc.__name__, None))
        if fn is not None:
            def _ufunc_call(*input_chunks):
                return fn(*_align(input_chunks))
        else:
            def _ufunc_call(*input_chunks):
                tensors = _align(input_chunks)
                out = getattr(ufunc, method)(
                    *[t.cpu().numpy() for t in tensors], **kwargs)
                return as_tensor(out).to(tensors[0].device)

        quantities = [Quantity.wrap(arg) for arg in args]
        result_qtype = Quantity._result_qtype(_ufunc_call, quantities)
        return Quantity(
            quantity_type=result_qtype,
            input_quantities=list(quantities),
            operation=_ufunc_call,
        )

    # host type -> QType factory for constant lifting
    _WRAP_RULES = (
        ((bool, np.bool_), lambda v: qt.BoolType()),
        ((int, float, np.integer, np.floating), lambda v: qt.ScalarType()),
        ((list, tuple, np.ndarray, torch.Tensor),
         lambda v: qt.ArrayType(shape=np.shape(v), qtype=qt.ScalarType())),
    )

    @staticmethod
    def wrap(value):
        """Lift a host value into a QuantityConst; Quantities pass through."""
        if isinstance(value, Quantity):
            return value
        for types, make_qtype in Quantity._WRAP_RULES:
            if isinstance(value, types):
                if isinstance(value, torch.Tensor):
                    value = value.detach().cpu().numpy()
                elif isinstance(value, (list, tuple)):
                    value = np.asarray(value)
                return QuantityConst(quantity_type=make_qtype(value), value=value)
        raise ValueError(
            "cannot lift {!r} into a Quantity constant "
            "(expected bool, number, or array-like)".format(value))

    @staticmethod
    def _probe_chunk(quantity):
        """First stored chunk of a quantity (constants get a dummy spec)."""
        storage = quantity.get_quantity_storage()
        spec = ChunkSpec() if storage is None else next(storage.chunks())
        return quantity.samples(spec)

    @staticmethod
    def _result_qtype(method, quantities):
        """Result QType found by running the op on one probe chunk per input."""
        probe = method(*(Quantity._probe_chunk(q) for q in quantities))
        base = Quantity._get_base_qtype(quantities)
        return qt.ArrayType(shape=probe.shape[0], qtype=base)

    # -------------------------------------------------------------- #
    # composite constructors: children stacked along the flat M axis
    # under the matching structural QType
    # -------------------------------------------------------------- #
    @staticmethod
    def QArray(quantities):
        """(Nested) lists of same-typed quantities -> ArrayType quantity."""
        grid = np.asarray(quantities, dtype=object)
        children = list(grid.ravel())
        elem_type = Quantity._check_same_qtype(children)
        return Quantity._concatenate(children, qt.ArrayType(grid.shape, elem_type))

    @staticmethod
    def QDict(key_quantity):
        """(name, quantity) pairs -> one DictType quantity."""
        pairs = list(key_quantity)
        dict_type = qt.DictType([(key, q.qtype) for key, q in pairs])
        return Quantity._concatenate([q for _, q in pairs], dict_type)

    @staticmethod
    def QTimeSeries(time_quantity):
        """(time, quantity) pairs of one shared type -> TimeSeriesType."""
        pairs = list(time_quantity)
        children = [q for _, q in pairs]
        elem_type = Quantity._check_same_qtype(children)
        ts_type = qt.TimeSeriesType(times=[t for t, _ in pairs], qtype=elem_type)
        return Quantity._concatenate(children, ts_type)

    @staticmethod
    def QField(key_quantity):
        """(location, quantity) pairs of one shared type -> FieldType."""
        pairs = list(key_quantity)
        children = [q for _, q in pairs]
        Quantity._check_same_qtype(children)
        field_type = qt.FieldType([(key, q.qtype) for key, q in pairs])
        return Quantity._concatenate(children, field_type)

    @staticmethod
    def _check_same_qtype(quantities):
        """All children must share one QType; return it."""
        first = quantities[0].qtype
        if any(q.qtype != first for q in quantities[1:]):
            raise ValueError("Quantities don't have same QType")
        return first


def _install_arithmetic(cls):
    """Generate the binary arithmetic protocol from the operator module.

    Each dunder builds a DAG node via create_quantity (constants fold
    eagerly); reflected variants swap the operand order. The
    reference-named staticmethod aliases (add_op, sub_op, mult_op,
    truediv_op, mod_op) point at the same operator functions.
    """
    table = {"add": operator.add, "sub": operator.sub, "mul": operator.mul,
             "truediv": operator.truediv, "mod": operator.mod}
    alias = {"add": "add_op", "sub": "sub_op", "mul": "mult_op",
             "truediv": "truediv_op", "mod": "mod_op"}

    def make(op, reflected):
        def binop(self, other):
            pair = [cls.wrap(other), self] if reflected else [self, cls.wrap(other)]
            return cls.create_quantity(pair, op)
        return binop

    for name, op in table.items():
        setattr(cls, "__{}__".format(name), make(op, False))
        setattr(cls, "__r{}__".format(name), make(op, True))
        setattr(cls, alias[name], staticmethod(op))
    return cls


_install_arithmetic(Quantity)


class _SubsampleParamsQuantity:
    """Internal pseudo-quantity delivering per-chunk subsample state."""

    _storage = None
    _selection_id = None

    def __init__(self, level_params_cls):
        self._cls = level_params_cls
        self.qtype = qt.ScalarType()
        self._input_quantities = []

    def samples(self, chunk_spec):
        return self._cls(chunk_spec.level_id, chunk_spec.chunk_id)

    def get_quantity_storage(self):
        return None

    def selection_id(self):
        return None

    def traceable(self):
        return False


class QuantityConst(Quantity):
    """Constant leaf: a host value broadcast as ``[M, 1, 1]`` against
    every chunk."""

    def __init__(self, quantity_type, value):
        self.qtype = quantity_type
        self._uid = next(_UID_COUNTER)
        self._value = self._process_value(value)
        self._input_quantities = []
        self._selection_id = None
        self._traceable = True
        self._storage = None
        self._operation = None

    def _process_value(self, value):
        if isinstance(value, (int, float, bool, np.integer, np.floating)):
            value = np.array([value])
        value = np.asarray(value)
        return value[:, np.newaxis, np.newaxis]

    def selection_id(self):
        return self._selection_id

    def samples(self, chunk_spec):
        return self._value


class QuantityMean:
    """Result of estimate_mean: per-level moment sums telescoped on demand.

    Holds the raw per-level statistics (flat along the M axis) and combines
    them lazily: ``mean = sum_l mean_l`` and ``var = sum_l var_l / n_l``.
    All public views are reshaped through the structural QType.
    """

    def __init__(self, quantity_type, l_means, l_vars, n_samples, n_rm_samples):
        self.qtype = quantity_type
        self._l_means = np.asarray(l_means)
        self._l_vars = np.asarray(l_vars)
        self._n_samples = np.asarray(n_samples)
        self._n_rm_samples = np.asarray(n_rm_samples)

    @functools.cached_property
    def _telescoped(self):
        """(combined mean, combined estimator variance), flat M axis."""
        return (self._l_means.sum(axis=0),
                (self._l_vars / self._n_samples[:, None]).sum(axis=0))

    @property
    def mean(self):
        return self.qtype.reshape(self._telescoped[0])

    @property
    def var(self):
        return self.qtype.reshape(self._telescoped[1])

    @property
    def l_means(self):
        return np.array([self.qtype.reshape(m) for m in self._l_means])

    @property
    def l_vars(self):
        return np.array([self.qtype.reshape(v) for v in self._l_vars])

    @property
    def n_samples(self):
        return self._n_samples

    @property
    def n_rm_samples(self):
        return self._n_rm_samples

    def __getitem__(self, key):
        """Structural indexing distributes over the per-level statistics."""
        new_qtype, start = self.qtype.get_key(key)
        if not isinstance(self.qtype, qt.ArrayType):
            key = slice(start, start + new_qtype.size())
        n_levels = self._l_means.shape[0]
        return QuantityMean(
            quantity_type=new_qtype,
            l_means=self.l_means[:, key].reshape((n_levels, -1)),
            l_vars=self.l_vars[:, key].reshape((n_levels, -1)),
            n_samples=self._n_samples,
            n_rm_samples=self._n_rm_samples,
        )


class QuantityStorage(Quantity):
    """DAG leaf reading level chunks straight from a SampleStorage; the
    root of every user DAG built by ``make_root_quantity``. Its chunks are
    tensors on ``device``."""

    def __init__(self, storage, qtype, device):
        self._storage = storage
        self.qtype = qtype
        self.device = torch.device(device)
        self._uid = next(_UID_COUNTER)
        self._input_quantities = []
        self._operation = None
        self._traceable = True
        self._selection_id = None

    def level_ids(self):
        """Level ids holding collected results in the backing storage."""
        return self._storage.get_level_ids()

    def selection_id(self):
        return self._uid

    def get_quantity_storage(self):
        return self

    def traceable(self):
        return True

    def chunks(self, level_id=None):
        """Iterate the storage's ChunkSpecs (one level or all levels)."""
        return self._storage.chunks(level_id)

    def samples(self, chunk_spec):
        # [M, chunk size, 2]
        return as_tensor(self._storage.sample_pairs_level(chunk_spec)).to(self.device)

    def n_collected(self):
        """Per-level collected sample counts from the backing storage."""
        return self._storage.get_n_collected()

    def payload_resident(self):
        """True when the backend holds payloads in RAM or device memory
        (whole-level evaluation is cheap)."""
        return getattr(self._storage, "payload_resident", False)
