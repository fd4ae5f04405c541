"""Carry state from ``mlmc_tpu`` into this package.

The state of a storage-free MLMC run is its per-level accumulators and its
moment basis. These helpers rebuild both from ``mlmc_tpu`` objects by
reading their fields and attributes, without importing ``jax`` or
``mlmc_tpu``: accumulator fields may be numpy arrays or anything
``numpy.asarray`` accepts. A checkpoint written by
``mlmc_tpu.FusedMLMC.save_state`` loads with ``FusedMLMC.load_state``.
"""
import numpy as np
import torch

from mlmc_tpu_torch import moments as _moments
from mlmc_tpu_torch.ops.cuda_kernels import SynthMomentResult
from mlmc_tpu_torch.ops.fused_estimate import MomentAccumulators


def accumulators_from_jax(obj, device=None):
    """An ``mlmc_tpu`` ``MomentAccumulators`` or ``SynthMomentResult`` as
    this package's tensors: float64 sums, and for a SynthMomentResult an
    int64 valid count (the Pallas kernels accumulate in f32)."""
    fields = obj._fields
    if fields == MomentAccumulators._fields:
        return MomentAccumulators(*(
            torch.tensor(np.asarray(getattr(obj, f), dtype=np.float64),
                         device=device) for f in fields))
    if fields == SynthMomentResult._fields:
        values = [torch.tensor(np.asarray(getattr(obj, f), dtype=np.float64),
                               device=device) for f in fields[:-1]]
        n_valid = torch.tensor(np.asarray(obj.n_valid, dtype=np.int64),
                               device=device)
        return SynthMomentResult(*values, n_valid)
    raise TypeError("not an accumulator: fields %r" % (fields,))


def moments_from_jax(m):
    """Rebuild an ``mlmc_tpu`` moment basis from its (type, size, domain,
    log, safe_eval, ref_domain); a TransformedMoments rebuilds its origin
    and keeps its matrix."""
    name = type(m).__name__
    if name == "TransformedMoments":
        return _moments.TransformedMoments(moments_from_jax(m._origin),
                                           np.asarray(m._transform_mat))
    cls = {"Legendre": _moments.Legendre, "Monomial": _moments.Monomial,
           "Fourier": _moments.Fourier}.get(name)
    if cls is None:
        raise TypeError("no counterpart for moment basis %s" % name)
    return cls(m.size, m.domain, ref_domain=tuple(m.ref_domain),
               log=m._is_log, safe_eval=m._is_clip)
