"""Carry state from ``mlmc_tpu`` into this package.

The state of a storage-free MLMC run is its per-level accumulators and its
moment basis; the state of a stored-sample run is its sample storage.
A simulation level's state is its config with the field modes drawn for
it, a random field's its decomposition, a MIMC value function's or a
Darcy inverse problem's its random modes (and observation points).
These helpers rebuild them from ``mlmc_tpu`` objects by reading their
fields and public methods, without importing ``jax`` or ``mlmc_tpu``:
arrays may be numpy arrays or anything ``numpy.asarray`` accepts. A
checkpoint written by ``mlmc_tpu.FusedMLMC.save_state`` loads with
``FusedMLMC.load_state``.
"""
import numpy as np
import torch

from mlmc_tpu_torch import moments as _moments
from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.ops.cuda_kernels import SynthMomentResult
from mlmc_tpu_torch.ops.fused_estimate import MomentAccumulators
from mlmc_tpu_torch.quantity.quantity_spec import QuantitySpec
from mlmc_tpu_torch.sample_storage import Memory
from mlmc_tpu_torch.tags import TagRange


def accumulators_from_jax(obj, device=None):
    """An ``mlmc_tpu`` ``MomentAccumulators`` or ``SynthMomentResult`` as
    this package's tensors: float64 sums, and for a SynthMomentResult an
    int64 valid count (the Pallas kernels accumulate in f32).

    :param device: None = the current CUDA device
    """
    device = resolve_device(device)
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


def storage_from_jax(memory, storage=None):
    """Copy an ``mlmc_tpu`` storage (``Memory``, ``DeviceMemory``,
    ``SampleStorageHDF`` or ``SampleStorageBin``: anything that keeps the
    ``SampleStorage`` contract) into a storage of this package, so that
    both packages estimate identical samples. A file written by
    ``mlmc_tpu`` needs no copy: this package's file storages open it.

    Carried over: the result format, the level parameters, every level's
    stored (fine, coarse) samples, the scheduled counts and the per-sample
    costs (n_ops). Sample ids are renumbered 0..n-1 per level.

    :param storage: the storage to fill (any of this package's); default
        a new host ``Memory``
    :return: the filled storage
    """
    storage = Memory() if storage is None else storage
    result_format = [_port_spec(q) for q in memory.load_result_format()]
    storage.save_global_data(result_format=result_format,
                             level_parameters=memory.get_level_parameters())
    for lid, tags in memory.load_scheduled_samples().items():
        storage.save_scheduled_samples(int(lid), TagRange(int(lid), 0, len(tags)))
    for lid, pairs in enumerate(memory.sample_pairs()):
        if pairs is None or np.size(pairs) == 0:
            continue                                  # no results on the level
        pairs = np.asarray(pairs)                     # [M, N, 1|2]
        fine = pairs[:, :, 0].T
        coarse = pairs[:, :, 1].T if pairs.shape[2] > 1 else np.zeros_like(fine)
        storage.save_samples_bulk(lid, TagRange(lid, 0, fine.shape[0]),
                                  fine, coarse)
    storage.save_n_ops([(lid, [float(c), 1.0])
                        for lid, c in enumerate(memory.get_n_ops())])
    return storage


def _port_spec(q):
    return QuantitySpec(name=q.name, unit=q.unit, shape=tuple(q.shape),
                        times=list(q.times), locations=list(q.locations))


#: per-level arrays of an ``mlmc_tpu`` simulation config: the modes and
#: eigenvalues its ``level_instance`` drew or built
_LEVEL_ARRAYS = ("_wave_numbers", "_wave_vectors", "_circ_eig")
#: per-level counts a ``level_instance`` set (the transport's step budgets)
_LEVEL_COUNTS = ("_n_steps_fine", "_n_steps_coarse")


def level_config_from_jax(config_dict, device=None, dtype=None):
    """An ``mlmc_tpu`` ``LevelSimulation.config_dict`` (of a shooting,
    diffusion or transport level) as this package's level config, so that
    both packages simulate the same field modes: ``_wave_numbers``,
    ``_wave_vectors`` and ``_circ_eig`` become float64 tensors on
    ``device``, the step budgets ``_n_steps_fine`` / ``_n_steps_coarse``
    ints, the result format this package's ``QuantitySpec``; every other
    entry without a leading underscore is copied.

    :param device: None = the current CUDA device
    :param dtype: sets ``config["dtype"]`` ('float32' | 'float64') when given
    """
    import copy

    device = resolve_device(device)
    config = {}
    for key, value in config_dict.items():
        if key in _LEVEL_ARRAYS:
            config[key] = torch.tensor(np.asarray(value, dtype=np.float64),
                                       device=device)
        elif key in _LEVEL_COUNTS:
            config[key] = int(value)
        elif key == "res_format":
            config[key] = [_port_spec(q) for q in value]
        elif not str(key).startswith("_"):
            config[key] = copy.deepcopy(value)
    if dtype is not None:
        config["dtype"] = str(dtype).replace("torch.", "")
    return config


def field_from_jax(field, device=None, dtype=torch.float64):
    """An ``mlmc_tpu`` ``SpatialCorrelatedField`` with its points and its
    decomposition (``_cov_l_factor``, ``_sqrt_ev``) as this package's, so
    that the same normals give the same realization.

    :param device: None = the current CUDA device
    """
    from mlmc_tpu_torch.random.correlated_field import SpatialCorrelatedField

    if type(field).__name__ != "SpatialCorrelatedField":
        raise TypeError("no decomposition to carry over from %s"
                        % type(field).__name__)
    out = SpatialCorrelatedField(
        corr_exp=field.correlation_exponent, dim=field.dim,
        corr_length=field._corr_length, mu=0.0, sigma=1.0, log=field.log,
        device=device, dtype=dtype)
    out.correlation_tensor = np.asarray(field.correlation_tensor)
    out._max_corr_length = field._max_corr_length
    if field.points is not None:
        out.set_points(np.asarray(field.points), mu=np.asarray(field.mu),
                       sigma=np.asarray(field.sigma))
    else:
        out.mu, out.sigma = field.mu, field.sigma
    if field.cov_mat is not None:
        out.cov_mat = np.asarray(field.cov_mat)
    if field._cov_l_factor is not None:
        out._cov_l_factor = np.asarray(field._cov_l_factor, dtype=np.float64)
        out._sqrt_ev = np.asarray(field._sqrt_ev, dtype=np.float64)
        out._n_approx_terms = int(field._n_approx_terms)
    return out


def mlqmc_from_jax(ml_jax, level_fns, device=None):
    """An ``mlmc_tpu`` ``MLQMC`` as this package's, over this package's
    ``level_fns``: the same dims, randomizations, chunk, dtype, QoI width,
    point set and fixed costs, and the JAX object's randomization carried
    across as numpy (the Owen scramble words, or the lattice shifts and
    CBC vectors), with each level's points, sums and chunk so far. The two
    objects then evaluate the same points.

    :param device: where the points are made (None: the current CUDA device)
    """
    from mlmc_tpu_torch.qmc import MLQMC

    dtype = torch.float64 if np.dtype(ml_jax._dtype) == np.float64 else torch.float32
    lattice = ml_jax._point_set == "lattice"
    kw = dict(lattice_n_max=ml_jax._lat_n_max,
              lattice_tent=ml_jax._lat_tent) if lattice else {}
    ml = MLQMC(level_fns, list(ml_jax._dims), n_randomizations=ml_jax._R,
               cost_per_sample=ml_jax._fixed_cost, chunk_size=ml_jax._chunk,
               dtype=dtype, qoi_dim=ml_jax._qoi_dim,
               point_set=ml_jax._point_set, device=device, **kw)
    home = ml._device
    if lattice:
        ml._zs = {int(d): np.asarray(z, np.int64) for d, z in ml_jax._zs.items()}
        ml._seeds = [torch.tensor(np.asarray(s, np.float64), device=home).to(dtype)
                     for s in ml_jax._seeds]
    else:
        ml._seeds = [torch.tensor(np.asarray(s, np.int64), device=home)
                     for s in ml_jax._seeds]
    for level, (src, dst) in enumerate(zip(ml_jax._levels, ml._levels)):
        dst.n = int(src.n)
        dst.sums = np.asarray(src.sums, np.float64).copy()
        dst.sums_sq = np.asarray(src.sums_sq, np.float64).copy()
        dst.elapsed = float(src.elapsed)
        if level in ml_jax._eval_cache:
            ml._chunks[level] = int(ml_jax._eval_cache[level][1])
    return ml


def _closure(fn):
    """The free variables a function reads (its closure), by name."""
    import inspect

    return inspect.getclosurevars(fn).nonlocals


def mimc_modes_from_jax(value_fn):
    """The random modes of an ``mlmc_tpu`` MIMC value function as numpy,
    read from its closure (or from a value function of this package, which
    holds them as attributes), so that both packages evaluate the same
    fields: ``heat_mimc_value_fn``'s ``{"k_modes": [M]}`` (drawn from
    ``jax.random.key(seed)``) or ``darcy_mimc_value_fn``'s
    ``{"wave_vectors": [M, 2]}`` (``_wave_vectors_2d``). Pass them as the
    keywords of the same names to this package's value functions."""
    for name in ("k_modes", "wave_vectors"):
        if hasattr(value_fn, name):
            return {name: np.asarray(getattr(value_fn, name), np.float64)}
    free = _closure(value_fn)
    if "k_modes" in free:
        return {"k_modes": np.asarray(free["k_modes"], np.float64)}
    if "kvec" in free:
        return {"wave_vectors": np.asarray(free["kvec"], np.float64)}
    raise TypeError("no MIMC modes in %r" % (value_fn,))


def darcy_inverse_from_jax(problem):
    """The random modes and observation points of an ``mlmc_tpu``
    ``mcmc.make_darcy_inverse`` problem (or of this package's) as numpy:
    ``{"wave_vectors": [M, 2], "obs_points": [K, 2]}``, the keywords of
    this package's ``make_darcy_inverse`` that make it the same problem."""
    if "wave_vectors" in problem:
        k_vec = problem["wave_vectors"]
    else:
        k_vec = _closure(_closure(problem["forward"])["_field"])["k_vec"]
    return {"wave_vectors": np.asarray(k_vec, np.float64),
            "obs_points": np.asarray(problem["observe_points"], np.float64)}


def pod_from_jax(pod, dtype=torch.float64, device=None, phases=None):
    """An ``mlmc_tpu`` ``pod_darcy_surrogate`` result as this package's
    surrogate over the same basis: the basis ``V``, the grid size, and the
    level config with its field's wave vectors, read from the closure of
    its ``model``. The port's models take ``SampleKeys`` (``pod``).

    :param phases: ``keys -> [C, M]`` RFF phases in place of the keyed
        draw (``pod.pod_darcy_surrogate``'s)
    :return: dict with ``model``, ``full_model``, ``energy``, ``rank``
    """
    from mlmc_tpu_torch.pod import _keyed_phases, _pod_models

    free = _closure(_closure(pod["model"])["reduced_flux"])
    cfg = level_config_from_jax(free["cfg"], device="cpu",
                                dtype=str(dtype).replace("torch.", ""))
    device = resolve_device(device)
    model, full_model = _pod_models(cfg, int(free["n"]), np.asarray(free["V"], np.float64),
                                    dtype, device, phases or _keyed_phases(cfg))
    return {"model": model, "full_model": full_model,
            "energy": np.asarray(pod["energy"]), "rank": int(pod["rank"])}


def pce_from_jax(pce, dtype=torch.float64, device=None):
    """A fitted ``mlmc_tpu`` ``PCE`` as this package's: its index set,
    basis and coefficients (and whether it was fitted on a scalar QoI).

    :param device: None = the current CUDA device
    """
    from mlmc_tpu_torch.pce import PCE

    out = PCE(pce.d, pce.degree, basis=pce.basis, indices=np.asarray(pce.indices),
              dtype=dtype, device=device)
    if pce.coefficients is not None:
        out.coefficients = torch.tensor(
            np.asarray(pce.coefficients, np.float64)).to(out.device, dtype)
        out._scalar = bool(pce._scalar)
    return out


def gp_from_jax(gp, device=None):
    """A fitted ``mlmc_tpu`` ``GP`` as this package's: its kernel (by
    name), fixed noise, the fitted ``params`` (log lengthscales, log
    signal, log noise, mean, rho), the training inputs ``X``, the Cholesky
    factor ``L`` and ``alpha``, in float64.

    :param device: None = the current CUDA device
    """
    from mlmc_tpu_torch.gp import GP

    name = {"rbf_kernel": "rbf", "matern52_kernel": "matern52"}.get(
        getattr(gp._kernel, "__name__", None))
    if name is None:
        raise TypeError("no counterpart for kernel %r" % (gp._kernel,))
    out = GP(name, gp._noise, dtype=torch.float64, device=device)
    st = gp._state

    def t(a):
        return torch.tensor(np.asarray(a, np.float64)).to(out._device)

    out._state = dict(X=t(st["X"]), params=[t(p) for p in st["params"]],
                      L=t(st["L"]), alpha=t(st["alpha"]))
    return out
