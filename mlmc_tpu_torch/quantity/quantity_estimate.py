"""MLMC estimators over Quantity DAGs (counterpart of
``mlmc_tpu/quantity/quantity_estimate.py``).

* NaN-sample masking keeps shapes: invalid sample columns are zeroed and
  counted instead of removed (identical sums);
* sums accumulate in f64 on the chunks' device; the per-level results
  come to the host in one fetch;
* the whole-level ("single-dispatch") tier evaluates a traceable DAG on
  fixed-size slices of each level's stored payload, on the storage's
  device, with no per-chunk memo.

The one-pass telescoping estimator:
    mean = sum_l mean(fine_l - coarse_l),  var = sum_l var_l / n_l
"""
import numpy as np
import torch

import mlmc_tpu_torch.quantity.quantity as q_mod
import mlmc_tpu_torch.quantity.quantity_types as qt
from mlmc_tpu_torch.quantity.quantity import as_tensor


def mask_nan_samples(chunk):
    """Drop samples containing NaN in fine or coarse part.

    :param chunk: array or tensor [M, N, 2]
    :return: (chunk without masked samples, number masked)
    """
    if isinstance(chunk, torch.Tensor):
        mask = torch.isnan(chunk).any(dim=0).any(dim=1)
        return chunk[..., ~mask, :], int(mask.sum())
    chunk = np.asarray(chunk)
    mask = np.any(np.isnan(chunk), axis=0).any(axis=1)
    return chunk[..., ~mask, :], int(np.count_nonzero(mask))


def cache_clear():
    q_mod.cache_clear()


def _chunk_sums(chunk):
    """Per-chunk masked accumulation: (sum [M], sum_sq [M], n_valid) as f64
    tensors on the chunk's device. chunk: [M, N, C] with C == 1 (level 0)
    or 2; NaN-poisoned samples are zeroed out and counted."""
    chunk = as_tensor(chunk)
    if not chunk.is_floating_point():
        raise TypeError("estimate_mean requires float-valued quantities, "
                        "got dtype {}".format(chunk.dtype))
    valid = ~torch.isnan(chunk).any(dim=2).any(dim=0)  # [N]
    diff = chunk[:, :, 0] - chunk[:, :, 1] if chunk.shape[2] > 1 else chunk[:, :, 0]
    diff = torch.where(valid[None, :], diff, torch.zeros_like(diff)).to(torch.float64)
    return diff.sum(dim=1), (diff * diff).sum(dim=1), valid.sum()


#: auto-enable threshold (samples on the largest level) of the whole-level
#: tier; below it the per-chunk path is as cheap
SINGLE_DISPATCH_MIN_SAMPLES = 1 << 15
#: budget for DAG-output intermediates materialized per slice
_SD_BYTE_BUDGET = 1 << 27
#: budget of device-resident chunk inputs behind un-fetched per-chunk
#: results (host inputs hold no device memory and are not counted)
_INFLIGHT_BYTES = 1 << 30


def _sd_chunk_size(m_out):
    """Samples per slice, bounding [m_out, chunk, 2] f64 intermediates to
    the byte budget (covariance quantities expand M by R^2)."""
    target = max(_SD_BYTE_BUDGET // (16 * max(int(m_out), 1)), 1 << 10)
    return min(1 << (int(target).bit_length() - 1), 1 << 16)


def _gather_raw_leaves(quantity_storage):
    """Native-layout ``[N, C, M]`` payload + true count per level.

    Resident storages hand over their level payloads (device capacity
    buffers pass whole; consumers slice to the true count); other backends
    are read chunk by chunk and concatenated. Leaves are tensors on the
    root quantity's device.

    :return: (list of leaves, list of true counts, tuple of level ids)
    """
    lids = tuple(sorted(quantity_storage.level_ids()))
    storage = getattr(quantity_storage, "_storage", None)
    raw_fn = getattr(storage, "raw_level_payload", None)
    leaves, n_trues = [], []
    for level_id in lids:
        if raw_fn is not None:
            payload, n = raw_fn(level_id)
        else:
            parts = [as_tensor(quantity_storage.samples(cs)).permute(1, 2, 0)
                     for cs in quantity_storage.chunks(level_id=level_id)]
            payload = torch.cat(parts, dim=0)
            n = payload.shape[0]
        leaves.append(as_tensor(payload).to(quantity_storage.device))
        n_trues.append(int(n))
    return leaves, n_trues, lids


def _normalize_leaf(leaf, is_level0):
    """Native [N, C, M] -> estimation layout [M, N, C] (level 0 drops the
    auxiliary coarse slot, matching QuantityStorage.samples)."""
    leaf = leaf.permute(2, 0, 1)
    if is_level0 and leaf.shape[2] > 1:
        leaf = leaf[:, :, :1]
    if not leaf.is_floating_point():
        leaf = leaf.to(torch.float64)
    return leaf


def _single_dispatch_sums(quantity, quantity_storage):
    """The whole-level tier: each level's payload goes through the DAG in
    slices of ``_sd_chunk_size`` samples, on the storage's device.

    :return: list of (sum [M], sum_sq [M], n_valid, n_true) per level
    """
    leaves, n_trues, lids = _gather_raw_leaves(quantity_storage)
    dag_eval = quantity.build_eval()
    chunk = _sd_chunk_size(quantity.size())
    outs = []
    for leaf, n_true, lid in zip(leaves, n_trues, lids):
        leaf = _normalize_leaf(leaf[:n_true], lid == 0)
        s = torch.zeros(quantity.size(), dtype=torch.float64, device=leaf.device)
        sp = torch.zeros_like(s)
        nv = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for base in range(0, n_true, chunk):
            y = as_tensor(dag_eval(leaf[:, base:base + chunk]))
            if not y.is_floating_point():
                y = y.to(torch.float64)
            cs, csp, cnv = _chunk_sums(y)
            s += cs
            sp += csp
            nv += cnv
        outs.append(torch.cat([s, sp, nv[None].to(torch.float64)]))
    # one fetch for every level's result
    host = torch.stack(outs).cpu().numpy()
    m = quantity.size()
    return [(h[:m], h[m:2 * m], int(h[2 * m]), n_true)
            for h, n_true in zip(host, n_trues)]


def estimate_mean(quantity, single_dispatch=None):
    """MLMC mean estimator over chunks.

    The whole-level tier (``single_dispatch``) is auto-selected for
    traceable DAGs over resident storages past
    ``SINGLE_DISPATCH_MIN_SAMPLES``; force it with ``True``, opt out with
    ``False``. Otherwise every stored chunk goes through the memoized DAG
    evaluation and is reduced on its device; the per-chunk results come
    to the host in one fetch (or one per ``_INFLIGHT_BYTES`` of device
    inputs).

    :param quantity: Quantity
    :param single_dispatch: tri-state override of the whole-level tier
    :return: QuantityMean holding per-level means/vars and combined estimate
    """
    cache_clear()
    quantity_vec_size = quantity.size()
    quantity_storage = quantity.get_quantity_storage()
    level_ids = quantity_storage.level_ids()
    if len(level_ids) == 0:
        raise ValueError(
            "estimate_mean: storage holds no collected results yet")
    n_levels = int(np.max(level_ids)) + 1

    n_samples = [0] * n_levels
    n_rm_samples = [0] * n_levels
    sums = [np.zeros(quantity_vec_size, dtype=np.float64)
            for _ in range(n_levels)]
    sums_of_squares = [np.zeros(quantity_vec_size, dtype=np.float64)
                       for _ in range(n_levels)]

    if single_dispatch is None:
        largest = max(quantity_storage.n_collected(), default=0)
        single_dispatch = (
            quantity.traceable()
            and getattr(quantity_storage, "payload_resident", lambda: False)()
            and largest >= SINGLE_DISPATCH_MIN_SAMPLES)
    if single_dispatch:
        per_level = _single_dispatch_sums(quantity, quantity_storage)
        for lid, (s, sp, nv, n_true) in zip(sorted(level_ids), per_level):
            sums[lid] += s
            sums_of_squares[lid] += sp
            n_samples[lid] += nv
            n_rm_samples[lid] += n_true - nv
        return _combine_level_sums(quantity, sums, sums_of_squares,
                                   n_samples, n_rm_samples)

    pending, done, inflight = [], [], 0

    def _drain():
        nonlocal pending, inflight
        if pending:
            flat = torch.stack([torch.cat([s, sp, nv[None].to(s.dtype)])
                                for _, _, (s, sp, nv) in pending]).cpu().numpy()
            done.extend(((lid, n_true), row) for (lid, n_true, _), row
                        in zip(pending, flat))
            pending, inflight = [], 0

    for chunk_spec in quantity_storage.chunks():
        samples = as_tensor(quantity.samples(chunk_spec))
        if samples.shape[0] != quantity_vec_size:
            raise ValueError("chunk holds %d values per sample, the quantity %d"
                             % (samples.shape[0], quantity_vec_size))
        n_true = samples.shape[1]
        if pending and samples.device != pending[0][2][0].device:
            _drain()
        pending.append((chunk_spec.level_id, n_true, _chunk_sums(samples)))
        if samples.device.type != "cpu":
            inflight += samples.numel() * samples.element_size()
        if inflight >= _INFLIGHT_BYTES:
            _drain()
    _drain()

    m = quantity_vec_size
    for (lid, n_true), row in done:
        n_valid = int(row[2 * m])
        n_samples[lid] += n_valid
        n_rm_samples[lid] += n_true - n_valid
        sums[lid] += row[:m]
        sums_of_squares[lid] += row[m:2 * m]

    return _combine_level_sums(quantity, sums, sums_of_squares,
                               n_samples, n_rm_samples)


def _combine_level_sums(quantity, sums, sums_of_squares, n_samples,
                        n_rm_samples):
    """Per-level (sum, sum_sq, n) -> QuantityMean (one-pass unbiased var)."""
    if sum(n_samples) == 0:
        raise Exception("All samples were masked")

    l_means = []
    l_vars = []
    for s, sp, n in zip(sums, sums_of_squares, n_samples):
        if n == 0:
            l_means.append(np.zeros(len(s)))
            l_vars.append(np.full(len(s), np.inf))
            continue
        l_means.append(s / n)
        if n > 1:
            l_vars.append((sp - (s ** 2 / n)) / (n - 1))
        else:
            l_vars.append(np.full(len(s), np.inf))

    return q_mod.QuantityMean(
        quantity.qtype,
        l_means=l_means,
        l_vars=l_vars,
        n_samples=n_samples,
        n_rm_samples=n_rm_samples,
    )


def moment(quantity, moments_fn, i=0):
    """Quantity evaluating the i-th moment function."""

    def eval_moment(x):
        return moments_fn.eval_single_moment(i, value=as_tensor(x))

    return q_mod.Quantity(
        quantity_type=quantity.qtype, input_quantities=[quantity], operation=eval_moment
    )


def moments(quantity, moments_fn, mom_at_bottom=True):
    """Quantity evaluating all R moment functions: each scalar of the
    quantity becomes an array of R moment values."""

    def eval_moments(x):
        mom = moments_fn.eval_all(as_tensor(x))  # [M, N, 2, R]
        if mom_at_bottom:
            mom = mom.permute(0, 3, 1, 2)  # [M, R, N, 2]
        else:
            mom = mom.permute(3, 0, 1, 2)  # [R, M, N, 2]
        return mom.reshape((int(np.prod(mom.shape[:-2])),) + tuple(mom.shape[-2:]))

    if mom_at_bottom:
        moments_array_type = qt.ArrayType(shape=(moments_fn.size,), qtype=qt.ScalarType())
        moments_qtype = quantity.qtype.replace_scalar(moments_array_type)
    else:
        moments_qtype = qt.ArrayType(shape=(moments_fn.size,), qtype=quantity.qtype)
    return q_mod.Quantity(
        quantity_type=moments_qtype, input_quantities=[quantity], operation=eval_moments
    )


def covariance(quantity, moments_fn, cov_at_bottom=True):
    """Quantity evaluating the R x R moment outer products."""

    def eval_cov(x):
        mom = moments_fn.eval_all(as_tensor(x))  # [M, N, 2, R]
        mom_fine = mom[..., 0, :]
        cov_fine = mom_fine[..., :, None] * mom_fine[..., None, :]
        if mom.shape[-2] == 1:
            cov = cov_fine[None, ...]  # [1, M, N, R, R]
        else:
            mom_coarse = mom[..., 1, :]
            cov_coarse = mom_coarse[..., :, None] * mom_coarse[..., None, :]
            cov = torch.stack([cov_fine, cov_coarse], dim=0)  # [2, M, N, R, R]
        if cov_at_bottom:
            cov = cov.permute(1, 3, 4, 2, 0)  # [M, R, R, N, 2]
        else:
            cov = cov.permute(3, 4, 1, 2, 0)  # [R, R, M, N, 2]
        return cov.reshape((int(np.prod(cov.shape[:-2])),) + tuple(cov.shape[-2:]))

    if cov_at_bottom:
        moments_array_type = qt.ArrayType(
            shape=(moments_fn.size, moments_fn.size), qtype=qt.ScalarType()
        )
        moments_qtype = quantity.qtype.replace_scalar(moments_array_type)
    else:
        moments_qtype = qt.ArrayType(shape=(moments_fn.size, moments_fn.size), qtype=quantity.qtype)
    return q_mod.Quantity(
        quantity_type=moments_qtype, input_quantities=[quantity], operation=eval_cov
    )
