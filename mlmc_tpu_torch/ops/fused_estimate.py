"""Fused sample -> moment estimation for any batch simulation.

Counterpart of ``mlmc_tpu/ops/fused_estimate.py``: samples are drawn chunk
by chunk, each chunk from a generator of its own, pushed through the
moment basis and reduced to per-level accumulators; they are never stored.

    generator --sample_chunk_fn--> (fine, coarse, failed)   [C]
              --eval_all---------> (phi_f, phi_c)           [C, R]
              --mask/diff--------> dphi                     [C, R]
              --reduce-----------> sums [R], sums2 [R], cov_f, cov_c [R, R]

The chunk loop carries a Kahan compensation across chunks and folds it in
at the end, as the JAX loop does. A chunk's samples are a function of
(seed, level, the chunk's first sample index), so a level continued later,
or split over the shards of a sample mesh, draws the same samples. Plain
PyTorch: the JAX package runs this path through XLA, not through a Pallas
kernel.
"""
from typing import NamedTuple

import numpy as np
import torch

from mlmc_tpu_torch.device import resolve_device
from mlmc_tpu_torch.tool import profiling


class MomentAccumulators(NamedTuple):
    """Per-level streaming state (tensors on the level's device)."""

    sums: torch.Tensor          # [R] sum of (phi_f - phi_c) over valid samples
    sums2: torch.Tensor         # [R] sum of squares of the diff
    cov_fine: torch.Tensor      # [R, R] sum of phi_f phi_f^T
    cov_coarse: torch.Tensor    # [R, R] sum of phi_c phi_c^T
    n_valid: torch.Tensor       # [] valid-sample count
    n_total: torch.Tensor       # [] processed-sample count


def chunk_generator(seed, level, first_index, device=None):
    """The generator of one chunk of a level's stream, seeded from (seed,
    level, the chunk's first sample index): a chunk's samples depend on
    where it starts, not on which shard draws it or when."""
    state = np.random.SeedSequence(
        [int(seed), int(level), int(first_index)]).generate_state(
        1, dtype=np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _moment_chunk(phi_f, phi_c, valid, acc_dtype):
    """One chunk's contributions. phi_*: [C, ..., R]; valid: [C] (a sample
    is dropped as a whole if any component is invalid)."""
    vf = valid.reshape(valid.shape + (1,) * (phi_f.ndim - 1))
    phi_f = torch.where(vf, phi_f, torch.zeros_like(phi_f)).to(acc_dtype)
    phi_c = torch.where(vf, phi_c, torch.zeros_like(phi_c)).to(acc_dtype)
    dphi = phi_f - phi_c
    sums = dphi.sum(0)
    sums2 = (dphi * dphi).sum(0)
    cov_f = torch.einsum("c...r,c...s->...rs", phi_f, phi_f)
    cov_c = torch.einsum("c...r,c...s->...rs", phi_c, phi_c)
    n_valid = valid.sum().to(acc_dtype)
    return sums, sums2, cov_f, cov_c, n_valid


def _any_nan(x):
    """[C] mask: any NaN over the trailing axes of x [C, ...]."""
    return torch.isnan(x.reshape(x.shape[0], -1)).any(dim=1)


def fused_level_moments(sample_chunk_fn, moments_fn, level_key, n_samples,
                        chunk_size, *, is_level0, acc_dtype=torch.float64,
                        start_index=0, shard=0, n_shards=1, device=None):
    """Stream one level's samples through the fused moment pipeline.

    Chunk ``c`` holds samples ``start_index + c * chunk_size ...`` and
    draws from ``chunk_generator(seed, level, its first index)``; shard
    ``s`` of ``n_shards`` takes chunks ``s, s + n_shards, ...`` (JAX's
    stride layout), so the samples do not depend on the shard count.

    :param sample_chunk_fn: ``f(generator, n, device) -> (fine, coarse,
        failed)``; fine/coarse are [n] for a scalar QoI or [n, M]
    :param moments_fn: moment basis (Moments instance)
    :param level_key: (seed, level) of the level's stream
    :param n_samples: samples to draw on this level (over all shards)
    :param chunk_size: samples per loop step
    :param is_level0: True -> coarse contributions are zero
    :param acc_dtype: accumulator dtype
    :param start_index: first sample index (a continued level goes on
        where it stopped)
    :param shard, n_shards: this shard's place on the mesh
    :param device: where samples are drawn and reduced; None = the
        current CUDA device
    :return: MomentAccumulators of this shard's chunks
    """
    device = resolve_device(device)
    seed, level = (int(v) for v in level_key)
    n_samples = int(n_samples)
    start_index = int(start_index)
    comp = None
    acc = None
    n_total = 0
    n_chunks = -(-n_samples // chunk_size)
    for c in range(int(shard), n_chunks, int(n_shards)):
        first = c * chunk_size
        m = min(chunk_size, n_samples - first)
        generator = chunk_generator(seed, level, start_index + first, device)
        fine, coarse, failed = sample_chunk_fn(generator, m, device)
        valid = ~failed & ~_any_nan(fine)
        if not is_level0:
            # level 0's coarse output is ignored entirely, so a NaN there
            # must not invalidate the sample
            valid = valid & ~_any_nan(coarse)
        phi_f = moments_fn.eval_all(fine)
        phi_c = (torch.zeros_like(phi_f) if is_level0
                 else moments_fn.eval_all(coarse))
        # moment-domain clipping produces NaN lanes -> invalid sample
        valid = valid & ~_any_nan(phi_f)
        if not is_level0:
            valid = valid & ~_any_nan(phi_c)
        chunk = _moment_chunk(torch.nan_to_num(phi_f), torch.nan_to_num(phi_c),
                              valid, acc_dtype)
        n_total += m
        if acc is None:
            acc = list(chunk[:4]) + [chunk[4]]
            comp = [torch.zeros_like(a) for a in chunk[:4]]
            continue
        for k in range(4):
            # Kahan step: the cross-chunk error stays at one rounding of
            # the final value
            y = chunk[k] - comp[k]
            t = acc[k] + y
            comp[k] = (t - acc[k]) - y
            acc[k] = t
        acc[4] = acc[4] + chunk[4]
    if acc is None:
        R = moments_fn.size
        probe = sample_chunk_fn(chunk_generator(seed, level, start_index, device),
                                0, device)[0]
        shape = tuple(probe.shape[1:])
        zeros = dict(dtype=acc_dtype, device=device)
        return MomentAccumulators(
            torch.zeros(shape + (R,), **zeros), torch.zeros(shape + (R,), **zeros),
            torch.zeros(shape + (R, R), **zeros), torch.zeros(shape + (R, R), **zeros),
            torch.zeros((), **zeros), torch.zeros((), **zeros))
    # fold the residual compensation (true total ~ acc - comp)
    return MomentAccumulators(
        acc[0] - comp[0], acc[1] - comp[1], acc[2] - comp[2], acc[3] - comp[3],
        acc[4], torch.tensor(float(n_total), dtype=acc_dtype, device=acc[4].device))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def telescope(sums, sums2, cov_fine, cov_coarse, n_valid):
    """MLMC estimates from per-level accumulators stacked over levels (axis
    0): the one rule of the fused drivers and both stored-sample tiers.

    Level l of n = n_valid samples has mean sum / n and variance
    (sums2 - sum^2 / n) / (n - 1), with divisors max(n, 1) and max(n - 1,
    1): a level with n = 0 has mean 0, one with n <= 1 variance inf. The
    estimate sums the level means, the level variances over max(n, 1),
    and cov_fine / n - cov_coarse / n.

    :param sums, sums2: [L, ..., R]; cov_fine, cov_coarse: [L, ..., R, R];
        n_valid: [L, ...] (host arrays)
    :return: dict with l_means, l_vars [L, ..., R], mean, var [..., R],
        cov [..., R, R], n_samples [L, ...] (float)
    """
    s, s2, cf = (np.asarray(a, dtype=np.float64) for a in (sums, sums2, cov_fine))
    cc = np.array(cov_coarse, dtype=np.float64)
    cc[0] = 0.0                      # level 0 has no coarse part
    n_samples = np.asarray(n_valid, dtype=np.float64)
    k = n_samples[..., None]
    n = np.maximum(k, 1.0)
    l_means = np.where(k > 0, s / n, 0.0)
    l_vars = np.where(k > 1, (s2 - s * s / n) / np.maximum(k - 1.0, 1.0), np.inf)
    return dict(l_means=l_means, l_vars=l_vars, mean=l_means.sum(axis=0),
                var=(l_vars / n).sum(axis=0),
                cov=(cf / n[..., None] - cc / n[..., None]).sum(axis=0),
                n_samples=n_samples)


def accumulators_to_estimates(accs):
    """Combine per-level accumulators into MLMC estimates (host, numpy).

    :param accs: list of MomentAccumulators or SynthMomentResult (one per
        level; tensors on any device or numpy arrays)
    :return: ``telescope``'s dict: l_means [L, R], l_vars [L, R], mean [R],
        var [R], cov [R, R] (telescoped fine-coarse), n_samples [L]
    """
    with profiling.span("fused.fetch"):
        host = [[_np(f) for f in (a.sums, a.sums2, a.n_valid, a.cov_fine, a.cov_coarse)]
                for a in accs]
    with profiling.span("fused.host"):
        sums, sums2, n_valid, cov_fine, cov_coarse = (np.stack(f) for f in zip(*host))
        return telescope(sums, sums2, cov_fine, cov_coarse, n_valid)


def fused_mlmc_moments(sim_chunk_fns, moments_fn, seed, n_samples_per_level,
                       chunk_size=1 << 16, acc_dtype=torch.float64,
                       device=None, mesh=None):
    """All levels of the fused pipeline; level l's chunks draw from
    ``chunk_generator(seed, l, first index)``.

    :param sim_chunk_fns: per-level ``f(generator, n, device) -> (fine,
        coarse, failed)``
    :param device: None = the current CUDA device (ignored with a mesh)
    :param mesh: a ``parallel.SampleMesh``: every shard draws its strided
        chunks of each level on its device, and the accumulators are
        summed over the mesh (JAX's ``axis_name`` with ``psum``)
    :return: list of MomentAccumulators, one per level
    """
    if mesh is None:
        shards, n_shards = [(0, resolve_device(device))], 1
    else:
        shards, n_shards = mesh.local_shards(), mesh.n_devices
    accs = []
    for lvl, (fn, n) in enumerate(zip(sim_chunk_fns, n_samples_per_level)):
        per_shard = [fused_level_moments(
            fn, moments_fn, (seed, lvl), int(n), min(chunk_size, max(int(n), 1)),
            is_level0=(lvl == 0), acc_dtype=acc_dtype, shard=s,
            n_shards=n_shards, device=d) for s, d in shards]
        accs.append(per_shard[0] if mesh is None else mesh.reduce(per_shard))
    return accs
