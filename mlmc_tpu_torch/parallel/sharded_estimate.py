"""MLMC estimation over a sample mesh (counterpart of
``mlmc_tpu/parallel/sharded_estimate.py``).

Each entry point returns a ``step`` that launches every local shard's
share on its own device, with no wait between shards, then sums the
per-level accumulators over the mesh (``SampleMesh.reduce``). A sample's
identity, never the shard, decides what it draws: the sharded result
equals the one-device result up to the order of the last sums.
"""
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.ops.fused_estimate import fused_mlmc_moments


def sharded_mlmc_step(sample_mesh, sim_chunk_fns, moments_fn,
                      n_samples_per_level, chunk_size: int = 65536,
                      acc_dtype=torch.float64):
    """The fused pipeline over the mesh.

    :param sim_chunk_fns: per-level ``f(generator, n, device) -> (fine,
        coarse, failed)``
    :return: ``step(seed) -> list[MomentAccumulators]``, summed over the
        mesh. Chunk ``i * D + s`` of a level runs on shard ``s``, and a
        chunk's generator is keyed by (seed, level, its first index), so
        the samples are the same for any shard count.
    """
    def step(seed):
        return fused_mlmc_moments(sim_chunk_fns, moments_fn, seed,
                                  n_samples_per_level, chunk_size=chunk_size,
                                  acc_dtype=acc_dtype, mesh=sample_mesh)

    return step


def sharded_synth_pipeline(sample_mesh, n_moments, n_samples_per_level,
                           level_steps, *, domain):
    """The headline over the mesh: shard ``s`` launches kernel A (the
    plain version on a CPU device) on sample indices ``[s n_l / D,
    (s + 1) n_l / D)`` of every level l, then the accumulators are summed.

    Per-level counts must divide by the device count (pad the request:
    MLMC targets are estimates, not exact counts).

    :return: ``step(seed) -> list[SynthMomentResult]`` (f64 sums, int64
        n_valid), the same on every shard
    """
    n_dev = sample_mesh.n_devices
    counts = [int(n) for n in n_samples_per_level]
    for n in counts:
        sample_mesh.check_divides(n)
    shard_counts = [n // n_dev for n in counts]
    if len(counts) != len(level_steps):
        raise ValueError("n_samples_per_level has %d entries but level_steps "
                         "has %d" % (len(counts), len(level_steps)))

    def step(seed):
        per_shard = [ck.synth_mlmc_pipeline(
            seed, n_moments, shard_counts, level_steps, domain=domain,
            device=device, starts=[s * n for n in shard_counts])
            for s, device in sample_mesh.local_shards()]
        return sample_mesh.reduce(per_shard)

    return step


def sharded_synth_pipeline_from_noise(sample_mesh, n_moments, level_steps, *,
                                      domain, chunk: int = 1024):
    """Noise-input twin of ``sharded_synth_pipeline``: every level's noise
    is split into equal contiguous shares; shard ``s`` maps its share to
    QoIs (``cuda_kernels.synth_qoi``, as the JAX step), packs the
    levels (``pack_level_samples``) and reduces them in one launch of
    kernel C (``mlmc_moment_pipeline_from_samples``); the accumulators
    are summed over the mesh.

    :return: ``step(*noise_per_level) -> list[SynthMomentResult]``; each
        noise array's length must divide by the device count
    """
    L = len(level_steps)

    def step(*noise_per_level):
        if len(noise_per_level) != L:
            raise ValueError("%d noise arrays for %d levels"
                             % (len(noise_per_level), L))
        xs = [torch.as_tensor(x).reshape(-1) for x in noise_per_level]
        for x in xs:
            sample_mesh.check_divides(x.numel(), "noise lengths")
        per_shard = []
        for s, device in sample_mesh.local_shards():
            fine_l, coarse_l = [], []
            for lvl, x in enumerate(xs):
                lo, hi = sample_mesh.bounds(x.numel(), s)
                fine, coarse = ck.synth_qoi(x[lo:hi].to(device), level_steps[lvl],
                                            level_steps[lvl - 1] if lvl else 0.0)
                fine_l.append(fine)
                coarse_l.append(coarse if lvl else None)
            fine, coarse, counts = ck.pack_level_samples(fine_l, coarse_l,
                                                         chunk=chunk)
            per_shard.append(ck.mlmc_moment_pipeline_from_samples(
                fine, coarse, counts, n_moments, domain=tuple(domain),
                chunk=chunk, device=device))
        return sample_mesh.reduce(per_shard)

    return step
