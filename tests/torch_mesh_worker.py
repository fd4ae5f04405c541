"""One rank of a spawned ``torch.distributed`` world for the multi-process
mesh test. It lives in a module of its own, which imports no JAX, so that
a spawned process that runs it starts quickly."""
import numpy as np
import torch

#: what every rank runs, and what the one-process 2-shard run repeats
SEED = 5
STEPS = [0.5, 0.25, 0.125]
N_SYNTH = [4096, 2048, 1024]
N_FUSED = [3000, 1000, 500]
N_MOMENTS = 6
DOMAIN = (-4.0, 4.0)
POOL_LEVELS = [[0.1], [0.01]]
POOL_COUNTS = [37, 20]


def fused_fns():
    import mlmc_tpu_torch as mt

    return [mt.SynthSimulation.scalar_batch_fn(h, 0.0 if i == 0 else STEPS[i - 1],
                                               mt.Norm())
            for i, h in enumerate(STEPS)]


def run_paths(mesh):
    """The sharded headline, the fused step and a sharded pool's payload
    over ``mesh``: {name: numpy array}."""
    import mlmc_tpu_torch as mt
    from mlmc_tpu_torch.parallel import sharded_mlmc_step, sharded_synth_pipeline

    out = {}
    res = sharded_synth_pipeline(mesh, N_MOMENTS, N_SYNTH, STEPS,
                                 domain=DOMAIN)(SEED)
    accs = sharded_mlmc_step(mesh, fused_fns(), mt.Legendre(N_MOMENTS, DOMAIN),
                             N_FUSED, chunk_size=256)(SEED)
    for lvl, (r, a) in enumerate(zip(res, accs)):
        for f in r._fields:
            out["synth%d_%s" % (lvl, f)] = getattr(r, f).numpy()
        for f in a._fields:
            out["fused%d_%s" % (lvl, f)] = getattr(a, f).numpy()
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=SEED, sharding=mesh, min_bucket=16,
                              device_results=True, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, POOL_LEVELS)
    sampler.set_initial_n_samples(POOL_COUNTS)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    for lvl, pairs in enumerate(storage.sample_pairs()):
        out["pool%d" % lvl] = pairs.numpy()
    return out


def rank_main(rank, world, init_file, out_path):
    """Join the world over gloo, run the paths over the global mesh, save
    what came out and whether this rank is the coordinator."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mlmc_tpu_torch.parallel import multihost

    multihost.initialize("file://" + init_file, num_processes=world,
                         process_id=rank, devices=["cpu"])
    multihost.initialize("file://" + init_file, num_processes=world,
                         process_id=rank, devices=["cpu"])    # idempotent
    try:
        mesh = multihost.global_sample_mesh(["cpu"])
        out = run_paths(mesh)
        out["coordinator"] = np.asarray(multihost.is_coordinator())
        out["n_hosts"] = np.asarray(multihost.n_hosts())
        out["n_devices"] = np.asarray(mesh.n_devices)
        out["backend"] = np.asarray(dist.get_backend())
        out["local_n_devices"] = np.asarray(
            multihost.local_sample_mesh(["cpu"]).n_devices)
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()


#: the synth5x4 deployment at a tiny size: two ranks, two CPU shards each
DEPLOY_N = [4096, 2048, 1024]
DEPLOY_MOMENTS = 6


def deployment_rank_main(rank, world, init_file, out_path):
    """Join the world over gloo with two CPU shards, run the sharded
    headline step over the global mesh and save its reduced accumulators."""
    torch.set_num_threads(1)
    import torch.distributed as dist

    from mlmc_tpu_torch.parallel import multihost, sharded_synth_pipeline

    multihost.initialize("file://" + init_file, num_processes=world,
                         process_id=rank, devices=["cpu"])
    try:
        mesh = multihost.global_sample_mesh(["cpu", "cpu"])
        res = sharded_synth_pipeline(mesh, DEPLOY_MOMENTS, DEPLOY_N, STEPS,
                                     domain=DOMAIN)(SEED)
        out = {"n_devices": np.asarray(mesh.n_devices)}
        for lvl, r in enumerate(res):
            for f in r._fields:
                out["%d_%s" % (lvl, f)] = getattr(r, f).numpy()
        np.savez(out_path, **out)
    finally:
        dist.destroy_process_group()
