"""The stored-samples MLMC slice end to end (Sampler -> DeviceBatchPool ->
storage -> Quantity -> Estimate), mlmc_tpu_torch against mlmc_tpu.

mlmc_tpu samples a small 3-level synthetic run into its ``Memory``;
``storage_from_jax`` copies it into the port, and both packages estimate
the same samples:
* the generic (f64) tier's means and variances agree to rtol 1e-10, and
  its maxent density to rtol 1e-8, as tests/test_torch_slice.py holds the
  storage-free slice;
* the fast tier's accumulators (f32 values) agree within mlmc_tpu's f32
  accumulation bound, and the allocation it drives to 1e-3.
A second test runs the port's own adaptive loop (its pool, a DeviceMemory
on the CPU) at a reduced size of the chip workload.
"""
import functools

import numpy as np
import torch

import mlmc_tpu_torch as mt
import mlmc_tpu_torch.quantity.quantity_estimate as tqe
from mlmc_tpu_torch.ops import cuda_kernels as ck

torch.set_num_threads(1)

LEVELS = [[0.5], [0.25], [0.125]]
DOMAIN = (-4.0, 4.0)
R = 8


@functools.lru_cache(maxsize=None)
def _jax_run():
    """One mlmc_tpu sampler run, shared by the tests of this file (they
    only read it)."""
    from mlmc_tpu import DeviceBatchPool, Memory, Sampler, SynthSimulation

    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=17, min_bucket=256),
                      SynthSimulation(dict(distr="norm", complexity=2)), LEVELS)
    sampler.set_initial_n_samples([2000, 200])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return storage


def _estimates():
    """(mlmc_tpu Estimate, port Estimate) over the same samples."""
    import mlmc_tpu.estimator as jest
    import mlmc_tpu.moments as jm
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root

    jstorage = _jax_run()
    storage = mt.storage_from_jax(jstorage)
    assert storage.get_n_collected() == jstorage.get_n_collected()
    jq = j_root(jstorage, jstorage.load_result_format())["length"][1]["10"][0, 0]
    tq = mt.make_root_quantity(storage, storage.load_result_format(),
                               device="cpu")["length"][1]["10"][0, 0]
    return (jest.Estimate(jq, jstorage, jm.Legendre(R, DOMAIN)),
            mt.Estimate(tq, storage, mt.Legendre(R, DOMAIN)))


def test_storage_from_jax_carries_the_run():
    jstorage = _jax_run()
    storage = mt.storage_from_jax(jstorage, mt.DeviceMemory(device="cpu"))
    assert storage.get_n_collected() == jstorage.get_n_collected()
    assert storage.get_level_parameters() == LEVELS
    for a, b in zip(storage.sample_pairs(), jstorage.sample_pairs()):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_stored_slice_fast_tier_and_allocation_match_mlmc_tpu():
    import mlmc_tpu.estimator as jest
    from mlmc_tpu.ops.precision import accumulation_error_bound

    je, te = _estimates()
    raw, ns = te.estimate_diff_vars_fast()
    jraw, jns = je.estimate_diff_vars_fast()
    assert ns.tolist() == jns.tolist()
    got = te._stream_results(te._moments_fn, [0])
    want = je._fast_results_packed(je._moments_fn, [0])[0]
    s_abs = ck.samples_mlmc_plain(
        te._packed_streams(te._moments_fn, [0]), R, basis="legendre",
        consts=ck.transform_constants(DOMAIN), absolute=True)
    for lvl, w in enumerate(want):
        assert int(got.n_valid[lvl, 0]) == int(w.n_valid)
        for f in ("sums", "sums2", "cov_fine", "cov_coarse"):
            bound = accumulation_error_bound(getattr(s_abs, f)[lvl].numpy())
            assert np.all(np.abs(getattr(got, f)[lvl, 0] - np.asarray(getattr(w, f)))
                          <= bound + 1e-12), (lvl, f)
    variances, n_ops = te.estimate_diff_vars_regression(ns, raw_vars=raw)
    j_variances, j_ops = je.estimate_diff_vars_regression(jns, raw_vars=jraw)
    np.testing.assert_allclose(n_ops, j_ops, rtol=1e-15)
    n_est = mt.estimate_n_samples_for_target_variance(1e-5, variances, n_ops, 3)
    j_est = jest.estimate_n_samples_for_target_variance(1e-5, j_variances, j_ops, 3)
    np.testing.assert_allclose(n_est, j_est, rtol=1e-3)


def test_stored_slice_generic_tier_matches_mlmc_tpu():
    je, te = _estimates()
    mean, var = te.estimate_moments()
    j_mean, j_var = je.estimate_moments()
    np.testing.assert_allclose(mean, j_mean, rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(var, j_var, rtol=1e-10, atol=1e-16)
    assert mean[0] == 1.0


def test_stored_slice_density_matches_mlmc_tpu():
    je, te = _estimates()
    td, t_info, t_res, _ = te.construct_density(tol=1e-8)
    jd, j_info, j_res, _ = je.construct_density(tol=1e-8)
    assert t_res.success and j_res.success
    np.testing.assert_allclose(t_info[2], j_info[2], rtol=1e-10, atol=1e-12)
    x = np.linspace(-3.9, 3.9, 100)
    np.testing.assert_allclose(td.density(x), jd.density(x), rtol=1e-8)


def test_port_adaptive_loop_on_device_memory():
    """The chip workload's loop at a reduced size: sample, estimate the
    level variances on the fast tier, regress, allocate, add samples until
    the target variance holds, then the fast maxent density."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=17, device_results=True, min_bucket=1 << 12,
                              max_batch=1 << 12, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, LEVELS)
    sampler.set_initial_n_samples([2000, 200])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    root = mt.make_root_quantity(storage, sim.result_format())
    est = mt.Estimate(root["length"][1]["10"][0, 0], storage, mt.Legendre(8, DOMAIN))
    target = 2e-5
    rounds, alloc_target = 0, target
    for rounds in range(30):
        raw, ns = est.estimate_diff_vars_fast()
        var = np.max((raw[:, 1:] / ns[:, None]).sum(axis=0))
        if var <= target:
            break
        variances, n_ops = est.estimate_diff_vars_regression(
            sampler._n_scheduled_samples, raw_vars=raw)
        n_est = mt.estimate_n_samples_for_target_variance(
            alloc_target, variances, n_ops, n_levels=sampler.n_levels)
        if sampler.process_adding_samples(n_est, 0, 0.3):
            # allocation reached but the target is not: the regressed
            # variances run low, so aim the allocation below the target
            alloc_target *= 0.95 * target / var
    mean, var = est.estimate_moments_fast()
    assert rounds > 0 and np.max(var[1:]) <= target and mean[0] == 1.0
    assert sum(storage.get_n_collected()) > 2500
    _, _, result, _ = est.construct_density_fast(tol=1e-8)
    assert result.success
    # the DAG (f64 sums of the same f32 values) agrees with the fast tier
    m = tqe.estimate_mean(tqe.moments(est.quantity, est._moments_fn))
    np.testing.assert_allclose(m.mean, mean, rtol=1e-6, atol=1e-7)
