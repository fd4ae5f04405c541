"""The bootstrap, ``Quantity.subsample`` and the rate fits of
mlmc_tpu_torch against mlmc_tpu.

Deterministic pieces (the aggregation of replicate statistics, the
replicate statistics from given weights or indices, the closed forms) are
held to 1e-12. The replicates themselves come from different random
streams in the two packages, so on one storage carried across with
``storage_from_jax`` (2 levels, 2000 + 500 samples, B = 200) each scheme's
``mean_bs_mean`` must lie within 5 sqrt(var_bs_mean / B) of mlmc_tpu's
and its ``var_bs_mean`` within a factor 2.
"""
import functools

import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
import mlmc_tpu_torch.estimator as test_mod
import mlmc_tpu_torch.quantity.quantity_estimate as tqe

torch.set_num_threads(1)

LEVELS = [[0.5], [0.25]]
DOMAIN = (-4.0, 4.0)
R = 6
B = 200


@functools.lru_cache(maxsize=None)
def _jax_run():
    from mlmc_tpu import DeviceBatchPool, Memory, Sampler, SynthSimulation

    storage = Memory()
    sampler = Sampler(storage, DeviceBatchPool(seed=5, min_bucket=256),
                      SynthSimulation(dict(distr="norm", complexity=2)), LEVELS)
    sampler.set_initial_n_samples([2000, 500])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return storage


def _estimates(structured=False, storage=None):
    """(mlmc_tpu Estimate, port Estimate) over the same samples."""
    import mlmc_tpu.estimator as jest
    import mlmc_tpu.moments as jm
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root

    jstorage = _jax_run()
    storage = mt.storage_from_jax(jstorage, storage)
    pick = (lambda root: root["length"][1]) if structured else \
        (lambda root: root["length"][1]["10"][0, 0])
    jq = pick(j_root(jstorage, jstorage.load_result_format()))
    tq = pick(mt.make_root_quantity(storage, storage.load_result_format(),
                                    device="cpu"))
    return (jest.Estimate(jq, jstorage, jm.Legendre(R, DOMAIN)),
            mt.Estimate(tq, storage, mt.Legendre(R, DOMAIN)))


_BS_ATTRS = ("mean_bs_mean", "mean_bs_var", "mean_bs_l_means", "mean_bs_l_vars",
             "var_bs_mean", "var_bs_var", "var_bs_l_means", "var_bs_l_vars",
             "_bs_level_mean_variance")


@pytest.mark.parametrize("regression", [False, True])
@pytest.mark.parametrize("log", [False, True])
@pytest.mark.parametrize("stat_shape", [(R,), (R, 3)])
def test_finish_bootstrap_matches_mlmc_tpu(stat_shape, log, regression):
    """The same [B, L, R(, M)] replicate statistics through both
    packages' aggregation: every attribute 1e-12."""
    rng = np.random.default_rng(0)
    L = 3
    means = rng.normal(size=(20, L) + stat_shape)
    variances = rng.uniform(0.1, 2.0, size=(20, L) + stat_shape) \
        * np.array([1.0, 0.1, 0.01]).reshape((1, L) + (1,) * len(stat_shape))
    variances[:, :, 0] = 0.0                       # moment 0
    ns = np.array([300, 120, 40])

    class _Storage:
        get_level_parameters = staticmethod(lambda: [[0.5], [0.25], [0.125]])
        get_n_collected = staticmethod(lambda: [400, 150, 50])

    import mlmc_tpu.estimator as jest

    je = jest.Estimate(None, _Storage(), None)
    te = mt.Estimate(None, _Storage(), None)
    je._finish_bootstrap(means.copy(), variances.copy(), ns, 20, L, regression, log)
    te._finish_bootstrap(means.copy(), variances.copy(), ns, 20, L, regression, log)
    attrs = _BS_ATTRS + (("var_bs_log_l_vars",) if log else ())
    for name in attrs:
        got, want = getattr(te, name), getattr(je, name)
        assert got.shape == want.shape == (L,) * (name.count("_l_") > 0 or name.startswith("_bs")) + stat_shape, name
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-15, err_msg=name)
    assert hasattr(te, "var_bs_log_l_vars") == log


def test_replicate_statistics_from_given_weights_and_indices():
    """The formulas of mlmc_tpu's replicate programs, written in numpy,
    from given Poisson uniforms and Efron indices: 1e-12."""
    from scipy.special import gammaln

    rng = np.random.default_rng(1)
    N, K, nb = 500, 4, 7
    dphi = rng.normal(size=(N, K))
    valid = rng.uniform(size=N) > 0.1
    dphi[~valid] = 0.0
    n_valid, n_sub = int(valid.sum()), 300

    # Poisson: weights = the count of cdf thresholds strictly below u
    u = rng.uniform(size=(nb, N))
    lam = n_sub / n_valid
    ks = np.arange(13.0)
    cdf = np.cumsum(np.exp(-lam + ks * np.log(lam) - gammaln(ks + 1.0)))
    W = sum((u > cdf[i]).astype(float) for i in range(12)) * valid
    n_r = np.maximum(W.sum(axis=1), 2.0)
    s, sp = W @ dphi, W @ (dphi * dphi)
    want_mean = s / n_r[:, None]
    want_var = (sp - s * s / n_r[:, None]) / (n_r - 1.0)[:, None]
    np.testing.assert_allclose(test_mod.Estimate._poisson_cdf(lam), cdf[:12], rtol=1e-14)
    w = test_mod.Estimate._weights_poisson(
        torch.tensor(u), torch.tensor(valid),
        torch.tensor(test_mod.Estimate._poisson_cdf(lam)))
    np.testing.assert_array_equal(w.numpy(), W)
    got_mean, got_var = test_mod.Estimate._replicate_stats(
        w, torch.tensor(dphi), w.sum(dim=1).clamp(min=2.0))
    np.testing.assert_allclose(got_mean.numpy(), want_mean, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got_var.numpy(), want_var, rtol=1e-12, atol=1e-14)

    # Efron: draws over the valid prefix of one stable argsort
    order = np.argsort(np.where(valid, 0, 1), kind="stable")
    r = rng.integers(0, n_valid, size=(nb, n_sub))
    sub = dphi[order[r]]                                     # [nb, n_sub, K]
    s, sp = sub.sum(axis=1), (sub * sub).sum(axis=1)
    w = test_mod.Estimate._weights_from_indices(torch.tensor(order[r]), N)
    assert np.all(w.numpy()[:, ~valid] == 0) and np.all(w.sum(dim=1).numpy() == n_sub)
    got_mean, got_var = test_mod.Estimate._replicate_stats(
        w, torch.tensor(dphi), torch.full((nb,), float(n_sub), dtype=torch.float64))
    np.testing.assert_allclose(got_mean.numpy(), s / n_sub, rtol=1e-12, atol=1e-14)
    np.testing.assert_allclose(got_var.numpy(), (sp - s * s / n_sub) / (n_sub - 1),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("replace", [False, True, "poisson"])
def test_bootstrap_schemes_agree_with_mlmc_tpu(replace):
    je, te = _estimates()
    sv = [1000, 250]
    je.est_bootstrap_fast(n_subsamples=B, sample_vector=sv, seed=1, replace=replace)
    te.est_bootstrap_fast(n_subsamples=B, sample_vector=sv, seed=1, replace=replace,
                          log=True)
    for name in _BS_ATTRS:
        assert getattr(te, name).shape == np.shape(getattr(je, name)), name
    assert te.var_bs_log_l_vars.shape == (2, R)
    assert te.var_bs_mean[0] == 0.0 and te.mean_bs_mean[0] == 1.0
    assert np.all(te.var_bs_mean >= 0)
    tol = 5 * np.sqrt(np.maximum(te.var_bs_mean, je.var_bs_mean) / B) + 1e-12
    assert np.all(np.abs(te.mean_bs_mean - je.mean_bs_mean) <= tol)
    ratio = te.var_bs_mean[1:] / je.var_bs_mean[1:]
    assert np.all((ratio > 0.5) & (ratio < 2.0)), ratio
    ratio = te.mean_bs_l_vars[:, 1:] / je.mean_bs_l_vars[:, 1:]
    np.testing.assert_allclose(ratio, 1.0, rtol=0.05)


def test_bootstrap_structured_quantity_shapes():
    je, te = _estimates(structured=True)
    sv = [400, 100]
    je.est_bootstrap_fast(n_subsamples=40, sample_vector=sv, replace="poisson")
    te.est_bootstrap_fast(n_subsamples=40, sample_vector=sv, replace="poisson")
    M = te._quantity.size()
    assert M == 4
    for name in _BS_ATTRS:
        assert getattr(te, name).shape == np.shape(getattr(je, name)), name
    assert te.mean_bs_l_means.shape == (2, R, M)
    assert np.all(te.mean_bs_mean[0] == 1.0) and np.all(te.var_bs_mean[0] == 0.0)
    tol = 5 * np.sqrt(np.maximum(te.var_bs_mean, je.var_bs_mean) / 40) + 1e-12
    assert np.all(np.abs(te.mean_bs_mean - je.mean_bs_mean) <= tol)


def test_replicates_do_not_depend_on_the_blocking(monkeypatch):
    _, te = _estimates()
    out = {}
    for budget in (1 << 29, 32 * 2000 * 3):       # all at once / 3 per block
        monkeypatch.setattr(mt.Estimate, "BOOTSTRAP_BLOCK_BYTES", budget)
        for replace in (False, True, "poisson"):
            te.est_bootstrap_fast(n_subsamples=8, sample_vector=[500, 100],
                                  seed=4, replace=replace)
            out.setdefault(replace, []).append(te.mean_bs_l_means.copy())
    for replace, (a, b) in out.items():
        np.testing.assert_allclose(a, b, rtol=1e-13, atol=1e-15, err_msg=str(replace))
    # and they do depend on the seed
    te.est_bootstrap_fast(n_subsamples=8, sample_vector=[500, 100], seed=5,
                          replace="poisson")
    assert not np.allclose(te.mean_bs_l_means, out["poisson"][0])


@pytest.mark.parametrize("replace", [False, True, "poisson"])
def test_invalid_samples_and_the_capacity_tail_are_never_picked(replace):
    """A DeviceMemory holds a capacity buffer beyond its true count, and
    some stored samples are NaN or out of the domain: with every valid
    sample's value equal, any pick of another one would show."""
    storage = mt.DeviceMemory(device="cpu")
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage.save_global_data(result_format=sim.result_format(),
                             level_parameters=LEVELS)
    rng = np.random.default_rng(3)
    from mlmc_tpu_torch.tags import TagRange
    for lid, n in enumerate((300, 90)):
        fine = np.full((n, 24), 1.5, np.float32)
        coarse = np.full((n, 24), 0.5 if lid else 0.0, np.float32)
        bad = rng.uniform(size=n) < 0.3
        fine[bad] = np.where(rng.uniform(size=(bad.sum(), 1)) < 0.5, np.nan, 77.0)
        storage.save_scheduled_samples(lid, TagRange(lid, 0, n))
        storage.save_samples_bulk(lid, TagRange(lid, 0, n), torch.tensor(fine),
                                  torch.tensor(coarse))
    payload, n_true = storage.raw_level_payload(0)
    assert payload.shape[0] > n_true == 300              # a capacity tail
    payload[n_true:] = 55.0                              # poison it
    q = mt.make_root_quantity(storage, sim.result_format())["length"][1]["10"][0, 0]
    mfn = mt.Legendre(R, DOMAIN)
    te = mt.Estimate(q, storage, mfn)
    te.est_bootstrap_fast(n_subsamples=12, sample_vector=[150, 40], replace=replace)
    phi = mfn.eval_all_np(np.array([1.5, 0.5]))
    np.testing.assert_allclose(te.mean_bs_l_means[0], phi[0], rtol=1e-12)
    np.testing.assert_allclose(te.mean_bs_l_means[1], phi[0] - phi[1], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(te.var_bs_l_means, 0.0, atol=1e-24)
    np.testing.assert_allclose(te.mean_bs_l_vars, 0.0, atol=1e-12)


def test_bootstrap_argument_errors():
    _, te = _estimates()
    with pytest.raises(ValueError, match="replace must be"):
        te.est_bootstrap_fast(n_subsamples=4, replace="x")
    mesh = mt.SampleMesh(["cpu", "cpu"], group=False)
    with pytest.raises(ValueError, match="poisson"):
        te.est_bootstrap_fast(n_subsamples=4, replace=True, mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        te.est_bootstrap_fast(n_subsamples=5, replace="poisson", mesh=mesh)


def test_est_bootstrap_and_target_var_allocation():
    je, te = _estimates()
    te.est_bootstrap(n_subsamples=20, sample_vector=[800, 200])
    assert te.mean_bs_l_vars.shape == (2, R) and te.var_bs_mean[0] == 0.0
    n_est = te.bs_target_var_n_estimated(1e-4, sample_vec=[1000, 250])
    j_est = je.bs_target_var_n_estimated(1e-4, sample_vec=[1000, 250])
    assert n_est.shape == (2,) and n_est[0] >= n_est[1] >= 2
    np.testing.assert_allclose(n_est, j_est, rtol=0.1)


@pytest.mark.parametrize("chunk_size", [None, 64, 7])
def test_subsample_picks_exactly_the_sample_vector(chunk_size):
    """Over any chunking a level yields exactly sample_vec[l] columns, all
    of them stored samples, none twice; a generator seeds the pick."""
    storage = mt.Memory(chunk_size=chunk_size) if chunk_size else mt.Memory()
    mt.storage_from_jax(_jax_run(), storage)
    root = mt.make_root_quantity(storage, storage.load_result_format(), device="cpu")
    q = root["length"][1]["10"][0, 0]
    sub = q.subsample([300, 50], generator=torch.Generator().manual_seed(2))
    assert not sub.traceable()
    for lid, want in enumerate((300, 50)):
        picked = torch.cat([sub.samples(cs) for cs in storage.chunks(level_id=lid)], dim=1)
        assert picked.shape[1] == want
        full = torch.cat([q.samples(cs) for cs in storage.chunks(level_id=lid)], dim=1)
        stored = {tuple(v) for v in full[0].numpy().round(12).tolist()}
        rows = [tuple(v) for v in picked[0].numpy().round(12).tolist()]
        assert len(set(rows)) == want and set(rows) <= stored
    tqe.cache_clear()
    mean = tqe.estimate_mean(
        q.subsample([300, 50], generator=torch.Generator().manual_seed(2)))
    assert mean.n_samples.tolist() == [300, 50]
    tqe.cache_clear()
    again = q.subsample([300, 50], generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(tqe.estimate_mean(again).mean, mean.mean)
    tqe.cache_clear()
    other = q.subsample([300, 50], generator=torch.Generator().manual_seed(3))
    assert not np.array_equal(tqe.estimate_mean(other).mean, mean.mean)
    # more than a level holds: all of it
    tqe.cache_clear()
    assert tqe.estimate_mean(q.subsample([10 ** 6, 10 ** 6])).n_samples.tolist() \
        == list(storage.get_n_collected())


def test_fast_tiers_refuse_a_subsampled_quantity():
    """subsample is eager and not packable: the whole-level tiers go
    through the chunked path and still see exactly the picked columns."""
    _, te = _estimates()
    sub = te.quantity.subsample([200, 40], generator=torch.Generator().manual_seed(0))
    est = mt.Estimate(sub, te._sample_storage, te._moments_fn)
    assert not sub.traceable()
    _, ns = est.estimate_diff_vars_fast()
    assert ns.sum() <= 240 and ns[0] > 150


def test_closed_forms_match_mlmc_tpu():
    import mlmc_tpu.estimator as jest

    je, te = _estimates()
    n = np.array([2, 3, 10, 1000, 12345])
    np.testing.assert_allclose(te._variance_of_variance(n),
                               je._variance_of_variance(n), rtol=1e-12)
    te._n_created_samples = je._n_created_samples = [50, 20]
    np.testing.assert_allclose(te._variance_of_variance(),
                               je._variance_of_variance(), rtol=1e-12)
    rng = np.random.default_rng(0)
    h = [[0.5], [0.25], [0.125], [0.0625]]
    means = 0.3 * np.array([4.0, 1.0, 0.27, 0.06]) * rng.uniform(0.9, 1.1, 4)
    variances = np.array([2.0, 0.5, 0.11, 0.03])
    costs = np.array([1.0, 4.2, 15.0, 66.0])
    for n_ops in (None, costs):
        got = test_mod.estimate_convergence_rates(means, variances, h, n_ops)
        want = jest.estimate_convergence_rates(means, variances, h, n_ops)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12)
    assert got["beta"] > got["gamma"] > 0
    # too few usable levels: nan, as in mlmc_tpu
    short = test_mod.estimate_convergence_rates(means[:2], variances[:2], h[:2])
    assert np.isnan(short["alpha"]) and short["n_fit_levels"] == 1
    for alpha in (got["alpha"], -1.0, np.nan):
        np.testing.assert_allclose(
            test_mod.richardson_extrapolation(means, h, alpha),
            jest.richardson_extrapolation(means, h, alpha), rtol=1e-12)
    np.testing.assert_array_equal(
        test_mod.determine_sample_vec([10, 5, 2], 2, None),
        jest.determine_sample_vec([10, 5, 2], 2, None))
    np.testing.assert_array_equal(
        test_mod.determine_sample_vec([10, 5], 2, [4, 3, 2]), [4, 3])
