"""Fused storage-free estimation: mlmc_tpu_torch against mlmc_tpu.

The JAX side runs its own fused pipeline in f64 (x64 is on in the test
harness). Both sides get identical sample arrays made with numpy, so the
accumulators and estimates must agree to rtol 1e-10 (f64 sums taken in
another order and chunking).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import mlmc_tpu.estimator as jest
import mlmc_tpu.fused_driver as jfd
import mlmc_tpu.moments as jm
import mlmc_tpu.ops.fused_estimate as jfe
from mlmc_tpu.random.distributions import Norm as JNorm
from mlmc_tpu.sim.synth_simulation import SynthSimulation as JSynth

import mlmc_tpu_torch as mt
import mlmc_tpu_torch.estimator as test_
import mlmc_tpu_torch.ops.fused_estimate as tfe
from mlmc_tpu_torch.convert import accumulators_from_jax, moments_from_jax

torch.set_num_threads(1)

RTOL = 1e-10
STEPS = [0.5, 0.125, 0.03125]


def _samples(n, seed, nan_rows=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=n)
    fine = x + 0.25 * np.sqrt(1e-4 + np.abs(x))
    coarse = x + 0.5 * np.sqrt(1e-4 + np.abs(x))
    failed = rng.uniform(size=n) < 0.02
    if nan_rows:
        fine[::97] = np.nan
        coarse[::131] = np.nan
    fine[:5] = 9.0  # outside the domain: clipped to NaN -> invalid
    return fine, coarse, failed


def _torch_chunk_fn(fine, coarse, failed):
    """f(generator, n, device) serving successive slices of fixed arrays."""
    pos = [0]

    def f(generator, n, device=None):
        s = slice(pos[0], pos[0] + n)
        pos[0] += n
        return (torch.from_numpy(fine[s]), torch.from_numpy(coarse[s]),
                torch.from_numpy(failed[s]))

    return f


@pytest.mark.parametrize("is_level0", [True, False])
def test_fused_level_moments_matches_jax(is_level0):
    n = 3000
    fine, coarse, failed = _samples(n, seed=int(is_level0))
    jmfn = jm.Legendre(6, (-4.0, 4.0))

    def jfn(keys):  # one chunk covering all samples: keys are not needed
        return jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(failed)

    want = jfe.fused_level_moments(jfn, jmfn, jax.random.key(0), n, n,
                                   is_level0=is_level0)
    got = tfe.fused_level_moments(_torch_chunk_fn(fine, coarse, failed),
                                  moments_from_jax(jmfn), (0, 0), n, 512,
                                  is_level0=is_level0, device="cpu")
    for field in tfe.MomentAccumulators._fields:
        np.testing.assert_allclose(getattr(got, field).numpy(),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=1e-12, err_msg=field)


def test_accumulators_to_estimates_matches_jax():
    jmfn = jm.Legendre(5, (-4.0, 4.0))
    accs_j = []
    for lvl in range(3):
        fine, coarse, failed = _samples(2000 + 500 * lvl, seed=10 + lvl)

        def jfn(keys, fine=fine, coarse=coarse, failed=failed):
            return jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(failed)

        accs_j.append(jfe.fused_level_moments(
            jfn, jmfn, jax.random.key(0), len(fine), len(fine),
            is_level0=(lvl == 0)))
    want = jfe.accumulators_to_estimates(accs_j)
    got = tfe.accumulators_to_estimates([accumulators_from_jax(a, device="cpu")
                                         for a in accs_j])
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_estimate_n_samples_matches_jax(seed):
    rng = np.random.default_rng(seed)
    L, R = 4, 6
    l_vars = rng.uniform(1e-6, 1.0, size=(L, R))
    n_ops = rng.uniform(1e-7, 1e-3, size=L)
    target = 10 ** rng.uniform(-6, -3)
    got = test_.estimate_n_samples_for_target_variance(target, l_vars, n_ops, L)
    want = jest.estimate_n_samples_for_target_variance(target, l_vars, n_ops, L)
    assert got.tolist() == want.tolist()


def test_level_helpers_match_jax():
    for n_levels in (1, 3, 5):
        assert test_.determine_level_parameters(n_levels, (0.5, 0.01)) == \
            jest.determine_level_parameters(n_levels, (0.5, 0.01))
        for spec in (None, [1000], [1000, 10], [5, 4, 3, 2, 1][:n_levels]):
            assert test_.determine_n_samples(n_levels, spec).tolist() == \
                jest.determine_n_samples(n_levels, spec).tolist()


def _fns(distr):
    return [mt.SynthSimulation.scalar_batch_fn(
        h, 0.0 if i == 0 else STEPS[i - 1], distr) for i, h in enumerate(STEPS)]


def test_fused_mlmc_run_meets_target():
    mfn = mt.Legendre(6, (-4.0, 4.0))
    driver = mt.FusedMLMC(_fns(mt.Norm()), mfn, seed=1, chunk_size=2048,
                          device="cpu")
    target = 2e-5
    est = driver.run(target, initial_n=(512, 64))
    assert np.max(est["var"][1:]) <= target
    assert est["n_samples"].sum() > 512 + 64
    assert abs(est["mean"][0] - 1.0) < 1e-12
    # the normal's odd Legendre moments are near zero, even ones are not
    assert abs(est["mean"][1]) < 6 * np.sqrt(est["var"][1]) + 1e-2


def test_fused_mlmc_sim_level_chunk_fns_path():
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    fns = mt.sim_level_chunk_fns(sim, [[s] for s in STEPS], component=3)
    driver = mt.FusedMLMC(fns, mt.Legendre(4, (-4.0, 6.0)), seed=2,
                          chunk_size=1024, device="cpu")
    for lvl in range(3):
        driver._run_level(lvl, 1500)
    est = driver.estimates()
    assert est["n_samples"].tolist()[0] > 1400
    assert abs(est["mean"][0] - 1.0) < 1e-12


def test_checkpoint_resume_continues_streams(tmp_path):
    mfn = mt.Legendre(5, (-4.0, 4.0))
    d1 = mt.FusedMLMC(_fns(mt.Norm()), mfn, seed=4, chunk_size=128,
                      device="cpu")
    for lvl in range(3):
        d1._run_level(lvl, 256)
    ckpt = str(tmp_path / "state.npz")
    d1.save_state(ckpt)
    for lvl in range(3):
        d1._run_level(lvl, 128)

    d2 = mt.FusedMLMC(_fns(mt.Norm()), mfn, seed=4, chunk_size=128,
                      device="cpu")
    d2.load_state(ckpt)
    for lvl in range(3):
        d2._run_level(lvl, 128)
    e1, e2 = d1.estimates(), d2.estimates()
    np.testing.assert_array_equal(e1["mean"], e2["mean"])
    assert e1["n_samples"].tolist() == e2["n_samples"].tolist()
    # a continued round draws new samples: the stream never restarts
    d3 = mt.FusedMLMC(_fns(mt.Norm()), mfn, seed=4, chunk_size=128,
                      device="cpu")
    for lvl in range(3):
        d3._run_level(lvl, 128)
    assert not np.array_equal(d3.estimates()["mean"], e1["mean"])


def test_load_state_reads_mlmc_tpu_checkpoint(tmp_path):
    """A checkpoint written by mlmc_tpu.FusedMLMC.save_state loads, with
    the same estimates, and the run continues on fresh generators."""
    jmfn = jm.Legendre(5, (-4.0, 4.0))
    jfns = [JSynth.scalar_batch_fn(h, 0.0 if i == 0 else STEPS[i - 1], JNorm())
            for i, h in enumerate(STEPS)]
    jdrv = jfd.FusedMLMC(jfns, jmfn, jax.random.key(0))
    for lvl in range(3):
        fine, coarse, failed = _samples(1000, seed=20 + lvl)

        def jfn(keys, fine=fine, coarse=coarse, failed=failed):
            return jnp.asarray(fine), jnp.asarray(coarse), jnp.asarray(failed)

        acc = jfe.fused_level_moments(jfn, jmfn, jax.random.key(0), 1000, 1000,
                                      is_level0=(lvl == 0))
        jdrv._accs[lvl] = jfe.MomentAccumulators(*(np.asarray(a) for a in acc))
        jdrv._n_drawn[lvl] = 1000
        jdrv._cost_per_sample[lvl] = 1e-6 * (lvl + 1)
    ckpt = str(tmp_path / "jax_state.npz")
    jdrv.save_state(ckpt)

    drv = mt.FusedMLMC(_fns(mt.Norm()), moments_from_jax(jmfn), seed=0,
                       device="cpu")
    drv.load_state(ckpt)
    want, got = jdrv.estimates(), drv.estimates()
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, err_msg=key)
    assert drv._n_drawn == [1000, 1000, 1000]
    drv._run_level(1, 500)
    assert drv._n_drawn[1] == 1500
    assert drv.estimates()["n_samples"][1] > want["n_samples"][1]
