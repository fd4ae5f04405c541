"""mlmc_tpu_torch.random.distributions and the SynthSimulation statics
against mlmc_tpu on identical inputs.

The inverse-transform samplers take the same uniforms in float64 on both
sides (tolerance 1e-10 relative; the two libraries' ``ndtri`` differ in the
last bits). The host helpers go through scipy in both packages and must
agree exactly. Generator draws use different generators, so they are held
to the law's exact mean and variance instead.
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import mlmc_tpu.random.distributions as jd
import mlmc_tpu_torch.random.distributions as td
from mlmc_tpu.sim.synth_simulation import SynthSimulation as JaxSynth
from mlmc_tpu_torch.sim.synth_simulation import SynthSimulation as TorchSynth

torch.set_num_threads(1)

LAWS = {
    "norm": (lambda m: m.Norm(0.5, 2.0)),
    "lognorm": (lambda m: m.LogNorm(0.4, 1.5)),
    "uniform": (lambda m: m.Uniform(-2.0, 3.0)),
    "two_gaussians": (lambda m: m.TwoGaussians(0.7, -1.0, 0.5, 4.0, 1.5)),
}


@pytest.mark.parametrize("name", sorted(LAWS))
def test_sample_uniforms_matches_jax(name):
    law_j, law_t = LAWS[name](jd), LAWS[name](td)
    assert law_t.qmc_dim == law_j.qmc_dim
    u = np.random.default_rng(5).uniform(1e-6, 1 - 1e-6,
                                         size=(300, law_j.qmc_dim))
    want = np.asarray(law_j.sample_uniforms(u))
    got = law_t.sample_uniforms(torch.from_numpy(u))
    assert got.dtype == torch.float64 and got.shape == (300,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("name", sorted(LAWS))
def test_host_helpers_match_jax(name):
    law_j, law_t = LAWS[name](jd), LAWS[name](td)
    q = np.array([0.001, 0.2, 0.5, 0.9, 0.999])
    x = np.asarray(law_j.ppf(q))
    np.testing.assert_array_equal(law_t.ppf(q), x)
    np.testing.assert_array_equal(law_t.pdf(x), law_j.pdf(x))
    np.testing.assert_array_equal(law_t.cdf(x), law_j.cdf(x))
    assert law_t.mean() == law_j.mean() and law_t.var() == law_j.var()
    np.testing.assert_array_equal(law_t.rvs(size=7, random_state=3),
                                  law_j.rvs(size=7, random_state=3))


@pytest.mark.parametrize("name", sorted(LAWS))
def test_generator_draws_follow_the_law(name):
    law = LAWS[name](td)
    gen = torch.Generator().manual_seed(12)
    y = law.sample(gen, (40000,), device="cpu")
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    sd = float(np.sqrt(law.var()))
    assert abs(float(y.mean()) - law.mean()) < 5 * sd / 200
    assert abs(float(y.var()) - law.var()) < 0.1 * law.var()
    again = law.sample(torch.Generator().manual_seed(12), (40000,), device="cpu")
    assert torch.equal(y, again)


def test_base_class_raises_alike():
    for base in (jd.JaxDistr(), td.TorchDistr()):
        with pytest.raises(NotImplementedError, match="QMC"):
            base.sample_uniforms(None)


@pytest.mark.parametrize("name", sorted(LAWS))
def test_as_torch_distr_names(name):
    assert td.as_torch_distr(name) == LAWS[name](td).__class__()
    assert type(td.as_torch_distr(name)).__name__ == \
        type(jd.as_jax_distr(name)).__name__
    with pytest.raises(ValueError):
        td.as_torch_distr("cauchy")


@pytest.mark.parametrize("frozen", [
    st.norm(1.0, 2.0), st.lognorm(s=0.3, scale=2.0), st.lognorm(0.3),
    st.uniform(loc=-1.0, scale=4.0)], ids=["norm", "lognorm_kw", "lognorm_pos",
                                          "uniform"])
def test_as_torch_distr_scipy(frozen):
    law_j, law_t = jd.as_jax_distr(frozen), td.as_torch_distr(frozen)
    assert type(law_t).__name__ == type(law_j).__name__
    import dataclasses
    assert dataclasses.asdict(law_t) == dataclasses.asdict(law_j)


@pytest.mark.parametrize("name", ["lognorm", "uniform", "two_gaussians"])
def test_synth_simulation_runs_with_every_law(name):
    import mlmc_tpu_torch as mt
    sim = mt.SynthSimulation(dict(distr=name, complexity=2))
    config = sim.level_instance([0.1], [0.5]).config_dict
    gen = torch.Generator().manual_seed(1)
    fine, coarse, failed = mt.SynthSimulation.calculate_batch(
        config, gen, 16, device="cpu")
    assert fine.shape == coarse.shape == (16, 24) and not bool(failed.any())
    assert bool(torch.isfinite(fine).all())


def test_synth_statics_match_jax():
    x = np.random.default_rng(2).normal(size=9)
    np.testing.assert_array_equal(
        TorchSynth.sample_fn_no_error(torch.from_numpy(x), 0.3).numpy(),
        np.asarray(JaxSynth.sample_fn_no_error(x, 0.3)))
    fine_j, coarse_j = JaxSynth.generate_random_samples("norm", 7, 5)
    fine_t, coarse_t = TorchSynth.generate_random_samples("norm", 7, 5)
    # one draw shared by fine and coarse, of the asked size, in both packages
    assert fine_t is coarse_t and fine_j is coarse_j
    assert tuple(fine_t.shape) == tuple(fine_j.shape) == (5,)
    assert torch.equal(fine_t, TorchSynth.generate_random_samples("norm", 7, 5)[0])
    big, _ = TorchSynth.generate_random_samples(td.Norm(2.0, 0.5), 1, 20000)
    assert abs(float(big.mean()) - 2.0) < 0.02 and abs(float(big.std()) - 0.5) < 0.02
