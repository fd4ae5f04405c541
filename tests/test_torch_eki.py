"""mlmc_tpu_torch.eki against mlmc_tpu's, on the CPU in float64.

The ensembles replay JAX's draws: ``mlmc_tpu.esmda`` splits its key into
(k_init, k_run), draws the prior ensemble from k_init and step t's
perturbations from ``split(k_run, T)[t]``; ``_JaxDraws`` hands those
normals to the port through ``draws=``. The forward maps are batched on
the port's side (JAX vmaps a per-theta function). Ensembles, misfits and
forward counts agree to 1e-10 (the Darcy forward's CG is run to 1e-12 in
both packages, as in ``test_torch_mcmc``; its ensembles to 1e-10
absolute on O(1) values, see the test).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import convert

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10


class _JaxDraws:
    """``mlmc_tpu.esmda``'s draws under ``key`` as the port's ``draws``."""

    def __init__(self, key, n_ens, d, n_obs, n_steps):
        self.k_init, k_run = jax.random.split(key)
        self.keys = jax.random.split(k_run, n_steps)
        self.J, self.d, self.K = n_ens, d, n_obs

    def init(self):
        return torch.tensor(np.asarray(jax.random.normal(self.k_init, (self.J, self.d))))

    def __call__(self, t):
        return torch.tensor(np.asarray(jax.random.normal(self.keys[t], (self.J, self.K))))


def _linear_problem(d=3, n_obs=5, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n_obs, d))
    y = A @ rng.normal(size=d) + noise * rng.normal(size=n_obs)
    Sigma = np.linalg.inv(np.eye(d) + A.T @ A / noise ** 2)
    mu = Sigma @ A.T @ y / noise ** 2
    At = torch.tensor(A)
    return (lambda th: jnp.asarray(A) @ th), (lambda th: th @ At.T), y, mu


def _same(rt, rj):
    np.testing.assert_allclose(rt["theta"], np.asarray(rj["theta"]), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(rt["misfit"], np.asarray(rj["misfit"]), rtol=RTOL)
    for k in ("mean", "std"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, atol=1e-12, err_msg=k)
    assert rt["n_forward"] == rj["n_forward"]


@pytest.mark.parametrize("n_steps,alphas", [(4, None), (3, [2.0, 4.0, 4.0]), (1, None)])
def test_esmda_replays_mlmc_tpu_linear(n_steps, alphas):
    from mlmc_tpu.eki import esmda

    fj, ft, y, mu = _linear_problem()
    key = jax.random.key(5)
    rj = esmda(fj, y, 0.5, n_ens=48, n_steps=n_steps, alphas=alphas, d=3, key=key)
    rt = mt.esmda(ft, y, 0.5, n_ens=48, n_steps=n_steps, alphas=alphas, d=3,
                  device="cpu", draws=_JaxDraws(key, 48, 3, 5, n_steps))
    _same(rt, rj)
    assert rt["obs"].shape == (48, 5)
    np.testing.assert_allclose(rt["obs"], np.asarray(rj["obs"]), rtol=RTOL, atol=1e-12)


def test_esmda_heteroscedastic_noise_and_theta0():
    from mlmc_tpu.eki import esmda

    fj, ft, y, _ = _linear_problem(seed=3)
    noise = np.array([0.3, 0.5, 0.4, 0.6, 0.5])
    theta0 = np.random.default_rng(2).normal(size=(32, 3))
    key = jax.random.key(7)
    rj = esmda(fj, y, noise, n_steps=2, theta0=theta0, key=key, final_obs=False)
    rt = mt.esmda(ft, y, noise, n_steps=2, theta0=torch.tensor(theta0),
                  draws=_JaxDraws(key, 32, 3, 5, 2), final_obs=False)
    _same(rt, rj)
    assert rt["obs"] is None and rt["n_forward"] == 64


def test_esmda_keyed_draws_recover_conjugate_posterior():
    """The port's own keyed draws: the ensemble mean lands on the
    conjugate posterior mean (J = 2048, MC error ~ 0.01)."""
    _, ft, y, mu = _linear_problem()
    rt = mt.esmda(ft, y, 0.5, n_ens=2048, n_steps=4, d=3, seed=1, device="cpu")
    assert np.all(np.abs(rt["mean"] - mu) < 0.06)
    assert rt["misfit"][-1] < rt["misfit"][0]
    again = mt.esmda(ft, y, 0.5, n_ens=2048, n_steps=4, d=3, seed=1, device="cpu")
    np.testing.assert_array_equal(rt["theta"], again["theta"])


def test_alpha_schedule_contract():
    _, ft, y, _ = _linear_problem()
    with pytest.raises(ValueError, match="sum"):
        mt.esmda(ft, y, 0.5, n_ens=8, d=3, n_steps=2, alphas=[2.0, 3.0], device="cpu")
    with pytest.raises(ValueError, match="n_steps"):
        mt.esmda(ft, y, 0.5, n_ens=8, d=3, n_steps=4, alphas=[2.0, 2.0], device="cpu")
    with pytest.raises(ValueError, match="need d"):
        mt.esmda(ft, y, 0.5, n_ens=8, device="cpu")
    with pytest.raises(ValueError, match="steps_per_level"):
        mt.hierarchical_esmda([ft, ft], y, 0.5, steps_per_level=[2, 0], n_steps=2,
                              d=3, device="cpu")


@pytest.fixture(scope="module")
def darcy():
    from mlmc_tpu import mcmc as jm
    from mlmc_tpu.sim.diffusion import DiffusionSimulation as JaxDiffusion

    mp = pytest.MonkeyPatch()
    for cls in (JaxDiffusion, mt.DiffusionSimulation):
        mp.setattr(cls, "CG_TOL", 1e-12)
    pj = jm.make_darcy_inverse([8, 16], n_modes=4, noise_std=0.05)
    pt = mt.make_darcy_inverse([8, 16], noise_std=0.05, **convert.darcy_inverse_from_jax(pj))
    theta_true = np.random.default_rng(3).normal(size=pj["d"])
    clean = np.asarray(jax.jit(lambda th: pj["forward"](th, 16)[0])(jnp.asarray(theta_true)))
    data = clean + 0.05 * np.random.default_rng(4).normal(size=clean.shape)
    yield pj, pt, data
    mp.undo()


def test_hierarchical_esmda_replays_mlmc_tpu_darcy(darcy):
    from mlmc_tpu.eki import hierarchical_esmda

    pj, pt, data = darcy
    d, J, key = pj["d"], 16, jax.random.key(9)
    fj = [lambda th, n=n: pj["forward"](th, n)[0] for n in (8, 16)]
    rj = hierarchical_esmda(fj, data, 0.05,
                            n_ens=J, n_steps=2, d=d, key=key)
    keys = jax.random.split(key, 3)
    draws = [_JaxDraws(keys[1], J, d, len(data), 1), _JaxDraws(keys[2], J, d, len(data), 1)]
    rt = mt.hierarchical_esmda([lambda th, n=n: pt["forward"](th, n)[0] for n in (8, 16)],
                               data, 0.05, n_ens=J, n_steps=2, d=d, device="cpu",
                               draws=draws)
    # theta is O(1); the CG iterates of the two packages differ at ~1e-12
    # and the Kalman gain (noise 0.05) amplifies that to ~3e-11 absolute
    np.testing.assert_allclose(rt["theta"], np.asarray(rj["theta"]), rtol=RTOL, atol=1e-10)
    np.testing.assert_allclose(rt["misfit"], np.asarray(rj["misfit"]), rtol=RTOL)
    assert rt["n_forward"] == rj["n_forward"] == [J, 2 * J]
    assert rt["misfit"][-1] < rt["misfit"][0]
