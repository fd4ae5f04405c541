"""mlmc_tpu_torch.gp against mlmc_tpu's, on the CPU in float64.

The fit is Adam on the exact marginal likelihood in both packages (optax
in JAX, ``risk.adam``'s copy of optax's update on plain tensors here):
the same start, the same gradients up to rounding, but each Adam step
normalizes by the running gradient moments, so the two parameter paths
round apart slowly. Over the fits here (up to 100 steps) the NLL traces
agree to 1e-8 relative and the posterior means and sds to 1e-7 (sds
near the data, a cancellation, to 1e-8 absolute); the
fixed noise and the absent offset stay exactly frozen. A JAX fit carried
over by ``convert.gp_from_jax`` predicts to 1e-12. ``bayes_opt`` takes
JAX's scramble words (``sobol.scramble_seeds(fold_in(key, it), d)``)
through ``scrambles=`` and then draws JAX's design and candidates.
"""
import jax
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import convert
from torch_cwd import removed_working_directory

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

NLL_RTOL, PRED_RTOL = 1e-8, 1e-7


def _data(n=14, seed=0, noise=0.0):
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 2, size=(n, 2))
    y = np.sin(3 * X[:, 0]) + 0.5 * X[:, 1] + noise * rng.standard_normal(n)
    return X, y


@pytest.mark.parametrize("kernel,noise", [("rbf", 1e-4), ("matern52", None)])
def test_gp_fit_and_predict_match_mlmc_tpu(kernel, noise):
    from mlmc_tpu.gp import GP

    X, y = _data(noise=0.05)
    gj = GP(kernel, noise).fit(X, y, n_steps=60)
    gt = mt.GP(kernel, noise, device="cpu").fit(X, y, n_steps=60)
    np.testing.assert_allclose(gt.nll_trace, gj.nll_trace, rtol=NLL_RTOL)
    assert gt.nll_trace[-1] < gt.nll_trace[0]
    Xs = np.random.default_rng(5).uniform(0, 2, size=(9, 2))
    for inc in (False, True):
        for a, b in zip(gt.predict(Xs, include_noise=inc), gj.predict(Xs, include_noise=inc)):
            np.testing.assert_allclose(a, b, rtol=PRED_RTOL)
    hj, ht = gj.hyperparameters, gt.hyperparameters
    np.testing.assert_allclose(ht["lengthscales"], hj["lengthscales"], rtol=PRED_RTOL)
    for k in ("signal_sd", "noise_sd", "mean"):
        assert ht[k] == pytest.approx(hj[k], rel=PRED_RTOL), k
    assert ht["rho"] == 0.0                      # no offset: frozen at 0
    if noise is not None:
        assert ht["noise_sd"] == pytest.approx(noise, rel=1e-15)


def test_gp_offset_fit_learns_rho_like_mlmc_tpu():
    from mlmc_tpu.gp import GP

    X, y = _data(seed=2)
    offset = 2.0 * y + 0.1 * np.cos(X[:, 0])
    gj = GP(noise=1e-3).fit(X, offset, offset=y, n_steps=80)
    gt = mt.GP(noise=1e-3, device="cpu").fit(X, offset, offset=y, n_steps=80)
    np.testing.assert_allclose(gt.nll_trace, gj.nll_trace, rtol=NLL_RTOL)
    assert gt.hyperparameters["rho"] == pytest.approx(gj.hyperparameters["rho"], rel=PRED_RTOL)


def test_gp_from_jax_predicts_like_jax():
    from mlmc_tpu.gp import GP

    X, y = _data(seed=3, noise=0.02)
    gj = GP("matern52").fit(X, y, n_steps=60)
    gt = convert.gp_from_jax(gj, device="cpu")
    Xs = np.random.default_rng(4).uniform(0, 2, size=(20, 2))
    for inc in (False, True):
        (mu_t, sd_t), (mu_j, sd_j) = (g.predict(Xs, include_noise=inc) for g in (gt, gj))
        np.testing.assert_allclose(mu_t, mu_j, rtol=1e-12)
        # sd^2 = sf^2 - |V|^2 cancels near the data: 1e-12 of the signal sd
        np.testing.assert_allclose(sd_t, sd_j, rtol=1e-12,
                                   atol=1e-12 * gj.hyperparameters["signal_sd"])
    for k, v in gj.hyperparameters.items():
        np.testing.assert_array_equal(gt.hyperparameters[k], v, err_msg=k)


def _forrester(x):
    return (6 * x - 2) ** 2 * np.sin(12 * x - 4)


def test_multilevel_gp_forrester_matches_mlmc_tpu():
    from mlmc_tpu.gp import MultilevelGP

    x_lo = np.linspace(0, 1, 25)[:, None]
    y_lo = 0.5 * _forrester(x_lo[:, 0]) + 10 * (x_lo[:, 0] - 0.5) - 5
    x_hi = np.array([0.0, 0.3, 0.55, 0.8, 1.0])[:, None]
    y_hi = _forrester(x_hi[:, 0])
    levels = [(x_lo, y_lo), (x_hi, y_hi)]
    mj = MultilevelGP(noise=1e-4).fit(levels, n_steps=100)
    mtp = mt.MultilevelGP(noise=1e-4, device="cpu").fit(levels, n_steps=100)
    assert mtp.rhos == pytest.approx(mj.rhos, rel=PRED_RTOL)
    xs = np.linspace(0, 1, 41)[:, None]
    (mu_t, sd_t), (mu_j, sd_j) = mtp.predict(xs), mj.predict(xs)
    np.testing.assert_allclose(mu_t, mu_j, rtol=PRED_RTOL, atol=1e-9)
    # the sds at the data points (~2e-4) are a cancellation sf^2 - |V|^2
    np.testing.assert_allclose(sd_t, sd_j, rtol=PRED_RTOL, atol=1e-8)
    with pytest.raises(ValueError, match="one level"):
        mt.MultilevelGP(device="cpu").fit([])


def _branin(x):
    a, b, c = 1.0, 5.1 / (4 * np.pi ** 2), 5.0 / np.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * np.pi)
    return (a * (x[1] - b * x[0] ** 2 + c * x[0] - r) ** 2
            + s * (1 - t) * np.cos(float(x[0])) + s)


BRANIN_BOUNDS = np.array([[-5.0, 10.0], [0.0, 15.0]])
BAYES_OPT = dict(n_init=6, n_iter=2, noise=1e-6, fit_steps=40, n_candidates=128)


def _bayes_opt_torch(key):
    """The port's ``bayes_opt`` on Branin with JAX's scramble words of
    ``key``, at the sizes of ``test_bayes_opt_draws_jax_candidates``."""
    from mlmc_tpu.ops import sobol as jax_sobol

    words = lambda it: jax_sobol.scramble_seeds(jax.random.fold_in(key, it), 2)
    scrambles = {it: torch.tensor(np.asarray(words(it)).astype(np.int64)) for it in range(3)}
    return lambda: mt.bayes_opt(lambda x: _branin(x.numpy()), BRANIN_BOUNDS, device="cpu",
                                scrambles=scrambles.__getitem__, **BAYES_OPT)


def test_bayes_opt_draws_jax_candidates():
    """With JAX's scramble words the initial design is JAX's Sobol' design
    (``bayes_opt``'s round 0) and each round picks from JAX's candidate
    set; the Branin run itself is held on the card (``chip_smoke.py``)."""
    from mlmc_tpu.ops import sobol as jax_sobol

    bounds = BRANIN_BOUNDS
    key, dv = jax.random.key(0), jax_sobol.direction_numbers(2)
    words = lambda it: jax_sobol.scramble_seeds(jax.random.fold_in(key, it), 2)

    def jax_points(it, n):
        u = np.asarray(jax_sobol.sobol_uniforms(dv, 0, n, seeds=words(it)), np.float64)
        return bounds[:, 0] + (bounds[:, 1] - bounds[:, 0]) * u

    rt = _bayes_opt_torch(key)()
    np.testing.assert_array_equal(rt["X"][:6], jax_points(0, 6))
    for it in (1, 2):
        assert (jax_points(it, 128) == rt["X"][5 + it]).all(1).any()
    np.testing.assert_array_equal(rt["y"], [_branin(x) for x in rt["X"]])
    assert rt["ei_trace"].shape == (2,) and np.all(rt["ei_trace"] >= 0)
    with pytest.raises(ValueError, match="bounds"):
        mt.bayes_opt(_branin, np.array([[1.0, 0.0]]), device="cpu")


@pytest.mark.parametrize("call", ["fit", "bayes_opt"])
def test_gp_runs_without_a_working_directory(call, tmp_path):
    """The fit's Adam needs no working directory, as optax does not
    (``torch.optim``'s constructor imports ``torch._dynamo``, whose config
    reads it): the port's call in a removed directory matches mlmc_tpu's."""
    from mlmc_tpu import gp as jgp

    if call == "fit":
        X, y = _data(noise=0.05)
        gj = jgp.GP("rbf", 1e-4).fit(X, y, n_steps=60)
        with removed_working_directory(tmp_path):
            gt = mt.GP("rbf", 1e-4, device="cpu").fit(X, y, n_steps=60)
        np.testing.assert_allclose(gt.nll_trace, gj.nll_trace, rtol=NLL_RTOL)
        Xs = np.random.default_rng(5).uniform(0, 2, size=(9, 2))
        for a, b in zip(gt.predict(Xs), gj.predict(Xs)):
            np.testing.assert_allclose(a, b, rtol=PRED_RTOL)
        return
    key = jax.random.key(0)
    rj = jgp.bayes_opt(_branin, BRANIN_BOUNDS, key=key, **BAYES_OPT)
    run = _bayes_opt_torch(key)
    with removed_working_directory(tmp_path):
        rt = run()
    np.testing.assert_array_equal(rt["X"], np.asarray(rj["X"]))
    np.testing.assert_array_equal(rt["y"], np.asarray(rj["y"]))
    np.testing.assert_allclose(rt["ei_trace"], np.asarray(rj["ei_trace"]), rtol=PRED_RTOL)
    assert rt["y_best"] == float(rj["y_best"])


def test_validation():
    X, y = _data()
    with pytest.raises(RuntimeError, match="fit"):
        mt.GP(device="cpu").predict(X)
    with pytest.raises(ValueError, match="X \\[n, d\\]"):
        mt.GP(device="cpu").fit(X, y[:3])
    with pytest.raises(ValueError, match="offset"):
        mt.GP(device="cpu").fit(X, y, offset=y[:3])
