"""mlmc_tpu_torch.rare against mlmc_tpu's, on the CPU in float64.

Subset simulation replays JAX's draws: ``mlmc_tpu.subset_simulation``
splits its key into (k_init, k_run); stage s folds s into k_run and splits
it into the resampling key (one uniform per island) and one key per
conditional pCN sweep; the final refresh is stage ``max_stages + 1``. The
cross-entropy method draws stage s from ``fold_in(key, s)`` (the final
stage s = 10000). ``_JaxDraws`` / ``_JaxCE`` hand those to the port
through ``draws=``. The ladder (thresholds, which islands finish when)
and every accept decision must then be equal, so probabilities, errors,
the conditional population and its QoI agree to 1e-10.
"""
from math import erfc, sqrt

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import mlmc_tpu_torch as mt

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
I = 8


class _JaxDraws:
    def __init__(self, key, N, d, n_moves):
        self.k_init, self.k_run = jax.random.split(key)
        self.N, self.d, self.n_moves = N, d, n_moves

    def init(self):
        return torch.tensor(np.asarray(jax.random.normal(self.k_init, (self.N, self.d))))

    def __call__(self, path):
        k_r, k_m = jax.random.split(jax.random.fold_in(self.k_run, path[0]))
        if len(path) == 1:
            u = np.asarray(jax.random.uniform(k_r, (I, 1), jnp.float64))
            return None, torch.tensor(np.repeat(u, self.N // I, axis=1).reshape(-1)), None
        kk = jax.random.split(k_m, self.n_moves)[path[1]]
        xi = jax.random.normal(kk, (I, self.N // I, self.d))
        return torch.tensor(np.asarray(xi).reshape(self.N, self.d)), None, None


class _JaxCE:
    def __init__(self, key, d):
        self.key, self.d = key, d

    def __call__(self, s, n):
        return torch.tensor(np.asarray(jax.random.normal(jax.random.fold_in(self.key, s),
                                                         (n, self.d))))


@pytest.mark.parametrize("gamma,d", [(3.0, 2), (0.0, 3)])
def test_subset_simulation_replays_mlmc_tpu(gamma, d):
    from mlmc_tpu.rare import subset_simulation

    key, N, n_moves = jax.random.key(1), 512, 3
    rj = subset_simulation(lambda th: th[0], gamma, d, n_particles=N, n_moves=n_moves,
                           key=key, qoi_fn=lambda th: th)
    rt = mt.subset_simulation(lambda th: th[:, 0], gamma, d, n_particles=N,
                              n_moves=n_moves, qoi_fn=lambda th: th, device="cpu",
                              draws=_JaxDraws(key, N, d, n_moves))
    assert rt["n_stages"] == rj["n_stages"] and rt["n_forward"] == rj["n_forward"]
    np.testing.assert_allclose(rt["thresholds"], rj["thresholds"], rtol=1e-12)
    for k in ("p", "log_p", "log_p_se", "p_lo", "p_hi", "beta", "acc_rates",
              "cond_qoi", "cond_qoi_se"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, atol=1e-14, err_msg=k)
    np.testing.assert_allclose(rt["theta"], rj["theta"], rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("tilt", ["mean", "full"])
def test_cross_entropy_is_replays_mlmc_tpu(tilt):
    from mlmc_tpu.rare import cross_entropy_is

    w = np.array([1.0, 2.0, -1.0, 0.5])
    w = w / np.linalg.norm(w)
    wj, wt = jnp.asarray(w), torch.tensor(w)
    key = jax.random.key(0)
    rj = cross_entropy_is(lambda th: wj @ th, 4.5, d=4, key=key, tilt=tilt,
                          n_per_stage=1024, n_final=4096, qoi_fn=lambda th: th)
    rt = mt.cross_entropy_is(lambda th: th @ wt, 4.5, d=4, tilt=tilt, n_per_stage=1024,
                             n_final=4096, qoi_fn=lambda th: th, device="cpu",
                             draws=_JaxCE(key, 4))
    np.testing.assert_allclose(rt["thresholds"], rj["thresholds"], rtol=1e-12)
    for k in ("p", "log_p", "p_se", "weight_ess", "mu", "sigma", "cond_qoi"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, atol=1e-14, err_msg=k)
    assert rt["n_forward"] == rj["n_forward"]


def test_keyed_gaussian_tail_and_cross_entropy():
    """The port's keyed draws: Phi(-4) by subset simulation within 6
    island se in log p, and by cross-entropy IS within 5 se."""
    out = mt.subset_simulation(lambda th: th[:, 0], 4.0, 3, n_particles=1024,
                               n_moves=6, seed=2, device="cpu")
    assert abs(out["log_p"] - np.log(stats.norm.sf(4.0))) < 6 * out["log_p_se"] + 0.05
    assert out["thresholds"][-1] == 4.0 and out["n_stages"] >= 4
    assert np.all(out["theta"][:, 0] > 4.0)
    ce = mt.cross_entropy_is(lambda th: th[:, 0], 4.0, 3, seed=3, device="cpu")
    assert abs(ce["p"] - 0.5 * erfc(4.0 / sqrt(2.0))) < 5 * ce["p_se"]


def test_validation():
    g = lambda th: th[:, 0]
    with pytest.raises(ValueError, match="divisible"):
        mt.subset_simulation(g, 1.0, 2, n_particles=100, device="cpu")
    with pytest.raises(ValueError, match="p0"):
        mt.subset_simulation(g, 1.0, 2, p0=1.5, device="cpu")
    with pytest.raises(RuntimeError, match="ladder"):
        mt.subset_simulation(lambda th: torch.tanh(th[:, 0]), 2.0, 2, n_particles=512,
                             max_stages=8, device="cpu")
    with pytest.raises(RuntimeError, match="ties"):
        mt.subset_simulation(lambda th: torch.clamp(th[:, 0], max=1.0), 1.0, 2,
                             n_particles=512, device="cpu")
    with pytest.raises(ValueError, match="rho"):
        mt.cross_entropy_is(g, 1.0, 2, rho=2.0, device="cpu")
    with pytest.raises(ValueError, match="tilt"):
        mt.cross_entropy_is(g, 1.0, 2, tilt="diag", device="cpu")
