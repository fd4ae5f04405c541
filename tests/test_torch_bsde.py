"""mlmc_tpu_torch.bsde against mlmc_tpu's.

JAX's forward normals (``split(key, n_steps)``, one ``normal(kk, (B,))``
per step) are replayed into the port's ``_solve``: ``y0``, ``z0`` and
their standard errors agree to 1e-10 relative (f64) for the linear
Black-Scholes measure-change driver and for the manufactured nonlinear
driver. The port's keyed run meets both closed forms.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmc_tpu_torch import bsde as tb
from mlmc_tpu_torch.sim import sde as tsde

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

MU, R, SIG, T = 0.15, 0.05, 0.2, 1.0
ALPHA, C, X0 = 0.4, 0.5, 0.8


def _problems(name):
    """(jax model, terminal, driver), (torch ...), the closed form."""
    import mlmc_tpu.sim.sde as jsde

    if name == "black_scholes":
        lam = (MU - R) / SIG
        return ((jsde.gbm(MU, SIG, 1.0), lambda x: jnp.maximum(x - 1.0, 0.0),
                 lambda t, x, y, z: -R * y - lam * z),
                (tsde.gbm(MU, SIG, 1.0), lambda x: torch.clamp(x - 1.0, min=0.0),
                 lambda t, x, y, z: -R * y - lam * z),
                tsde.black_scholes_call(1.0, 1.0, R, SIG, T), 5, None)
    u_j = lambda t, x: jnp.exp(ALPHA * (T - t)) * jnp.sin(x)
    u_t = lambda t, x: torch.exp(ALPHA * (T - t)) * torch.sin(x)
    jm = jsde.SDEModel(drift=lambda x, t: jnp.zeros_like(x),
                       diffusion=lambda x, t: jnp.ones_like(x), s0=X0)
    tm = tsde.SDEModel(drift=lambda x, t: torch.zeros_like(x),
                       diffusion=lambda x, t: torch.ones_like(x), s0=X0)
    return ((jm, jnp.sin, lambda t, x, y, z: (ALPHA + 0.5) * y + C * (y ** 2 - u_j(t, x) ** 2)),
            (tm, torch.sin, lambda t, x, y, z: (ALPHA + 0.5) * y
             + C * (y ** 2 - u_t(t, x) ** 2)),
            float(np.exp(ALPHA * T) * np.sin(X0)), 6, 1.0)


@pytest.mark.parametrize("name", ["black_scholes", "nonlinear"])
@pytest.mark.parametrize("n_steps", [1, 8])
def test_solve_bsde_matches_mlmc_tpu_on_its_normals(name, n_steps):
    from mlmc_tpu.bsde import solve_bsde

    (jm, jg, jf), (tm, tg, tf), _, degree, scale = _problems(name)
    B, key = 512, jax.random.key(3)
    res_j = solve_bsde(jm, jg, jf, T, n_steps, n_paths=B, degree=degree, scale=scale,
                       key=key, dtype=jnp.float64)
    z = np.stack([np.asarray(jax.random.normal(k, (B,), jnp.float64))
                  for k in jax.random.split(key, n_steps)], axis=1)
    y0, z0, var0, varz = tb._solve(tm, tg, tf, T, n_steps, torch.tensor(z), degree, scale, 3)
    np.testing.assert_allclose(float(y0), res_j["y0"], rtol=1e-10)
    np.testing.assert_allclose(float(z0), res_j["z0"], rtol=1e-10)
    np.testing.assert_allclose(np.sqrt(float(var0) / B), res_j["y0_se"], rtol=1e-9)
    np.testing.assert_allclose(np.sqrt(float(varz) / B), res_j["z0_se"], rtol=1e-9)


@pytest.mark.parametrize("name", ["black_scholes", "nonlinear"])
def test_keyed_solve_meets_the_closed_form(name):
    _, (tm, tg, tf), exact, degree, scale = _problems(name)
    out = tb.solve_bsde(tm, tg, tf, T, 16, n_paths=1 << 13, degree=degree, scale=scale,
                        seed=2, dtype=torch.float64, device="cpu")
    assert abs(out["y0"] - exact) < 6 * out["y0_se"] + 5e-3
    assert out["y0_se"] > 0 and out["z0_se"] > 0
    with pytest.raises(ValueError, match="picard"):
        tb.solve_bsde(tm, tg, tf, T, 4, picard=0, device="cpu")
