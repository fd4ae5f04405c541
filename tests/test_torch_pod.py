"""mlmc_tpu_torch.pod against mlmc_tpu's, on the CPU in float64.

Same field, same samples: the port takes the JAX level config's wave
vectors (``wave_vectors=``) and JAX's RFF phases of each identity
(``phases=``: sample (seed, 0, i) is ``fold_in(key(seed), i)``'s
``uniform(.., maxval=2 pi)``, as ``DiffusionSimulation._conductivity``
draws it). The CG runs to 1e-12 in both packages. Snapshot energies, the
reduced and the full flux then agree to 1e-10; a JAX surrogate carried
over by ``convert.pod_from_jax`` (its own basis) evaluates to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import convert
from mlmc_tpu_torch.random.keyed import SampleKeys

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
CFG = dict(sigma=1.0, corr_length=0.3, n_modes=16)


def _jax_keys(keys):
    root = jax.random.key(keys.seed)
    return jax.vmap(lambda i: jax.random.fold_in(root, i))(
        jnp.asarray(keys.indices.numpy(), jnp.uint32))


def _jax_phases(M):
    def phases(keys):
        u = jax.vmap(lambda k: jax.random.uniform(k, (M,), maxval=2 * np.pi))(_jax_keys(keys))
        return torch.tensor(np.asarray(u))
    return phases


@pytest.fixture(scope="module")
def pods():
    from mlmc_tpu.pod import pod_darcy_surrogate
    from mlmc_tpu.sim.diffusion import DiffusionSimulation as JaxDiffusion

    mp = pytest.MonkeyPatch()
    for cls in (JaxDiffusion, mt.DiffusionSimulation):
        mp.setattr(cls, "CG_TOL", 1e-12)
    pj = pod_darcy_surrogate(CFG, n=8, rank=6, n_snapshots=16, seed=3)
    cfg_j = convert._closure(convert._closure(pj["model"])["reduced_flux"])["cfg"]
    pt = mt.pod_darcy_surrogate(CFG, n=8, rank=6, n_snapshots=16, seed=3, device="cpu",
                                phases=_jax_phases(16),
                                wave_vectors=np.asarray(cfg_j["_wave_vectors"]))
    yield pj, pt
    mp.undo()


def test_pod_replays_mlmc_tpu(pods):
    pj, pt = pods
    assert pt["rank"] == pj["rank"] == 6
    np.testing.assert_allclose(pt["energy"], pj["energy"], rtol=RTOL)
    keys = SampleKeys(7, 0, torch.arange(24))
    for name in ("model", "full_model"):
        want = np.asarray(jax.jit(pj[name])(_jax_keys(keys)))
        np.testing.assert_allclose(pt[name](keys).numpy(), want, rtol=RTOL, err_msg=name)


def test_pod_from_jax_evaluates_jax_surrogate(pods):
    pj, _ = pods
    carried = convert.pod_from_jax(pj, device="cpu", phases=_jax_phases(16))
    keys = SampleKeys(11, 0, torch.arange(40))
    want = np.asarray(jax.jit(pj["model"])(_jax_keys(keys)))
    np.testing.assert_allclose(carried["model"](keys).numpy(), want, rtol=1e-12)
    np.testing.assert_allclose(carried["energy"], pj["energy"])


def test_pod_keyed_reproduction_quality_and_chunks(monkeypatch):
    """The port's keyed phases at n = 32, rank 24, 64 snapshots
    (``tests/test_pod.py``'s size): 99% energy at the rank and rho > 0.97
    on 256 held-out identities; chunking does not change the values."""
    from mlmc_tpu_torch import pod

    monkeypatch.setattr(pod, "CHUNK", 100)
    out = mt.pod_darcy_surrogate(dict(sigma=1.0, corr_length=0.3), n=32, rank=24,
                                 n_snapshots=64, device="cpu")
    assert out["energy"][out["rank"] - 1] > 0.99
    keys = SampleKeys(7, 0, torch.arange(256))
    red, full = out["model"](keys).numpy(), out["full_model"](keys).numpy()
    assert np.corrcoef(red, full)[0, 1] > 0.97
    monkeypatch.setattr(pod, "CHUNK", 2048)
    np.testing.assert_allclose(out["model"](keys).numpy(), red, rtol=1e-13)
