"""mlmc_tpu_torch.random.frac_geom against mlmc_tpu.random.frac_geom.

The port's networks are functions of explicit draws; the tests take the
draws from JAX's keys exactly as mlmc_tpu's functions split and draw them
(``k_c, k_l, k_a = split(key, 3)``, and for a fractured sample ``k_field,
k_frac = split(key)``) and hand them over, f64 on both sides.

Tolerances: segments and discs 1e-15 (the same float operations on the same
draws); 2-D and 3-D fracture indicators EQUAL, including cells whose
centers lie exactly at the threshold distance h/2 (the case of
``tests/test_diffusion3d.py:178``); conductivities 1e-12; fractured fluxes
(2-D circulant and RFF routes, 3-D) 1e-8 at ``cg_tol=1e-12``, solved
under the spectral preconditioner (mlmc_tpu compiles a multigrid solve for
a minute; the port's multigrid solves are held against mlmc_tpu's in
``test_torch_diffusion.py`` and ``test_torch_diffusion3d.py``).
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.random import frac_geom as tf

torch.set_num_threads(1)

F = 12


def _jf():
    from mlmc_tpu.random import frac_geom
    return frac_geom


def _np(x):
    return torch.tensor(np.asarray(x))


def _jax_draws_2d(key, concentration=0.0):
    import jax

    k_c, k_l, k_a = jax.random.split(key, 3)
    angle = (jax.random.normal(k_a, (F,)) if concentration > 0
             else jax.random.uniform(k_a, (F,)))
    return tf.FractureDraws(_np(jax.random.uniform(k_c, (F, 2))),
                            _np(jax.random.uniform(k_l, (F,))), _np(angle))


def _jax_draws_3d(key):
    import jax

    k_c, k_r, k_n = jax.random.split(key, 3)
    return tf.FractureDraws(_np(jax.random.uniform(k_c, (F, 3))),
                            _np(jax.random.uniform(k_r, (F,))),
                            _np(jax.random.normal(k_n, (F, 3))))


@pytest.mark.parametrize("kw", [dict(), dict(concentration=4.0, mean_angle=0.7),
                                dict(size_range=(0.05, 0.9), power=2.5,
                                     box=((0.0, -1.0), (2.0, 1.0)))])
def test_2d_network_from_the_same_draws(kw):
    import jax

    jf = _jf()
    for seed in range(3):
        key = jax.random.key(seed)
        got = tf.sample_fracture_network(_jax_draws_2d(key, kw.get("concentration", 0.0)),
                                         F, **kw)
        want = np.asarray(jf.sample_fracture_network(key, F, **kw))
        assert got.shape == (F, 2, 2)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("kw", [dict(), dict(mean_normal=(0.0, 1.0, 1.0), concentration=9.0),
                                dict(size_range=(0.2, 0.4), power=1.5)])
def test_3d_network_from_the_same_draws(kw):
    import jax

    jf = _jf()
    for seed in range(3):
        key = jax.random.key(seed)
        got = tf.sample_fracture_network_3d(_jax_draws_3d(key), F, **kw)
        want = jf.sample_fracture_network_3d(key, F, **kw)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-15, atol=1e-15)
        np.testing.assert_allclose(got[1].norm(dim=1).numpy(), 1.0, rtol=1e-15)


@pytest.mark.parametrize("n", [8, 16, 64])
def test_2d_indicator_equal(n):
    import jax

    jf = _jf()
    keys = jax.random.split(jax.random.key(n), 4)
    segs = [jf.sample_fracture_network(k, F) for k in keys]
    batch = tf.fracture_indicator(torch.stack([_np(s) for s in segs]), n)
    assert batch.shape == (4, n, n)
    for b, s in enumerate(segs):
        want = np.asarray(jf.fracture_indicator(s, n))
        assert np.array_equal(tf.fracture_indicator(_np(s), n).numpy(), want)
        assert np.array_equal(batch[b].numpy(), want)
        assert 0 < want.sum() < n * n
    wide = tf.fracture_indicator(_np(segs[0]), n, aperture=0.2).numpy()
    assert np.array_equal(wide, np.asarray(jf.fracture_indicator(segs[0], n, aperture=0.2)))
    dist = tf.fracture_min_distance(_np(segs[0]), torch.tensor([[0.5, 0.5], [0.1, 0.9]],
                                                               dtype=torch.float64))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jf.fracture_min_distance(
        segs[0], np.array([[0.5, 0.5], [0.1, 0.9]]))), rtol=1e-15)


@pytest.mark.parametrize("n", [8, 16])
def test_3d_indicator_equal(n):
    import jax

    jf = _jf()
    keys = jax.random.split(jax.random.key(100 + n), 3)
    discs = [jf.sample_fracture_network_3d(k, F) for k in keys]
    batch = tf.fracture_indicator_3d(tuple(torch.stack([_np(d[i]) for d in discs])
                                           for i in range(3)), n)
    assert batch.shape == (3, n, n, n)
    for b, d in enumerate(discs):
        want = np.asarray(jf.fracture_indicator_3d(d, n))
        assert np.array_equal(tf.fracture_indicator_3d(tuple(_np(x) for x in d), n).numpy(),
                              want)
        assert np.array_equal(batch[b].numpy(), want)
        assert 0 < want.sum() < n ** 3


def test_indicators_at_the_threshold_equal():
    """Cell centers exactly h/2 from a fracture: both packages flag them."""
    import jax.numpy as jnp

    jf = _jf()
    discs = (jnp.array([[0.5, 0.5, 0.5]]), jnp.array([[0.0, 0.0, 1.0]]), jnp.array([0.3]))
    want = np.asarray(jf.fracture_indicator_3d(discs, 8))
    got = tf.fracture_indicator_3d(tuple(_np(x) for x in discs), 8).numpy()
    assert np.array_equal(got, want)
    on = got.sum(axis=(0, 1))
    assert on[3] > 0 and on[4] > 0 and on[[0, 1, 2, 5, 6, 7]].sum() == 0
    # 2-D: a horizontal segment on y = 0.5 flags the two rows at distance h/2
    seg = jnp.array([[[0.2, 0.5], [0.8, 0.5]]])
    want = np.asarray(jf.fracture_indicator(seg, 8))
    got = tf.fracture_indicator(_np(seg), 8).numpy()
    assert np.array_equal(got, want)
    assert got[:, 3].sum() > 0 and got[:, 4].sum() > 0 and got[:, :3].sum() == 0


def test_indicators_in_chunks_of_samples(monkeypatch):
    gen = torch.Generator().manual_seed(0)
    segs = tf.sample_fracture_network(tf.fracture_draws(gen, F, 2, batch=5,
                                                        dtype=torch.float64), F)
    discs = tf.sample_fracture_network_3d(tf.fracture_draws(gen, F, 3, batch=(5,),
                                                            dtype=torch.float64), F)
    whole = (tf.fracture_indicator(segs, 16), tf.fracture_indicator_3d(discs, 8))
    monkeypatch.setattr(tf, "INDICATOR_CHUNK_ELEMENTS", 1)   # one sample per chunk
    assert torch.equal(tf.fracture_indicator(segs, 16), whole[0])
    assert torch.equal(tf.fracture_indicator_3d(discs, 8), whole[1])


def test_fracture_conductivity_matches_mlmc_tpu():
    import jax

    jf = _jf()
    key = jax.random.key(5)
    seg = jf.sample_fracture_network(key, F)
    disc = jf.sample_fracture_network_3d(key, F)
    bulk2 = np.random.default_rng(0).lognormal(size=(16, 16))
    bulk3 = np.random.default_rng(1).lognormal(size=(8, 8, 8))
    np.testing.assert_allclose(
        tf.fracture_conductivity(_np(seg), 16, torch.tensor(bulk2), 1e3).numpy(),
        np.asarray(jf.fracture_conductivity(seg, 16, bulk2, 1e3)), rtol=1e-12)
    np.testing.assert_allclose(
        tf.fracture_conductivity_3d(tuple(_np(x) for x in disc), 8, torch.tensor(bulk3),
                                    1e3).numpy(),
        np.asarray(jf.fracture_conductivity_3d(disc, 8, bulk3, 1e3)), rtol=1e-12)


@pytest.mark.parametrize("method", ["circulant", "rff"])
def test_fractured_2d_flux_from_the_same_key(method):
    """mlmc_tpu's ``_calculate_one(config, key)`` against the port's
    ``_calculate`` on the draws that key gives: one network per sample,
    rasterized at both grids (RFF) or point-sampled with the fine K
    (circulant)."""
    import jax

    jf = _jf()
    JF = jf.FracturedDiffusionSimulation
    jcfg = JF(dict(sigma=1.0, corr_length=0.3, field_method=method, n_modes=32,
                   n_fractures=F, cg_tol=1e-12, precond="spectral")
              ).level_instance([1 / 16], [1 / 8]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    keys = jax.random.split(jax.random.key(7), 2)
    j_one = jax.jit(lambda k: JF._calculate_one(jcfg, k))
    draws, nets, want = [], [], []
    for k in keys:
        k_field, k_frac = jax.random.split(k)
        if method == "circulant":
            kr, ki = jax.random.split(k_field)
            shape = jcfg["_circ_eig"].shape
            draws.append(np.stack([np.asarray(jax.random.normal(kr, shape)),
                                   np.asarray(jax.random.normal(ki, shape))]))
        else:
            draws.append(np.asarray(jax.random.uniform(k_field, (32,), maxval=2 * np.pi)))
        nets.append(np.asarray(jf.sample_fracture_network(k_frac, F, size_range=(0.1, 0.5))))
        f, c = j_one(k)
        want.append([float(f[0]), float(c[0])])
    draws, want = torch.tensor(np.stack(draws)), np.asarray(want)
    field = (dict(noise=(draws[:, 0], draws[:, 1])) if method == "circulant"
             else dict(phases=draws))
    fine, coarse, it_f, it_c = tf.FracturedDiffusionSimulation._calculate(
        tcfg, network=torch.tensor(np.stack(nets)), **field)
    np.testing.assert_allclose(fine[:, 0].numpy(), want[:, 0], rtol=1e-8)
    np.testing.assert_allclose(coarse[:, 0].numpy(), want[:, 1], rtol=1e-8)
    assert int(it_f.max()) > 1


def test_fractured_3d_flux_from_the_same_key():
    import jax

    jf = _jf()
    JF = jf.FracturedDiffusionSimulation3D
    jcfg = JF(dict(sigma=0.5, corr_length=0.4, n_modes=16, n_fractures=F,
                   cg_tol=1e-12, precond="spectral")).level_instance([1 / 8], [1 / 4]).config_dict
    tcfg = mt.level_config_from_jax(jcfg, device="cpu", dtype="float64")
    keys = jax.random.split(jax.random.key(8), 2)
    j_one = jax.jit(lambda k: JF._calculate_one(jcfg, k))
    phases, nets, want = [], [], []
    for k in keys:
        k_field, k_frac = jax.random.split(k)
        phases.append(np.asarray(jax.random.uniform(k_field, (16,), maxval=2 * np.pi)))
        nets.append(jf.sample_fracture_network_3d(k_frac, F, size_range=(0.15, 0.6)))
        f, c = j_one(k)
        want.append([float(f[0]), float(c[0])])
    want = np.asarray(want)
    network = tuple(torch.stack([_np(n[i]) for n in nets]) for i in range(3))
    fine, coarse, _, _ = tf.FracturedDiffusionSimulation3D._calculate(
        tcfg, phases=torch.tensor(np.stack(phases)), network=network)
    np.testing.assert_allclose(fine[:, 0].numpy(), want[:, 0], rtol=1e-8)
    np.testing.assert_allclose(coarse[:, 0].numpy(), want[:, 1], rtol=1e-8)


@pytest.mark.parametrize("cls", [tf.FracturedDiffusionSimulation,
                                 tf.FracturedDiffusionSimulation3D])
def test_batches_from_generator_and_from_keys(cls):
    """Both draw routes give finite coupled fluxes above the bulk; a keyed
    batch is a function of the sample identity; the fracture draws take
    Philox calls of their own."""
    three = cls is tf.FracturedDiffusionSimulation3D
    sim = cls(dict(sigma=0.5, corr_length=0.4, n_fractures=F, frac_contrast=1e3,
                   n_modes=32, dtype="float64",
                   **({} if three else dict(field_method="circulant"))))
    cfg = sim.level_instance([1 / 8], [1 / 4]).config_dict
    fine, coarse, failed = cls.calculate_batch(cfg, torch.Generator().manual_seed(1), 4,
                                               device="cpu")
    assert fine.shape == coarse.shape == (4, 1) and not failed.any()
    assert torch.isfinite(fine).all() and bool((fine > 0.5).all())
    again = cls.calculate_batch(cfg, torch.Generator().manual_seed(1), 4)
    assert torch.equal(again[0], fine)
    idx, att = torch.arange(5), torch.zeros(5, dtype=torch.int64)
    keyed = cls.calculate_keyed_batch(cfg, 3, 1, idx, att)
    part = cls.calculate_keyed_batch(cfg, 3, 1, idx[2:], att[2:])
    np.testing.assert_allclose(part[0].numpy(), keyed[0][2:].numpy(), rtol=1e-12)
    one = cls.calculate(cfg, 9, device="cpu")
    assert one[0].shape == (1,) and np.isfinite(one[1]).all()
    d = tf.keyed_fracture_draws(3, 1, idx, att, F, 3 if three else 2)
    field = mt.random.keyed.keyed_uniforms(3, 1, idx, att, F * 3)
    assert not torch.equal(d.centers.reshape(5, -1)[:, :F * 3 if three else F * 2],
                           field[:, :F * 3 if three else F * 2])
    assert bool((d.centers >= 0).all() and (d.centers < 1).all())


def test_fractured_conductivity_has_no_phase_parametrization():
    cfg = tf.FracturedDiffusionSimulation3D(dict(n_fractures=F, n_modes=16)
                                            ).level_instance([1 / 8], [1 / 4]).config_dict
    with pytest.raises(ValueError, match="QMC"):
        tf.FracturedDiffusionSimulation3D._conductivity(cfg, 8, phases=torch.zeros(1, 16))
    cfg2 = tf.FracturedDiffusionSimulation(dict(n_fractures=F, n_modes=16)
                                           ).level_instance([1 / 8], [1 / 4]).config_dict
    with pytest.raises(ValueError, match="QMC"):
        tf.FracturedDiffusionSimulation._conductivity(cfg2, 8, phases=torch.zeros(1, 16))
    with pytest.raises(ValueError, match="fractures"):
        tf.sample_fracture_network(tf.fracture_draws(torch.Generator(), 3), 4)
    assert tf.FracturedDiffusionSimulation.PRECOND == _jf().FracturedDiffusionSimulation.PRECOND
    assert tf.FracturedDiffusionSimulation3D.CG_MAXITER_FACTOR == 32


def test_make_frac_mesh_stays_descoped():
    with pytest.raises(ImportError, match="geomop"):
        tf.make_frac_mesh(((0, 0), (1, 1)), 0.1, [], 0.05)
    with pytest.raises(ImportError, match="geomop"):
        _jf().make_frac_mesh(((0, 0), (1, 1)), 0.1, [], 0.05)
