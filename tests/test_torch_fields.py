"""mlmc_tpu_torch.random (correlated fields, keyed streams) against mlmc_tpu.

The two packages' random streams differ by design, so the draws are made
once, as the JAX generator makes them (``kr, ki = split(key)``, then
``normal(kr, shape)``) or with numpy where it takes them as an argument,
and handed to both; f64 on both sides. Tolerances: circulant eigenvalues
1e-12, samples from the same draws 1e-10, ``cov_matrix`` 1e-12, the
factor product ``L L^T`` of ``svd_dcmp`` 1e-9 with the same term count.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.random import correlated_field as tcf
from mlmc_tpu_torch.random.keyed import (
    WIDE, keyed_normals, keyed_uniforms, keyed_words)

torch.set_num_threads(1)


def _jcf():
    import mlmc_tpu.random.correlated_field as jcf
    return jcf


def _points(n, seed=0, dim=2):
    return np.random.default_rng(seed).uniform(0.0, 5.0, size=(n, dim))


@pytest.mark.parametrize("corr_exp", ["gauss", "exp"])
@pytest.mark.parametrize("shape,step", [((8, 8), 0.125), ((6, 10), (0.2, 0.1))])
def test_circulant_eigenvalues_match(corr_exp, shape, step):
    kw = dict(corr_exp=corr_exp, dim=2, corr_length=0.3, grid_shape=shape,
              grid_step=step)
    jf = _jcf().CirculantEmbeddingField(**kw)
    tf = tcf.CirculantEmbeddingField(device="cpu", **kw)
    np.testing.assert_allclose(tf._eig.numpy(), np.asarray(jf._eig),
                               rtol=1e-12, atol=1e-12)
    assert tf._emb_shape == jf._emb_shape
    assert tf._neg_fraction == pytest.approx(jf._neg_fraction, abs=1e-15)


@pytest.mark.parametrize("branch", ["fftn", "matmul_dft"])
def test_circulant_sample_from_same_noise(branch, monkeypatch):
    """The port's fftn sample equals both of mlmc_tpu's branches (fftn and
    the six-matmul DFT) on the same white noise, 1e-10."""
    import jax

    jcf = _jcf()
    kw = dict(corr_exp="gauss", dim=2, corr_length=0.3, grid_shape=(8, 8),
              grid_step=0.125, sigma=1.7, mu=0.3)
    jf = jcf.CirculantEmbeddingField(**kw)
    if branch == "fftn":
        monkeypatch.setattr(jcf.CirculantEmbeddingField, "DFT_MATMUL_MAX_EMB", 0)
    key = jax.random.key(5)
    kr, ki = jax.random.split(key)
    wr = np.asarray(jax.random.normal(kr, jf._emb_shape))
    wi = np.asarray(jax.random.normal(ki, jf._emb_shape))
    want = np.asarray(jf.sample(key))
    tf = tcf.CirculantEmbeddingField(device="cpu", **kw)
    got = tf._finish(tf._sample_from(torch.tensor(wr), torch.tensor(wi)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("corr_exp", ["gauss", "exp"])
def test_spectral_sample_from_carried_modes(corr_exp):
    """Wave vectors carried over, phases drawn as mlmc_tpu draws them."""
    import jax

    kw = dict(corr_exp=corr_exp, dim=2, corr_length=1.5, mode_no=64)
    jf = _jcf().SpectralCorrelatedField(seed=3, log=True, **kw)
    pts = _points(20)
    jf.set_points(pts)
    key = jax.random.key(8)
    phases = np.asarray(jax.random.uniform(key, (64,), maxval=2 * np.pi))
    tf = tcf.SpectralCorrelatedField(seed=3, log=True, device="cpu", **kw)
    tf._wave_vectors = torch.tensor(np.asarray(jf._wave_vectors, np.float64))
    tf.set_points(pts)
    got = tf._finish(tf._sample_from(torch.tensor(phases)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.sample(key)),
                               rtol=1e-10, atol=1e-10)


def test_spectral_wave_vectors_follow_the_spectral_measure():
    """gauss: k ~ N(0, 2/L^2 I), checked on the second moment (5 sigma)."""
    L, M = 0.7, 20000
    tf = tcf.SpectralCorrelatedField(corr_exp="gauss", dim=2, corr_length=L,
                                     mode_no=M, seed=1, device="cpu")
    k = tf._wave_vectors.numpy()
    var = 2.0 / L ** 2
    assert abs(k.var() - var) < 5 * var * np.sqrt(2.0 / (2 * M))
    assert abs(k.mean()) < 5 * np.sqrt(var / (2 * M))


@pytest.mark.parametrize("corr_exp", ["gauss", "exp", 1.5])
def test_cov_matrix_and_svd_factor_match(corr_exp):
    kw = dict(corr_exp=corr_exp, dim=2, corr_length=2.0)
    pts = _points(30, seed=2)
    jf = _jcf().SpatialCorrelatedField(**kw)
    tf = tcf.SpatialCorrelatedField(device="cpu", **kw)
    jf.set_points(pts)
    tf.set_points(pts)
    np.testing.assert_allclose(tf.cov_matrix(), jf.cov_matrix(), rtol=1e-12, atol=1e-12)
    jL, js = jf.svd_dcmp(precision=0.01)
    tL, ts = tf.svd_dcmp(precision=0.01)
    assert tf.n_approx_terms == jf.n_approx_terms
    np.testing.assert_allclose(ts, js, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(tL @ tL.T, jL @ jL.T, rtol=1e-9, atol=1e-9)


def test_svd_lowrank_branch_approximates_the_covariance():
    """Fewer than half the terms: the randomized range finder; its factor
    reproduces the covariance to the truncated tail, and repeats under one
    ``random_state``."""
    pts = _points(60, seed=4)
    tf = tcf.SpatialCorrelatedField(corr_exp="gauss", dim=2, corr_length=3.0,
                                    device="cpu")
    tf.set_points(pts)
    L1, s1 = tf.svd_dcmp(precision=1e-6, n_terms_range=(1, 20), random_state=7)
    L2, _ = tf.svd_dcmp(precision=1e-6, n_terms_range=(1, 20), random_state=7)
    np.testing.assert_array_equal(L1, L2)
    exact = np.linalg.svd(tf.cov_mat, compute_uv=False)
    np.testing.assert_allclose(s1 ** 2, exact[:len(s1)], rtol=1e-6)
    assert np.abs(L1 @ L1.T - tf.cov_mat).max() < 10 * exact[len(s1):].sum() + 1e-8


def test_field_from_jax_carries_the_decomposition():
    """Same normals -> same realization through the carried factor."""
    import jax

    jf = _jcf().SpatialCorrelatedField(corr_exp="exp", dim=2, corr_length=1.0,
                                       sigma=2.0, mu=0.5, log=True)
    jf.set_points(_points(25, seed=6))
    jf.svd_dcmp(precision=0.05)
    tf = mt.field_from_jax(jf, device="cpu")
    assert tf.n_approx_terms == jf.n_approx_terms
    key = jax.random.key(2)
    z = np.asarray(jax.random.normal(key, (jf.n_approx_terms,)))
    got = tf._finish(tf._sample_from(torch.tensor(z)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jf.sample(key)),
                               rtol=1e-10, atol=1e-12)
    with pytest.raises(TypeError, match="no decomposition"):
        mt.field_from_jax(object(), device="cpu")


def test_sample_is_a_function_of_the_generator():
    tf = tcf.CirculantEmbeddingField(corr_exp="gauss", dim=2, corr_length=0.3,
                                     grid_shape=(8, 8), grid_step=0.125,
                                     device="cpu")
    a = tf.sample(torch.Generator().manual_seed(4))
    b = tf.sample(torch.Generator().manual_seed(4))
    c = tf.sample(torch.Generator().manual_seed(5))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert tf.sample_grid().shape == (8, 8)
    with pytest.raises(ValueError, match="regular grid"):
        tf.set_points(np.zeros((3, 2)))


def test_circulant_covariance_is_exact():
    """Sample covariance of 2000 fields at a few lags within 5 sigma of
    exp(-(r/L)^2)."""
    L, n, h = 0.3, 16, 1.0 / 16
    tf = tcf.CirculantEmbeddingField(corr_exp="gauss", dim=2, corr_length=L,
                                     grid_shape=(n, n), grid_step=h, device="cpu")
    gen = torch.Generator().manual_seed(0)
    N = 2000
    wr = torch.randn((N, 2 * n, 2 * n), generator=gen, dtype=torch.float64)
    wi = torch.randn((N, 2 * n, 2 * n), generator=gen, dtype=torch.float64)
    g = (torch.fft.fftn(torch.sqrt(tf._eig) * torch.complex(wr, wi), dim=(-2, -1)).real
         / np.sqrt(tf._emb_size))[:, :n, :n]
    # the batched expression is the field's own, sample by sample
    np.testing.assert_allclose(g[3].reshape(-1).numpy(),
                               tf._sample_from(wr[3], wi[3]).numpy(), atol=1e-12)
    for lag in (0, 1, 3, 6):
        prod = (g[:, 0, 0] * g[:, 0, lag]).numpy()
        want = np.exp(-(lag * h / L) ** 2)
        assert abs(prod.mean() - want) < 5 * prod.std() / np.sqrt(N), lag


def test_fields_composition():
    """Fields/Field dependency graph: derived fields + region restriction."""
    rf = tcf.SpatialCorrelatedField(corr_exp="gauss", dim=2, corr_length=2.0,
                                    log=True, device="cpu", seed=0)
    fields = tcf.Fields([
        tcf.Field("por", rf, regions="ground"),
        tcf.Field("porosity", tcf.positive_to_range, ["por", 0.02, 0.1],
                  regions="ground"),
        tcf.Field("conductivity", tcf.kozeny_carman, ["porosity", 1, 1e-8, 8.9e-4],
                  regions="ground"),
    ], seed=1)
    pts = _points(25)
    fields.set_points(pts, region_ids=[0] * 25, region_map={"ground": 0})
    fields.set_outer_fields(["conductivity"])
    out = fields.sample(torch.Generator().manual_seed(1))
    assert set(out.keys()) == {"conductivity"}
    assert out["conductivity"].shape == (25,)
    assert np.all(out["conductivity"] > 0)
    # the derived laws are mlmc_tpu's
    jcf = _jcf()
    x = np.linspace(0.01, 3.0, 7)
    np.testing.assert_allclose(tcf.positive_to_range(x, 0.02, 0.1),
                               jcf.positive_to_range(x, 0.02, 0.1), rtol=1e-15)
    p = np.linspace(0.0, 1.0, 9)
    np.testing.assert_allclose(tcf.kozeny_carman(p, 1, 1e-8, 8.9e-4),
                               jcf.kozeny_carman(p, 1, 1e-8, 8.9e-4), rtol=1e-14)
    np.testing.assert_allclose(
        tcf.kozeny_carman(torch.from_numpy(p), 1, 1e-8, 8.9e-4).numpy(),
        jcf.kozeny_carman(p, 1, 1e-8, 8.9e-4), rtol=1e-14)


def test_fields_forward_reference_rejected():
    rf = tcf.SpectralCorrelatedField(corr_exp="gauss", dim=2, corr_length=1.0,
                                     mode_no=16, device="cpu")
    with pytest.raises(KeyError, match="before its definition"):
        tcf.Fields([tcf.Field("K", np.exp, ["logk"]), tcf.Field("logk", rf)])


def test_fields_region_args_must_pair():
    rf = tcf.GSToolsSpatialCorrelatedField(corr_exp="gauss", dim=2, corr_length=1.0,
                                           mode_no=16, device="cpu")
    fields = tcf.Fields([tcf.Field("k", rf, regions="ground")])
    pts = np.random.default_rng(0).uniform(size=(10, 2))
    with pytest.raises(ValueError, match="together"):
        fields.set_points(pts, region_ids=[1] * 10)   # ids without map
    with pytest.raises(ValueError, match="together"):
        fields.set_points(pts, region_map={"ground": 1})  # map without ids
    fields.set_points(pts)  # no regions at all: every point, every field
    assert fields.sample()["k"].shape == (10,)


# --------------------------------------------------------------------- #
# keyed streams
# --------------------------------------------------------------------- #
def _ids(n, start=0):
    return (torch.arange(start, start + n, dtype=torch.int64),
            torch.zeros(n, dtype=torch.int64))


def test_keyed_stream_does_not_depend_on_the_batch_cut(monkeypatch):
    idx, att = _ids(40)
    whole = keyed_normals(7, 2, idx, att, 50)
    parts = torch.cat([keyed_normals(7, 2, idx[a:b], att[a:b], 50)
                       for a, b in ((0, 13), (13, 14), (14, 40))])
    assert torch.equal(whole, parts)
    # nor on the internal blocking of the Philox calls
    import mlmc_tpu_torch.random.keyed as keyed
    monkeypatch.setattr(keyed, "CALLS_PER_BLOCK", 64)
    assert torch.equal(whole, keyed_normals(7, 2, idx, att, 50))


def test_keyed_stream_changes_with_every_part_of_the_identity():
    idx, att = _ids(16)
    base = keyed_uniforms(7, 2, idx, att, 12)
    assert not torch.equal(base, keyed_uniforms(8, 2, idx, att, 12))
    assert not torch.equal(base, keyed_uniforms(7, 3, idx, att, 12))
    assert not torch.equal(base, keyed_uniforms(7, 2, idx, att + 1, 12))
    assert not torch.equal(base, keyed_uniforms(7, 2, idx + 16, att, 12))
    # a longer request extends the same stream
    assert torch.equal(base, keyed_uniforms(7, 2, idx, att, 40)[:, :12])


def test_keyed_counters_cannot_collide():
    """Distinct (index, attempt, call) give distinct words, and the level
    word carries the marker that no other stream of the package sets."""
    from mlmc_tpu_torch.ops import cuda_kernels as ck

    idx = torch.tensor([0, 1, 1 << 33, 5], dtype=torch.int64)
    att = torch.tensor([0, 1, 0, 4095], dtype=torch.int64)
    words = keyed_words(3, 1, idx, att, 8)                   # [4, 32]
    assert len(np.unique(words.numpy().reshape(-1, 4), axis=0)) == 32
    # the synthetic simulation's and the kernels' counter of the same
    # (seed, level, index) has the bare level in word 2
    zero = torch.zeros_like(idx)
    bare = torch.stack(ck.philox4x32_10(
        (idx & ck.MASK32, idx >> 32, zero + 1, zero), ck.key_words(3)), dim=-1)
    assert not torch.equal(bare, words[:, :4])
    marked = torch.stack(ck.philox4x32_10(
        (idx & ck.MASK32, idx >> 32, zero + (WIDE | 1), (att & 0xFFF) << 20),
        ck.key_words(3)), dim=-1)
    assert torch.equal(marked, words[:, :4])
    with pytest.raises(ValueError, match="Philox calls"):
        keyed_words(3, 1, idx, att, (1 << 20) + 1)


def test_keyed_uniforms_and_normals_pass_a_coarse_check():
    idx, att = _ids(500)
    u = keyed_uniforms(11, 0, idx, att, 200).numpy().ravel()
    assert u.min() >= 0.0 and u.max() < 1.0
    counts = np.histogram(u, bins=20, range=(0, 1))[0]
    expected = u.size / 20
    assert np.all(np.abs(counts - expected) < 5 * np.sqrt(expected))
    # neighbouring numbers of one sample are uncorrelated
    uu = u.reshape(500, 200)
    assert abs(np.corrcoef(uu[:, :-1].ravel(), uu[:, 1:].ravel())[0, 1]) < 0.02
    z = keyed_normals(11, 0, idx, att, 200, dtype=torch.float64).numpy().ravel()
    assert abs(z.mean()) < 5 / np.sqrt(z.size)
    assert abs(z.var() - 1) < 5 * np.sqrt(2 / z.size)
    assert abs((z ** 4).mean() - 3) < 0.15
