"""mlmc_tpu_torch.ops.sobol and ops.lattice against mlmc_tpu's.

The same direction numbers, indices, scramble words, generating vectors
and shifts go through both packages: Sobol' bits, scrambled bits and
float32/float64 uniforms equal bit for bit, CBC vectors equal, lattice
points within 1 ulp, and the shifted lattice estimate within 1e-12
relative (f64 on both sides). The port's own Philox scramble words and
shifts are held to their statistics.
"""
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.ops import lattice as tl
from mlmc_tpu_torch.ops import sobol as ts
from mlmc_tpu_torch.parallel import SampleMesh

torch.set_num_threads(1)


def _jax():
    import jax
    import jax.numpy as jnp
    from mlmc_tpu.ops import lattice as jl
    from mlmc_tpu.ops import sobol as js
    return jax, jnp, js, jl


@pytest.mark.parametrize("dim,start,n", [(1, 0, 64), (7, 5, 300), (40, (1 << 20) - 3, 97),
                                         (3, (1 << 32) - 10, 20)])
def test_sobol_bits_and_scramble_equal_mlmc_tpu(dim, start, n):
    jax, jnp, js, _ = _jax()
    dv = js.direction_numbers(dim)
    assert np.array_equal(dv, ts.direction_numbers(dim))
    b_j = np.asarray(js.sobol_bits(jnp.asarray(dv), start, n)).astype(np.int64)
    b_t = ts.sobol_bits(dv, start, n, device="cpu")
    assert b_t.dtype == torch.int64 and np.array_equal(b_j, b_t.numpy())
    seeds = np.asarray(js.scramble_seeds(jax.random.key(dim), dim))
    s_j = np.asarray(js.owen_scramble(jnp.asarray(b_j.astype(np.uint32)),
                                      jnp.asarray(seeds))).astype(np.int64)
    s_t = ts.owen_scramble(b_t, torch.as_tensor(seeds.astype(np.int64)))
    assert np.array_equal(s_j, s_t.numpy())
    # the scramble reorders the points of every dyadic box: raw != scrambled
    assert not np.array_equal(b_j, s_j)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniforms_from_bits_equal_mlmc_tpu(dtype):
    jax, jnp, js, _ = _jax()
    rng = np.random.default_rng(3)
    words = rng.integers(0, 1 << 32, size=(500, 3), dtype=np.int64)
    words[0] = [0, (1 << 32) - 1, (1 << 31)]          # the extremes
    u_j = np.asarray(js.uniforms_from_bits(jnp.asarray(words.astype(np.uint32)),
                                           getattr(jnp, dtype)))
    u_t = ts.uniforms_from_bits(torch.as_tensor(words), getattr(torch, dtype)).numpy()
    assert u_t.dtype == u_j.dtype and np.array_equal(u_j, u_t)
    assert 0.0 < u_t.min() and u_t.max() < 1.0
    n_j = np.asarray(js.normals_from_uniforms(jnp.asarray(u_j)))
    n_t = ts.normals_from_uniforms(torch.as_tensor(u_t)).numpy()
    tol = 1e-14 if dtype == "float64" else 2e-6        # ndtri's last bits
    np.testing.assert_allclose(n_t, n_j, rtol=tol, atol=tol)


def test_sobol_uniforms_match_scipy_and_nets():
    """Raw points are scipy's draw order; scrambled points keep the
    (t, s)-net property: one point per dyadic box in 1-D at 2^k points."""
    from scipy.stats import qmc

    dv = ts.direction_numbers(5)
    raw = ts.sobol_uniforms(dv, 0, 256, dtype=torch.float64, device="cpu").numpy()
    ref = qmc.Sobol(d=5, scramble=False).random(256)
    np.testing.assert_allclose(raw, ref + 2.0 ** -33, rtol=0, atol=1e-15)
    seeds = ts.scramble_seeds(1, 0, 2, 5, device="cpu")
    for r in range(2):
        u = ts.sobol_uniforms(dv, 0, 256, seeds=seeds[r], dtype=torch.float64,
                              device="cpu").numpy()
        for d in range(5):
            assert np.array_equal(np.sort(np.floor(u[:, d] * 256)), np.arange(256))


def test_scramble_seeds_are_keyed_words():
    """(seed, level, r) name the words: other seeds, levels and
    randomizations give other words; their bits are balanced."""
    a = ts.scramble_seeds(5, 0, 64, 33, device="cpu")
    assert a.shape == (64, 33) and a.dtype == torch.int64
    assert torch.equal(a, ts.scramble_seeds(5, 0, 64, 33, device="cpu"))
    assert torch.equal(a[:8], ts.scramble_seeds(5, 0, 8, 33, device="cpu"))
    for other in (ts.scramble_seeds(6, 0, 64, 33, device="cpu"),
                  ts.scramble_seeds(5, 1, 64, 33, device="cpu")):
        assert not torch.equal(a, other)
    bits = ((a[..., None] >> torch.arange(32)) & 1).double().mean()
    assert abs(float(bits) - 0.5) < 0.02
    assert bool(((a >= 0) & (a < (1 << 32))).all())


@pytest.mark.parametrize("n,dim,method", [(64, 5, "direct"), (64, 5, "fft"),
                                          (1 << 10, 6, "auto"), (1 << 12, 8, "auto")])
def test_cbc_vector_and_p_alpha_equal_mlmc_tpu(n, dim, method):
    _, _, _, jl = _jax()
    z = tl.cbc_vector(n, dim, method=method)
    assert np.array_equal(z, jl.cbc_vector(n, dim, method=method))
    assert tl.p_alpha(z, n) == jl.p_alpha(z, n)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("extensible", [False, True])
@pytest.mark.parametrize("shift_rank", [0, 1, 2])
def test_lattice_points_within_one_ulp(dtype, extensible, shift_rank):
    _, jnp, _, jl = _jax()
    n = 1 << 10
    z = jl.cbc_vector(n, 6)
    rng = np.random.default_rng(shift_rank)
    shift = [None, rng.uniform(size=6), rng.uniform(size=(3, 6))][shift_rank]
    jfn = jl.lattice_points_extensible if extensible else jl.lattice_points
    tfn = tl.lattice_points_extensible if extensible else tl.lattice_points
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    a = np.asarray(jfn(z, n, None if shift is None else jnp.asarray(shift, jd),
                       start=17, count=200, dtype=jd))
    b = tfn(z, n, None if shift is None else torch.tensor(shift).to(td),
            start=17, count=200, dtype=td, device="cpu").numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    ulp = np.spacing(np.maximum(np.abs(a), np.finfo(a.dtype).tiny))
    assert np.all(np.abs(a - b) <= ulp)


def test_lattice_index_arithmetic_wraps_as_uint32():
    """i z mod n past 2^32 of the product: the word arithmetic equals the
    exact residue (n = 2^31, f64)."""
    n = 1 << 31
    z = np.array([1, 2_147_483_647, 1_234_567_891], np.int64)
    start = (1 << 31) - 5
    got = tl.lattice_points(z, n, start=start, count=8, dtype=torch.float64,
                            device="cpu").numpy()
    i = np.arange(start, start + 8, dtype=object)[:, None]
    exact = np.array((i * z.astype(object)[None, :]) % n, np.float64) / n
    assert np.array_equal(got, exact)
    with pytest.raises(ValueError, match="exact range"):
        tl.lattice_points(z, 1 << 25, dtype=torch.float32, device="cpu")


def _f_periodic_t(u):
    return torch.prod(1.0 + 0.25 * (u * u - u + 1.0 / 6.0), dim=1)


@pytest.mark.parametrize("use_tent", [False, True])
def test_lattice_estimate_matches_mlmc_tpu(use_tent, monkeypatch):
    """On JAX's shifts (``uniform(key(seed), (R, d))``, put in place of the
    port's Philox shifts) the estimates agree."""
    jax, jnp, _, jl = _jax()
    f_j = lambda u: jnp.prod(jnp.exp(u), axis=1)
    f_t = lambda u: torch.prod(torch.exp(u), dim=1)
    rj = jl.lattice_estimate(f_j, 5, n=1 << 10, n_shifts=4, seed=2, use_tent=use_tent,
                             dtype=jnp.float64, chunk_size=256)
    shifts = np.asarray(jax.random.uniform(jax.random.key(2), (4, 5), jnp.float64))
    monkeypatch.setattr(tl, "random_shifts",
                        lambda seed, level, R, dim, dtype, device: torch.tensor(shifts))
    rt = tl.lattice_estimate(f_t, 5, n=1 << 10, n_shifts=4, seed=2, use_tent=use_tent,
                             dtype=torch.float64, chunk_size=256, device="cpu")
    np.testing.assert_allclose(rt["per_shift"], rj["per_shift"], rtol=1e-12)
    np.testing.assert_allclose(rt["within_shift_var"], rj["within_shift_var"], rtol=1e-9)
    assert abs(rt["mean"] - rj["mean"]) <= 1e-12 * abs(rj["mean"])
    assert np.array_equal(rt["z"], rj["z"])


def test_lattice_estimate_keyed_shifts_closed_form_and_mesh():
    """With the port's own shifts: the periodic product's integral (1)
    within 6 se, and the estimate over a two-shard mesh equal to one
    device."""
    one = tl.lattice_estimate(_f_periodic_t, 6, n=1 << 10, n_shifts=8, seed=4,
                              dtype=torch.float64, device="cpu")
    assert abs(one["mean"] - 1.0) <= 6 * one["se"]
    two = tl.lattice_estimate(_f_periodic_t, 6, n=1 << 10, n_shifts=8, seed=4,
                              dtype=torch.float64,
                              mesh=SampleMesh(["cpu", "cpu"], group=False))
    assert np.array_equal(one["per_shift"], two["per_shift"])
    sh = tl.random_shifts(4, 0, 8, 6, torch.float32, device="cpu")
    assert sh.dtype == torch.float32 and float(sh.max()) < 1.0 and float(sh.min()) >= 0.0
