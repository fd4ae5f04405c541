"""mlmc_tpu_torch.sensitivity against mlmc_tpu's.

The same scramble words (JAX's, per randomization) go into both design
programs: the six pick-freeze accumulators agree to 1e-12 relative (f64),
so do the indices; ``sobol_indices_mlmc`` agrees on two levels;
``active_subspace`` agrees on replayed draws. The port's own runs meet the
Ishigami closed forms, and a non-finite model value raises.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmc_tpu_torch import sensitivity as ts
from torch_cwd import removed_working_directory

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

A, B_ = 7.0, 0.1


def _ishigami_jax(u):
    x = 2 * jnp.pi * u - jnp.pi
    return jnp.sin(x[:, 0]) + A * jnp.sin(x[:, 1]) ** 2 + B_ * x[:, 2] ** 4 * jnp.sin(x[:, 0])


def _ishigami_torch(u):
    x = 2 * np.pi * u - np.pi
    return (torch.sin(x[:, 0]) + A * torch.sin(x[:, 1]) ** 2
            + B_ * x[:, 2] ** 4 * torch.sin(x[:, 0]))


def _ishigami_exact():
    v1 = 0.5 * (1 + B_ * np.pi ** 4 / 5) ** 2
    v2 = A ** 2 / 8
    v13 = 8 * B_ ** 2 * np.pi ** 8 / 225
    v = v1 + v2 + v13
    return np.array([v1, v2, 0.0]) / v, np.array([v1 + v13, v2, v13]) / v


def _jax_seeds(key, R, dim):
    from mlmc_tpu.ops import sobol as jsobol

    s = jax.vmap(lambda k: jsobol.scramble_seeds(k, 2 * dim))(jax.random.split(key, R))
    return torch.tensor(np.asarray(s).astype(np.int64))


def test_accumulators_and_indices_match_mlmc_tpu():
    from mlmc_tpu import sensitivity as js

    dim, R, chunk, n_chunks = 3, 4, 256, 2
    seeds = _jax_seeds(jax.random.key(9), R, dim)
    run = js._design_program_cached(_ishigami_jax, dim, chunk, jnp.float64, None,
                                    single=True)
    want = [np.asarray(x) for x in run(n_chunks, jnp.asarray(seeds.numpy().astype(np.uint32)))]
    got = ts._design_accumulators(lambda x: (_ishigami_torch(x), None), dim, chunk,
                                  n_chunks, seeds, torch.float64, None)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    # the whole public call with the same words
    res_j = js.sobol_indices(_ishigami_jax, 3, n=512, n_randomizations=R, seed=9,
                             chunk_size=256, dtype=jnp.float64)
    res_t = ts._indices_from_accumulators(got, 512, R, 3)
    for f in ("first_order", "total_effect", "first_order_se", "total_effect_se"):
        np.testing.assert_allclose(res_t[f], res_j[f], rtol=1e-10, atol=1e-13)
    assert res_t.n_evaluations == res_j.n_evaluations == R * 512 * 5


def test_transform_and_normals_match_mlmc_tpu():
    from mlmc_tpu import sensitivity as js
    from mlmc_tpu.ops import sobol as jsobol
    from mlmc_tpu_torch.ops import sobol as tsobol

    dim, R = 2, 3
    seeds = _jax_seeds(jax.random.key(1), R, dim)
    run = js._design_program(lambda x: x[:, 0] * jnp.exp(0.3 * x[:, 1]), dim, 128,
                             jnp.float64, jsobol.normals_from_uniforms, single=True)
    want = run(1, jnp.asarray(seeds.numpy().astype(np.uint32)))
    got = ts._design_accumulators(lambda x: (x[:, 0] * torch.exp(0.3 * x[:, 1]), None),
                                  dim, 128, 1, seeds, torch.float64,
                                  tsobol.normals_from_uniforms)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-12)


def test_mlmc_indices_match_mlmc_tpu_on_two_levels(monkeypatch):
    """``sobol_indices_mlmc`` with JAX's per-level words (fold_in(key,
    level) then split) replayed through the port's ``scramble_seeds``."""
    from mlmc_tpu import sensitivity as js
    from mlmc_tpu_torch.ops import sobol as tsobol

    dim, R = 3, 4
    fns_j = [lambda u: (_ishigami_jax(u), jnp.zeros(u.shape[0])),
             lambda u: (_ishigami_jax(u), 0.9 * _ishigami_jax(u))]
    fns_t = [lambda u: (_ishigami_torch(u), torch.zeros(u.shape[0], dtype=u.dtype)),
             lambda u: (_ishigami_torch(u), 0.9 * _ishigami_torch(u))]
    key = jax.random.key(3)
    words = {lev: _jax_seeds(jax.random.fold_in(key, lev), R, dim) for lev in range(2)}
    monkeypatch.setattr(tsobol, "scramble_seeds",
                        lambda seed, level, n, d, device=None: words[level])
    res_j = js.sobol_indices_mlmc(fns_j, dim, [512, 256], n_randomizations=R, seed=3,
                                  chunk_size=256, dtype=jnp.float64)
    res_t = ts.sobol_indices_mlmc(fns_t, dim, [512, 256], n_randomizations=R, seed=3,
                                  chunk_size=256, dtype=torch.float64, device="cpu")
    for f in ("first_order", "total_effect"):
        np.testing.assert_allclose(res_t[f], res_j[f], rtol=1e-10, atol=1e-13)
    np.testing.assert_allclose(res_t["level_terms"]["e_f2"], res_j["level_terms"]["e_f2"],
                               rtol=1e-12)
    assert list(res_t.n) == list(res_j.n) and res_t.n_evaluations == res_j.n_evaluations


def _active_subspace_pair(context):
    """mlmc_tpu's active subspace and the port's on JAX's draws, the port's
    run inside ``context``; held to each other."""
    from mlmc_tpu import sensitivity as js

    dim, chunk = 4, 128
    w = np.array([0.8, -0.5, 0.3, 0.1])
    c = np.array([0.1, 0.2, 0.3, 0.4])        # a full-rank gradient covariance
    fj = lambda x: jnp.sin(x @ jnp.asarray(w)) + 0.5 * (x * x) @ jnp.asarray(c)
    ft = lambda x: (torch.sin(x @ torch.tensor(w, dtype=x.dtype))
                    + 0.5 * (x * x) @ torch.tensor(c, dtype=x.dtype))
    key = jax.random.key(6)
    draws = [np.asarray(jax.random.normal(jax.random.fold_in(key, c), (chunk, dim),
                                          jnp.float64)) for c in range(3)]
    res_j = js.active_subspace(fj, dim, n_samples=3 * chunk, key=key, chunk_size=chunk,
                               dtype=jnp.float64)
    with context:
        res_t = ts.active_subspace(ft, dim, n_samples=3 * chunk, chunk_size=chunk,
                                   sampler=lambda keys, n: draws[keys.level].copy(),
                                   dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(res_t["C"], res_j["C"], rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(res_t["eigvals"], res_j["eigvals"], rtol=1e-10, atol=1e-14)
    np.testing.assert_allclose(np.abs(res_t["W"][:, 0]), np.abs(res_j["W"][:, 0]),
                               rtol=1e-9)
    np.testing.assert_allclose(res_t["subspace_dist"], res_j["subspace_dist"],
                               rtol=1e-8, atol=1e-12)
    assert res_t["n_samples"] == res_j["n_samples"] == 3 * chunk


def test_active_subspace_matches_mlmc_tpu_on_replayed_draws():
    _active_subspace_pair(contextlib.nullcontext())


def test_active_subspace_runs_without_a_working_directory(tmp_path):
    """The per-sample gradients need no working directory, as ``jax.grad``
    does not (``torch.func.grad`` imports ``torch._dynamo``, whose config
    reads it)."""
    _active_subspace_pair(removed_working_directory(tmp_path))


def test_ishigami_meets_its_closed_forms_and_active_direction():
    s_exact, st_exact = _ishigami_exact()
    res = ts.sobol_indices(_ishigami_torch, 3, n=1 << 12, n_randomizations=8, seed=4,
                           chunk_size=1 << 11, device="cpu")
    assert np.all(np.abs(res.first_order - s_exact) < 6 * res.first_order_se + 1e-3)
    assert np.all(np.abs(res.total_effect - st_exact) < 6 * res.total_effect_se + 1e-3)
    # a ridge function varies along w alone
    w = torch.tensor([0.6, 0.0, -0.8])
    out = ts.active_subspace(lambda x: torch.tanh(x @ w.to(x.dtype)), 3, n_samples=4096,
                             seed=2, device="cpu")
    assert out["explained"][0] > 1 - 1e-6
    assert abs(abs(float(out["W"][:, 0] @ w.double().numpy())) - 1.0) < 1e-6


def test_non_finite_model_values_raise():
    with pytest.raises(FloatingPointError, match="non-finite"):
        ts.sobol_indices(lambda u: torch.log(u[:, 0] - 0.5), 2, n=256, n_randomizations=2,
                         device="cpu")
    with pytest.raises(ValueError, match="randomizations"):
        ts.sobol_indices(_ishigami_torch, 3, n_randomizations=1, device="cpu")
