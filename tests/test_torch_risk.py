"""mlmc_tpu_torch.risk against mlmc_tpu's, on the CPU in float64.

Identical draws: every identity the JAX drivers key by ``fold_in`` chains
(the quantile pilot ``(seed, 10001, i)``, the CDF stage ``(seed + 1, l,
i)``, the tail stage ``(seed + 2, l, i)``; the gradient drivers' ``(key,
l, step, i)``) has its normals computed once in JAX; the port's pair and
objective functions look them up by their ``SampleKeys``. VaR, CVaR,
their errors and counts, gradients and a short Adam trajectory (optax's
against ``risk.adam``'s copy of it) then agree to 1e-10. ``cvar_mlmc``
over a ``SampleMesh`` of repeated CPU devices equals one device bit for
bit.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import risk as tr
from mlmc_tpu_torch.parallel import SampleMesh
from torch_cwd import removed_working_directory

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

RTOL = 1e-10
ADAM_RTOL = 1e-15
REPO = Path(__file__).resolve().parent.parent


@jax.jit
def _normals(key):
    return jax.random.normal(key, (2,))


def _table(*path, n):
    """[n, 2] normals of keys fold_in(...fold_in(key(path[0]), path[1])...,
    i), i < n."""
    k = jax.random.key(path[0])
    for p in path[1:]:
        k = jax.random.fold_in(k, p)
    keys = jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.arange(n, dtype=jnp.uint32))
    return torch.tensor(np.asarray(jax.vmap(_normals)(keys)))


def _gauss_pair(draw, ones, c=0.4):
    def fn(level, keys):
        xy = draw(keys)
        fine = xy[:, 0] + c * 2.0 ** -level * xy[:, 1]
        coarse = xy[:, 0] + c * 2.0 ** -(level - 1) * xy[:, 1] if level else 0.0 * fine
        return fine, coarse, ones(fine)
    return fn


def _jax_draw(keys):
    return jax.vmap(_normals)(keys)


def _torch_ones(x):
    return torch.ones_like(x, dtype=torch.bool)


def _jax_ones(x):
    return jnp.ones(x.shape, bool)


CVAR = dict(n_levels=2, alpha=0.9, target_se=0.05, bandwidth=[0.2, 0.1],
            seed=5, cost_fn=lambda lv: 2.0 ** lv, chunk_size=256, n_pilot=1024)


def test_cvar_empirical_matches_mlmc_tpu():
    from mlmc_tpu import risk as jr

    x = np.random.default_rng(0).normal(size=999)
    a, b = tr.cvar_empirical(x, 0.95), jr.cvar_empirical(x, 0.95)
    assert a == b
    with pytest.raises(ValueError, match="alpha"):
        tr.cvar_empirical(x, 1.0)


def test_cvar_mlmc_matches_mlmc_tpu_on_identical_draws():
    from mlmc_tpu import risk as jr

    out_j = jr.cvar_mlmc(_gauss_pair(_jax_draw, _jax_ones), **CVAR)
    seed, L = CVAR["seed"], CVAR["n_levels"]
    tables = {(seed, 10_001): _table(seed, 10_001, n=CVAR["n_pilot"])}
    for lv in range(L):
        tables[(seed + 1, lv)] = _table(seed + 1, lv, n=int(out_j["cdf"]["n_samples"][lv]))
        tables[(seed + 2, lv)] = _table(seed + 2, lv, n=int(out_j["n_per_level"][lv]))
    pair = _gauss_pair(lambda k: tables[(k.seed, k.level)][k.indices], _torch_ones)
    out_t = tr.cvar_mlmc(pair, device="cpu", **CVAR)
    assert out_t["n_per_level"].tolist() == out_j["n_per_level"].tolist()
    assert out_t["cdf"]["n_samples"].tolist() == out_j["cdf"]["n_samples"].tolist()
    assert out_t["rounds"] == out_j["rounds"]
    for k in ("var", "var_se", "cvar", "cvar_se", "tail_mean", "tail_se",
              "level_corrections"):
        np.testing.assert_allclose(out_t[k], out_j[k], rtol=RTOL, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_cvar_mlmc_mesh_equals_one_device_bit_for_bit(n_shards):
    pair = _gauss_pair(lambda k: k.normals(2).double(), _torch_ones)
    kw = dict(CVAR, chunk_size=128)
    one = tr.cvar_mlmc(pair, device="cpu", **kw)
    shard = tr.cvar_mlmc(pair, mesh=SampleMesh(["cpu"] * n_shards, group=False), **kw)
    for k in ("var", "var_se", "cvar", "cvar_se", "tail_mean", "tail_se"):
        assert one[k] == shard[k], k
    assert one["n_per_level"].tolist() == shard["n_per_level"].tolist()
    assert np.array_equal(one["cdf"]["cdf"], shard["cdf"]["cdf"])


def _obj(draw, ones):
    """A hedged quadratic loss, differentiable in theta = [a, b]."""
    def fn(level, theta, keys):
        xy = draw(keys)
        h = 2.0 ** -level
        f = (theta[0] * xy[:, 0] + theta[1] + h * xy[:, 1]) ** 2
        c = (theta[0] * xy[:, 0] + theta[1] + 2 * h * xy[:, 1]) ** 2 if level else 0 * f
        return f, c, ones(f)
    return fn


def _grad_tables(n_levels, steps, n_per):
    """{keyed level id (s << 8 | l): [n_l, 2]} as ``_level_keys`` keys them."""
    return {(s << 8) | lv: _table(0, lv, s, n=n_per[lv])
            for lv in range(n_levels) for s in steps}


def test_mlmc_gradient_matches_mlmc_tpu():
    from mlmc_tpu import risk as jr

    n_per = [512, 256, 128]
    theta = np.array([0.7, -0.2])
    out_j = jr.mlmc_gradient(_obj(_jax_draw, _jax_ones), jnp.asarray(theta), 3, n_per)
    tables = _grad_tables(3, [0], n_per)
    obj_t = _obj(lambda k: tables[k.level][k.indices], _torch_ones)
    out_t = tr.mlmc_gradient(obj_t, theta, 3, n_per, device="cpu")
    for k in ("value", "grad", "level_values", "level_variances", "n_valid"):
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), rtol=RTOL, err_msg=k)


OPT_N_PER, OPT_THETA0 = [256, 128], np.array([0.5, 0.3])
OPT_KEYS = {"expectation": ("theta", "values", "grad_norms"),
            "cvar": ("theta", "t", "cvar", "values", "grad_norms")}


def _optimize(which, risk, obj, theta0, **kw):
    """Five Adam steps of ``optimize_expectation`` or three of the joint
    CVaR program, in either package."""
    if which == "expectation":
        return risk.optimize_expectation(obj, theta0, 2, OPT_N_PER, n_steps=5, **kw)
    return risk.optimize_cvar(obj, theta0, 0.8, 2, OPT_N_PER, n_steps=3,
                              smoothing=0.1, t0_init=0.5, **kw)


def _optimize_jax(which):
    from mlmc_tpu import risk as jr

    return _optimize(which, jr, _obj(_jax_draw, _jax_ones), jnp.asarray(OPT_THETA0))


def _torch_opt_obj():
    tables = _grad_tables(2, range(1, 6), OPT_N_PER)
    return _obj(lambda k: tables[k.level][k.indices], _torch_ones)


def _assert_optimize_match(which, out_t, out_j):
    for k in OPT_KEYS[which]:
        np.testing.assert_allclose(out_t[k], np.asarray(out_j[k]), rtol=RTOL, err_msg=k)


def test_optimize_expectation_and_cvar_match_mlmc_tpu():
    """Five Adam steps: optax.adam(0.05) against ``risk.adam`` (0.05); and
    three steps of the joint CVaR program."""
    obj_t = _torch_opt_obj()
    for which in ("expectation", "cvar"):
        out_t = _optimize(which, tr, obj_t, OPT_THETA0, device="cpu")
        _assert_optimize_match(which, out_t, _optimize_jax(which))
    assert mt.optimize_cvar is tr.optimize_cvar and mt.cvar_mlmc is tr.cvar_mlmc


@pytest.mark.parametrize("which", ["expectation", "cvar"])
def test_optimizers_run_without_a_working_directory(which, tmp_path):
    """The default optimizer needs no working directory, as optax does not
    (``torch.optim``'s constructor imports ``torch._dynamo``, whose config
    reads it): the port's call in a removed directory matches mlmc_tpu's."""
    out_j, obj_t = _optimize_jax(which), _torch_opt_obj()
    with removed_working_directory(tmp_path):
        out_t = _optimize(which, tr, obj_t, OPT_THETA0, device="cpu")
    _assert_optimize_match(which, out_t, out_j)


def test_adam_trace_matches_optax_on_a_quadratic():
    """200 steps of ``risk.adam(0.05)`` and ``optax.adam(0.05)`` from one
    start on the separable quadratic sum(0.5 a p^2 - b p), float64, each
    side forming its gradient a * p - b elementwise. Both run the same
    float64 operations in the same order, so the traces agree bit for bit
    but where XLA's fused elementwise code rounds a step one ulp apart:
    over six seeds (0-5) the largest gap measured was 1.2e-16 relative
    (seed 2, at 9 of 200 steps; the other seeds bit for bit), and
    ADAM_RTOL = 1e-15 is about five ulps. A dense quadratic's matrix
    product rounds differently in the two libraries and
    would hold the test to that, not to the optimizer."""
    import optax

    rng = np.random.default_rng(3)
    a, b, p0 = rng.uniform(0.5, 2.5, 6), rng.standard_normal(6), rng.standard_normal(6)

    opt = optax.adam(0.05)
    pj = jnp.asarray(p0)
    state = opt.init(pj)
    aj, bj = jnp.asarray(a), jnp.asarray(b)
    trace_j = []
    for _ in range(200):
        upd, state = opt.update(aj * pj - bj, state)
        pj = optax.apply_updates(pj, upd)
        trace_j.append(np.asarray(pj))

    pt = torch.tensor(p0)
    at, bt = torch.tensor(a), torch.tensor(b)
    opt_t = tr.adam(0.05)([pt])
    assert not isinstance(opt_t, torch.optim.Optimizer)
    trace_t = []
    for _ in range(200):
        pt.grad = at * pt - bt
        opt_t.step()
        trace_t.append(pt.numpy().copy())
    assert pt.dtype == torch.float64 and pt.grad is not None
    opt_t.zero_grad()
    assert pt.grad is None
    np.testing.assert_allclose(np.array(trace_t), np.array(trace_j), rtol=ADAM_RTOL)


_NO_CWD_SCRIPT = r"""
import os
import sys
import numpy as np
import torch
import mlmc_tpu_torch as mt
from mlmc_tpu_torch import risk, sensitivity
os.rmdir(os.getcwd())
p = torch.zeros(3, dtype=torch.float64, requires_grad=True)
opt = risk.adam(0.05)([p])
(p - 1.0).pow(2).sum().backward()
opt.step()
assert np.allclose(p.detach().numpy(), 0.05)
X = np.linspace(0.0, 1.0, 6)[:, None]
gp = mt.GP(device="cpu").fit(X, np.sin(3 * X[:, 0]), n_steps=5)
assert np.isfinite(gp.nll_trace).all()
bo = mt.bayes_opt(lambda x: float((x ** 2).sum()), np.array([[-1.0, 1.0]]), n_init=4,
                  n_iter=1, fit_steps=5, n_candidates=16, device="cpu")
assert np.isfinite(bo["y_best"])
res = sensitivity.active_subspace(lambda x: (x ** 2).sum(), 3, n_samples=64,
                                  chunk_size=32, device="cpu")
assert np.isfinite(res["eigvals"]).all()
assert "torch._dynamo" not in sys.modules, "torch._dynamo was imported"
print("no-cwd-ok")
"""


def test_fresh_process_without_a_working_directory_never_imports_dynamo(tmp_path):
    """In a fresh process whose working directory is removed once the port
    is imported (as a pytest worker's is), ``risk.adam``'s step, ``GP.fit``, ``bayes_opt`` and
    ``active_subspace`` run and never import ``torch._dynamo`` (whose config
    reads the working directory). Unlike the removed-directory cases above,
    this holds whatever an earlier test imported in the pytest process."""
    gone = tmp_path / "gone"
    gone.mkdir()
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", _NO_CWD_SCRIPT], cwd=str(gone),
                          env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "no-cwd-ok" in proc.stdout
