"""mlmc_tpu_torch.sim.american against mlmc_tpu's.

JAX's path normals (``split(key)`` into the fit and evaluation keys, then
``split(kr, n_dates)`` per date, as ``lsmc_price``'s ``simulate`` draws
them) are replayed into the port's private ``_lsmc`` core, f64 on both
sides. Exercise decisions are discontinuous, so the rule is: the
coefficients within 1e-9 relative, the prices within the flipped paths'
payoffs over B, and the number of flipped paths asserted (0 here). The
duals, the multilevel dual and the swing option run from frozen JAX
coefficients; the binomial tree is the same code; the mesh run draws the
one-device paths and is held to the same rule.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.parallel import SampleMesh
from mlmc_tpu_torch.parallel.mesh import single_device_mesh
from mlmc_tpu_torch.sim import american as ta
from mlmc_tpu_torch.sim import sde as tsde

torch.set_num_threads(1)
jax.config.update("jax_enable_x64", True)

B = 256
RATE, SIGMA = 0.06, 0.2


def _ja():
    import mlmc_tpu.sim.american as ja
    return ja


def _date_draws(kr, n_dates, shape):
    keys = jax.random.split(kr, n_dates)
    return np.stack([np.asarray(jax.random.normal(k, shape, jnp.float64)) for k in keys])


def _price_normals(key, n_dates, kind, n_sub=1, n_drivers=1):
    """[pass][B, n_dates, per_date] from JAX's fit/eval keys."""
    out = []
    for kr in jax.random.split(key):
        if kind == "gbm":
            z = _date_draws(kr, n_dates, (B,))[..., None]                 # [N, B, 1]
        elif kind == "model":
            z = _date_draws(kr, n_dates, (n_sub, B)).transpose(0, 2, 1)    # [N, B, sub]
        else:
            z = _date_draws(kr, n_dates, (n_sub, B, n_drivers))            # [N, sub, B, d]
            z = z.transpose(0, 2, 1, 3).reshape(n_dates, B, n_sub * n_drivers)
        out.append(torch.tensor(z.transpose(1, 0, 2).copy()))
    return lambda p, idx: out[p][idx]


def _flips(a, b):
    return int((a["stop"] != b["stop"]).sum()) + int(
        (a["stop_insample"] != b["stop_insample"]).sum())


def _hold(res, paths, ref, ref_paths, n, coef_rtol=1e-9):
    """The flipped-path rule over n paths: returns the number of flipped
    paths."""
    flipped = _flips(paths, ref_paths)
    if not flipped:
        np.testing.assert_allclose(res["coef"], ref["coef"], rtol=coef_rtol,
                                   atol=coef_rtol * np.abs(ref["coef"]).max())
    moved = (paths["stop"] != ref_paths["stop"])
    slack = float((paths["value"] - ref_paths["value"]).abs()[moved].sum()) / n
    assert abs(res["price"] - ref["price"]) <= slack + 1e-12 * abs(ref["price"])
    return flipped


CASES = {
    "gbm_put": dict(kind="gbm", n_dates=8, kw=dict(sigma=SIGMA, degree=3)),
    "gbm_put_global": dict(kind="gbm", n_dates=6, kw=dict(sigma=SIGMA, degree=5,
                                                         itm_only=False)),
    "model_milstein": dict(kind="model", n_dates=5, kw=dict(
        scheme="milstein", n_sub=3, degree=3)),
    "heston": dict(kind="system", n_dates=4, kw=dict(n_sub=2, degree=2)),
}


def _models(kind):
    import mlmc_tpu.sim.sde as jsde

    if kind == "model":
        return jsde.gbm(RATE, SIGMA, 1.0), tsde.gbm(RATE, SIGMA, 1.0)
    return jsde.heston(mu=0.05), tsde.heston(mu=0.05)


@pytest.mark.parametrize("name", sorted(CASES))
def test_lsmc_price_matches_mlmc_tpu_on_its_paths(name):
    ja = _ja()
    case = CASES[name]
    kind, n_dates, kw = case["kind"], case["n_dates"], dict(case["kw"])
    key = jax.random.key(5)
    if kind == "system":
        jpay, tpay = (lambda s: jnp.maximum(1.0 - s[..., 0], 0.0),
                      lambda s: torch.clamp(1.0 - s[..., 0], min=0.0))
    else:
        jpay, tpay = ja.put_payoff(1.0), ta.put_payoff(1.0)
    jkw, tkw = dict(kw), dict(kw)
    if kind != "gbm":
        jkw["model"], tkw["model"] = _models(kind)
    res_j = ja.lsmc_price(jpay, 1.0, RATE, 1.0, n_dates, n_paths=B, key=key,
                          dtype=jnp.float64, **jkw)
    dyn = ta._Dynamics(1.0, RATE, 1.0, n_dates, tkw.pop("sigma", None), tkw.pop("model", None),
                       tkw.pop("scheme", "euler"), tkw.pop("n_sub", 1), tkw.pop("degree"),
                       None, torch.float64, "pricing")
    normals = _price_normals(key, n_dates, kind, dyn.n_sub,
                             getattr(dyn.model, "n_drivers", 1))
    mesh = single_device_mesh("cpu")
    itm = tkw.pop("itm_only", True)
    res_t, paths_t = ta._lsmc(tpay, dyn, n_dates, B, itm, normals, mesh, keep_paths=True)
    # the port's own rule against JAX's frozen rule on the same paths
    res_f, paths_f = ta._lsmc(tpay, dyn, n_dates, B, itm, normals, mesh, keep_paths=True,
                              frozen=res_j["coef"])
    np.testing.assert_allclose(res_f["price"], res_j["price"], rtol=1e-12)
    np.testing.assert_allclose(res_t["price_insample"], res_j["price_insample"], rtol=1e-10)
    flipped = int((paths_t["stop"] != paths_f["stop"]).sum())
    print("%s: %d of %d paths flipped their exercise decision" % (name, flipped, B))
    assert flipped == 0
    np.testing.assert_allclose(res_t["coef"], res_j["coef"], rtol=1e-9,
                               atol=1e-9 * np.abs(res_j["coef"]).max())
    np.testing.assert_allclose(res_t["price"], res_j["price"], rtol=1e-12)
    np.testing.assert_allclose(res_t["european"], res_j["european"], rtol=1e-12)
    assert res_t["exercise_frac"] == pytest.approx(res_j["exercise_frac"], rel=1e-12)
    assert res_t["coef"].shape == (n_dates - 1, dyn.K)


def test_mesh_draws_the_one_device_paths():
    """lsmc_price's keyed paths over SampleMesh(["cpu", "cpu"]) against
    one device: the TSQR fit pools the shards; flips counted and held."""
    dyn = ta._Dynamics(1.0, RATE, 1.0, 10, SIGMA, None, "euler", 1, 4, None,
                       torch.float64, "pricing")
    normals = ta._keyed_panel_normals(3, dyn, 10)
    one, p_one = ta._lsmc(ta.put_payoff(1.0), dyn, 10, 1024, True, normals,
                          single_device_mesh("cpu"), keep_paths=True)
    two, p_two = ta._lsmc(ta.put_payoff(1.0), dyn, 10, 1024, True, normals,
                          SampleMesh(["cpu", "cpu"], group=False), keep_paths=True)
    flipped = _hold(two, p_two, one, p_one, 1024)
    print("mesh: %d of 1024 paths flipped" % flipped)
    assert flipped == 0
    pub = ta.lsmc_price(ta.put_payoff(1.0), 1.0, RATE, 1.0, 10, sigma=SIGMA, degree=4,
                        n_paths=1024, seed=3, dtype=torch.float64, device="cpu")
    assert pub["price"] == one["price"] and np.array_equal(pub["coef"], one["coef"])
    with pytest.raises(ValueError, match="n_paths"):
        ta.lsmc_price(ta.put_payoff(1.0), 1.0, RATE, 1.0, 4, sigma=SIGMA, n_paths=1023,
                      mesh=SampleMesh(["cpu", "cpu"], group=False))


def test_bermudan_binomial_is_the_same_code():
    ja = _ja()
    for kind in ("put", "call"):
        assert ta.bermudan_binomial(1.0, 1.1, 0.05, 0.25, 1.0, 8, n_steps=512, kind=kind) \
            == ja.bermudan_binomial(1.0, 1.1, 0.05, 0.25, 1.0, 8, n_steps=512, kind=kind)
    from mlmc_tpu.pce import total_degree_indices

    assert np.array_equal(ta.total_degree_indices(3, 4), total_degree_indices(3, 4))


def test_gbm_dual_bound_matches_mlmc_tpu_from_frozen_coefficients():
    ja = _ja()
    n_dates, n_inner = 6, 8
    coef = ja.lsmc_price(ja.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, sigma=SIGMA,
                         degree=3, n_paths=B, key=jax.random.key(2), itm_only=False,
                         dtype=jnp.float64)["coef"]
    key = jax.random.key(4)
    res_j = ja.lsmc_dual_bound(ja.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, coef,
                               sigma=SIGMA, n_paths=B, n_inner=n_inner, key=key,
                               dtype=jnp.float64)
    k_path, k_inner = jax.random.split(key)
    z = _date_draws(k_path, n_dates, (B,))
    zh = _date_draws(k_inner, n_dates, (n_inner // 2, B))
    dyn = ta._Dynamics(1.0, RATE, 1.0, n_dates, SIGMA, None, "euler", 1, 3, None,
                       torch.float64, "duals")
    best = ta._dual_gbm(ta.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, coef, dyn, n_inner, B,
                        lambda i: (torch.tensor(z[i - 1]), torch.tensor(zh[i - 1])), "cpu")
    res_t = ta._upper(best, B, 0.0)
    np.testing.assert_allclose(res_t["upper"], res_j["upper"], rtol=1e-10)
    np.testing.assert_allclose(res_t["upper_se"], res_j["upper_se"], rtol=1e-8)


def _model_dual_normals(kk, ik_parts, n_sub, Bl, drivers):
    """(outer [Bl, per_date], inner [n, Bl, per_date]) from JAX's draws."""
    def flat(x, lead):                       # [n_sub, *lead, (drv)] -> [*lead, per_date]
        x = np.asarray(x)
        if drivers == 1:
            x = x[..., None]
        x = np.moveaxis(x, 0, -2)
        return torch.tensor(x.reshape(lead + (n_sub * drivers,)).copy())

    shape = (n_sub, Bl) + ((drivers,) if drivers > 1 else ())
    outer = flat(jax.random.normal(kk, shape, jnp.float64), (Bl,))
    inner = torch.cat([flat(jax.random.normal(k, (n_sub, n, Bl) + shape[2:], jnp.float64),
                            (n, Bl)) for k, n in ik_parts])
    return outer, inner


@pytest.mark.parametrize("kind", ["model", "system"])
def test_model_dual_bound_matches_mlmc_tpu(kind):
    ja = _ja()
    n_dates, n_sub, n_inner = 4, 2, 8
    jm, tm = _models(kind)
    if kind == "system":
        jpay, tpay = (lambda s: jnp.maximum(1.0 - s[..., 0], 0.0),
                      lambda s: torch.clamp(1.0 - s[..., 0], min=0.0))
        drivers = 2
    else:
        jpay, tpay, drivers = ja.put_payoff(1.0), ta.put_payoff(1.0), 1
    coef = ja.lsmc_price(jpay, 1.0, 0.05, 1.0, n_dates, model=jm, n_sub=n_sub, degree=2,
                         n_paths=B, key=jax.random.key(7), itm_only=False,
                         dtype=jnp.float64)["coef"]
    key = jax.random.key(8)
    Bd = 64
    res_j = ja.lsmc_dual_bound(jpay, 1.0, 0.05, 1.0, n_dates, coef, model=jm, n_sub=n_sub,
                               n_paths=Bd, n_inner=n_inner, key=key, dtype=jnp.float64)
    k_path, k_inner = jax.random.split(key)
    keys, ikeys = jax.random.split(k_path, n_dates), jax.random.split(k_inner, n_dates)
    draws = [_model_dual_normals(keys[i], [(ikeys[i], n_inner // 2)], n_sub, Bd, drivers)
             for i in range(n_dates)]
    degree = ta._model_degree(coef.shape[1], tm, None)
    dyn = ta._Dynamics(1.0, 0.05, 1.0, n_dates, None, tm, "euler", n_sub, degree, None,
                       torch.float64, "duals")
    best = ta._dual_model_paths(tpay, dyn, n_dates, torch.tensor(coef), Bd, n_inner, False,
                                lambda i: draws[i - 1], "cpu")[0]
    res_t = ta._upper(best, Bd, 0.0)
    np.testing.assert_allclose(res_t["upper"], res_j["upper"], rtol=1e-10)


def test_multilevel_dual_matches_mlmc_tpu():
    ja = _ja()
    n_dates, n_sub, n0, L = 3, 2, 4, 1
    jm, tm = _models("system")
    jpay = lambda s: jnp.maximum(1.0 - s[..., 0], 0.0)
    tpay = lambda s: torch.clamp(1.0 - s[..., 0], min=0.0)
    coef = ja.lsmc_price(jpay, 1.0, 0.05, 1.0, n_dates, model=jm, n_sub=n_sub, degree=2,
                         n_paths=B, key=jax.random.key(9), itm_only=False,
                         dtype=jnp.float64)["coef"]
    key = jax.random.key(10)
    paths = [64, 32]
    res_j = ja.lsmc_dual_bound_ml(jpay, 1.0, 0.05, 1.0, n_dates, coef, jm, n_sub=n_sub,
                                  n0_inner=n0, n_levels=L, n_paths=paths, key=key,
                                  dtype=jnp.float64)
    lkeys = jax.random.split(key, L + 1)

    def level_normals(l, nl, Bl, coupled):
        k_path, k_inner = jax.random.split(lkeys[l])
        keys = jax.random.split(k_path, n_dates)
        ikeys = jax.random.split(k_inner, n_dates)
        parts = [(list(jax.random.split(ikeys[i])) if coupled else [ikeys[i]])
                 for i in range(n_dates)]
        sizes = [nl // 4, nl // 4] if coupled else [nl // 2]
        draws = [_model_dual_normals(keys[i], list(zip(parts[i], sizes)), n_sub, Bl, 2)
                 for i in range(n_dates)]
        return lambda i: draws[i - 1]

    res_t = ta._dual_ml(tpay, 1.0, 0.05, 1.0, n_dates, coef, tm, "euler", n_sub, None, None,
                        n0, L, paths, torch.float64, "cpu", level_normals)
    np.testing.assert_allclose(res_t["upper"], res_j["upper"], rtol=1e-10)
    np.testing.assert_allclose([lv["mean"] for lv in res_t["levels"]],
                               [lv["mean"] for lv in res_j["levels"]], rtol=1e-9, atol=1e-14)
    assert res_t["inner_evals"] == res_j["inner_evals"]


def test_swing_matches_mlmc_tpu():
    ja = _ja()
    n_dates, Q = 6, 3
    key = jax.random.key(12)
    res_j = ja.lsmc_swing(ja.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, Q, SIGMA, degree=3,
                          n_paths=B, key=key, dtype=jnp.float64)
    z = [torch.tensor(_date_draws(kr, n_dates, (B,)).T.copy())
         for kr in jax.random.split(key)]
    args = (ta.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, Q, SIGMA, 3, B, None,
            torch.float64, "cpu", lambda p: z[p])
    frozen = ta._swing(*args, frozen=res_j["coef"])
    np.testing.assert_allclose(frozen["prices_by_rights"], res_j["prices_by_rights"],
                               rtol=1e-12)
    own = ta._swing(*args)
    np.testing.assert_allclose(own["coef"], res_j["coef"], rtol=1e-9,
                               atol=1e-9 * np.abs(res_j["coef"]).max())
    np.testing.assert_allclose(own["prices_by_rights"], res_j["prices_by_rights"],
                               rtol=1e-12)
    np.testing.assert_allclose(own["price_insample"], res_j["price_insample"], rtol=1e-10)


def test_keyed_prices_bracket_the_tree():
    """The port's own keyed run: the lower bound, the tree and the dual
    upper bound in order (f64, small sizes)."""
    n_dates = 8
    lo = ta.lsmc_price(ta.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, sigma=SIGMA,
                       n_paths=1 << 13, seed=1, dtype=torch.float64, device="cpu")
    surf = ta.lsmc_price(ta.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, sigma=SIGMA,
                         degree=5, itm_only=False, n_paths=1 << 13, seed=2,
                         dtype=torch.float64, device="cpu")
    up = ta.lsmc_dual_bound(ta.put_payoff(1.0), 1.0, RATE, 1.0, n_dates, surf["coef"],
                            sigma=SIGMA, n_paths=1 << 11, n_inner=16, seed=3,
                            dtype=torch.float64, device="cpu")
    tree = ta.bermudan_binomial(1.0, 1.0, RATE, SIGMA, 1.0, n_dates, n_steps=200 * n_dates)
    assert lo["price"] - 4 * lo["price_se"] <= tree <= up["upper"] + 4 * up["upper_se"]
    sw = ta.lsmc_swing(ta.put_payoff(1.0), 1.0, RATE, 1.0, 4, 4, SIGMA, n_paths=1 << 12,
                       dtype=torch.float64, device="cpu")
    assert np.all(np.diff(sw["prices_by_rights"]) > 0)
