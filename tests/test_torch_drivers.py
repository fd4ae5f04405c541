"""The drivers that take ``mesh=`` (``cdf_estimate``, ``cmlmc``, ``ml2r``,
``unbiased``): mlmc_tpu_torch against mlmc_tpu on identical draws, and
mesh-size invariance in the port, on the CPU.

Identical draws: mlmc_tpu's drivers draw sample i of level l from the key
``fold_in(fold_in(key(seed), l), i)``. A table of those draws (two
normals per sample) is computed once in JAX by that derivation; the JAX
level function draws them from its keys, the port's looks them up by the
sample indices of its ``SampleKeys``. Both drivers then see the same
samples, and must take the same decisions (counts, levels, stages) and
agree on means and variances to 1e-10 relative (f64 on both sides; pow
and sum order may differ in the last bits). The weights and kernels
agree element-wise to 1e-12.

Mesh-size invariance (1, 2 and 4 CPU shards of the port): decisions
equal, means within 1e-12 relative; the chunk guard raises as JAX's.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch import cdf_estimate as tcdf
from mlmc_tpu_torch import unbiased as tunb
from mlmc_tpu_torch.parallel import SampleMesh

torch.set_num_threads(1)

RTOL = 1e-10


def _cpu_mesh(n):
    return SampleMesh(["cpu"] * n, group=False)


# ---------------------------------------------------------------------- #
# identical draws for both packages
# ---------------------------------------------------------------------- #
def _jax_table(seed, level, n):
    """[n, 2] normals of samples 0..n-1 of ``level``, as the JAX drivers
    key them."""
    import jax
    import jax.numpy as jnp

    lkey = jax.random.fold_in(jax.random.key(seed), level)
    keys = jax.vmap(lambda i: jax.random.fold_in(lkey, i))(
        jnp.arange(n, dtype=jnp.uint32))
    return np.asarray(jax.vmap(lambda k: jax.random.normal(k, (2,)))(keys))


def _tables(seed, counts):
    return {lvl: torch.from_numpy(_jax_table(seed, lvl, int(n)).copy())
            for lvl, n in enumerate(counts) if n}


def _lookup(tables):
    return lambda keys: tables[keys.level][keys.indices]


def _keyed(keys):
    """The port's own draws of a chunk: two keyed normals per sample."""
    return keys.normals(2).to(torch.float64)


def _torch_ones(x):
    return torch.ones_like(x, dtype=torch.bool)


# the hierarchies, written once over ``draw(keys) -> [C, 2]`` normals and
# ``ones(x)`` valid flags: the same arithmetic runs on jnp and on torch
def _gauss_pair(draw, ones=_torch_ones, c=0.5, rate=1.0):
    def fn(level, keys):
        xy = draw(keys)
        x, y = xy[:, 0], xy[:, 1]
        fine = x + c * 2.0 ** (-rate * level) * y
        coarse = (x + c * 2.0 ** (-rate * (level - 1)) * y if level > 0
                  else 0.0 * x)
        return fine, coarse, ones(x)
    return fn


def _poly_pair(draw, h, ones=_torch_ones, c0=2.0, c1=0.5, c2=0.3, noise=0.2,
               jump=0.3, beta=1.5):
    def fn(level, keys):
        zz = draw(keys)
        z, zc = zz[:, 0], zz[:, 1]

        def y(hl):
            return (c0 + c1 * hl + c2 * hl * hl + noise * z
                    + jump * hl ** (beta / 2.0) * zc)
        fine = y(h[level])
        coarse = y(h[level - 1]) if level else 0.0 * z
        return fine, coarse, ones(z)
    return fn


def _unbiased_fn(draw, ones=None, mean=1.0, c=0.5, rate=1.0, noise=1.0):
    def fn(level, keys):
        za = draw(keys)
        z, a = za[:, 0], za[:, 1]
        if level == 0:
            return mean + noise * z + c * (1.0 + a)
        return (c * (2.0 ** (-rate * level) - 2.0 ** (-rate * (level - 1)))
                * (1.0 + a))
    return fn


def _jax_version(make, *args):
    """``make``'s hierarchy over JAX keys: the draws from the keys, jnp
    valid flags."""
    import jax
    import jax.numpy as jnp

    def draw(keys):
        return jax.vmap(lambda k: jax.random.normal(k, (2,)))(keys)

    return make(draw, *args, ones=lambda x: jnp.ones(x.shape, bool))


# ---------------------------------------------------------------------- #
# element-wise helpers
# ---------------------------------------------------------------------- #
@pytest.mark.parametrize("order", [2, 4])
def test_smoothed_indicator_matches_jax(order):
    from mlmc_tpu import cdf_estimate as jcdf

    s = np.linspace(-1.5, 1.5, 301)
    np.testing.assert_allclose(tcdf.smoothed_indicator(s, order).numpy(),
                               np.asarray(jcdf.smoothed_indicator(s, order)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tcdf._kernel_pdf(torch.from_numpy(s), order).numpy(),
                               np.asarray(jcdf._kernel_pdf(s, order)),
                               rtol=1e-12, atol=1e-12)
    with pytest.raises(ValueError, match="order"):
        tcdf.smoothed_indicator(s, 3)


@pytest.mark.parametrize("h,alpha", [([0.5, 0.25, 0.125], 1.0),
                                     ([1.0, 0.5, 0.25, 0.125, 0.0625], 1.0),
                                     ([0.3, 0.1, 0.05, 0.01], 0.5)])
def test_ml2r_weights_match_jax(h, alpha):
    from mlmc_tpu.ml2r import ml2r_weights as j_weights

    w, W = mt.ml2r_weights(h, alpha)
    jw, jW = j_weights(h, alpha)
    np.testing.assert_allclose(w, jw, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(W, jW, rtol=1e-12, atol=1e-12)
    assert W[0] == pytest.approx(1.0, abs=1e-12)


def test_ml2r_weights_guards():
    with pytest.raises(ValueError, match="decrease"):
        mt.ml2r_weights([0.5, 0.5])
    with pytest.raises(ValueError, match="ill-conditioned"):
        mt.ml2r_weights([0.5 ** k for k in range(16)], alpha=0.25)


def test_geometric_levels_match_jax():
    from mlmc_tpu.unbiased import GeometricLevels as JGeo

    lv = np.arange(20)
    for r in (0.2, 0.4, 0.7):
        np.testing.assert_allclose(mt.GeometricLevels(r).p(lv), JGeo(r).p(lv),
                                   rtol=1e-12)
        np.testing.assert_allclose(mt.GeometricLevels(r).tail(lv),
                                   JGeo(r).tail(lv), rtol=1e-12)
    assert mt.GeometricLevels.from_rates(2.0, 1.0).r == pytest.approx(
        JGeo.from_rates(2.0, 1.0).r, rel=1e-12)
    with pytest.raises(ValueError, match="beta"):
        mt.GeometricLevels.from_rates(1.0, 1.0)


# ---------------------------------------------------------------------- #
# the drivers against mlmc_tpu on identical draws
# ---------------------------------------------------------------------- #
def test_multilevel_cdf_matches_jax():
    from mlmc_tpu.cdf_estimate import MultilevelCDF as JCDF

    grid = np.linspace(-3.0, 3.0, 25)
    kw = dict(n_levels=3, grid=grid, bandwidth=[0.3, 0.2, 0.1], seed=13,
              chunk_size=256)
    counts = [768, 512, 256]
    j = JCDF(_jax_version(_gauss_pair), **kw)
    t = mt.MultilevelCDF(_gauss_pair(_lookup(_tables(13, counts))), device="cpu",
                         **kw)
    for lv, n in enumerate(counts):
        j.extend(lv, n)
        t.extend(lv, n)
    ej, et = j.estimates(), t.estimates()
    assert ej["n_samples"].tolist() == et["n_samples"].tolist() == counts
    for k in ("cdf", "cdf_raw", "cdf_var", "pdf", "pdf_var"):
        np.testing.assert_allclose(et[k], ej[k], rtol=RTOL, atol=1e-14, err_msg=k)
    qj, sj = j.quantiles([0.3, 0.5, 0.7])
    qt, st_ = t.quantiles([0.3, 0.5, 0.7])
    np.testing.assert_allclose(qt, qj, rtol=RTOL)
    np.testing.assert_allclose(st_, sj, rtol=RTOL)


def test_cmlmc_matches_jax():
    from mlmc_tpu.cmlmc import cmlmc as j_cmlmc

    steps = [0.5 ** k for k in range(6)]
    kw = dict(eps=3e-2, seed=1, n_stages=2, n_pilot=256, chunk_size=256,
              cost_fn=lambda lv: 2.0 ** lv)
    rj = j_cmlmc(_jax_version(_poly_pair, steps), steps, **kw)
    counts = list(rj["n_per_level"])
    rt = mt.cmlmc(_poly_pair(_lookup(_tables(1, counts)), steps), steps,
                  device="cpu", **kw)
    assert rt["n_levels"] == rj["n_levels"]
    assert rt["n_per_level"].tolist() == counts
    assert [h["n_levels"] for h in rt["stage_history"]] == \
        [h["n_levels"] for h in rj["stage_history"]]
    for k in ("mean", "se", "bias"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(rt["level_means"], rj["level_means"], rtol=RTOL)
    np.testing.assert_allclose(rt["level_vars"], rj["level_vars"], rtol=RTOL)


def test_ml2r_matches_jax():
    from mlmc_tpu.ml2r import ml2r as j_ml2r

    h = [0.5, 0.25, 0.125]
    kw = dict(target_var=2e-5, alpha=1.0, seed=4, chunk_size=256, n_pilot=512,
              cost_fn=lambda lv: 2.0 ** lv)
    rj = j_ml2r(_jax_version(_poly_pair, h), h, **kw)
    counts = list(rj["n_per_level"])
    rt = mt.ml2r(_poly_pair(_lookup(_tables(4, counts)), h), h, device="cpu", **kw)
    assert rt["n_per_level"].tolist() == counts and rt["rounds"] == rj["rounds"]
    for k in ("mean", "mean_mlmc", "var"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(rt["level_vars"], rj["level_vars"], rtol=RTOL)


@pytest.mark.parametrize("estimator", ["single", "coupled"])
def test_unbiased_matches_jax(estimator):
    from mlmc_tpu.unbiased import GeometricLevels as JGeo, UnbiasedMLMC as JUnb

    chunk = 256
    j = JUnb(_jax_version(_unbiased_fn), JGeo(0.35), estimator=estimator,
             seed=21, chunk_size=chunk, cost_fn=lambda lv: 2.0 ** lv)
    j.sample(800)
    ej = j.estimates()
    # the port's chunks also evaluate the masked tail of a level's last
    # chunk: the table covers whole chunks
    counts = [-(-int(n) // chunk) * chunk for n in ej["n_samples"]]
    t = mt.UnbiasedMLMC(_unbiased_fn(_lookup(_tables(21, counts))),
                        mt.GeometricLevels(0.35), estimator=estimator, seed=21,
                        chunk_size=chunk, cost_fn=lambda lv: 2.0 ** lv,
                        device="cpu")
    t.sample(800)
    et = t.estimates()
    assert et["levels"].tolist() == ej["levels"].tolist()
    assert et["n_samples"].tolist() == ej["n_samples"].tolist()
    for k in ("mean", "var", "var_per_draw", "cost_per_draw"):
        np.testing.assert_allclose(et[k], ej[k], rtol=RTOL, err_msg=k)
    np.testing.assert_allclose(et["level_means"], ej["level_means"], rtol=RTOL)


# ---------------------------------------------------------------------- #
# mesh-size invariance in the port
# ---------------------------------------------------------------------- #
def _invariant(run, keys, n_shards):
    one, shard = run(None), run(_cpu_mesh(n_shards))
    for k in keys:
        a, b = np.asarray(one[k]), np.asarray(shard[k])
        if a.dtype.kind in "iub":
            assert a.tolist() == b.tolist(), k
        else:
            np.testing.assert_allclose(b, a, rtol=1e-12, atol=1e-15, err_msg=k)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_cdf_mesh_invariance(n_shards):
    def run(mesh):
        m = mt.MultilevelCDF(_gauss_pair(_keyed), 3, np.linspace(-3, 3, 21), 0.2,
                             seed=5, chunk_size=256, mesh=mesh, device="cpu")
        for lv in range(3):
            m.extend(lv, 512)
            m.extend(lv, 300)
        return m.estimates()
    _invariant(run, ("n_samples", "cdf", "cdf_var", "pdf", "pdf_var"), n_shards)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_cmlmc_mesh_invariance(n_shards):
    steps = [0.5 ** k for k in range(6)]

    def run(mesh):
        r = mt.cmlmc(_poly_pair(_keyed, steps), steps, eps=3e-2, seed=6,
                     n_stages=2, n_pilot=256, chunk_size=256,
                     cost_fn=lambda lv: 2.0 ** lv, mesh=mesh, device="cpu")
        r["stage_levels"] = np.array([h["n_levels"] for h in r["stage_history"]])
        return r
    _invariant(run, ("n_levels", "n_per_level", "stage_levels", "mean",
                     "level_means", "level_vars"), n_shards)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_ml2r_mesh_invariance(n_shards):
    h = [0.5, 0.25, 0.125]

    def run(mesh):
        return mt.ml2r(_poly_pair(_keyed, h), h, target_var=2e-5, seed=4,
                       chunk_size=256, n_pilot=512, cost_fn=lambda lv: 2.0 ** lv,
                       mesh=mesh, device="cpu")
    _invariant(run, ("n_per_level", "rounds", "mean", "mean_mlmc", "level_means"),
               n_shards)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_unbiased_mesh_invariance(n_shards):
    fn, _ = tunb.synth_unbiased_level_fn(mean=1.0)

    def run(mesh):
        m = mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.4), estimator="coupled",
                            seed=21, chunk_size=256, mesh=mesh, device="cpu",
                            cost_fn=lambda lv: 2.0 ** lv)
        m.sample(700)
        return m.estimates()
    _invariant(run, ("levels", "n_samples", "mean", "var_per_draw", "level_means"),
               n_shards)


def _driver_with_chunk(name, chunk, mesh):
    steps = [0.5, 0.25]
    if name == "cdf":
        return mt.MultilevelCDF(_gauss_pair(_keyed), 2, [0.0, 1.0], 0.1,
                                chunk_size=chunk, mesh=mesh)
    if name == "cmlmc":
        return mt.cmlmc(_poly_pair(_keyed, steps), steps, eps=1e-2,
                        chunk_size=chunk, mesh=mesh)
    if name == "ml2r":
        return mt.ml2r(_poly_pair(_keyed, steps), steps, target_var=1e-6,
                       chunk_size=chunk, mesh=mesh)
    fn, _ = tunb.synth_unbiased_level_fn()
    return mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.5), chunk_size=chunk,
                           mesh=mesh)


@pytest.mark.parametrize("name", ["cdf", "cmlmc", "ml2r", "unbiased"])
def test_mesh_chunk_divisibility_validated(name):
    with pytest.raises(ValueError, match="divide"):
        _driver_with_chunk(name, 10, _cpu_mesh(4))


def test_unbiased_per_level_chunk_guard():
    fn, _ = tunb.synth_unbiased_level_fn()
    m = mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.5), mesh=_cpu_mesh(2),
                        chunk_size=lambda lv: 256 if lv == 0 else 15)
    with pytest.raises(ValueError, match="divide"):
        for _ in range(20):
            m.sample(200)


def test_unbiased_synthetic_limit():
    """The port's own keyed synthetic hierarchy telescopes to its mean."""
    fn, exact = tunb.synth_unbiased_level_fn(mean=1.5)
    m = mt.UnbiasedMLMC(fn, mt.GeometricLevels(0.4), seed=3, chunk_size=512,
                        device="cpu", cost_fn=lambda lv: 2.0 ** lv)
    m.sample(4000)
    est = m.estimates()
    assert abs(est["mean"] - exact) < 6 * np.sqrt(est["var"])


def test_simulation_pair_fn_drives_the_cdf():
    """simulation_pair_fn binds the keyed batch: the synthetic simulation's
    CDF over a 2-shard mesh equals the one-device run, and a simulation
    without a keyed batch path is refused."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    pair_fn, n_levels = mt.simulation_pair_fn(sim, [[0.5], [0.25]], component=3)
    assert n_levels == 2
    est = []
    for mesh in (None, _cpu_mesh(2)):
        m = mt.MultilevelCDF(pair_fn, n_levels, np.linspace(-3, 5, 17), 0.3,
                             seed=2, chunk_size=128, mesh=mesh, device="cpu")
        for lv in range(n_levels):
            m.extend(lv, 256)
        est.append(m.estimates())
    assert est[0]["n_samples"].tolist() == est[1]["n_samples"].tolist() == [256, 256]
    np.testing.assert_allclose(est[1]["cdf"], est[0]["cdf"], rtol=1e-12, atol=1e-15)
    assert est[0]["cdf"][-1] > 0.9

    class NoBatch:
        pass

    with pytest.raises(ValueError, match="batch path"):
        mt.simulation_pair_fn(NoBatch(), [[0.5]])


# ---------------------------------------------------------------------- #
# the unbiased SDE ladder (sde_unbiased_level_fn)
# ---------------------------------------------------------------------- #
def _sde_call_sims(strike=1.05):
    import mlmc_tpu.sim.sde as js
    from mlmc_tpu_torch.sim import sde as ts

    disc = float(np.exp(-0.05))
    kw = dict(scheme="milstein", total_time=1.0)
    return (js.SDESimulation(dict(model=js.gbm(0.05, 0.2, 1.0),
                                  payoff=js.european_call(strike, disc), **kw)),
            ts.SDESimulation(dict(model=ts.gbm(0.05, 0.2, 1.0),
                                  payoff=ts.european_call(strike, disc), **kw)))


@pytest.mark.parametrize("level", [0, 1, 2])
def test_sde_unbiased_corrections_match_jax(level):
    """The port's level-l correction (float64 state: 'df64') from the
    normals that JAX's keys give each coarse step equals JAX's level
    function (float64 on the CPU) to 1e-12 relative."""
    import jax
    import jax.numpy as jnp
    from mlmc_tpu.unbiased import sde_unbiased_level_fn as jfn
    from mlmc_tpu_torch.sim import sde as ts

    n0, refine = 2, 2
    sim_j, sim_t = _sde_call_sims()
    keys = jax.random.split(jax.random.key(5), 32)
    want = np.asarray(jfn(sim_j, n0=n0, refine=refine, precision="float")(level, keys))
    n_f = n0 * refine ** level
    m = 1 if level == 0 else refine
    trips = n_f // m
    z = jax.jit(jax.vmap(lambda k: jnp.concatenate([
        jax.random.normal(jax.random.fold_in(k, c), (m,)) for c in range(trips)])))(keys)
    coarse = [0.0] if level == 0 else [1.0 / (n_f // refine)]
    cfg = dict(sim_t.level_instance([1.0 / n_f], coarse).config_dict, precision="df64")
    fine, coarse_v, _ = ts.SDESimulation._from_draws(cfg, torch.tensor(np.asarray(z),
                                                                       dtype=torch.float32))
    got = (fine[:, 0] - coarse_v[:, 0]).numpy()
    # the port's float32 draws widened to float64 against JAX's float64 ones
    z64 = torch.tensor(np.asarray(z, np.float32).astype(np.float64))
    f64, c64, _ = ts.SDESimulation._from_draws(cfg, z64)
    assert fine.dtype == torch.float64 and np.array_equal(got, (f64 - c64)[:, 0].numpy())
    f_ref, c_ref, _ = ts.SDESimulation._from_draws(cfg, torch.tensor(np.asarray(z)))
    np.testing.assert_allclose((f_ref - c_ref)[:, 0].numpy(), want, rtol=1e-12, atol=1e-15)


def test_sde_unbiased_level_fn_is_keyed_and_loud_past_the_stream():
    """The port's level function draws the keyed normals of its samples;
    a level past the keyed stream's 2^22 numbers per sample raises."""
    from mlmc_tpu_torch.random.keyed import SampleKeys, keyed_normals
    from mlmc_tpu_torch.sim import sde as ts

    _, sim = _sde_call_sims()
    fn = tunb.sde_unbiased_level_fn(sim, n0=8, refine=4)
    idx = torch.arange(64)
    got = fn(2, SampleKeys(3, 2, idx))
    cfg = dict(sim.level_instance([1 / 128], [1 / 32]).config_dict, precision="df64")
    fine, coarse, _ = ts.SDESimulation._from_draws(
        cfg, keyed_normals(3, 2, idx, torch.zeros_like(idx), 128))
    assert got.dtype == torch.float64 and torch.equal(got, (fine - coarse)[:, 0])
    with pytest.raises(ValueError, match="Philox calls"):
        fn(10, SampleKeys(3, 10, idx[:2]))                  # 8 * 4^10 = 2^23 normals
    with pytest.raises(ValueError, match="payoff"):
        tunb.sde_unbiased_level_fn(ts.SDESimulation(dict(qoi="functionals")))


def test_sde_unbiased_prices_black_scholes():
    """Rhee-Glynn coupled-sum over the Milstein ladder (n0=4, refine=4,
    r=1/8) on the CPU: within 6 se of Black-Scholes, no discretization
    bias; over two shards the same decisions and means."""
    from mlmc_tpu_torch.sim import sde as ts

    _, sim = _sde_call_sims()
    bs = ts.black_scholes_call(1.0, 1.05, 0.05, 0.2, 1.0)

    def run(mesh):
        m = mt.UnbiasedMLMC(tunb.sde_unbiased_level_fn(sim, n0=4, refine=4),
                            mt.GeometricLevels(0.125), estimator="coupled", seed=11,
                            chunk_size=lambda lv: max(1024 >> (2 * lv), 64),
                            cost_fn=lambda lv: 4.0 ** lv, mesh=mesh,
                            device="cpu" if mesh is None else None)
        return m.run(target_var=4e-6, n_init=2048)

    one = run(None)
    assert one["target_met"] and abs(one["mean"] - bs) < 6 * np.sqrt(one["var"])
    two = run(_cpu_mesh(2))
    assert two["levels"].tolist() == one["levels"].tolist()
    assert two["n_samples"].tolist() == one["n_samples"].tolist()
    np.testing.assert_allclose(two["mean"], one["mean"], rtol=1e-12)
