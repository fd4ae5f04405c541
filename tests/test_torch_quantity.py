"""The Quantity algebra and its estimators, mlmc_tpu_torch against mlmc_tpu
on identical stored samples.

Both packages' host ``Memory`` get the same f64 samples (numpy, seeded)
through ``save_samples_bulk``; the port's root quantity evaluates on the
CPU. Chunk values agree to 1e-12 and the estimates (means, variances,
per-level means, counts) to rtol 1e-10 in f64, for each DAG below and for
both of the port's estimate_mean tiers.
"""
import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
import mlmc_tpu_torch.quantity.quantity_estimate as tqe
from mlmc_tpu_torch.quantity.quantity import Quantity as TQuantity

torch.set_num_threads(1)

STEPS = [0.5, 0.25, 0.125]
COUNTS = [900, 300, 120]
RTOL = 1e-10


def _synth_payload(n, lvl, rng):
    """[n, 24] fine/coarse results laid out as SynthSimulation's result
    format (location i adds i on levels > 0), a few NaN samples."""
    x = rng.normal(size=(n, 2))

    def expand(h, level0):
        r = x + h * np.sqrt(1e-4 + np.abs(x))
        parts = [r if level0 else r + i
                 for _q in range(2) for _t in range(3) for i in range(2)]
        return np.concatenate(parts, axis=1)

    fine = expand(STEPS[lvl], lvl == 0)
    coarse = np.zeros_like(fine) if lvl == 0 else expand(STEPS[lvl - 1], False)
    fine[::53, 4] = np.nan
    return fine, coarse


def twin_storages(seed=0, counts=COUNTS, f32_values=False):
    """(mlmc_tpu Memory, port Memory) holding identical samples."""
    from mlmc_tpu import Memory as JMemory, SynthSimulation as JSynth

    rng = np.random.default_rng(seed)
    jst, tst = JMemory(), mt.Memory()
    jst.save_global_data(result_format=JSynth().result_format(),
                         level_parameters=[[h] for h in STEPS[:len(counts)]])
    tst.save_global_data(result_format=mt.SynthSimulation().result_format(),
                         level_parameters=[[h] for h in STEPS[:len(counts)]])
    for lvl, n in enumerate(counts):
        fine, coarse = _synth_payload(n, lvl, rng)
        if f32_values:
            fine = fine.astype(np.float32).astype(np.float64)
            coarse = coarse.astype(np.float32).astype(np.float64)
        ids = ["L%02d_S%07d" % (lvl, i) for i in range(n)]
        jst.save_samples_bulk(lvl, ids, fine, coarse)
        tst.save_samples_bulk(lvl, ids, fine, coarse)
    return jst, tst


def _roots(seed=0):
    from mlmc_tpu import SynthSimulation as JSynth
    from mlmc_tpu.quantity.quantity import make_root_quantity as j_root

    jst, tst = twin_storages(seed)
    return (j_root(jst, JSynth().result_format()),
            mt.make_root_quantity(tst, mt.SynthSimulation().result_format(),
                                  device="cpu"))


#: DAGs built the same way on either package's root (numpy ufuncs reach
#: each package's Quantity through __array_ufunc__)
DAGS = {
    "structured": lambda r, Q: r["length"],
    "time_location": lambda r, Q: r["length"][2]["20"],
    "array_element": lambda r, Q: r["width"][1]["30"][1, 0],
    "config4": lambda r, Q: np.sin(r["length"][1]["10"]) * 2.0
    + r["width"][2]["30"] / 3.0,
    "exp_power": lambda r, Q: np.power(np.exp(r["length"][3]["20"] / 4.0) - 1.0, 2),
    "maximum_rsub": lambda r, Q: 1.0 - np.maximum(r["width"][3]["40"], 0.5),
    "time_interpolation": lambda r, Q: r["length"].time_interpolation(2.5)["10"],
    "mask": lambda r, Q: (lambda e: e.mask(e < 1.0))(
        np.sin(r["length"][1]["10"]) * 2.0 + r["width"][2]["30"] / 3.0),
    "select": lambda r, Q: (lambda q: q.select(q > -1.0, q < 3.0))(
        r["length"][1]["10"][0]),
    "qarray": lambda r, Q: Q.QArray([[r["length"][1]["10"][0],
                                      r["width"][2]["40"][1]]]),
}


def _jq():
    from mlmc_tpu.quantity.quantity import Quantity

    return Quantity


@pytest.mark.parametrize("name", sorted(DAGS))
def test_chunk_values_match_jax(name):
    from mlmc_tpu.quantity.quantity_spec import ChunkSpec as JChunk

    jr, tr = _roots()
    jq, tq = DAGS[name](jr, _jq()), DAGS[name](tr, TQuantity)
    assert tq.size() == jq.size() and tq.traceable() == jq.traceable()
    for lvl, n in enumerate(COUNTS):
        spec = dict(chunk_id=0, chunk_slice=slice(0, n, 1), level_id=lvl)
        want = np.asarray(jq.samples(JChunk(**spec)))
        got = tq.samples(mt.ChunkSpec(**spec))
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-14)


def _assert_means_equal(got, want):
    assert np.array_equal(got.n_samples, want.n_samples)
    assert np.array_equal(got.n_rm_samples, want.n_rm_samples)
    for field in ("mean", "var", "l_means", "l_vars"):
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(want, field)),
                                   rtol=RTOL, atol=1e-14, err_msg=field)


# select removes samples: it has no whole-level tier
@pytest.mark.parametrize("name,single_dispatch", [
    (name, sd) for name in sorted(DAGS) for sd in (False, True)
    if not (sd and name == "select")])
def test_estimate_mean_of_moments_matches_jax(name, single_dispatch):
    import mlmc_tpu.moments as jm
    import mlmc_tpu.quantity.quantity_estimate as jqe

    jr, tr = _roots(seed=1)
    jq, tq = DAGS[name](jr, _jq()), DAGS[name](tr, TQuantity)
    want = jqe.estimate_mean(jqe.moments(jq, jm.Legendre(6, (-4.0, 6.0))))
    got = tqe.estimate_mean(tqe.moments(tq, mt.Legendre(6, (-4.0, 6.0))),
                            single_dispatch=single_dispatch)
    _assert_means_equal(got, want)


@pytest.mark.parametrize("name", ["config4", "time_location", "select"])
def test_estimate_mean_of_covariance_matches_jax(name):
    import mlmc_tpu.moments as jm
    import mlmc_tpu.quantity.quantity_estimate as jqe

    jr, tr = _roots(seed=2)
    jq, tq = DAGS[name](jr, _jq()), DAGS[name](tr, TQuantity)
    want = jqe.estimate_mean(jqe.covariance(jq, jm.Legendre(5, (-4.0, 6.0))))
    got = tqe.estimate_mean(tqe.covariance(tq, mt.Legendre(5, (-4.0, 6.0))))
    _assert_means_equal(got, want)
    assert np.asarray(got.mean).shape == np.asarray(want.mean).shape


def test_single_moment_and_plain_mean_match_jax():
    import mlmc_tpu.moments as jm
    import mlmc_tpu.quantity.quantity_estimate as jqe

    jr, tr = _roots(seed=3)
    jq, tq = jr["width"][2]["40"], tr["width"][2]["40"]
    _assert_means_equal(tqe.estimate_mean(tq), jqe.estimate_mean(jq))
    _assert_means_equal(
        tqe.estimate_mean(tqe.moment(tq, mt.Monomial(4, (-3.0, 6.0)), i=3)),
        jqe.estimate_mean(jqe.moment(jq, jm.Monomial(4, (-3.0, 6.0)), i=3)))
    # structural indexing of a QuantityMean distributes over the levels
    sub_t = tqe.estimate_mean(tr["width"][2])["40"]
    sub_j = jqe.estimate_mean(jr["width"][2])["40"]
    _assert_means_equal(sub_t, sub_j)


def test_mask_nan_samples_matches_jax():
    import mlmc_tpu.quantity.quantity_estimate as jqe

    chunk = np.random.default_rng(0).normal(size=(3, 40, 2))
    chunk[1, 7, 0] = np.nan
    chunk[2, 30, 1] = np.nan
    want, n_want = jqe.mask_nan_samples(chunk)
    for x in (chunk, torch.from_numpy(chunk)):
        got, n_got = tqe.mask_nan_samples(x)
        assert n_got == n_want == 2
        np.testing.assert_array_equal(np.asarray(got), want)


def test_algebra_guards():
    _, tr = _roots()
    with pytest.raises(TypeError):
        tr["length"].select(tr["length"])            # not a Bool condition
    sel = tr["length"][1]["10"].select(tr["length"][1]["10"] > 0.0)
    with pytest.raises(ValueError):
        sel + tr["length"][1]["10"]                  # two populations
    with pytest.raises(ValueError):
        TQuantity.wrap(object())
    c = TQuantity.wrap(2.0) * 3.0                    # constants fold eagerly
    assert isinstance(c, mt.QuantityConst) and float(c._value.ravel()[0]) == 6.0
