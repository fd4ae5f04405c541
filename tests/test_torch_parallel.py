"""The sample mesh of mlmc_tpu_torch (``parallel/``) on the CPU: the mesh
itself, the sharded pipelines against mlmc_tpu's and against the
one-device run, the sharded pool, the sharded bootstrap and the PBS shim.

Tolerances:
* the sharded noise pipeline (kernel C's plain version per shard) against
  mlmc_tpu's on ``jax.devices()[:2]`` in interpret mode, on identical f32
  noise: n_valid exact, the sums within the f32 tier's bound
  ``accumulation_error_bound(S_abs)`` of ``ops/precision.py``, as the
  unsharded kernel C parity tests;
* a sharded run against the one-device run of the port (1, 2 and 4 CPU
  shards): counts exact, sums within 1e-13 * S_abs (the samples are the
  same; only the order of the last sums differs);
* sharded pool payloads: bit for bit for the synthetic simulation, within
  1e-10 for the Darcy flow (JAX's own tolerance for the sharded pool);
* the Poisson bootstrap over the mesh: 1e-10 relative to ``mesh=None``.
"""
import warnings

import numpy as np
import pytest
import torch

import mlmc_tpu_torch as mt
from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.parallel import (
    SampleMesh, sample_mesh, sharded_mlmc_step, sharded_synth_pipeline,
    sharded_synth_pipeline_from_noise)
from mlmc_tpu_torch.parallel.mesh import backend_for

torch.set_num_threads(1)

DOMAIN = (-4.0, 4.0)
STEPS = [0.5, 0.25, 0.125]
FIELDS = ("sums", "sums2", "cov_fine", "cov_coarse")


def _cpu_mesh(n):
    return SampleMesh(["cpu"] * n, group=False)


def _assert_within_s_abs(got, want, s_abs, rtol=1e-13):
    """n_valid exact and every sum within rtol * S_abs (per level)."""
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert int(g.n_valid) == int(w.n_valid), lvl
        for f in FIELDS:
            diff = (getattr(g, f) - getattr(w, f)).abs()
            scale = getattr(s_abs, f)[lvl].clamp(min=1.0)
            assert bool((diff <= rtol * scale).all()), (lvl, f, float(diff.max()))


# ---------------------------------------------------------------------- #
# the mesh
# ---------------------------------------------------------------------- #
def test_mesh_shards_bounds_and_helpers():
    mesh = _cpu_mesh(4)
    assert mesh.n_devices == 4 and mesh.n_local == 4 and mesh.world_size == 1
    assert [s for s, _ in mesh.local_shards()] == [0, 1, 2, 3]
    assert mesh.pad_to_shards(13) == 16 and mesh.pad_to_shards(16) == 16
    assert mesh.bounds(12, 2) == (6, 9)
    x = torch.arange(12)
    parts = mesh.shard_batch(x)
    assert [p.tolist() for p in parts] == [[0, 1, 2], [3, 4, 5], [6, 7, 8], [9, 10, 11]]
    assert [p.tolist() for p in mesh.batch_sharding()(x)] == [p.tolist() for p in parts]
    assert mesh.replicated()(x) is x
    assert mesh.axis_name == SampleMesh.AXIS == "samples"
    with pytest.raises(ValueError, match="divisible"):
        mesh.shard_batch(torch.arange(10))


def test_mesh_backend_follows_the_devices():
    assert backend_for(["cpu", "cpu"]) == "gloo"
    assert backend_for([torch.device("cuda", 0)]) == "nccl"
    with pytest.raises(ValueError, match="one kind"):
        backend_for(["cpu", "cuda:0"])
    assert _cpu_mesh(2).backend == "gloo" and _cpu_mesh(2).group is None


def test_mesh_reduce_and_gather_in_shard_order():
    mesh = _cpu_mesh(3)
    per_shard = [(torch.tensor([1.0, 2.0], dtype=torch.float32),
                  [torch.tensor(3, dtype=torch.int32)]) for _ in range(3)]
    out = mesh.reduce(per_shard)
    assert out[0].dtype == torch.float32 and out[0].tolist() == [3.0, 6.0]
    assert out[1][0].dtype == torch.int32 and int(out[1][0]) == 9
    res = mesh.reduce([ck.SynthMomentResult(*(torch.full((2,), float(s))
                                              for _ in range(4)),
                                            torch.tensor(s)) for s in range(3)])
    assert isinstance(res, ck.SynthMomentResult) and int(res.n_valid) == 3
    g = mesh.gather([torch.tensor([[s, s]]) for s in range(3)])
    assert g.tolist() == [[0, 0], [1, 1], [2, 2]]
    with pytest.raises(ValueError, match="local shards"):
        mesh.reduce(per_shard[:2])


def test_sample_mesh_needs_a_card():
    """SampleMesh() is every visible CUDA device: without a card it raises
    instead of running on the CPU; sample_mesh(n) raises past the count."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the mesh takes it")
    with pytest.raises(RuntimeError, match="is_available"):
        SampleMesh()
    with pytest.raises(ValueError, match="only 0 available"):
        sample_mesh(2)


# ---------------------------------------------------------------------- #
# kernel A and kernel C over the mesh
# ---------------------------------------------------------------------- #
def test_per_level_start_draws_the_index_range():
    """Kernel A's per-level first index: a level split at any index draws
    the samples of the whole (the plain version; exact for the counts)."""
    n = [3000, 1000]
    whole = ck.synth_mlmc_pipeline(5, 6, n, STEPS[:2], domain=DOMAIN, device="cpu")
    a = ck.synth_mlmc_pipeline(5, 6, [1234, 1], STEPS[:2], domain=DOMAIN,
                               device="cpu")
    b = ck.synth_mlmc_pipeline(5, 6, [1766, 999], STEPS[:2], domain=DOMAIN,
                               device="cpu", starts=[1234, 1])
    s_abs = ck.synth_mlmc_plain(None, 5, n, *ck._ladder(STEPS[:2]), 6,
                                domain=DOMAIN, device="cpu", absolute=True)
    both = [ck.SynthMomentResult(*(x + y for x, y in zip(ra, rb)))
            for ra, rb in zip(a, b)]
    _assert_within_s_abs(both, whole, s_abs)
    blocks, _ = ck._block_tables([70000, 5], [0, 70000], [True, False],
                                 starts=[1 << 16, 7])
    assert blocks[:, 1].tolist() == [1 << 16, 2 << 16, 7]
    assert blocks[:, 3].tolist() == [0, 1 << 16, 70000]
    with pytest.raises(ValueError, match="starts"):
        ck.synth_mlmc_pipeline(5, 6, n, STEPS[:2], domain=DOMAIN, device="cpu",
                               starts=[0])


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_synth_pipeline_equals_one_device(n_shards):
    n = [8192, 4096, 2048]
    one = ck.synth_mlmc_pipeline(11, 7, n, STEPS, domain=DOMAIN, device="cpu")
    s_abs = ck.synth_mlmc_plain(None, 11, n, *ck._ladder(STEPS), 7,
                                domain=DOMAIN, device="cpu", absolute=True)
    got = sharded_synth_pipeline(_cpu_mesh(n_shards), 7, n, STEPS,
                                 domain=DOMAIN)(11)
    assert all(r.n_valid.dtype == torch.int64 for r in got)
    _assert_within_s_abs(got, one, s_abs)


@pytest.mark.parametrize("n_shards", [2, 3, 4])
def test_sharded_synth_pipeline_draws_one_device_stream(n_shards, monkeypatch):
    """Shard counts that are not multiples of 4: every shard but the first
    starts inside a Philox call's quad of normals. The shards together draw
    the one-device normals bit for bit; the sums agree within 1e-13 S_abs."""
    n = [n_shards * c for c in (2047, 1023, 509)]
    draws = []
    philox_normals = ck.philox_normals

    def recorded(seed, level, start, count, *, device=None):
        z = philox_normals(seed, level, start, count, device=device)
        draws.append((level, start, z))
        return z

    monkeypatch.setattr(ck, "philox_normals", recorded)
    one = ck.synth_mlmc_pipeline(11, 7, n, STEPS, domain=DOMAIN, device="cpu")
    whole = {lvl: z for lvl, start, z in draws}
    assert sorted(whole) == [0, 1, 2] and all(start == 0 for _, start, _ in draws)
    draws.clear()
    got = sharded_synth_pipeline(_cpu_mesh(n_shards), 7, n, STEPS,
                                 domain=DOMAIN)(11)
    for lvl in range(3):
        mine = sorted((start, z) for level, start, z in draws if level == lvl)
        assert [start for start, _ in mine] == [s * n[lvl] // n_shards
                                                for s in range(n_shards)]
        assert torch.equal(torch.cat([z for _, z in mine]), whole[lvl]), lvl
    s_abs = ck.synth_mlmc_plain(None, 11, n, *ck._ladder(STEPS), 7,
                                domain=DOMAIN, device="cpu", absolute=True)
    _assert_within_s_abs(got, one, s_abs)


def test_sharded_synth_pipeline_guards():
    """Counts that do not divide by the device count are rejected, as JAX's."""
    with pytest.raises(ValueError, match="divisible"):
        sharded_synth_pipeline(_cpu_mesh(4), 5, (101, 40), STEPS[:2],
                               domain=DOMAIN)
    step = sharded_synth_pipeline_from_noise(_cpu_mesh(4), 5, STEPS[:2],
                                             domain=DOMAIN)
    with pytest.raises(ValueError, match="divisible"):
        step(np.zeros(10, np.float32), np.zeros(8, np.float32))


def _noise(n_levels, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=n).astype(np.float32) * 1.5 for _ in range(n_levels)]


def test_sharded_noise_pipeline_matches_jax():
    """Two shards of kernel C's plain version against mlmc_tpu's sharded
    noise pipeline on two JAX devices in interpret mode."""
    import jax
    from mlmc_tpu.ops.precision import accumulation_error_bound
    from mlmc_tpu.parallel import SampleMesh as JMesh
    from mlmc_tpu.parallel.sharded_estimate import (
        sharded_synth_pipeline_from_noise as j_from_noise)

    R, steps, chunk = 6, (0.5, 0.25), 1024
    noise = _noise(2, 2048)
    want = j_from_noise(JMesh(jax.devices()[:2]), R, steps, domain=DOMAIN,
                        chunk=chunk, interpret=True)(*noise)
    got = sharded_synth_pipeline_from_noise(_cpu_mesh(2), R, steps,
                                            domain=DOMAIN, chunk=chunk)(*noise)
    # S_abs of the same streams: the absolute terms of the plain version
    fine_l, coarse_l = [], []
    for lvl, x in enumerate(noise):
        x = torch.from_numpy(x)
        err = ck._sqrt_f32(ck._ERR_FLOOR_F32 + x.abs())
        fine_l.append(x + ck._f32(steps[lvl]) * err)
        coarse_l.append(None if lvl == 0 else x + ck._f32(steps[lvl - 1]) * err)
    streams = ck.pack_streams(fine_l, coarse_l, [False, True])
    s_abs = ck.samples_mlmc_plain(streams, R, basis="legendre",
                                  consts=ck.transform_constants(DOMAIN),
                                  absolute=True)
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert int(g.n_valid) == int(np.asarray(w.n_valid)), lvl
        for f in FIELDS:
            err = np.abs(getattr(g, f).numpy() - np.asarray(getattr(w, f), np.float64))
            bound = accumulation_error_bound(getattr(s_abs, f)[lvl].numpy())
            assert np.all(err <= bound + 1e-12), (lvl, f)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_noise_pipeline_equals_one_device(n_shards):
    R, noise = 5, _noise(3, 4096, seed=8)
    one = sharded_synth_pipeline_from_noise(_cpu_mesh(1), R, STEPS,
                                            domain=DOMAIN)(*noise)
    got = sharded_synth_pipeline_from_noise(_cpu_mesh(n_shards), R, STEPS,
                                            domain=DOMAIN)(*noise)
    s_abs = ck.synth_mlmc_plain([torch.from_numpy(x) for x in noise], 0,
                                [4096] * 3, *ck._ladder(STEPS), R,
                                domain=DOMAIN, device="cpu", absolute=True)
    _assert_within_s_abs(got, one, s_abs)


# ---------------------------------------------------------------------- #
# the fused pipeline and FusedMLMC over the mesh
# ---------------------------------------------------------------------- #
def _fns():
    return [mt.SynthSimulation.scalar_batch_fn(h, 0.0 if i == 0 else STEPS[i - 1],
                                               mt.Norm())
            for i, h in enumerate(STEPS)]


def _acc_s_abs(accs):
    """A scale for 1e-13 * S_abs: the fused accumulators of |phi| are
    bounded by the count for Legendre rows clipped to the domain (|P_k|
    <= 1), so S_abs <= 4 n per entry."""
    return [4.0 * max(float(a.n_total), 1.0) for a in accs]


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_mlmc_step_equals_one_device(n_shards):
    mfn = mt.Legendre(6, DOMAIN)
    n = [6000, 2000, 700]
    one = mt.fused_mlmc_moments(_fns(), mfn, 9, n, chunk_size=512, device="cpu")
    got = sharded_mlmc_step(_cpu_mesh(n_shards), _fns(), mfn, n,
                            chunk_size=512)(9)
    for g, w, scale in zip(got, one, _acc_s_abs(one)):
        assert float(g.n_valid) == float(w.n_valid)
        assert float(g.n_total) == float(w.n_total)
        for f in FIELDS:
            diff = float((getattr(g, f) - getattr(w, f)).abs().max())
            assert diff <= 1e-13 * scale, (f, diff)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_fused_mlmc_mesh_equals_one_device(n_shards):
    mfn = mt.Legendre(5, DOMAIN)
    kw = dict(seed=3, chunk_size=256)
    one = mt.FusedMLMC(_fns(), mfn, device="cpu", **kw)
    shard = mt.FusedMLMC(_fns(), mfn, mesh=_cpu_mesh(n_shards), **kw)
    for drv in (one, shard):
        for lvl, n in enumerate((1500, 700, 300)):
            drv._run_level(lvl, n)
            drv._run_level(lvl, n // 3)       # continued, not a chunk multiple
    e1, e2 = one.estimates(), shard.estimates()
    assert e1["n_samples"].tolist() == e2["n_samples"].tolist()
    np.testing.assert_allclose(e2["mean"], e1["mean"], rtol=0, atol=1e-13 * 4)
    np.testing.assert_allclose(e2["cov"], e1["cov"], rtol=0, atol=1e-13 * 4)


def test_fused_continuation_keys_chunks_by_first_index():
    """An extension by a count that is not a chunk multiple draws new
    samples (its chunks start where the level stopped), and a chunk's
    samples depend on its first index alone."""
    from mlmc_tpu_torch.ops.fused_estimate import chunk_generator

    fn = _fns()[0]
    mfn = mt.Legendre(4, DOMAIN)
    a = mt.fused_level_moments(fn, mfn, (1, 0), 300, 256, is_level0=True,
                               device="cpu")
    b = mt.fused_level_moments(fn, mfn, (1, 0), 300, 256, is_level0=True,
                               start_index=300, device="cpu")
    assert not torch.equal(a.sums, b.sums)
    # shard 1 of 2 runs chunk 1 only: the samples of indices 256..299
    half = mt.fused_level_moments(fn, mfn, (1, 0), 300, 256, is_level0=True,
                                  shard=1, n_shards=2, device="cpu")
    x = fn(chunk_generator(1, 0, 256), 44, "cpu")[0]
    assert float(half.n_total) == 44
    assert abs(float(half.sums[1]) - float(mfn.eval_all(x)[:, 1].sum())) < 1e-12


# ---------------------------------------------------------------------- #
# the sharded pool, the bootstrap, the PBS shim
# ---------------------------------------------------------------------- #
def _pool_run(sim, levels, counts, sharding, seed, min_bucket=64):
    storage = mt.DeviceMemory(device="cpu")
    pool = mt.DeviceBatchPool(seed=seed, sharding=sharding, min_bucket=min_bucket,
                              device_results=True, device="cpu")
    sampler = mt.Sampler(storage, pool, sim, levels)
    sampler.set_initial_n_samples(counts)
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    return storage, pool


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_device_pool_synthetic_bit_for_bit(n_shards):
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    ref, pool0 = _pool_run(sim, [[0.1], [0.01]], [101, 42], None, 21)
    got, pool = _pool_run(sim, [[0.1], [0.01]], [101, 42], _cpu_mesh(n_shards), 21)
    for a, b in zip(ref.sample_pairs(), got.sample_pairs()):
        assert a.shape == b.shape and torch.equal(a, b)
    # one dispatch per shard, one blocking fetch per wave as before
    assert pool.n_dispatches == n_shards * pool0.n_dispatches
    assert pool.n_blocking_fetches == pool0.n_blocking_fetches
    assert pool._level_slices(0) == []


def test_sharded_device_pool_renewed_samples():
    """Renewed (failed) samples keep their attempt salt across the split."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    level = sim.level_instance([0.1], [0.0])
    level.level_id = 0
    level.calculate_keyed_batch = mt.SynthSimulation.calculate_keyed_batch
    out = []
    for sharding in (None, _cpu_mesh(3)):
        pool = mt.DeviceBatchPool(seed=5, sharding=sharding, device="cpu",
                                  device_results=True)
        pool.schedule_level_batch(level, np.array([4, 9, 1, 30, 2]), renew=True)
        succ, _, _, _ = pool.get_finished()
        out.append(succ[0][0])
    assert out[0].ids.indices.tolist() == out[1].ids.indices.tolist()
    assert torch.equal(out[0].fine, out[1].fine)
    fresh = mt.SynthSimulation.calculate_keyed_batch(
        level.config_dict, 5, 0, torch.tensor([4, 9]), torch.zeros(2, dtype=torch.int64))
    assert not torch.equal(out[1].fine[:2], fresh[0])   # attempt 1, not 0


def test_sharded_device_pool_darcy():
    """Config 5's Darcy flow over the mesh: the payloads of the unsharded
    pool within 1e-10 (a batch's shape may change the rounding of its
    FFTs and CG reductions)."""
    sim = mt.DiffusionSimulation(dict(field_method="circulant", corr_length=0.3))
    ref, _ = _pool_run(sim, [[1 / 8], [1 / 16]], [12, 6], None, 4, min_bucket=8)
    got, _ = _pool_run(sim, [[1 / 8], [1 / 16]], [12, 6], _cpu_mesh(2), 4,
                       min_bucket=8)
    for a, b in zip(ref.sample_pairs(), got.sample_pairs()):
        a, b = a.double().numpy(), b.double().numpy()
        assert a.shape == b.shape
        np.testing.assert_allclose(b, a, atol=1e-10, rtol=0)


def _bootstrap_estimate():
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    storage, _ = _pool_run(sim, [[0.1], [0.01]], [400, 120], None, 2)
    q = mt.make_root_quantity(storage, sim.result_format())["length"][1]["10"][0, 0]
    return mt.Estimate(q, storage, mt.Legendre(5, DOMAIN))


@pytest.mark.parametrize("n_shards", [2, 4])
def test_poisson_bootstrap_over_the_mesh(n_shards):
    est = _bootstrap_estimate()
    kw = dict(n_subsamples=16, sample_vector=[200, 60], seed=7, replace="poisson")
    est.est_bootstrap_fast(**kw)
    want = {k: getattr(est, k).copy() for k in
            ("mean_bs_mean", "var_bs_mean", "mean_bs_l_vars", "var_bs_l_vars")}
    est.est_bootstrap_fast(mesh=_cpu_mesh(n_shards), **kw)
    for k, v in want.items():
        np.testing.assert_allclose(getattr(est, k), v, rtol=1e-10, atol=1e-300,
                                   err_msg=k)


@pytest.mark.parametrize("replace", [False, True])
def test_mesh_bootstrap_takes_the_poisson_scheme_only(replace):
    est = _bootstrap_estimate()
    with pytest.raises(ValueError, match="poisson"):
        est.est_bootstrap_fast(n_subsamples=8, replace=replace, mesh=_cpu_mesh(2))
    with pytest.raises(ValueError, match="divide"):
        est.est_bootstrap_fast(n_subsamples=9, replace="poisson", mesh=_cpu_mesh(2))


def test_sampling_pool_pbs_shim(tmp_path):
    """The PBS pool is a DeviceBatchPool sharded over the mesh; its PBS
    options are ignored with a DeprecationWarning."""
    sim = mt.SynthSimulation(dict(distr="norm", complexity=2))
    with pytest.warns(DeprecationWarning, match="shim"):
        pool = mt.SamplingPoolPBS(str(tmp_path / "work"), clean=True, debug=False,
                                  device="cpu", n_cores=4, mem="2gb")
    assert isinstance(pool, mt.DeviceBatchPool)
    assert pool._sharding.n_devices == 1 and pool._device.type == "cpu"
    storage = mt.DeviceMemory(device="cpu")
    sampler = mt.Sampler(storage, pool, sim, [[0.1]])
    sampler.set_initial_n_samples([50])
    sampler.schedule_samples()
    sampler.ask_sampling_pool_for_samples()
    ref, _ = _pool_run(sim, [[0.1]], [50], None, 0)
    assert torch.equal(storage.sample_pairs()[0], ref.sample_pairs()[0])
    if not torch.cuda.is_available():
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(RuntimeError, match="is_available"):
                mt.SamplingPoolPBS()


# ---------------------------------------------------------------------- #
# on the card: the kernels per shard
# ---------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n_shards", [2, 3])
def test_cuda_sharded_kernels_equal_one_launch(cuda_device, n_shards):
    """Kernel A over shards whose first indices are not SPAN multiples,
    and kernel C over shards of the noise, against one launch: n_valid
    equal, sums within 1e-13 * S_abs; kernel A launched once per shard."""
    n = [3 * 70001, 3 * 4099, 3 * 65536]
    mesh = SampleMesh([cuda_device] * n_shards, group=False)
    n = [k - k % n_shards for k in n]
    one = ck.synth_mlmc_pipeline(2, 25, n, STEPS, domain=DOMAIN, device=cuda_device)
    s_abs = ck.synth_mlmc_plain(None, 2, n, *ck._ladder(STEPS), 25, domain=DOMAIN,
                                device=cuda_device, absolute=True)
    before = ck.synth_mlmc_cuda.launches
    got = sharded_synth_pipeline(mesh, 25, n, STEPS, domain=DOMAIN)(2)
    assert ck.synth_mlmc_cuda.launches - before == n_shards
    _assert_within_s_abs(got, one, s_abs)
    noise = [torch.from_numpy(x).to(cuda_device) for x in _noise(3, 3 * 2 ** 16)]
    one_c = sharded_synth_pipeline_from_noise(SampleMesh([cuda_device], group=False),
                                              25, STEPS, domain=DOMAIN)(*noise)
    before = ck.samples_mlmc_cuda.launches
    got_c = sharded_synth_pipeline_from_noise(mesh, 25, STEPS, domain=DOMAIN)(*noise)
    assert ck.samples_mlmc_cuda.launches - before == n_shards
    s_abs_c = ck.synth_mlmc_plain(noise, 0, [x.numel() for x in noise],
                                  *ck._ladder(STEPS), 25, domain=DOMAIN,
                                  device=cuda_device, absolute=True)
    _assert_within_s_abs(got_c, one_c, s_abs_c)
