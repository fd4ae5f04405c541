"""mlmc_tpu_torch.ops.cuda_kernels: plain versions against mlmc_tpu, and
(on a machine with a GPU) the CUDA kernels against the plain versions.

mlmc_tpu is imported inside the tests that compare with it, so the
``cuda`` tests also run on a GPU machine without JAX:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda``.

Memory mode is held to two references on identical f32 normals made with
numpy:
* mlmc_tpu's Pallas noise kernel in interpret mode (f32 sums with Kahan):
  n_valid exact, everything else within the derived f32 accumulation
  bound ``accumulation_error_bound(S_abs)`` (mlmc_tpu/ops/precision.py);
* mlmc_tpu's exact f64 summation ``f64_reference_moments`` of the same
  f32 per-sample values: within 1e-12 * S_abs (the port computes the same
  f32 per-sample values and sums them in f64, in another order).
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.ops import precision as port_precision

torch.set_num_threads(1)

DOMAIN = (-4.0, 4.0)
STEPS = [0.5, 0.25, 0.125, 0.0625, 0.03125]
FIELDS = [("sums", "abs_sums"), ("sums2", "abs_sums2"),
          ("cov_fine", "abs_cov_fine"), ("cov_coarse", "abs_cov_coarse")]


def _level_noise(n=8192, seed=0):
    """Per-level normals with a few values far outside the domain."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in STEPS:
        x = np.concatenate([rng.normal(size=n - 32),
                            rng.uniform(3.5, 7.0, size=16),
                            -rng.uniform(3.5, 7.0, size=16)])
        rng.shuffle(x)
        out.append(x.astype(np.float32))
    return out


def _jax_precision():
    from mlmc_tpu.ops import precision
    return precision


def _f64_ref(x, level, n_moments, precision=None):
    """Exact f64 summation of the kernel body's f32 per-sample values
    (mlmc_tpu's reference unless another module is given)."""
    precision = precision or _jax_precision()
    return precision.f64_reference_moments(
        x, n_moments, fine_step=STEPS[level],
        coarse_step=STEPS[level - 1] if level else 0.0, domain=DOMAIN,
        is_level0=(level == 0))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --------------------------------------------------------------------- #
# memory mode (plain version) vs mlmc_tpu
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_memory_mode_vs_pallas_interpret(level):
    from mlmc_tpu.ops.pallas_kernels import synth_moment_pipeline_from_noise as jax_from_noise

    bound = _jax_precision().accumulation_error_bound
    xs = _level_noise()
    res = ck.synth_mlmc_pipeline_from_noise(xs, 8, STEPS, domain=DOMAIN,
                                            device="cpu")[level]
    want = jax_from_noise(xs[level], 8, fine_step=STEPS[level],
                          coarse_step=STEPS[level - 1], domain=DOMAIN,
                          chunk=8192, interpret=True)
    ref = _f64_ref(xs[level], level, 8)
    assert int(res.n_valid) == int(want.n_valid) == ref["n_valid"]
    for name, abs_name in FIELDS:
        err = np.abs(getattr(res, name).numpy() - np.asarray(getattr(want, name)))
        assert np.all(err <= bound(ref[abs_name]) + 1e-12), name


@pytest.mark.parametrize("level", [0, 1, 2, 3, 4])
def test_memory_mode_vs_f64_reference(level):
    xs = _level_noise(n=1 << 14, seed=1)
    res = ck.synth_mlmc_pipeline_from_noise(xs, 25, STEPS, domain=DOMAIN,
                                            device="cpu")[level]
    ref = _f64_ref(xs[level], level, 25)
    assert int(res.n_valid) == ref["n_valid"]
    assert res.sums.dtype == torch.float64 and res.n_valid.dtype == torch.int64
    for name, abs_name in FIELDS:
        err = np.abs(getattr(res, name).numpy() - ref[name])
        assert np.all(err <= 1e-12 * np.maximum(ref[abs_name], 1.0)), name
    if level == 0:
        assert not torch.any(res.cov_coarse != 0)


@pytest.mark.parametrize("level", [0, 2])
def test_plain_absolute_sums_match_f64_reference(level):
    """``absolute=True`` gives the S_abs of ``f64_reference_moments``."""
    xs = [torch.from_numpy(x) for x in _level_noise(n=4096, seed=5)]
    res = ck.synth_mlmc_plain(xs, 0, [x.numel() for x in xs], *ck._ladder(STEPS),
                              13, domain=DOMAIN, device="cpu", absolute=True)
    ref = _f64_ref(xs[level].numpy(), level, 13)
    assert int(res.n_valid[level]) == ref["n_valid"]
    for name, abs_name in FIELDS:
        np.testing.assert_allclose(getattr(res, name)[level].numpy(), ref[abs_name],
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_single_level_entry_points_match_multi_level():
    """synth_moment_pipeline(_from_noise) are L=1 calls of the same body."""
    x = _level_noise(seed=2)[2]
    multi = ck.synth_mlmc_pipeline_from_noise(
        [x[:0], x[:0], x], 25, STEPS[:3], domain=DOMAIN, device="cpu")[2]
    single = ck.synth_moment_pipeline_from_noise(
        x, 25, fine_step=STEPS[2], coarse_step=STEPS[1], domain=DOMAIN,
        device="cpu")
    for a, b in zip(multi, single):
        assert torch.equal(a, b)
    lvl0 = ck.synth_moment_pipeline_from_noise(
        x, 9, fine_step=0.5, coarse_step=0.0, domain=DOMAIN, is_level0=True,
        device="cpu")
    ref = _jax_precision().f64_reference_moments(
        x, 9, fine_step=0.5, coarse_step=0.0, domain=DOMAIN, is_level0=True)
    assert int(lvl0.n_valid) == ref["n_valid"]
    np.testing.assert_allclose(lvl0.sums.numpy(), ref["sums"], rtol=1e-12)


def test_rng_mode_draws_the_philox_stream():
    """RNG mode == memory mode fed with philox_normals of each level."""
    n_per_level = [5000, 3000, 1000, 0, 17]
    res = ck.synth_mlmc_pipeline(11, 7, n_per_level, STEPS, domain=DOMAIN,
                                 device="cpu")
    xs = [ck.philox_normals(11, lvl, 0, n) for lvl, n in enumerate(n_per_level)]
    mem = ck.synth_mlmc_pipeline_from_noise(xs, 7, STEPS, domain=DOMAIN, device="cpu")
    for a, b in zip(res, mem):
        for fa, fb in zip(a, b):
            assert torch.equal(fa, fb)
    single = ck.synth_moment_pipeline(11, 7, 5000, fine_step=0.5,
                                      coarse_step=0.0, domain=DOMAIN,
                                      is_level0=True, device="cpu")
    for fa, fb in zip(single, res[0]):
        assert torch.equal(fa, fb)
    assert float(res[0].sums[0]) == float(res[0].n_valid)


@pytest.mark.parametrize("level", [0, 3])
def test_synth_qoi_is_the_kernel_body_qoi(level):
    """``synth_qoi`` is numpy's f32 arithmetic of the QoI bit for bit (the
    values of ``precision.f64_reference_moments``), and kernel C's plain
    version over its QoIs, with kernel A's transform, gives
    ``level_moments_plain``'s accumulators bit for bit."""
    x = _level_noise(n=4096, seed=6)[level]
    x[:4] = [0.0, -0.0, 1e-42, -3.5]
    fine_step, coarse_step = STEPS[level], STEPS[level - 1] if level else 0.0
    fine, coarse = ck.synth_qoi(torch.from_numpy(x), fine_step, coarse_step)
    err = np.sqrt(np.float32(1e-4) + np.abs(x), dtype=np.float32)
    assert fine.dtype == coarse.dtype == torch.float32
    np.testing.assert_array_equal(fine.numpy(), x + np.float32(fine_step) * err)
    np.testing.assert_array_equal(coarse.numpy(), x + np.float32(coarse_step) * err)
    body = ck.level_moments_plain(torch.from_numpy(x), 9, fine_step=fine_step,
                                  coarse_step=coarse_step, has_coarse=level > 0,
                                  domain=DOMAIN)
    streams = ck.pack_streams([fine], [coarse if level else None], [level > 0])
    stream = ck.samples_plain(streams, 9, basis="legendre",
                              consts=ck.transform_constants(DOMAIN, symmetric=True))
    for a, b in zip(body, stream):
        assert torch.equal(a, b[0])


@pytest.mark.parametrize("level", [0, 3])
def test_port_precision_reference_matches_jax(level):
    """The port's copy of the f64 reference and bound equals mlmc_tpu's."""
    x = _level_noise(n=4096, seed=4)[level]
    want = _f64_ref(x, level, 11)
    got = _f64_ref(x, level, 11, precision=port_precision)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])
    assert port_precision.accumulation_error_bound(2.0) == \
        _jax_precision().accumulation_error_bound(2.0)


def test_zero_sample_level_returns_zeros():
    res = ck.synth_mlmc_pipeline(3, 6, [100, 0, 50], STEPS[:3], domain=DOMAIN,
                                 device="cpu")
    assert int(res[1].n_valid) == 0
    for field in res[1]:
        assert not torch.any(field != 0)
    mem = ck.synth_mlmc_pipeline_from_noise(
        [np.zeros(4, np.float32), np.zeros(0, np.float32)], 6, STEPS[:2],
        domain=DOMAIN, device="cpu")
    assert int(mem[1].n_valid) == 0 and not torch.any(mem[1].cov_fine != 0)


def test_mismatched_lengths_raise():
    with pytest.raises(ValueError):
        ck.synth_mlmc_pipeline(0, 5, (100, 100), (0.5, 0.25, 0.125),
                               domain=DOMAIN, device="cpu")
    with pytest.raises(ValueError):
        ck.synth_mlmc_pipeline_from_noise([np.zeros(8, np.float32)], 5,
                                          (0.5, 0.25), domain=DOMAIN, device="cpu")
    with pytest.raises(ValueError):
        ck.synth_mlmc_pipeline(0, ck.R_PAD + 1, (10,), (0.5,), domain=DOMAIN,
                               device="cpu")


# --------------------------------------------------------------------- #
# Philox4x32-10 and Box-Muller
# --------------------------------------------------------------------- #
M32 = 0xFFFFFFFF


@pytest.mark.parametrize("counter,key,want", [
    # Random123 known-answer vectors for philox4x32-10
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((M32, M32, M32, M32), (M32, M32),
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    out = ck.philox4x32_10([torch.tensor([c], dtype=torch.int64) for c in counter], key)
    assert tuple(int(o[0]) for o in out) == want


def _np_box_muller(b0, b1):
    """numpy model of _normal_pair's bit map: (cosine, sine) branch in f64
    of the f32 uniforms (top 24 bits, u1 offset by half an ulp)."""
    i1 = (b0 >> 8).astype(np.int32).astype(np.float32)
    i2 = (b1 >> 8).astype(np.int32).astype(np.float32)
    u1 = i1 * np.float32(1.0 / (1 << 24)) + np.float32(0.5 / (1 << 24))
    u2 = i2 * np.float32(1.0 / (1 << 24))
    r = np.sqrt(-2.0 * np.log(u1.astype(np.float64)))
    angle = np.float32(2 * np.pi) * u2.astype(np.float64)
    return r * np.cos(angle), r * np.sin(angle)


@pytest.mark.parametrize("branch", [0, 1], ids=["cos", "sin"])
def test_box_muller_bit_map_matches_normal_pair(branch):
    """Top 24 bits -> (0, 1) uniforms, u1 offset by half an ulp, as
    mlmc_tpu's _normal_pair; the cosine and the sine branch of Box-Muller
    in f32 (_normal_pair's first and second output)."""
    rng = np.random.default_rng(5)
    b0 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    b1 = rng.integers(0, 1 << 32, size=4096, dtype=np.uint64)
    b0[:3] = [0, M32, 255]  # extremes: smallest and largest u1
    z = ck.box_muller(torch.from_numpy(b0.astype(np.int64)),
                      torch.from_numpy(b1.astype(np.int64)))[branch].numpy()
    want = _np_box_muller(b0, b1)[branch]
    assert np.all(np.isfinite(z)) and z.dtype == np.float32
    np.testing.assert_allclose(z, want, rtol=0, atol=4e-6)


def _np_philox(counter, key):
    """Philox4x32-10 in numpy uint64 arithmetic (a product of two uint32
    words fits), independent of the port's int64 tensor code."""
    c0, c1, c2, c3 = (np.asarray(c, dtype=np.uint64) for c in counter)
    k0, k1 = np.uint64(key[0]), np.uint64(key[1])
    m32 = np.uint64(M32)
    for rnd in range(10):
        if rnd:
            k0 = (k0 + np.uint64(0x9E3779B9)) & m32
            k1 = (k1 + np.uint64(0xBB67AE85)) & m32
        p0 = np.uint64(0xD2511F53) * c0
        p1 = np.uint64(0xCD9E8D57) * c2
        c0, c1, c2, c3 = (p1 >> np.uint64(32)) ^ c1 ^ k0, p1 & m32, \
            (p0 >> np.uint64(32)) ^ c3 ^ k1, p0 & m32
    return c0, c1, c2, c3


def _np_stream(seed, level, start, n):
    """numpy model of the normal stream: index i is slot i & 3 of Philox
    call i >> 2 (counter (call low, call high, level, 0), key (seed low,
    seed high)); slots 0-3 = cos, sin of words (0, 1), cos, sin of (2, 3)."""
    idx = np.arange(start, start + n, dtype=np.uint64)
    q = idx >> np.uint64(2)
    w = _np_philox((q & np.uint64(M32), q >> np.uint64(32),
                    np.full_like(q, level), np.zeros_like(q)),
                   (seed & M32, (seed >> 32) & M32))
    slots = np.stack(_np_box_muller(w[0], w[1]) + _np_box_muller(w[2], w[3]))
    return slots[(idx & np.uint64(3)).astype(np.int64), np.arange(n)]


@pytest.mark.parametrize("start", [0, 1, 2, 3, 77, 2 ** 32 - 3, 2 ** 34 - 3])
@pytest.mark.parametrize("n", [36, 37, 38, 39])
def test_philox_normals_match_a_numpy_model(start, n):
    """philox_normals against an independent numpy model of the stream:
    every residue of the start and the length mod 4, across a quad and
    across the high word of the index (2^32) and of the Philox call
    number (index 2^34)."""
    seed = (7 << 32) | 12345
    z = ck.philox_normals(seed, 5, start, n).numpy()
    assert z.dtype == np.float32 and z.shape == (n,)
    np.testing.assert_allclose(z, _np_stream(seed, 5, start, n), rtol=0, atol=4e-6)


def test_synth_normals_index_mapping_and_statistics():
    z = ck.synth_normals(9, 1 << 16, level=3, device="cpu")
    part = ck.synth_normals(9, 100, level=3, start=1000, device="cpu")
    assert torch.equal(z[1000:1100], part)
    for start in (1, 2, 3, 77, 1001):   # slices that start and end inside quads
        for n in (1, 2, 3, 4, 5, 6, 7, 8, 9, 100, 4099):
            part = ck.synth_normals(9, n, level=3, start=start, device="cpu")
            assert torch.equal(z[start:start + n], part), (start, n)
    assert not torch.equal(ck.synth_normals(9, 100, level=2, device="cpu"),
                           z[:100])
    assert not torch.equal(ck.synth_normals(10, 100, level=3, device="cpu"),
                           z[:100])
    z = z.numpy().astype(np.float64)
    assert abs(z.mean()) < 5 / np.sqrt(z.size)
    assert abs(z.var() - 1) < 5 * np.sqrt(2 / z.size)
    assert st.kstest(z, "norm").pvalue > 1e-3
    for slot in range(4):   # each slot of a Philox call
        assert st.kstest(z[slot::4], "norm").pvalue > 1e-3, slot
    # the cosine and sine of one pair, and neighbouring calls, uncorrelated
    lag1 = np.corrcoef(z[:-1], z[1:])[0, 1]
    assert abs(lag1) < 5 / np.sqrt(z.size), lag1


# --------------------------------------------------------------------- #
# the Gram tile schedule of kernels A and C (host tables)
# --------------------------------------------------------------------- #
def _scheduled_entries(codes, R):
    """(gram, a, b) of every partial entry the reduction writes: entry
    (i, j) of the 16x8 tile (P, J) at a = 16P + i, b = 8J + j, where
    a <= b < R."""
    out = []
    for code in codes.tolist():
        gram, P, J = code >> 16, (code >> 8) & 0xFF, code & 0xFF
        assert 2 * P <= J
        out += [(gram, 16 * P + i, 8 * J + j) for i in range(16) for j in range(8)
                if 16 * P + i <= 8 * J + j < R]
    return out


@pytest.mark.parametrize("has_coarse", [True, False])
def test_tile_schedule_covers_each_entry_once(has_coarse):
    for R in range(1, ck.R_PAD + 1):
        codes = ck._tile_schedule(R, has_coarse)
        grams = (0, 1) if has_coarse else (0,)
        want = sorted((g, a, b) for g in grams for a in range(R) for b in range(a, R))
        got = _scheduled_entries(codes, R)
        assert len(got) == len(set(got)), R      # each entry once
        assert sorted(got) == want, R           # every needed entry
        nb = -(-R // 8)
        n_tiles = sum(nb - 2 * p for p in range((nb + 1) // 2))
        assert codes.shape[0] == len(grams) * n_tiles
        assert ck._gram_partial_size(codes) == codes.shape[0] * 128 + 2 * ck.R_PAD
        if not has_coarse:
            assert not np.any(codes >> 16)       # no coarse tile
            full = ck._tile_schedule(R, True)
            np.testing.assert_array_equal(full[:codes.shape[0]], codes)


def test_block_tables_cover_each_sample_once_coarse_levels_first():
    counts, offsets = [70_000, 5, 0, 131_072], [0, 70_000, 70_005, 70_005]
    hasc = [False, True, True, True]
    blocks, lvl_blocks = ck._block_tables(counts, offsets, hasc, span=1 << 15)
    for lvl, (first, n_blk) in enumerate(lvl_blocks.tolist()):
        mine = blocks[first:first + n_blk]
        assert np.all(mine[:, 0] == lvl)               # contiguous per level
        assert mine[:, 1].tolist() == [b * (1 << 15) for b in range(n_blk)]
        assert int(mine[:, 2].sum()) == counts[lvl]    # every sample once
        np.testing.assert_array_equal(mine[:, 3], offsets[lvl] + mine[:, 1])
    assert lvl_blocks[2].tolist()[1] == 1             # zero-sample level: one empty block
    first_fine = int(lvl_blocks[0][0])
    assert np.all(blocks[:first_fine, 0] != 0)         # coarse levels' blocks first


# --------------------------------------------------------------------- #
# CUDA kernels vs their plain versions (run on a machine with a GPU)
# --------------------------------------------------------------------- #
#: moment counts that exercise every tile count (R <= 8, 16, 24, 32) and
#: the padded edges
CUDA_R = [1, 2, 8, 24, 25, 32]
#: per-level counts: a fine-only level 0 next to coarse levels, one or
#: several 32-sample chunks and 64-sample flushes, a zero-sample level,
#: a single sample, and more than one block (2^16 samples per block)
CUDA_COUNTS = [(1 << 14) + 1, 65, 0, 63, 1, (1 << 16) + 3]
#: per-level counts that end inside a stage of kernel A's rings or wrap them
#: many times: fewer samples than one 32-sample chunk (the fine-only level 0
#: and a coarse level), a 2^16-sample span less one, a whole span, a span
#: and 33 (two blocks), beside a zero-sample level
CUDA_RING_COUNTS = [17, (1 << 16) - 1, 0, (1 << 16) + 33, 1 << 16, 5]
#: RNG mode: CUDA_COUNTS with a last level of four blocks
CUDA_RNG_COUNTS = CUDA_COUNTS[:-1] + [1 << 18]
CUDA_STEPS = STEPS + [STEPS[-1] / 2]


def _noise_counts(counts, seed):
    """Per-level f32 normals of the given sizes, some far outside the domain."""
    rng = np.random.default_rng(seed)
    out = []
    for n in counts:
        x = rng.normal(size=n) * 1.3
        x[5::37] = 6.5      # the first sample stays in the domain
        out.append(x.astype(np.float32))
    return out


def _assert_vs_plain(got, plain, s_abs, n_levels):
    for lvl in range(n_levels):
        assert int(got[lvl].n_valid) == int(plain.n_valid[lvl]), lvl
        for name, _ in FIELDS:
            err = (getattr(got[lvl], name) - getattr(plain, name)[lvl]).abs()
            scale = getattr(s_abs, name)[lvl].clamp(min=1.0)
            assert bool(torch.all(err <= 1e-12 * scale)), (lvl, name)


def _assert_bit_identical(a, b):
    for ra, rb in zip(a, b):
        for fa, fb in zip(ra, rb):
            assert torch.equal(fa, fb)


@pytest.mark.cuda
@pytest.mark.parametrize("counts", [CUDA_COUNTS, CUDA_RING_COUNTS], ids=["levels", "ring"])
@pytest.mark.parametrize("R", CUDA_R)
def test_cuda_memory_mode_vs_plain(cuda_device, R, counts):
    xs = [torch.from_numpy(x).to(cuda_device)
          for x in _noise_counts(counts, seed=R)]
    before = ck.synth_mlmc_cuda.launches
    got = ck.synth_mlmc_pipeline_from_noise(xs, R, CUDA_STEPS, domain=DOMAIN)
    assert ck.synth_mlmc_cuda.launches == before + 1
    args = (xs, 0, counts, *ck._ladder(CUDA_STEPS), R)
    plain, s_abs = (ck.synth_mlmc_plain(*args, domain=DOMAIN, device=cuda_device,
                                        absolute=a) for a in (False, True))
    _assert_vs_plain(got, plain, s_abs, len(counts))
    for lvl in range(len(STEPS)):   # the levels whose steps _f64_ref knows
        if counts[lvl]:
            ref = _f64_ref(xs[lvl].cpu().numpy(), lvl, R, precision=port_precision)
            assert int(got[lvl].n_valid) == ref["n_valid"], lvl
    assert not torch.any(got[0].cov_coarse != 0)          # fine-only level
    assert all(not torch.any(f != 0) for f in got[2])     # zero-sample level
    _assert_bit_identical(got, ck.synth_mlmc_pipeline_from_noise(
        xs, R, CUDA_STEPS, domain=DOMAIN))


@pytest.mark.cuda
@pytest.mark.parametrize("start", [0, 1, 2, 3, 77, 2 ** 32 - 3, 2 ** 34 - 3])
def test_cuda_normals_vs_plain(cuda_device, start):
    """Kernel B equals the plain version on the card bit for bit, from
    every residue of the first index mod 4 and across the high words of
    the index and of the Philox call number; lengths of every residue."""
    for n in ((1 << 20) + 1, 1 << 20, 5, 2):
        before = ck.normals_dump_cuda.launches
        z = ck.synth_normals(4, n, level=2, start=start, device=cuda_device)
        assert ck.normals_dump_cuda.launches == before + 1
        zp = ck.philox_normals(4, 2, start, n, device=cuda_device)
        assert z.shape == (n,) and torch.equal(z, zp), (n, float((z - zp).abs().max()))


#: per-level first indices for kernel A's RNG mode: levels that start
#: inside a quad, as the shards of a sample mesh may
CUDA_STARTS = [None, [1, 2, 3, 77, 5, (1 << 16) - 1]]


@pytest.mark.cuda
@pytest.mark.parametrize("n", [CUDA_RNG_COUNTS, CUDA_RING_COUNTS], ids=["levels", "ring"])
@pytest.mark.parametrize("starts", CUDA_STARTS, ids=["from0", "misaligned"])
@pytest.mark.parametrize("R", CUDA_R)
def test_cuda_rng_mode_vs_plain(cuda_device, R, starts, n):
    got = ck.synth_mlmc_pipeline(5, R, n, CUDA_STEPS, domain=DOMAIN,
                                 device=cuda_device, starts=starts)
    plain, s_abs = (ck.synth_mlmc_plain(None, 5, n, *ck._ladder(CUDA_STEPS), R,
                                        domain=DOMAIN, device=cuda_device,
                                        absolute=a, starts=starts)
                    for a in (False, True))
    _assert_vs_plain(got, plain, s_abs, len(n))
    assert not torch.any(got[0].cov_coarse != 0)
    assert all(not torch.any(f != 0) for f in got[2])
    _assert_bit_identical(got, ck.synth_mlmc_pipeline(
        5, R, n, CUDA_STEPS, domain=DOMAIN, device=cuda_device, starts=starts))
