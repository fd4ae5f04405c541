"""The block tables of kernels A, C and D (``cuda_kernels._block_tables``)
against the per-block loop they were first built by, kept here as the
reference: equal arrays, values and dtypes, on the CPU; and (on a machine
with a GPU) the kernels' outputs from either table bit for bit.

No JAX here, so the ``cuda`` tests run on a GPU machine without it:
``python -m pytest --noconftest tests/test_torch_block_tables.py -m cuda``.
"""
import numpy as np
import pytest
import torch

from mlmc_tpu_torch.ops import cuda_kernels as ck


def _block_tables_loop(n_per_level, x_offsets, has_coarse, span=ck.SPAN,
                       starts=None):
    """The reference: one tuple appended per block."""
    blocks, lvl_blocks = [], [None] * len(n_per_level)
    order = sorted(range(len(n_per_level)), key=lambda lvl: not has_coarse[lvl])
    for lvl in order:
        n = int(n_per_level[lvl])
        n_blk = max(-(-n // span), 1)
        lvl_blocks[lvl] = (len(blocks), n_blk)
        first = 0 if starts is None else int(starts[lvl])
        for b in range(n_blk):
            start = b * span
            blocks.append((lvl, first + start, max(min(span, n - start), 0),
                           int(x_offsets[lvl]) + start))
    return (np.asarray(blocks, dtype=np.int64),
            np.asarray(lvl_blocks, dtype=np.int64))


def _packed_offsets(counts):
    return tuple(int(o) for o in np.concatenate([[0], np.cumsum(counts)])[:-1])


#: synth5's levels (the headline's job) and synth5.process's stored run
HEADLINE = [64_000_000, 24_000_000, 8_000_000, 3_000_000, 1_000_000]
PROCESS = [6_236_609, 4_906_143, 2_087_180, 587_549, 143_724]
SYNTH_HASC = [False, True, True, True, True]
#: rank 3 of 4 of synth5.sharded4: a quarter of each level, from 3/4 on
SHARD = [n // 4 for n in
         (1_024_000_000, 384_000_000, 128_000_000, 48_000_000, 16_000_000)]
SPAN, SPAN_C = ck.SPAN, ck.SAMPLES_SPAN

CASES = {
    "headline": (HEADLINE, _packed_offsets(HEADLINE), SYNTH_HASC, SPAN, None),
    "sharded4_rank3": (SHARD, _packed_offsets(SHARD), SYNTH_HASC, SPAN,
                       [3 * n for n in SHARD]),
    "process_60_streams": (PROCESS * 12, _packed_offsets(PROCESS * 12),
                           SYNTH_HASC * 12, SPAN_C, None),
    "zero_level_first": ([0, 70_000, 5], (0, 0, 70_000), [True, False, True],
                         SPAN_C, None),
    "zero_level_middle": ([70_000, 0, 5], (0, 70_000, 70_000),
                          [False, True, True], SPAN_C, None),
    "zero_level_last": ([70_000, 5, 0], (0, 70_000, 70_005),
                        [True, True, False], SPAN_C, None),
    "has_coarse_mixed": ([40_000, 3, 100_000, 1, 65_536, 9],
                         _packed_offsets([40_000, 3, 100_000, 1, 65_536, 9]),
                         [False, True, False, True, True, False], SPAN_C, None),
    "has_coarse_none": ([40_000, 3, 100_000], (0, 40_000, 40_003),
                        [False, False, False], SPAN_C, None),
    "one_level": ([200_001], (0,), [False], SPAN, None),
    "multiples_of_span": ([2 * SPAN_C, 2 * SPAN_C + 1, SPAN_C, SPAN_C - 1],
                          _packed_offsets([2 * SPAN_C, 2 * SPAN_C + 1, SPAN_C,
                                           SPAN_C - 1]),
                          [True, False, True, False], SPAN_C, None),
    "starts_past_2_34": ([3 * SPAN + 7, 5, SPAN], (0, 3 * SPAN + 7, 3 * SPAN + 12),
                         [False, True, True], SPAN,
                         [(1 << 34) - 5, (1 << 35) + 77, 1 << 40]),
    "nonzero_x_offsets": ([70_000, 16_384, 2], (1_000, 123_457, 9_999_999),
                          [True, False, True], SPAN_C, [11, 0, 1 << 34]),
    "darcy_first_round": ([2000, 500, 100, 25, 6], _packed_offsets(
        [2000, 500, 100, 25, 6]), SYNTH_HASC, SPAN_C, None),
    "numpy_and_tensor_inputs": (np.asarray(HEADLINE[:3]), torch.tensor(
        _packed_offsets(HEADLINE[:3])), (False, True, np.bool_(True)), SPAN,
        np.asarray([5, 1 << 33, 0], dtype=np.int64)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_block_tables_equal_the_per_block_loop(case):
    counts, offsets, hasc, span, starts = CASES[case]
    got = ck._block_tables(counts, offsets, hasc, span=span, starts=starts)
    want = _block_tables_loop(counts, offsets, hasc, span=span, starts=starts)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int64
        assert g.shape == w.shape
        np.testing.assert_array_equal(g, w)


# --------------------------------------------------------------------- #
# the kernels from either table (run on a machine with a GPU)
# --------------------------------------------------------------------- #
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _both_tables(monkeypatch, launch):
    """``launch()`` with the vectorised tables, then with the loop's."""
    built = launch()
    monkeypatch.setattr(ck, "_block_tables", _block_tables_loop)
    return built, launch()


def _assert_bitwise_equal(a, b):
    for name, x, y in zip(ck.SynthMomentResult._fields, a, b):
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert torch.equal(x, y), name


@pytest.mark.cuda
def test_cuda_kernel_a_equal_from_either_table(cuda_device, monkeypatch):
    fine, coarse, hasc = ck._ladder([0.5, 0.25, 0.125, 0.0625, 0.03125])

    def launch():
        out = ck.synth_mlmc_cuda(None, 4200000123, HEADLINE, fine, coarse, hasc,
                                 25, domain=(-4.0, 4.0), device=cuda_device)
        torch.cuda.synchronize(cuda_device)
        return out

    built, loop = _both_tables(monkeypatch, launch)
    assert int(built.n_valid.sum()) > 0.99 * sum(HEADLINE)
    _assert_bitwise_equal(built, loop)


@pytest.mark.cuda
def test_cuda_kernels_c_d_equal_from_either_table(cuda_device, monkeypatch):
    """Kernels C and D over synth5.process's 60 streams (12 components x 5
    levels, component-major, level 0 without a coarse part)."""
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    fine, coarse = [], []
    for n in PROCESS * 12:
        x = torch.randn(n, generator=gen, device=cuda_device) * 1.5
        fine.append(x)
        coarse.append(x + 0.01 * torch.randn(n, generator=gen, device=cuda_device))
    streams = ck.pack_streams(fine, [None if not h else c for c, h in
                                     zip(coarse, SYNTH_HASC * 12)], SYNTH_HASC * 12)
    del fine, coarse

    def launch():
        c = ck.samples_moments(streams, 25, domain=(-4.0, 4.0))
        d = ck.samples_moments(streams, 25, domain=(-4.0, 4.0), f64=True)
        torch.cuda.synchronize(cuda_device)
        return c, d

    built, loop = _both_tables(monkeypatch, launch)
    for a, b in zip(built, loop):
        assert int(a.n_valid.sum()) > 0.9 * 12 * sum(PROCESS)
        _assert_bitwise_equal(a, b)
