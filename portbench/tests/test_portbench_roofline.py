"""The work counts of the kernel metrics against hand counts."""
import pytest

from harness import roofline


def test_fma_per_sample_by_hand():
    # R = 2, level 0: sums and squares (4) and the upper triangle of one
    # 2 x 2 outer product (3); with a coarse part two triangles (6)
    assert roofline.fma_per_sample(2, False) == 4 + 3
    assert roofline.fma_per_sample(2, True) == 4 + 6
    assert roofline.fma_per_sample(25, True) == 50 + 650


def test_fused_work_by_hand():
    bytes_moved, flop = roofline.fused_work([10, 4], 2)
    assert flop == 2 * (10 * 7 + 4 * 10)
    # per level: sums 2, squares 2, two 2 x 2 Grams, the count: 13 doubles
    assert bytes_moved == 2 * 13 * 8


def test_stream_work_by_hand():
    bytes_moved, flop = roofline.stream_work([100, 50], [False, True], [90, 40], 3)
    assert bytes_moved == 100 * 4 + 50 * 8 + 2 * (6 + 18 + 1) * 8
    assert flop == 2 * (90 * (6 + 6) + 40 * (6 + 12))


def test_least_time_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 1.0)
    assert t == pytest.approx(1.0) and by == "bytes"
    t, by = roofline.least_seconds(1.0, 2 * 67e12)
    assert t == pytest.approx(2.0) and by == "flop"
