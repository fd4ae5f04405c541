"""The yardstick of the kernel metrics: the card's peaks and the work that
each moment reduction needs, counted from its inputs.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
limit): HBM3 at 3.35 TB/s and 67 TFLOP/s in float64 on the tensor cores,
the fastest float64 unit. A kernel's least time is the larger of its bytes
over the memory rate and its float64 operations over the float64 rate;
each input byte is counted once, each output byte once, and the operations
are those of the samples that are valid (an invalid sample adds a zero
row, which needs no arithmetic).
"""
HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12


def fma_per_sample(n_moments, has_coarse):
    """float64 multiply-adds of one valid sample of a level: the sums and
    the sums of squares of the R differences, and one (fine only) or two
    upper triangles of R x R outer products."""
    R = int(n_moments)
    return 2 * R + (R * (R + 1) if has_coarse else R * (R + 1) // 2)


def output_bytes(n_moments):
    """float64 accumulators of one level or stream: sums, sums of squares,
    two Gram matrices and the count."""
    R = int(n_moments)
    return (2 * R + 2 * R * R + 1) * 8


def least_seconds(bytes_moved, flop):
    """(least time in seconds, 'bytes' or 'flop': which bound holds)."""
    t_bytes, t_flop = bytes_moved / HBM_BYTES_PER_S, flop / FP64_FLOP_PER_S
    return max(t_bytes, t_flop), ("bytes" if t_bytes >= t_flop else "flop")


def fused_work(n_valid_per_level, n_moments):
    """(bytes, flop) of one storage-free estimate: the samples are drawn in
    the kernel, so only the levels' outputs move; level 0 has no coarse."""
    flop = 2 * sum(int(n) * fma_per_sample(n_moments, lvl > 0)
                   for lvl, n in enumerate(n_valid_per_level))
    return len(n_valid_per_level) * output_bytes(n_moments), flop


def stream_work(counts, has_coarse, n_valid, n_moments):
    """(bytes, flop) of one reduction over stored float32 streams: each
    stream's fine values read once, its coarse values too where it has
    them, its outputs written once, and the multiply-adds of its valid
    samples."""
    bytes_in = sum(int(n) * (8 if h else 4) for n, h in zip(counts, has_coarse))
    flop = 2 * sum(int(v) * fma_per_sample(n_moments, h)
                   for v, h in zip(n_valid, has_coarse))
    return bytes_in + len(counts) * output_bytes(n_moments), flop
