// Moment Gram products on the FP64 tensor cores (sm_90a): the device part
// of kernels C and D (csrc/samples_mlmc.cu), and the row build, the
// division, the instruction and the tile schedule of kernel A
// (csrc/synth_mlmc.cu, whose warp-specialised block has its own
// accumulators and budget, stated there).
//
// The kernels reduce per-sample basis rows phi_f, phi_c in [R], R <= 32,
// into five accumulators per level or stream: sum(phi_f - phi_c),
// sum((phi_f - phi_c)^2), the Grams sum(phi_f phi_f^T), sum(phi_c phi_c^T)
// and a valid count. The Grams are ~R^2 f64 multiply-adds per sample.
//
// What bounded the slot loop this replaces: every f64 multiply-add read both
// operands from shared memory (two 8-byte loads), so at 128 bytes per clock
// an SM could feed ~8 of them per clock, ~12% of the f64 vector rate.
//
// The design:
// * Gram tiles by DMMA, mma.sync.aligned.m16n8k8.row.col.f64 (wgmma has no
//   f64). On the H100, m8n8k4 runs at half the rate of m16n8k{4,8,16}
//   (33 against 66 TFLOP/s, mlmc_tpu_torch/tool/dmma_rates.py); of the
//   full-rate shapes, k8 takes two 4-sample k-steps per instruction from
//   the same registers as k4, and k16 would need twice the operand
//   registers. Fragments of lane l (g = l/4, t = l%4): A (16x8 row-major)
//   a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4];
//   B (8x8 col-major) b0 = B[t][g], b1 = B[t+4][g]; C (16x8)
//   C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1].
// * Operand reuse. Rows sit in shared memory as Phi[row][sample]. Per
//   8-sample k-step a lane loads v[I][h] = Phi[8I + g][k0 + 4h + t], two
//   f64 per 8-row block I. The A fragment of the 16-row block P is
//   (v[2P][0], v[2P+1][0], v[2P][1], v[2P+1][1]) and the B fragment of the
//   8-column block J is (v[J][0], v[J][1]): the same registers feed every
//   tile (P, J), 2P <= J, that covers the Gram's upper triangle, as A and as
//   B. At R = 25 that is 8 loads for 6 tiles, 0.33 byte of shared memory
//   per multiply-add instead of 16.
// * R padded to 8 NB (NB = ceil(R/8) row blocks): rows >= R load as 0. At
//   R = 25 the 6 tiles compute 768 Gram entries for 325 needed; the other
//   option, rows 0-23 on DMMA and row 24 on the vector pipe, saves 2 of 6
//   tiles, about a tenth of the kernel's time (PERF.md), at the price of
//   a second path through the kernel and the reduction. NB is a template
//   parameter, so the tile loops unroll and the accumulators stay in
//   registers; one code path serves every R in 1..32.
// * Work split (kernels C and D): the 4 warps of a block take interleaved
//   32-sample chunks of the block's span (an Order of block_span). A lane
//   builds one sample's fine and coarse rows in
//   lockstep (two independent recurrences) into its warp's private rows
//   (stride 36 doubles = 4 mod 16: the operand loads and the row stores are
//   bank-conflict free), __syncwarp, then 4 k-steps. The next chunk's input
//   is fetched (read, or drawn) before the tiles of the current one run.
//   (Block-shared rows with warps owning tiles was measured slower: each
//   warp then runs few accumulator chains of many dependent DMMAs.)
// * Skipped coarse work: a level or stream without a coarse part
//   (HC = false) builds no coarse rows, loads none and runs no coarse
//   tiles; d = phi_f. Its coarse outputs are written as zeros by the
//   reduction, which reads no coarse partial for it.
// * Precision: DMMA accumulates in f64 registers; every 64 samples (two
//   chunks) each lane adds its fragments into its warp's f64 totals in
//   shared memory and zeroes them, so no chain in registers is longer than
//   64 products. The totals are plain sums: a warp adds at most
//   2^14 / 4 / 64 = 64 flushes in kernels C and D (kernel A, in registers:
//   2^16 / 4 / 64 = 256), about 3e-14 of S_abs in the worst case, inside the
//   1e-12 contract (measured: PERF.md). Kernel D's bound against an exact
//   f64 summation (ops/precision.extended_error_bound) counts these steps.
//   sum(d) and sum(d^2) are direct f64 sums of each sample's difference on
//   the vector pipe, taken from the operand registers (never derived from
//   the Gram: cov_f[:, 0] - cov_c[:, 0] cancels where phi_f ~ phi_c).
// * Output: the tile schedule (gram << 16 | P << 8 | J, fine tiles first;
//   a fine-only schedule is its prefix) is built on the host
//   (cuda_kernels._tile_schedule) and passed to both passes. A block writes
//   one f64 partial per scheduled tile entry, summing its warps' totals in
//   warp order, then sum(d) and sum(d^2) (32 each); gram_reduce sums a
//   level's block partials in block order with Kahan compensation and
//   scatters entry (i, j) of tile (P, J) to cov[a, b] and cov[b, a],
//   a = 16P + i, b = 8J + j, for a <= b < R only. No atomics: results are
//   bit-reproducible.
// * Budget at R = 25 (NB = 4), kernels C and D: 96 registers (48 f64) of
//   accumulators per lane with a coarse part (253-255 registers in all, a
//   few spilled, most in kernel D, whose recurrences hold f64 values:
//   mlmc_tpu_torch/tool/kernel_sass.py); per warp 14.4 KB of rows, 12.3 KB
//   of totals and 0.5 KB of sums: 108.8 KB of dynamic shared memory per
//   block, two blocks (8 warps) per SM (at R = 32: 124.9 KB, one block).
//   Kernel A's budget per role is in csrc/synth_mlmc.cu.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace gram {

constexpr int kRPad = 32;               // largest supported moment count
constexpr int kWarps = 4;               // warps per block
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 32;              // samples per warp per row build
constexpr int kFlushChunks = 2;         // flush every 64 samples
constexpr int kRowStride = 36;          // doubles per row (32 samples + 4)
constexpr int kReduceThreads = 128;

// 16x8 tiles (P, J), 2P <= J < nb, of one Gram over nb 8-row blocks
__host__ __device__ constexpr int n_tiles(int nb) {
  return nb == 1 ? 1 : nb == 2 ? 2 : nb == 3 ? 4 : 6;
}

// doubles of one warp's shared region: rows_f[R][36], rows_c[R][36],
// totals[2 * n_tiles][4][32], sums[2][32]
__host__ __device__ constexpr int warp_doubles(int R, int nb) {
  return 2 * R * kRowStride + 2 * n_tiles(nb) * 128 + 2 * 32;
}

inline size_t smem_bytes(int R) {
  return sizeof(double) * kWarps * warp_doubles(R, (R + 7) / 8);
}

// partial row of one block: one f64 per scheduled tile entry (128 per
// tile), then sum(d)[32] and sum(d^2)[32]
__host__ __device__ constexpr int n_out(int n_codes) {
  return n_codes * 128 + 2 * kRPad;
}

template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// D = A B + D, A 16x8 row-major, B 8x8 col-major, f64
__device__ __forceinline__ void dmma(double (&c)[4], double a0, double a1,
                                     double a2, double a3, double b0,
                                     double b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));
}

// a / n, correctly rounded, for the Legendre recurrence's divisors
// n = 2 .. 31, without the IEEE division, which is a subroutine of some
// ten (f32) to twenty-five (f64) instructions and took a third of kernel
// C's time and 40% of kernel D's (mlmc_tpu_torch/tool/gram_ablation.py).
// With y = RN(1 / n) from a table: q = RN(a y), the remainder r = a - n q
// (one fma, exact: r is a multiple of ulp(q) and smaller than 2^6 ulp(q)),
// and q' = RN(q + r y). Before its rounding, q + r y = a/n + (a/n - q) e,
// where |e| <= eps / 2 is the relative error of y and |a/n - q| <= 2 ulp:
// it lies within eps ulp of a/n (eps = 2^-23 or 2^-52). With n = 2^k m, m
// odd, the part of a/n below its last place is j/m ulp for an integer j:
// 0, or at least 1/62 ulp away from the midpoint of two neighbours. So
// q + r y and a/n round to the same value: q' is the IEEE quotient, up to
// the sign of a zero (the recurrence's values are far from the subnormal
// range, where r need not be exact). mlmc_tpu_torch/tool/exact_division.py
// compares it with the division operator on the card: every f32 dividend,
// and 2^32 f64 dividends per divisor.
#define MLMC_RECIPROCALS(one)                                                \
  {0,        one / 1,  one / 2,  one / 3,  one / 4,  one / 5,  one / 6,      \
   one / 7,  one / 8,  one / 9,  one / 10, one / 11, one / 12, one / 13,     \
   one / 14, one / 15, one / 16, one / 17, one / 18, one / 19, one / 20,     \
   one / 21, one / 22, one / 23, one / 24, one / 25, one / 26, one / 27,     \
   one / 28, one / 29, one / 30, one / 31}
__constant__ float kRecip32[kRPad] = MLMC_RECIPROCALS(1.0f);
__constant__ double kRecip64[kRPad] = MLMC_RECIPROCALS(1.0);
#undef MLMC_RECIPROCALS

__device__ __forceinline__ float recip_of(float, int n) { return kRecip32[n]; }
__device__ __forceinline__ double recip_of(double, int n) { return kRecip64[n]; }

template <typename T>
__device__ __forceinline__ T div_small(T a, int n) {
  const T y = recip_of(a, n);
  const T q = a * y;
  const T r = fma(-static_cast<T>(n), q, a);
  return fma(r, y, q);
}

__device__ __forceinline__ float cos_of(float x) { return cosf(x); }
__device__ __forceinline__ float sin_of(float x) { return sinf(x); }
__device__ __forceinline__ double cos_of(double x) { return cos(x); }
__device__ __forceinline__ double sin_of(double x) { return sin(x); }

// Rows of one lane's sample for NS sides (fine, coarse) in lockstep into
// row[k][n * kRowStride], n < R; basis 0 Legendre, 1 monomial, 2 Fourier,
// in the operation order of pallas_kernels._basis_rows, in T (f32 for
// kernels A and C, f64 for kernel D): bit-identical to the plain versions
// under --fmad=false and correctly rounded division (Fourier up to the
// last bits of cos and sin).
template <int NS, typename T>
__device__ __forceinline__ void basis_rows(double* const (&row)[NS],
                                           const T (&t)[NS], T v, int R,
                                           int basis) {
  constexpr int S = kRowStride;
#pragma unroll
  for (int k = 0; k < NS; ++k) row[k][0] = static_cast<double>(v);
  if (basis == 0) {
    T p2[NS], p1[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (R > 1) row[k][S] = static_cast<double>(t[k]);
      p2[k] = v;
      p1[k] = t[k];
    }
    for (int n = 2; n < R; ++n) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        const T cur = div_small(static_cast<T>(2 * n - 1) * t[k] * p1[k] -
                                    static_cast<T>(n - 1) * p2[k],
                                n);
        row[k][n * S] = static_cast<double>(cur);
        p2[k] = p1[k];
        p1[k] = cur;
      }
    }
  } else if (basis == 1) {
    T power[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) power[k] = v;
    for (int n = 1; n < R; ++n) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        power[k] = power[k] * t[k];
        row[k][n * S] = static_cast<double>(power[k]);
      }
    }
  } else {
    T c1[NS], s1[NS], ck[NS], sk[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      c1[k] = cos_of(t[k]) * v;
      s1[k] = sin_of(t[k]) * v;
      ck[k] = c1[k];
      sk[k] = s1[k];
    }
    for (int i = 1; i < R; ++i) {
#pragma unroll
      for (int k = 0; k < NS; ++k) {
        if (i % 2 == 1) {
          row[k][i * S] = static_cast<double>(ck[k]);
        } else {
          row[k][i * S] = static_cast<double>(sk[k]);
          const T nc = ck[k] * c1[k] - sk[k] * s1[k];
          const T ns = sk[k] * c1[k] + ck[k] * s1[k];
          ck[k] = nc;
          sk[k] = ns;
        }
      }
    }
  }
}

// One warp's accumulators. Lane l (g = l/4, t = l%4) holds, for every
// tile (P, J) of each Gram, its C fragment: rows 16P + g and 16P + 8 + g,
// columns 8J + 2t + {0, 1}; and for each row block I the chains of
// sum(d), sum(d^2) of row 8I + g over the samples k0 + t and k0 + 4 + t
// of every k-step.
template <int NB, bool HC>
struct WarpGram {
  static constexpr int T = n_tiles(NB);
  static constexpr int NP = (NB + 1) / 2;  // 16-row blocks
  double f[T][4];
  double c[HC ? T : 1][4];
  double sd[NB], sd2[NB];  // chains since the last flush
  double td[NB], td2[NB];  // this lane's share of the warp's totals

  __device__ __forceinline__ void zero_fragments() {
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        f[t][e] = 0.0;
        if constexpr (HC) c[t][e] = 0.0;
      }
    }
#pragma unroll
    for (int I = 0; I < NB; ++I) sd[I] = sd2[I] = 0.0;
  }

  __device__ __forceinline__ void init() {
    zero_fragments();
#pragma unroll
    for (int I = 0; I < NB; ++I) td[I] = td2[I] = 0.0;
  }

  // the 4 k-steps of 8 samples of one 32-sample chunk in rf / rc
  // ([R][kRowStride]): per step a lane loads v[I][h] = Phi[8I + g][k0 +
  // 4h + t] of each 8-row block and feeds every tile from those registers
  __device__ __forceinline__ void chunk(const double* rf, const double* rc,
                                        int R, int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
#pragma unroll
    for (int ks = 0; ks < kChunk / 8; ++ks) {
      double vf[2 * NP][2], vc[2 * NP][2];
#pragma unroll
      for (int I = 0; I < 2 * NP; ++I) {
        const int r = 8 * I + g;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = r * kRowStride + 8 * ks + 4 * h + t;
          vf[I][h] = (I < NB && r < R) ? rf[at] : 0.0;
          vc[I][h] = 0.0;
          if constexpr (HC) vc[I][h] = (I < NB && r < R) ? rc[at] : 0.0;
        }
      }
      int tt = 0;
#pragma unroll
      for (int P = 0; P < NP; ++P) {
#pragma unroll
        for (int J = 2 * P; J < NB; ++J, ++tt) {
          dmma(f[tt], vf[2 * P][0], vf[2 * P + 1][0], vf[2 * P][1],
               vf[2 * P + 1][1], vf[J][0], vf[J][1]);
          if constexpr (HC)
            dmma(c[tt], vc[2 * P][0], vc[2 * P + 1][0], vc[2 * P][1],
                 vc[2 * P + 1][1], vc[J][0], vc[J][1]);
        }
      }
#pragma unroll
      for (int I = 0; I < NB; ++I) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const double d = vf[I][h] - vc[I][h];
          sd[I] += d;
          sd2[I] = fma(d, d, sd2[I]);
        }
      }
    }
  }

  // fragments into the warp's totals tot[2T][4][32] (lane-private
  // entries), then zeroed
  __device__ __forceinline__ void flush(double* tot, int lane) {
#pragma unroll
    for (int t = 0; t < T; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[(t * 4 + e) * 32 + lane] += f[t][e];
        if constexpr (HC) tot[((T + t) * 4 + e) * 32 + lane] += c[t][e];
      }
    }
#pragma unroll
    for (int I = 0; I < NB; ++I) {
      td[I] += sd[I];
      td2[I] += sd2[I];
    }
    zero_fragments();
  }

  // sum(d), sum(d^2) of each row over the warp's samples into sums[2][32]
  // (rows < 8 NB; the 4 lanes of a row combine by fixed shuffles)
  __device__ __forceinline__ void write_sums(double* sums, int lane) {
#pragma unroll
    for (int I = 0; I < NB; ++I) {
      double a = td[I];
      double b = td2[I];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      b += __shfl_xor_sync(0xffffffffu, b, 1);
      a += __shfl_xor_sync(0xffffffffu, a, 2);
      b += __shfl_xor_sync(0xffffffffu, b, 2);
      if ((lane & 3) == 0) {
        sums[8 * I + (lane >> 2)] = a;
        sums[32 + 8 * I + (lane >> 2)] = b;
      }
    }
  }
};

// tile (P, J), 2P <= J, in the unrolled order of WarpGram
__device__ __forceinline__ int tile_index(int nb, int P, int J) {
  return P * nb - P * (P - 1) + (J - 2 * P);
}

// The order in which a warp's lanes visit a span's samples: chunk k of
// warp w takes sample slot (k kWarps + w) kChunk + lane, and runs while
// its first slot is in the span (kernels C and D).
struct Interleaved {
  __device__ __forceinline__ int64_t slot(int64_t k, int warp, int lane) const {
    return (k * kWarps + warp) * kChunk + lane;
  }
  __device__ __forceinline__ bool runs(int64_t k, int warp, int64_t count) const {
    return (k * kWarps + warp) * kChunk < count;
  }
};

// One block's span of `count` samples of one level or stream, visited in
// `order`'s chunks (slot(k, warp, lane): the sample slot, which may lie
// outside [0, count); runs(k, warp, count): whether chunk k runs). `rows`
// has two calls: `rows.fetch(s, in_range)` reads or draws sample slot s's
// input (issued one chunk ahead, so that its latency overlaps the tiles
// of the chunk before), and `rows.build(x, in_range, row_f, row_c,
// Flag<HC>)` builds its rows into the lane's column and returns whether it
// is valid. Writes the block's partial row `out` (n_out(n_codes) doubles;
// coarse entries only where HC) and its valid count.
template <int NB, bool HC, typename Rows, typename Order = Interleaved>
__device__ __forceinline__ void block_span(int64_t count, int R,
                                           const int32_t* __restrict__ codes,
                                           int n_codes, const Rows& rows,
                                           double* __restrict__ out,
                                           long long* __restrict__ out_n,
                                           const Order order = Order{}) {
  extern __shared__ double smem[];
  __shared__ int warp_counts[kWarps];
  constexpr int T = n_tiles(NB);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wd = warp_doubles(R, NB);
  const int tot_at = 2 * R * kRowStride;  // totals' offset in a region
  const int sums_at = tot_at + 2 * T * 128;
  double* rf = smem + warp * wd;
  double* rc = rf + R * kRowStride;
  double* tot = smem + warp * wd + tot_at;
  for (int k = lane; k < (HC ? 2 : 1) * T * 128; k += 32) tot[k] = 0.0;

  WarpGram<NB, HC> g;
  g.init();
  int n_valid = 0;
  int since_flush = 0;
  int64_t s = order.slot(0, warp, lane);
  auto x = rows.fetch(s, s >= 0 && s < count, Flag<HC>{});
  for (int64_t k = 0; order.runs(k, warp, count); ++k) {
    __syncwarp();  // the previous chunk's operand loads are done
    if (rows.build(x, s >= 0 && s < count, rf + lane, rc + lane, Flag<HC>{}))
      ++n_valid;
    __syncwarp();
    s = order.slot(k + 1, warp, lane);
    x = rows.fetch(s, s >= 0 && s < count, Flag<HC>{});
    g.chunk(rf, rc, R, lane);
    if (++since_flush == kFlushChunks) {
      g.flush(tot, lane);
      since_flush = 0;
    }
  }
  g.flush(tot, lane);
  g.write_sums(smem + warp * wd + sums_at, lane);
  for (int o = 16; o > 0; o >>= 1)
    n_valid += __shfl_down_sync(0xffffffffu, n_valid, o);
  if (lane == 0) warp_counts[warp] = n_valid;
  __syncthreads();

  // the warps' totals, in warp order, into the scheduled tile entries
  const int n_used = HC ? n_codes : n_codes / 2;
  for (int k = threadIdx.x; k < n_used * 128; k += kThreads) {
    const int code = codes[k >> 7];
    const int tt = (code >> 16) * T + tile_index(NB, (code >> 8) & 0xff,
                                                 code & 0xff);
    const int i = (k & 127) >> 3;  // entry (i, j) of the 16x8 tile
    const int j = k & 7;
    const int src = (tt * 4 + (i >> 3) * 2 + (j & 1)) * 32 + (i & 7) * 4 + (j >> 1);
    double sum = 0.0;
    for (int w = 0; w < kWarps; ++w) sum += smem[w * wd + tot_at + src];
    out[k] = sum;
  }
  if (threadIdx.x < 2 * kRPad) {
    const int r = threadIdx.x & 31;
    double sum = 0.0;
    if (r < 8 * NB) {
      for (int w = 0; w < kWarps; ++w)
        sum += smem[w * wd + sums_at + threadIdx.x];
    }
    out[n_codes * 128 + threadIdx.x] = sum;
  }
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < kWarps; ++w) total += warp_counts[w];
    *out_n = total;
  }
}

// Second pass: grid (segments, ceil(n_out / kReduceThreads)). Each thread
// sums one partial entry of its segment's blocks in block order (Kahan),
// then scatters it; a segment without a coarse part gets zeros in cov_c.
template <typename CoarseOf>
__global__ void __launch_bounds__(kReduceThreads)
gram_reduce(const double* __restrict__ partial,
            const long long* __restrict__ partial_n,
            const int64_t* __restrict__ seg_blocks, CoarseOf coarse_of,
            const int32_t* __restrict__ codes, int n_codes, int R,
            double* __restrict__ sums, double* __restrict__ sums2,
            double* __restrict__ cov_f, double* __restrict__ cov_c,
            long long* __restrict__ n_valid) {
  const int seg = blockIdx.x;
  const int64_t first = seg_blocks[2 * seg];
  const int64_t n_blk = seg_blocks[2 * seg + 1];
  const int stride = n_out(n_codes);
  if (blockIdx.y == 0 && threadIdx.x == 0) {
    long long total = 0;
    for (int64_t i = 0; i < n_blk; ++i) total += partial_n[first + i];
    n_valid[seg] = total;
  }
  const int k = blockIdx.y * blockDim.x + threadIdx.x;
  if (k >= stride) return;
  double* dst_a;
  double* dst_b;
  bool zero = false;
  if (k < n_codes * 128) {
    const int code = codes[k >> 7];
    const int a = 16 * ((code >> 8) & 0xff) + ((k & 127) >> 3);
    const int b = 8 * (code & 0xff) + (k & 7);
    if (a > b || b >= R) return;
    double* cov = ((code >> 16) ? cov_c : cov_f) + static_cast<int64_t>(seg) * R * R;
    dst_a = cov + a * R + b;
    dst_b = cov + b * R + a;
    zero = (code >> 16) != 0 && !coarse_of(seg);
  } else {
    const int j = k - n_codes * 128;
    if ((j & 31) >= R) return;
    dst_a = dst_b = (j < kRPad ? sums : sums2) + static_cast<int64_t>(seg) * R + (j & 31);
  }
  double s = 0.0;
  if (!zero) {
    double comp = 0.0;
    for (int64_t i = 0; i < n_blk; ++i) {
      const double y = partial[(first + i) * stride + k] - comp;
      const double t = s + y;
      comp = (t - s) - y;
      s = t;
    }
    s -= comp;
  }
  *dst_a = s;
  *dst_b = s;
}

// launch gram_reduce for n_seg segments on stream s
template <typename CoarseOf>
inline cudaError_t launch_reduce(const double* partial,
                                 const long long* partial_n,
                                 const int64_t* seg_blocks, int n_seg,
                                 CoarseOf coarse_of, const int32_t* codes,
                                 int n_codes, int R, double* sums,
                                 double* sums2, double* cov_f, double* cov_c,
                                 long long* n_valid, cudaStream_t s) {
  const dim3 grid(n_seg, (n_out(n_codes) + kReduceThreads - 1) / kReduceThreads);
  gram_reduce<CoarseOf><<<grid, kReduceThreads, 0, s>>>(
      partial, partial_n, seg_blocks, coarse_of, codes, n_codes, R, sums,
      sums2, cov_f, cov_c, n_valid);
  return cudaGetLastError();
}

}  // namespace gram
