// Fused synthetic-sample -> Legendre-moment kernels for Hopper (sm_90a).
//
// Kernel A (synth_mlmc_kernel<NB> + gram_reduce) replaces the Pallas
// kernels _synth_mlmc_kernel, _synth_moment_kernel and
// _synth_moment_kernel_noise (mlmc_tpu/ops/pallas_kernels.py:605, :248,
// :270). Kernel B (normals_dump_kernel) replaces _normals_dump_kernel
// (:1013). Both draw from one stream (normal_quad): sample i of a level is
// slot i & 3 of Philox4x32-10 call i >> 2, whose four words give four
// normals by both branches of Box-Muller on two word pairs
// (ops/cuda_kernels.py states the counter and the bit map).
//
// Per sample, kernel A draws x (or reads it from memory), evaluates the
// fine/coarse QoI x + h*sqrt(1e-4 + |x|), maps both onto [-1, 1], decides
// validity, and builds both Legendre rows in f32 with the same operation
// order as the numpy reference (mlmc_tpu/ops/precision.py
// f64_reference_moments): every per-sample value is bit-identical to it.
// The accumulation is f64: sum(phi_f - phi_c), sum((phi_f - phi_c)^2) and
// the Grams sum(phi_f phi_f^T), sum(phi_c phi_c^T), plus an int64 valid
// count.
//
// Bound on the card: nothing is read from device memory in RNG mode, so the
// kernel is compute-bound: ~R^2 f64 multiply-adds per sample of a coarse
// level (half on level 0), plus per sample one Philox4x32-10 call, one
// Box-Muller pair (f32 log, sqrt, sin and cos) and 2(R - 2) correctly
// rounded f32 divisions in the recurrences (a reciprocal multiplication
// and two fused corrections, gram::div_small). The Grams run on the FP64
// tensor cores (m16n8k4, at the rate of m16n8k8; RingGram states the
// operand layout); at R = 25 the padded tiles take 3 m16n8k4 per coarse
// sample, 3.1 ms per 2^26 coarse samples at the tensor pipe's full rate.
// The f64 sums and flushes run on the same f64 unit of an SM sub-partition
// as the tiles (PERF.md, kernel A), so they add to them.
//
// Warp specialisation. Built as one warp that draws a chunk's samples,
// builds their rows and then runs their tiles, the kernel's parts (the
// tiles, the row build, the frame of loads, sums and flushes) added up: at
// the 255 registers and 109 KB of shared memory such a warp needs, 8 warps
// fit on an SM, too few for one warp's build to hide under another's tiles.
// Here a block of kThreadsA threads splits by warpgroup into two roles:
// * kProducers producer warps draw or read each sample, evaluate the QoI
//   and its validity, build the sample's fine and coarse rows (gram::
//   basis_rows, f32 values stored widened to f64) into a stage in shared
//   memory, and count the valid samples. A chunk is 32 consecutive
//   samples: in RNG mode lanes 4j .. 4j + 3 take the four slots of one
//   Philox call (normal_at, the same bits as normal_quad's slot).
// * kConsumers consumer warps wait for a full stage, run its tiles and
//   sum(d), sum(d^2) from the same operand registers (RingGram), release
//   it, and every 64 samples add their fragments into totals kept in
//   registers (48 f64 accumulators and 48 f64 totals at NB = 4 with a
//   coarse part; at level 0 the fine tiles alternate two sets of
//   fragments, so that 12 tile chains are in flight either way).
// * Stages: consumer c has kRings of them, one per producer that serves
//   it, each one chunk's rows: [2][R][36] f64, 14.4 KB at R = 25, with a
//   full and an empty mbarrier (32 arrivals: every lane of the warp that
//   filled or emptied it). Chunk k of consumer c goes to producer k %
//   kRings's stage: one producer fills a stage and one consumer empties
//   it, and a consumer has kRings chunks in flight. A consumer takes its
//   chunks in order, so its accumulation order is fixed: two launches
//   agree bit for bit.
// * Registers: setmaxnreg gives each consumer thread kConsumerRegs and takes
//   the producers' down to kProducerRegs; the block launches at 65536 /
//   kThreadsA each, and the launcher refuses a build that holds fewer than
//   the roles ask for (setmaxnreg.inc would wait forever).
// * Shared memory per block: the stages, 4 x 3 x 14.4 = 173 KB at R = 25
//   (221 KB at R = 32), and each consumer's lane-private sum(d), sum(d^2)
//   totals (2 KB); after the last chunk the consumers' totals take the
//   stages' place. One block fills an SM.
// * At the end producers post their valid counts and arrive on a named
//   barrier; consumers wait on it and write the block's partial row: each
//   tile entry and sum adds the consumers' totals in consumer order.
// What bounds A now is the consumer (PERF.md): the tensor pipe and
// the f64 adds beside it on one unit, and the in-order waits of a single
// consumer warp per sub-partition on those adds.
//
// Kernels C and D (csrc/samples_mlmc.cu) keep gram::block_span, in which
// every warp builds and then multiplies: they read their samples from
// device memory, and D builds in f64 under other register and shared
// memory budgets, so a split tuned for A's on-chip draw is not theirs to
// inherit untried.
//
// One block per 2^16-sample span of a level, the blocks of levels with a
// coarse part first; a second pass reduces each level's block partials in
// block order: no atomics, results are deterministic. Level 0 (no coarse
// part, 64% of the headline's samples) builds one row and runs the fine
// Gram only.
//
// The TPU workarounds are not carried over: no bf16 hi/lo split (the
// Grams run in f64), no Kahan scratch carried along a sequential grid (f64
// partials per block), and no sequential-grid zeroing (partials are
// written, never accumulated in place).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps the f32 value path from
// contracting a*b+c into one rounding, so memory mode reproduces numpy's
// f32 per-sample values bit for bit, and keeps the Kahan steps exact; the
// f64 products use DMMA or explicit fma(). setmaxnreg needs sm_90a.

#include <cstdint>
#include <cuda_runtime.h>

#include "moment_gram.cuh"

namespace {

__device__ __forceinline__ void philox4x32_10(uint32_t c[4], uint32_t k0,
                                              uint32_t k1) {
#pragma unroll
  for (int round = 0; round < 10; ++round) {
    if (round > 0) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c[0];
    const uint32_t hi0 = __umulhi(0xD2511F53u, c[0]);
    const uint32_t lo1 = 0xCD9E8D57u * c[2];
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]);
    const uint32_t n0 = hi1 ^ c[1] ^ k0;
    const uint32_t n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0;
    c[1] = lo1;
    c[2] = n2;
    c[3] = lo0;
  }
}

// Both Box-Muller branches of a word pair, mapped as mlmc_tpu's
// _normal_pair maps its bits (top 24 bits, u1 offset by half an ulp):
// (r cos, r sin) in f32. logf, sinf and cosf are the functions PyTorch's
// CUDA log, sin and cos call, and sqrtf is correctly rounded, so the
// plain version on the card gives the same bits.
__device__ __forceinline__ float2 box_muller(uint32_t w0, uint32_t w1) {
  const float i1 = static_cast<float>(static_cast<int>(w0 >> 8));
  const float i2 = static_cast<float>(static_cast<int>(w1 >> 8));
  const float u1 = i1 * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
  const float u2 = i2 * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  const float angle = 6.28318548202514648f * u2;
  return make_float2(r * cosf(angle), r * sinf(angle));
}

// The four normals of Philox call q of a level: counter (q low word, q
// high word, level, 0); slots 0, 1 from words (0, 1), slots 2, 3 from
// words (2, 3), cosine branch first.
__device__ __forceinline__ float4 normal_quad(uint64_t q, uint32_t level,
                                              uint32_t k0, uint32_t k1) {
  uint32_t c[4] = {static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   level, 0u};
  philox4x32_10(c, k0, k1);
  const float2 a = box_muller(c[0], c[1]);
  const float2 b = box_muller(c[2], c[3]);
  return make_float4(a.x, a.y, b.x, b.y);
}


// The normal of sample i of a level: slot i & 3 of normal_quad(i >> 2),
// from the one Box-Muller pair that gives it (the same bits)
__device__ __forceinline__ float normal_at(uint64_t i, uint32_t level,
                                          uint32_t k0, uint32_t k1) {
  const uint64_t q = i >> 2;
  uint32_t c[4] = {static_cast<uint32_t>(q), static_cast<uint32_t>(q >> 32),
                   level, 0u};
  philox4x32_10(c, k0, k1);
  const bool second = (i & 2) != 0;
  const float2 z = box_muller(second ? c[2] : c[0], second ? c[3] : c[1]);
  return (i & 1) ? z.y : z.x;
}

// has_coarse of a level: column 2 of the level table
struct LevelCoarse {
  const float* lvl;
  __device__ bool operator()(int level) const { return lvl[3 * level + 2] != 0.0f; }
};

// Kernel A's block (see the note at the top): warpgroups of consumer and
// producer warps, and each role's registers per thread after setmaxnreg.
constexpr int kConsumerGroups = 1;
constexpr int kProducerGroups = 3;
constexpr int kConsumerRegs = 248;
constexpr int kProducerRegs = 88;
constexpr int kConsumers = 4 * kConsumerGroups;
constexpr int kProducers = 4 * kProducerGroups;
// stages per consumer, one per producer that serves it: its producers take
// its chunks in turn
constexpr int kRings = kProducers / kConsumers;
constexpr int kThreadsA = 32 * (kConsumers + kProducers);
// registers per thread at launch: the SM's 65536 over the block
constexpr int kLaunchRegs = 65536 / kThreadsA / 8 * 8 > 255 ? 255 : 65536 / kThreadsA / 8 * 8;
constexpr int kPoolRegs = 32 * (kConsumers * kConsumerRegs + kProducers * kProducerRegs);
static_assert(kProducers % kConsumers == 0, "every consumer has as many producers");
static_assert(kConsumerRegs >= kLaunchRegs && kProducerRegs <= kLaunchRegs &&
                  kPoolRegs <= kThreadsA * kLaunchRegs,
              "setmaxnreg: the roles ask for more registers than the block holds");

// doubles of one stage: one chunk's fine and coarse rows
// [2][R][kRowStride]
__host__ __device__ constexpr int stage_doubles(int R) {
  return 2 * R * gram::kRowStride;
}

// doubles of one consumer's part of the block's partial: tiles
// [2 n_tiles][4][32], then sum(d), sum(d^2) [2][32]
__host__ __device__ constexpr int totals_doubles(int nb) {
  return 2 * gram::n_tiles(nb) * 128 + 2 * 32;
}

// doubles of one consumer's sum(d), sum(d^2) chains' totals [2][nb][32]
__host__ __device__ constexpr int chains_doubles(int nb) { return 2 * nb * 32; }

// dynamic shared memory: the consumers' chain totals, then the stages
// (after the last chunk, the consumers' totals in their place)
__host__ __device__ constexpr int stages_doubles(int R) {
  return kConsumers * kRings * stage_doubles(R) > kConsumers * totals_doubles((R + 7) / 8)
             ? kConsumers * kRings * stage_doubles(R)
             : kConsumers * totals_doubles((R + 7) / 8);
}
__host__ __device__ constexpr size_t smem_a(int R) {
  return sizeof(double) * (kConsumers * chains_doubles((R + 7) / 8) + stages_doubles(R));
}
static_assert(smem_a(gram::kRPad) <= 226 * 1024, "kernel A's stages fit at R = 32");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

// arrive, with release semantics: the calling thread's earlier shared
// memory accesses happen before the phase completes
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

// wait, with acquire semantics, until the phase of this parity completes
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (done == 0);
}

// named barriers: 1 of all kThreadsA threads (producers arrive, consumers
// wait), 2 of the consumers
constexpr int kDoneBarrier = 1;
constexpr int kTotalsBarrier = 2;

// Kernel A's sample order: chunk k of consumer c takes the 32 sample
// slots (k kConsumers + c) kChunk + lane - head of the span, and runs while
// its first slot is below count. head = start & 3 in RNG mode (0 in memory
// mode), so that a chunk's 32 samples are 8 whole Philox quads: lanes 4j ..
// 4j + 3 take the four slots of one call. Slots outside [0, count) are
// drawn (or skipped) and masked: a span that starts or ends inside a quad
// leaves those samples to its neighbour. An empty span runs no chunk.
struct SynthOrder {
  int head;
  int64_t count;  // samples of the span

  __device__ __forceinline__ int64_t slot(int k, int c, int lane) const {
    return (static_cast<int64_t>(k) * kConsumers + c) * gram::kChunk + lane - head;
  }
  __device__ __forceinline__ bool in_span(int64_t s) const {
    return s >= 0 && s < count;
  }
  __device__ __forceinline__ bool runs(int k, int c) const {
    return count > 0 && slot(k, c, 0) < count;
  }
};

// The block's stages: stage q of consumer c at [c][q], `stage` doubles
// each, with a full and an empty barrier. Chunk k of consumer c goes
// through stage q = k % kRings, as its turn u = k / kRings there; one
// producer fills a stage and one consumer empties it.
struct Rings {
  double* rows;
  uint64_t* full;
  uint64_t* empty;
  int stage;

  __device__ __forceinline__ int bar(int c, int q) const { return c * kRings + q; }
  __device__ __forceinline__ double* rows_of(int c, int q) const {
    return rows + static_cast<int64_t>(bar(c, q)) * stage;
  }
};

// Per-sample input and rows of kernel A (the producers' work)
struct SynthRows {
  const float* x;  // memory mode; nullptr in RNG mode
  int64_t start;   // first sample index of the span within its level
  int64_t xoff;    // memory mode: offset of the span's first sample in x
  uint32_t level, k0, k1;
  float fine_step, coarse_step, t_scale, t_shift;
  int R;

  // the input of sample slot s: drawn (RNG mode, also outside the span),
  // or read where s lies in the span (memory mode)
  __device__ __forceinline__ float fetch(int64_t s, bool in_range) const {
    if (x != nullptr) return in_range ? x[xoff + s] : 0.0f;
    return normal_at(static_cast<uint64_t>(start + s), level, k0, k1);
  }

  template <typename HCF>
  __device__ __forceinline__ bool build(float xv, bool in_range, double* row_f,
                                        double* row_c, HCF) const {
    const float err = sqrtf(1e-4f + fabsf(xv));
    const float fine = xv + fine_step * err;
    const float t_f = (fine - t_shift) * t_scale;
    bool valid = in_range && (t_f >= -1.0f) && (t_f <= 1.0f);
    float t_c = 0.0f;
    if constexpr (HCF::value) {
      const float coarse = xv + coarse_step * err;
      t_c = (coarse - t_shift) * t_scale;
      valid = valid && (t_c >= -1.0f) && (t_c <= 1.0f);
    }
    const float v = valid ? 1.0f : 0.0f;
    if constexpr (HCF::value) {
      double* const out[2] = {row_f, row_c};
      const float t[2] = {valid ? t_f : 0.0f, valid ? t_c : 0.0f};
      gram::basis_rows<2>(out, t, v, R, 0);
    } else {
      double* const out[1] = {row_f};
      const float t[1] = {valid ? t_f : 0.0f};
      gram::basis_rows<1>(out, t, v, R, 0);
    }
    return valid;
  }
};

// D = A B + D, A 16x4 row-major, B 4x8 col-major, f64. Lane l (g = l/4,
// t = l%4) gives a0 = A[g][t], a1 = A[g+8][t], b0 = B[t][g]; C as in
// m16n8k8 (gram::dmma).
__device__ __forceinline__ void dmma_k4(double (&c)[4], double a0, double a1,
                                        double b0) {
  asm("mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b0));
}

// A consumer's accumulators. As gram::WarpGram: lane l (g = l/4, t = l%4)
// holds the C fragment of every tile (P, J), 2P <= J, of each Gram and
// the chains of sum(d), sum(d^2) of rows 8I + g; every 64 samples the
// fragments are added into totals and zeroed, so no chain is longer than
// 64 products. Unlike WarpGram, the totals stay in registers (a flush is
// 48 f64 adds at NB = 4, not a read and a write of shared memory), and
// the tiles are m16n8k4 at the rate of m16n8k8: per 4-sample k-step a
// lane loads v[I] = Phi[8I + g][k0 + t] of each 8-row block, and the A
// operand of the 16-row block P is the register pair (v[2P], v[2P + 1]),
// the B operand of the 8-column block J is v[J]. One load per block feeds
// every tile with no register moves; m16n8k8 pairs the samples k0 + t and
// k0 + 4 + t of one row in B but of two rows in A, which costs a copy of
// every value. The chains take the samples in WarpGram's order. Without a
// coarse part the fine tiles take the even k-steps into one set of
// fragments and the odd ones into the other (the coarse Gram's registers),
// so that as many tile chains are in flight as with one.
template <int NB, bool HC>
struct RingGram {
  static constexpr int T = gram::n_tiles(NB);
  static constexpr int NP = (NB + 1) / 2;  // 16-row blocks
  static constexpr int G = HC ? 2 : 1;     // Grams
  double acc[2][T][4];  // fragments since the last flush
  double tot[G][T][4];  // this lane's share of the consumer's totals
  double sd[NB], sd2[NB];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[0][t][e] = acc[1][t][e] = 0.0;
#pragma unroll
        for (int k = 0; k < G; ++k) tot[k][t][e] = 0.0;
      }
#pragma unroll
    for (int I = 0; I < NB; ++I) sd[I] = sd2[I] = 0.0;
  }

  // the 8 k-steps of one 32-sample chunk in rf / rc ([R][kRowStride];
  // rows >= R load as 0, and only the last 8-row block has such rows)
  __device__ __forceinline__ void chunk(const double* rf, const double* rc,
                                        int R, int lane) {
    const int g = lane >> 2;
    const int t = lane & 3;
    const bool last_in = 8 * (NB - 1) + g < R;
#pragma unroll
    for (int ks = 0; ks < gram::kChunk / 4; ++ks) {
      double vf[2 * NP], vc[2 * NP];
#pragma unroll
      for (int I = 0; I < 2 * NP; ++I) {
        const int at = (8 * I + g) * gram::kRowStride + 4 * ks + t;
        const bool in = I < NB - 1 || (I == NB - 1 && last_in);
        vf[I] = in ? rf[at] : 0.0;
        vc[I] = 0.0;
        if constexpr (HC) vc[I] = in ? rc[at] : 0.0;
      }
      int tt = 0;
#pragma unroll
      for (int P = 0; P < NP; ++P) {
#pragma unroll
        for (int J = 2 * P; J < NB; ++J, ++tt) {
          dmma_k4(acc[HC ? 0 : ks & 1][tt], vf[2 * P], vf[2 * P + 1], vf[J]);
          if constexpr (HC) dmma_k4(acc[1][tt], vc[2 * P], vc[2 * P + 1], vc[J]);
        }
      }
#pragma unroll
      for (int I = 0; I < NB; ++I) {
        const double d = vf[I] - vc[I];
        sd[I] += d;
        sd2[I] = fma(d, d, sd2[I]);
      }
    }
  }

  // fragments into the totals and chains into chains[2][NB][32]
  // (lane-private entries in shared memory), all zeroed
  __device__ __forceinline__ void flush(double* chains, int lane) {
#pragma unroll
    for (int t = 0; t < T; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        tot[0][t][e] += acc[0][t][e];
        tot[G - 1][t][e] += acc[1][t][e];
        acc[0][t][e] = acc[1][t][e] = 0.0;
      }
#pragma unroll
    for (int I = 0; I < NB; ++I) {
      chains[I * 32 + lane] += sd[I];
      chains[(NB + I) * 32 + lane] += sd2[I];
      sd[I] = sd2[I] = 0.0;
    }
  }

  // the totals into out[2T][4][32] and sum(d), sum(d^2) of each row over
  // the consumer's samples into out[2T * 128 + (0 | 32) + row] (rows < 8 NB;
  // the 4 lanes of a row combine by fixed shuffles)
  __device__ __forceinline__ void write(const double* chains, double* out,
                                        int lane) const {
#pragma unroll
    for (int k = 0; k < G; ++k)
#pragma unroll
      for (int t = 0; t < T; ++t)
#pragma unroll
        for (int e = 0; e < 4; ++e) out[((k * T + t) * 4 + e) * 32 + lane] = tot[k][t][e];
    double* sums = out + 2 * T * 128;
#pragma unroll
    for (int I = 0; I < NB; ++I) {
      double a = chains[I * 32 + lane];
      double b = chains[(NB + I) * 32 + lane];
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

// Producer warp j: stage q = j / kConsumers of consumer c = j % kConsumers.
// It builds chunks k = q, q + kRings, ... of its consumer, each into its
// stage once the consumer has emptied it, and posts its valid count. (A
// producer with q >= kRings, which only gram_ablation's "serial" variant
// makes, builds nothing.)
template <bool HC>
__device__ __forceinline__ void produce(const SynthRows& rows,
                                        const SynthOrder& order,
                                        const Rings& ring, int j, int lane,
                                        int* counts) {
  const int q = j / kConsumers;
  const int c = j % kConsumers;
  int n_valid = 0;
  for (int k = q; q < kRings && order.runs(k, c); k += kRings) {
    const int64_t s = order.slot(k, c, lane);
    const bool in_range = order.in_span(s);
    const float xv = rows.fetch(s, in_range);
    const int u = k / kRings;  // the chunk's turn in its stage
    if (u > 0) mbar_wait(ring.empty + ring.bar(c, q), (u - 1) & 1);
    double* rf = ring.rows_of(c, q) + lane;
    if (rows.build(xv, in_range, rf, rf + rows.R * gram::kRowStride,
                   gram::Flag<HC>{}))
      ++n_valid;
    mbar_arrive(ring.full + ring.bar(c, q));
  }
  for (int o = 16; o > 0; o >>= 1)
    n_valid += __shfl_down_sync(0xffffffffu, n_valid, o);
  if (lane == 0) counts[j] = n_valid;
  __threadfence_block();
  asm volatile("bar.arrive %0, %1;" ::"n"(kDoneBarrier), "n"(kThreadsA) : "memory");
}

// Consumer warp c: its groups in order, every chunk's tiles from its
// stage (RingGram), flushed every 64 samples; then, with the other
// consumers, the block's partial row (n_out(n_codes) doubles; coarse
// entries only where HC) and its valid count.
template <int NB, bool HC>
__device__ __forceinline__ void consume(const SynthOrder& order,
                                        const Rings& ring, int c, int lane,
                                        int R, double* chains,
                                        const int* counts,
                                        const int32_t* __restrict__ codes,
                                        int n_codes, double* __restrict__ out,
                                        long long* __restrict__ out_n) {
  constexpr int T = gram::n_tiles(NB);
  constexpr int TD = totals_doubles(NB);
  double* mine = chains + c * chains_doubles(NB);
  for (int k = lane; k < chains_doubles(NB); k += 32) mine[k] = 0.0;

  RingGram<NB, HC> g;
  g.init();
  int k = 0;
  for (; order.runs(k, c); ++k) {
    const int q = k % kRings;
    const double* rf = ring.rows_of(c, q);
    mbar_wait(ring.full + ring.bar(c, q), (k / kRings) & 1);
    g.chunk(rf, rf + R * gram::kRowStride, R, lane);
    mbar_arrive(ring.empty + ring.bar(c, q));
    if (k & 1) g.flush(mine, lane);  // every gram::kFlushChunks chunks
  }
  if (k & 1) g.flush(mine, lane);
  // every stage is empty and every producer done: the consumers' totals
  // take the stages' place, in consumer order
  asm volatile("bar.sync %0, %1;" ::"n"(kDoneBarrier), "n"(kThreadsA) : "memory");
  double* totals = ring.rows;
  g.write(mine, totals + c * TD, lane);
  asm volatile("bar.sync %0, %1;" ::"n"(kTotalsBarrier), "n"(32 * kConsumers) : "memory");

  // the consumers' totals, in consumer order, into the scheduled tile entries
  const int n_used = HC ? n_codes : n_codes / 2;
  constexpr int kStride = 32 * kConsumers;
  for (int k = threadIdx.x; k < n_used * 128; k += kStride) {
    const int code = codes[k >> 7];
    const int tt = (code >> 16) * T + gram::tile_index(NB, (code >> 8) & 0xff,
                                                       code & 0xff);
    const int i = (k & 127) >> 3;  // entry (i, j) of the 16x8 tile
    const int j = k & 7;
    const int src = (tt * 4 + (i >> 3) * 2 + (j & 1)) * 32 + (i & 7) * 4 + (j >> 1);
    double sum = 0.0;
    for (int w = 0; w < kConsumers; ++w) sum += totals[w * TD + src];
    out[k] = sum;
  }
  if (threadIdx.x < 2 * gram::kRPad) {
    const int r = threadIdx.x & 31;
    double sum = 0.0;
    if (r < 8 * NB) {
      for (int w = 0; w < kConsumers; ++w)
        sum += totals[w * TD + 2 * T * 128 + threadIdx.x];
    }
    out[n_codes * 128 + threadIdx.x] = sum;
  }
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int p = 0; p < kProducers; ++p) total += counts[p];
    *out_n = total;
  }
}

// Block table: [n_blocks, 4] int64 = (level, first sample index within the
// level, sample count, offset into x for memory mode).
// Level table: [n_levels, 3] f32 = (fine step, coarse step, has coarse).
// codes: the tile schedule (moment_gram.cuh), n_codes = 2 n_tiles(NB).
// The roles split once, by warpgroup, and never rejoin (setmaxnreg).
template <int NB>
__global__ void __launch_bounds__(kThreadsA, 1)
synth_mlmc_kernel(const float* __restrict__ x, const int64_t* __restrict__ blk,
                  const float* __restrict__ lvl,
                  const int32_t* __restrict__ codes, int n_codes,
                  int n_moments, float t_scale, float t_shift, uint32_t k0,
                  uint32_t k1, double* __restrict__ partial,
                  long long* __restrict__ partial_n) {
  extern __shared__ double chains[];  // then the stages: smem_a
  __shared__ uint64_t full[kConsumers * kRings];
  __shared__ uint64_t empty[kConsumers * kRings];
  __shared__ int counts[kProducers];
  const int64_t* b = blk + 4 * static_cast<int64_t>(blockIdx.x);
  const int level = static_cast<int>(b[0]);
  const int64_t count = b[2];
  const int R = n_moments;
  if (threadIdx.x < kConsumers * kRings) {
    mbar_init(full + threadIdx.x, 32);
    mbar_init(empty + threadIdx.x, 32);
  }
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  __syncthreads();

  const SynthOrder order{x == nullptr ? static_cast<int>(b[1] & 3) : 0, count};
  const Rings ring{chains + kConsumers * chains_doubles(NB), full, empty,
                   stage_doubles(R)};
  const bool hc = lvl[3 * level + 2] != 0.0f;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < kConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    double* out = partial + static_cast<int64_t>(blockIdx.x) * gram::n_out(n_codes);
    long long* out_n = partial_n + blockIdx.x;
    if (hc) {
      consume<NB, true>(order, ring, warp, lane, R, chains, counts, codes,
                        n_codes, out, out_n);
    } else {
      consume<NB, false>(order, ring, warp, lane, R, chains, counts, codes,
                         n_codes, out, out_n);
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const SynthRows rows{x, b[1], b[3], static_cast<uint32_t>(level), k0, k1,
                         lvl[3 * level + 0], lvl[3 * level + 1], t_scale,
                         t_shift, R};
    if (hc) {
      produce<true>(rows, order, ring, warp - kConsumers, lane, counts);
    } else {
      produce<false>(rows, order, ring, warp - kConsumers, lane, counts);
    }
  }
}

// registers per thread that kernel A<NB> holds at launch (0 if unknown)
template <int NB>
int launch_regs() {
  cudaFuncAttributes attr{};
  return cudaFuncGetAttributes(&attr, synth_mlmc_kernel<NB>) == cudaSuccess
             ? attr.numRegs : 0;
}

template <int NB>
cudaError_t launch_synth(const float* x, const int64_t* blk, int n_blocks,
                         const float* lvl, const int32_t* codes, int n_codes,
                         int n_moments, float t_scale, float t_shift,
                         uint32_t k0, uint32_t k1, double* partial,
                         long long* partial_n, cudaStream_t s) {
  // setmaxnreg.inc draws on the registers the block holds at launch: a
  // build that holds fewer than the roles ask for would never start
  static const int regs = launch_regs<NB>();
  if (regs * kThreadsA < kPoolRegs) return cudaErrorInvalidConfiguration;
  const size_t smem = smem_a(n_moments);
  cudaError_t err = cudaFuncSetAttribute(
      synth_mlmc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  synth_mlmc_kernel<NB><<<n_blocks, kThreadsA, smem, s>>>(
      x, blk, lvl, codes, n_codes, n_moments, t_scale, t_shift, k0, k1,
      partial, partial_n);
  return cudaGetLastError();
}

// Kernel B. Bound on the card: per 4 normals one Philox call (~104 int32
// operations at half the f32 issue rate), two f32 log/sqrt and two sin/cos
// evaluations, and 16 bytes written; nothing is read. Thread t of a
// grid-stride loop draws quad q0 + t of [start, start + n) and writes it
// with one 16-byte store where the quad lies whole in the range and its
// first slot is 16-byte aligned (the wrapper offsets the buffer by start & 3
// floats so that every whole quad is); the head and tail quads of a range
// that starts or ends inside a quad store their slots one by one. The grid
// is capped at kNormalsBlocksPerSm blocks per SM
// (mlmc_tpu_torch/tool/gram_ablation.py --kernel b times the caps). One
// draw site keeps the SASS's f32 count, which the bound reads, per call.
constexpr int kNormalsThreads = 256;
constexpr int kNormalsBlocksPerSm = 16;

__global__ void __launch_bounds__(kNormalsThreads)
normals_dump_kernel(float* __restrict__ out, int64_t n, int64_t start,
                    uint32_t level, uint32_t k0, uint32_t k1) {
  const int head = static_cast<int>(start & 3);
  const uint64_t q0 = static_cast<uint64_t>(start) >> 2;
  const int64_t n_quads = (n + head + 3) >> 2;
  const bool vec = ((reinterpret_cast<uintptr_t>(out) - 4u * head) & 15u) == 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < n_quads; t += stride) {
    const float4 z = normal_quad(q0 + t, level, k0, k1);
    const int64_t o = 4 * t - head;  // where the quad's slot 0 goes
    if (vec && o >= 0 && o + 4 <= n) {
      *reinterpret_cast<float4*>(out + o) = z;
    } else {
      const float v[4] = {z.x, z.y, z.z, z.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (o + j >= 0 && o + j < n) out[o + j] = v[j];
      }
    }
  }
}

}  // namespace

extern "C" {

// Kernel A and its per-level reduction on one stream. `codes` is the tile
// schedule of cuda_kernels._tile_schedule(n_moments) (n_codes entries);
// `partial` holds n_blocks x gram::n_out(n_codes) doubles. Returns the
// CUDA error code of the launches (0 on success).
int synth_mlmc_launch(const float* x, const int64_t* blk, int n_blocks,
                      const float* lvl, const int64_t* lvl_blocks,
                      int n_levels, const int32_t* codes, int n_codes,
                      int n_moments, float t_scale, float t_shift,
                      uint32_t k0, uint32_t k1, double* partial,
                      long long* partial_n, double* sums, double* sums2,
                      double* cov_f, double* cov_c, long long* n_valid,
                      void* stream) {
  if (n_moments < 1 || n_moments > gram::kRPad) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n_moments + 7) / 8;
  if (n_codes != 2 * gram::n_tiles(nb)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (nb) {
    case 1: err = launch_synth<1>(x, blk, n_blocks, lvl, codes, n_codes, n_moments, t_scale, t_shift, k0, k1, partial, partial_n, s); break;
    case 2: err = launch_synth<2>(x, blk, n_blocks, lvl, codes, n_codes, n_moments, t_scale, t_shift, k0, k1, partial, partial_n, s); break;
    case 3: err = launch_synth<3>(x, blk, n_blocks, lvl, codes, n_codes, n_moments, t_scale, t_shift, k0, k1, partial, partial_n, s); break;
    default: err = launch_synth<4>(x, blk, n_blocks, lvl, codes, n_codes, n_moments, t_scale, t_shift, k0, k1, partial, partial_n, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram::launch_reduce(
      partial, partial_n, lvl_blocks, n_levels, LevelCoarse{lvl}, codes,
      n_codes, n_moments, sums, sums2, cov_f, cov_c, n_valid, s));
}

// Kernel B: out[i] = normal(seed, level, start + i) for i < n.
int normals_dump_launch(float* out, long long n, long long start,
                        uint32_t level, uint32_t k0, uint32_t k1,
                        void* stream) {
  if (n <= 0) return 0;
  if (start < 0) return static_cast<int>(cudaErrorInvalidValue);
  int device = 0;
  int n_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n_quads = (n + (start & 3) + 3) / 4;
  long long blocks = (n_quads + kNormalsThreads - 1) / kNormalsThreads;
  const long long cap = static_cast<long long>(n_sm) * kNormalsBlocksPerSm;
  if (blocks > cap) blocks = cap;
  normals_dump_kernel<<<static_cast<int>(blocks), kNormalsThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(out, n, start,
                                                             level, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
