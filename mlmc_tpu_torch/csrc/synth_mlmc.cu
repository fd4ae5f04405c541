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
// level (half on level 0), plus per sample a quarter of a Philox4x32-10
// call, half a Box-Muller pair (f32 log, sqrt, sin and cos) and 2(R - 2)
// correctly rounded f32 divisions in the
// recurrences (a reciprocal multiplication and two fused corrections,
// gram::div_small). The Grams run on the FP64 tensor cores with
// register-level operand reuse
// (csrc/moment_gram.cuh, which states the instruction, fragment layout,
// flush length and register budget). What is left is measured
// (mlmc_tpu_torch/tool/gram_ablation.py, PERF.md): the recurrences' long
// dependent chains, the DMMA issue, and the RNG, which overlap little at the
// 8 warps per SM that the registers and shared memory allow. A lane builds
// one sample per 32-sample chunk, fine and coarse in lockstep, and fetches
// the next chunk's sample before the tiles run. In RNG mode a warp's four
// consecutive chunks take the 128 consecutive samples of 32 quads, lane l
// the four slots of quad l (SynthOrder): the lane draws one Philox call on
// the first of the four chunks, keeps the other three normals in its own
// shared-memory slot (no registers held across the tiles, which run at the
// 255-register limit at R = 25), and the warp skips the call on the other
// three. A span whose first index is not a multiple of 4 starts and ends
// inside a quad; its head and tail slots outside the span are drawn and
// masked, and the neighbouring span builds them. Level 0 (no coarse part,
// 64% of the headline's samples) builds one row and runs the fine Gram
// only. One block per 2^16-sample span of a level, the blocks of levels
// with a coarse part first; a second pass reduces each level's block
// partials in block order: no atomics, results are deterministic.
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
// f64 products use DMMA or explicit fma().

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

// has_coarse of a level: column 2 of the level table
struct LevelCoarse {
  const float* lvl;
  __device__ bool operator()(int level) const { return lvl[3 * level + 2] != 0.0f; }
};

// Kernel A's sample order (gram::block_span): the interleaved chunks of
// kernels C and D in memory mode; quads in RNG mode. There slot s of the
// span is sample start + s, and with head = start & 3, chunk k of warp w
// takes quad t = ((k >> 2) kWarps + w) kChunk + lane of the span (counted
// from the quad boundary at or below start), slot k & 3 of it: s = 4t +
// (k & 3) - head. Chunks run in fours while their first quad is in the
// span.
struct SynthOrder {
  bool quads;       // RNG mode
  int head;         // start & 3
  int64_t n_quads;  // quads that hold the span's samples

  __device__ __forceinline__ int64_t slot(int64_t k, int warp, int lane) const {
    if (!quads) return gram::Interleaved{}.slot(k, warp, lane);
    const int64_t t = ((k >> 2) * gram::kWarps + warp) * gram::kChunk + lane;
    return 4 * t + (k & 3) - head;
  }
  __device__ __forceinline__ bool runs(int64_t k, int warp, int64_t count) const {
    if (!quads) return gram::Interleaved{}.runs(k, warp, count);
    return ((k >> 2) * gram::kWarps + warp) * gram::kChunk < n_quads;
  }
};

// RNG mode: the calling lane's slot of the block's shared memory, which
// holds the four normals of its current quad (indexed by threadIdx.x, so no
// pointer is carried through the loop)
__device__ __forceinline__ float* quad_slot() {
  __shared__ float4 quads[gram::kThreads];
  return reinterpret_cast<float*>(quads + threadIdx.x);
}

// Per-sample input and rows of kernel A (see gram::block_span)
struct SynthRows {
  const float* x;  // memory mode; nullptr in RNG mode
  int64_t start;   // first sample index of the block within its level
  int64_t xoff;    // offset of that sample in x
  uint32_t level, k0, k1;
  float fine_step, coarse_step, t_scale, t_shift;
  int R;

  // RNG mode visits slots in SynthOrder's quads: slot 0 of a quad draws its
  // call (drawn and discarded where it lies outside the span), slots 1-3
  // read the normals it left in the lane's quad_slot
  template <typename HCF>
  __device__ __forceinline__ float fetch(int64_t s, bool in_range, HCF) const {
    if (x != nullptr) return in_range ? x[xoff + s] : 0.0f;
    const uint64_t i = static_cast<uint64_t>(start + s);
    if ((i & 3) == 0) {
      const float4 z = normal_quad(i >> 2, level, k0, k1);
      *reinterpret_cast<float4*>(quad_slot()) = z;
      return z.x;
    }
    return quad_slot()[i & 3];
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

// Block table: [n_blocks, 4] int64 = (level, first sample index within the
// level, sample count, offset into x for memory mode).
// Level table: [n_levels, 3] f32 = (fine step, coarse step, has coarse).
// codes: the tile schedule (moment_gram.cuh), n_codes = 2 n_tiles(NB).
template <int NB>
__global__ void __launch_bounds__(gram::kThreads)
synth_mlmc_kernel(const float* __restrict__ x, const int64_t* __restrict__ blk,
                  const float* __restrict__ lvl,
                  const int32_t* __restrict__ codes, int n_codes,
                  int n_moments, float t_scale, float t_shift, uint32_t k0,
                  uint32_t k1, double* __restrict__ partial,
                  long long* __restrict__ partial_n) {
  const int64_t* b = blk + 4 * static_cast<int64_t>(blockIdx.x);
  const int level = static_cast<int>(b[0]);
  const int64_t count = b[2];
  const SynthRows rows{x, b[1], b[3], static_cast<uint32_t>(level), k0, k1,
                       lvl[3 * level + 0], lvl[3 * level + 1], t_scale,
                       t_shift, n_moments};
  const int head = static_cast<int>(b[1] & 3);
  const SynthOrder order{x == nullptr, head, count > 0 ? (count + head + 3) >> 2 : 0};
  double* out = partial + static_cast<int64_t>(blockIdx.x) * gram::n_out(n_codes);
  if (lvl[3 * level + 2] != 0.0f) {
    gram::block_span<NB, true>(count, n_moments, codes, n_codes, rows, out,
                               partial_n + blockIdx.x, order);
  } else {
    gram::block_span<NB, false>(count, n_moments, codes, n_codes, rows, out,
                                partial_n + blockIdx.x, order);
  }
}

template <int NB>
cudaError_t launch_synth(const float* x, const int64_t* blk, int n_blocks,
                         const float* lvl, const int32_t* codes, int n_codes,
                         int n_moments, float t_scale, float t_shift,
                         uint32_t k0, uint32_t k1, double* partial,
                         long long* partial_n, cudaStream_t s) {
  const size_t smem = gram::smem_bytes(n_moments);
  cudaError_t err = cudaFuncSetAttribute(
      synth_mlmc_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  synth_mlmc_kernel<NB><<<n_blocks, gram::kThreads, smem, s>>>(
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
