// Fused synthetic-sample -> Legendre-moment kernels for Hopper (sm_90a).
//
// Kernel A (synth_mlmc_kernel<NB> + gram_reduce) replaces the Pallas
// kernels _synth_mlmc_kernel, _synth_moment_kernel and
// _synth_moment_kernel_noise (mlmc_tpu/ops/pallas_kernels.py:605, :248,
// :270). Kernel B (normals_dump_kernel) replaces _normals_dump_kernel
// (:1013). Both share one Philox4x32-10 + Box-Muller device function.
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
// level (half on level 0), plus per sample one Philox4x32-10, Box-Muller's
// f32 log/sqrt/cos and 2(R - 2) correctly rounded f32 divisions in the
// recurrences (a reciprocal multiplication and two fused corrections,
// gram::div_small). The Grams run on the FP64 tensor cores with
// register-level operand reuse
// (csrc/moment_gram.cuh, which states the instruction, fragment layout,
// flush length and register budget). What is left is measured
// (mlmc_tpu_torch/tool/gram_ablation.py, PERF.md): the recurrences' long
// dependent chains, the DMMA issue, and the RNG, which overlap little at the
// 8 warps per SM that the registers and shared memory allow. A lane builds
// one sample per 32-sample chunk, fine and coarse in lockstep, and draws
// the next chunk's sample before the tiles run; level 0 (no coarse part,
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

// Standard normal of (seed, level, index): one Philox call, words 0 and 1
// feed Box-Muller exactly as mlmc_tpu's _normal_pair maps its bits (top 24
// bits, u1 offset by half an ulp), cosine branch only.
__device__ __forceinline__ float normal_at(uint64_t index, uint32_t level,
                                           uint32_t k0, uint32_t k1) {
  uint32_t c[4] = {static_cast<uint32_t>(index),
                   static_cast<uint32_t>(index >> 32), level, 0u};
  philox4x32_10(c, k0, k1);
  const float i1 = static_cast<float>(static_cast<int>(c[0] >> 8));
  const float i2 = static_cast<float>(static_cast<int>(c[1] >> 8));
  const float u1 = i1 * 5.9604644775390625e-08f + 2.98023223876953125e-08f;
  const float u2 = i2 * 5.9604644775390625e-08f;
  const float r = sqrtf(-2.0f * logf(u1));
  return r * cosf(6.28318548202514648f * u2);
}

// has_coarse of a level: column 2 of the level table
struct LevelCoarse {
  const float* lvl;
  __device__ bool operator()(int level) const { return lvl[3 * level + 2] != 0.0f; }
};

// Per-sample input and rows of kernel A (see gram::block_span)
struct SynthRows {
  const float* x;  // memory mode; nullptr in RNG mode
  int64_t start;   // first sample index of the block within its level
  int64_t xoff;    // offset of that sample in x
  uint32_t level, k0, k1;
  float fine_step, coarse_step, t_scale, t_shift;
  int R;

  template <typename HCF>
  __device__ __forceinline__ float fetch(int64_t s, bool in_range, HCF) const {
    if (!in_range) return 0.0f;
    return x != nullptr ? x[xoff + s]
                        : normal_at(static_cast<uint64_t>(start + s), level, k0, k1);
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
  double* out = partial + static_cast<int64_t>(blockIdx.x) * gram::n_out(n_codes);
  if (lvl[3 * level + 2] != 0.0f) {
    gram::block_span<NB, true>(count, n_moments, codes, n_codes, rows, out,
                               partial_n + blockIdx.x);
  } else {
    gram::block_span<NB, false>(count, n_moments, codes, n_codes, rows, out,
                                partial_n + blockIdx.x);
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

__global__ void normals_dump_kernel(float* __restrict__ out, int64_t n,
                                    int64_t start, uint32_t level,
                                    uint32_t k0, uint32_t k1) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = normal_at(static_cast<uint64_t>(start + i), level, k0, k1);
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
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  normals_dump_kernel<<<static_cast<int>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(out, n, start,
                                                             level, k0, k1);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
