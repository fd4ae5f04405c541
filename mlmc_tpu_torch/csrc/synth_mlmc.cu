// Fused synthetic-sample -> Legendre-moment kernels for Hopper (sm_90a).
//
// Kernel A (synth_mlmc_kernel + synth_mlmc_reduce) replaces the Pallas
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
// the upper triangles of sum(phi_f phi_f^T) and sum(phi_c phi_c^T), plus an
// int64 valid count. Each thread sums a tile's products per slot and adds
// the tile sum into its running total with Kahan compensation.
//
// Bound on the card: ~1.3k f64 multiply-adds per sample for the two R=25
// outer products, each fed by two shared-memory loads, plus f32
// transcendentals for Box-Muller; nothing is read from device memory in RNG
// mode, so the kernel is compute-bound (shared-memory bandwidth and the f64
// pipe), not memory-bound. The design keeps every per-sample value in
// shared memory (one 64-sample tile of both Legendre blocks, stored as f64
// so each value is converted once), gives each thread a fixed set of
// accumulator slots in registers, and writes one f64 partial per block and
// slot. A second kernel reduces the partials of each level in block order:
// no atomics, so results are deterministic.
//
// The TPU workarounds are not carried over: no bf16 hi/lo split (the
// outer products run in f64), no Kahan scratch carried along a sequential
// grid (f64 partials per block), and no sequential-grid zeroing (partials
// are written, never accumulated in place).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 --fmad=false
// -shared -Xcompiler -fPIC. --fmad=false keeps the f32 value path from
// contracting a*b+c into one rounding, so memory mode reproduces numpy's
// f32 per-sample values bit for bit, and keeps the Kahan steps exact; the
// outer products use explicit fma().

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kRPad = 32;             // largest supported moment count
constexpr int kThreads = 128;         // threads per block of kernel A
constexpr int kTile = kThreads / 2;   // samples per tile
constexpr int kStride = kTile + 1;    // padded row stride (bank spread)
constexpr int kMaxSlotsPerThread = 9; // ceil((2*32 + 2*528) / 128)

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

// Block table: [n_blocks, 4] int64 = (level, first sample index within the
// level, sample count, offset into x for memory mode).
// Level table: [n_levels, 3] f32 = (fine step, coarse step, has coarse).
// Slot codes: [n_slots] int32 = mode << 16 | a << 8 | b, where mode 0 is
// sum(phi_f[a] - phi_c[a]), 1 its square, 2 phi_f[a] phi_f[b], 3
// phi_c[a] phi_c[b]; slots list sums, sums2, then the two upper triangles.
__global__ void __launch_bounds__(kThreads)
synth_mlmc_kernel(const float* __restrict__ x, const int64_t* __restrict__ blk,
                  const float* __restrict__ lvl,
                  const int32_t* __restrict__ slot_codes, int n_slots,
                  int n_moments, float t_scale, float t_shift, uint32_t k0,
                  uint32_t k1, double* __restrict__ partial,
                  long long* __restrict__ partial_n) {
  __shared__ double phi[2 * kRPad * kStride];
  __shared__ int warp_counts[kThreads / 32];

  const int tid = threadIdx.x;
  const int64_t* b = blk + 4 * static_cast<int64_t>(blockIdx.x);
  const int level = static_cast<int>(b[0]);
  const int64_t start = b[1];
  const int64_t count = b[2];
  const int64_t xoff = b[3];
  const float fine_step = lvl[3 * level + 0];
  const float coarse_step = lvl[3 * level + 1];
  const bool has_coarse = lvl[3 * level + 2] != 0.0f;

  // per-slot operands: offsets of the two shared-memory rows it reads
  int mode[kMaxSlotsPerThread];
  int off_a[kMaxSlotsPerThread];
  int off_b[kMaxSlotsPerThread];
  double acc[kMaxSlotsPerThread];
  double comp[kMaxSlotsPerThread];  // Kahan compensation of acc
#pragma unroll
  for (int m = 0; m < kMaxSlotsPerThread; ++m) {
    const int k = tid + m * kThreads;
    acc[m] = 0.0;
    comp[m] = 0.0;
    mode[m] = -1;
    off_a[m] = 0;
    off_b[m] = 0;
    if (k < n_slots) {
      const int code = slot_codes[k];
      const int md = code >> 16;
      const int ra = (code >> 8) & 0xff;
      const int rb = code & 0xff;
      mode[m] = md;
      if (md <= 1) {  // fine row a, coarse row a
        off_a[m] = ra * kStride;
        off_b[m] = (kRPad + ra) * kStride;
      } else {
        const int base = (md == 2) ? 0 : kRPad;
        off_a[m] = (base + ra) * kStride;
        off_b[m] = (base + rb) * kStride;
      }
    }
  }

  // phase-1 role: threads [0, kTile) build fine rows, the rest coarse rows
  const int side = tid / kTile;
  const int j = tid % kTile;
  double* row = phi + side * kRPad * kStride + j;
  int n_valid = 0;

  for (int64_t tile = 0; tile < count; tile += kTile) {
    const bool in_range = tile + j < count;
    float xv = 0.0f;
    if (in_range) {
      xv = (x != nullptr)
               ? x[xoff + tile + j]
               : normal_at(static_cast<uint64_t>(start + tile + j),
                           static_cast<uint32_t>(level), k0, k1);
    }
    const float err = sqrtf(1e-4f + fabsf(xv));
    const float fine = xv + fine_step * err;
    const float coarse = xv + coarse_step * err;
    const float t_f = (fine - t_shift) * t_scale;
    const float t_c = (coarse - t_shift) * t_scale;
    bool valid = in_range && (t_f >= -1.0f) && (t_f <= 1.0f);
    if (has_coarse) valid = valid && (t_c >= -1.0f) && (t_c <= 1.0f);
    if (side == 0 && valid) ++n_valid;

    if (side == 1 && !has_coarse) {
      for (int n = 0; n < n_moments; ++n) row[n * kStride] = 0.0;
    } else {
      const float t = valid ? (side == 0 ? t_f : t_c) : 0.0f;
      const float v = valid ? 1.0f : 0.0f;
      row[0] = static_cast<double>(v);
      if (n_moments > 1) row[kStride] = static_cast<double>(t);
      float p2 = v;
      float p1 = t;
      for (int n = 2; n < n_moments; ++n) {
        const float cur = (static_cast<float>(2 * n - 1) * t * p1 -
                           static_cast<float>(n - 1) * p2) /
                          static_cast<float>(n);
        row[n * kStride] = static_cast<double>(cur);
        p2 = p1;
        p1 = cur;
      }
    }
    __syncthreads();

    // each slot sums the tile's products, then adds the tile sum into its
    // running total with Kahan compensation: the error stays at the
    // tile's 64-term chain, not the block's whole span
    const int64_t rest = count - tile;
    const int tile_n = rest < kTile ? static_cast<int>(rest) : kTile;
#pragma unroll
    for (int m = 0; m < kMaxSlotsPerThread; ++m) {
      const int md = mode[m];
      if (md < 0) continue;
      const double* pa = phi + off_a[m];
      const double* pb = phi + off_b[m];
      double s = 0.0;
      if (md >= 2) {
        for (int jj = 0; jj < tile_n; ++jj) s = fma(pa[jj], pb[jj], s);
      } else if (md == 0) {
        for (int jj = 0; jj < tile_n; ++jj) s += pa[jj] - pb[jj];
      } else {
        for (int jj = 0; jj < tile_n; ++jj) {
          const double d = pa[jj] - pb[jj];
          s += d * d;
        }
      }
      const double y = s - comp[m];
      const double t = acc[m] + y;
      comp[m] = (t - acc[m]) - y;
      acc[m] = t;
    }
    __syncthreads();
  }

  double* out = partial + static_cast<int64_t>(blockIdx.x) * n_slots;
#pragma unroll
  for (int m = 0; m < kMaxSlotsPerThread; ++m) {
    const int k = tid + m * kThreads;
    if (k < n_slots) out[k] = acc[m] - comp[m];
  }

  // exact valid count: warp shuffle, then the block's warps in order
  for (int o = 16; o > 0; o >>= 1) n_valid += __shfl_down_sync(0xffffffffu, n_valid, o);
  if ((tid & 31) == 0) warp_counts[tid >> 5] = n_valid;
  __syncthreads();
  if (tid == 0) {
    long long total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += warp_counts[w];
    partial_n[blockIdx.x] = total;
  }
}

// One block per level: each slot sums its level's block partials in block
// order (fixed order, deterministic), then scatters into the outputs.
__global__ void synth_mlmc_reduce(const double* __restrict__ partial,
                                  const long long* __restrict__ partial_n,
                                  const int64_t* __restrict__ lvl_blocks,
                                  const int32_t* __restrict__ slot_codes,
                                  int n_slots, int n_moments,
                                  double* __restrict__ sums,
                                  double* __restrict__ sums2,
                                  double* __restrict__ cov_f,
                                  double* __restrict__ cov_c,
                                  long long* __restrict__ n_valid) {
  const int level = blockIdx.x;
  const int64_t first = lvl_blocks[2 * level];
  const int64_t n_blk = lvl_blocks[2 * level + 1];
  const int R = n_moments;
  for (int k = threadIdx.x; k < n_slots; k += blockDim.x) {
    double s = 0.0;
    double c = 0.0;  // Kahan compensation
    for (int64_t i = 0; i < n_blk; ++i) {
      const double y = partial[(first + i) * n_slots + k] - c;
      const double t = s + y;
      c = (t - s) - y;
      s = t;
    }
    s -= c;
    const int code = slot_codes[k];
    const int md = code >> 16;
    const int ra = (code >> 8) & 0xff;
    const int rb = code & 0xff;
    if (md == 0) {
      sums[level * R + ra] = s;
    } else if (md == 1) {
      sums2[level * R + ra] = s;
    } else {
      double* cov = (md == 2 ? cov_f : cov_c) + static_cast<int64_t>(level) * R * R;
      cov[ra * R + rb] = s;
      cov[rb * R + ra] = s;
    }
  }
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int64_t i = 0; i < n_blk; ++i) total += partial_n[first + i];
    n_valid[level] = total;
  }
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

// Kernel A and its per-level reduction on one stream. Returns the CUDA
// error code of the launches (0 on success).
int synth_mlmc_launch(const float* x, const int64_t* blk, int n_blocks,
                      const float* lvl, const int64_t* lvl_blocks,
                      int n_levels, const int32_t* slot_codes, int n_slots,
                      int n_moments, float t_scale, float t_shift,
                      uint32_t k0, uint32_t k1, double* partial,
                      long long* partial_n, double* sums, double* sums2,
                      double* cov_f, double* cov_c, long long* n_valid,
                      void* stream) {
  if (n_moments < 1 || n_moments > kRPad) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots > kMaxSlotsPerThread * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  synth_mlmc_kernel<<<n_blocks, kThreads, 0, s>>>(
      x, blk, lvl, slot_codes, n_slots, n_moments, t_scale, t_shift, k0, k1,
      partial, partial_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  synth_mlmc_reduce<<<n_levels, 256, 0, s>>>(partial, partial_n, lvl_blocks,
                                             slot_codes, n_slots, n_moments,
                                             sums, sums2, cov_f, cov_c,
                                             n_valid);
  return static_cast<int>(cudaGetLastError());
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
