// Stored-sample -> moment kernels for Hopper (sm_90a).
//
// Kernel C (samples_gram_kernel<NB> + gram_reduce, entry
// samples_mlmc_launch) replaces the Pallas kernels _samples_mlmc_kernel and
// _samples_moment_kernel (mlmc_tpu/ops/pallas_kernels.py:815 and :324,
// body _accumulate_qoi_chunk :288): every (component, level) stream of
// stored fine/coarse QoIs in one launch. Kernel D (samples_kernel<double>,
// entry samples_ext_launch) replaces the double-float kernel
// _samples_kernel_ext (mlmc_tpu/ops/pallas_extended.py:269, body
// _accumulate_qoi_chunk_ext :223): the same function with the transform and
// the basis rows in f64. Hopper has native f64, so none of the double-float
// mechanics come over.
//
// Per sample of a stream: t = (x - shift) * scale + offset for the fine QoI
// and, where the stream has a coarse part, the coarse one; the sample is
// valid when every such t lies in [lo, hi] (NaN fails every comparison);
// t := 0 where invalid and row 0 carries the valid mask, so invalid samples
// give zero rows. Rows are the Legendre three-term recurrence, monomial
// powers, or Fourier [1, cos, sin, ...] by angle addition, in the operation
// order of pallas_kernels._basis_rows (f32 for C, f64 for D). The sums are
// f64: sum(phi_f - phi_c), sum((phi_f - phi_c)^2) and the Grams
// sum(phi_f phi_f^T), sum(phi_c phi_c^T) (phi_c = 0 on a stream without a
// coarse part), plus an int64 valid count.
//
// Bound on the card: per valid sample of a coarse-bearing stream, R^2 + 3R
// f64 multiply-adds, about half that on a fine-only stream, against 4 or 8
// bytes read; at R = 25 that is ~700 f64 multiply-adds per 8 bytes, so the
// kernels are bound by f64 arithmetic, not by device memory.
//
// Kernel C runs the Grams on the FP64 tensor cores (csrc/moment_gram.cuh:
// DMMA m16n8k8 with register-level operand reuse, warp-private rows, a
// flush every 64 samples; its note states the fragment layout and register
// budget); a fine-only stream builds no coarse rows and runs no coarse
// tiles, and each lane reads its next sample before the tiles of the
// current chunk run. One block per 2^14-sample span of one stream from a
// block table over the streams' true counts, coarse-bearing streams first
// (NaN padding costs no work, and a zero-sample stream keeps one empty
// block so its outputs are written as zeros); a second kernel sums a
// stream's partials in block order. No atomics: results are deterministic.
//
// Kernel D keeps the slot loop: each 64-sample tile's rows go to shared
// memory as f64, each thread owns a fixed set of accumulator slots in
// registers and adds the tile's products into them with Kahan compensation;
// its deviation bound against the strict f64 reference
// (ops/precision.extended_error_bound) was derived for that summation
// order.
//
// Build with --fmad=false and IEEE division: the transform must judge
// validity exactly as the host does (estimator._harmonize_validity), and a
// contracted x*scale + offset can move a sample across the domain edge.

#include <cstdint>
#include <cuda_runtime.h>

#include "moment_gram.cuh"

namespace {

constexpr int kRPad = 32;             // largest supported moment count
constexpr int kThreads = 128;         // threads per block
constexpr int kTile = kThreads / 2;   // samples per tile
constexpr int kStride = kTile + 1;    // padded row stride (bank spread)
constexpr int kMaxSlotsPerThread = 9; // ceil((2*32 + 2*528) / 128)

__device__ __forceinline__ double dev_cos(double x) { return cos(x); }
__device__ __forceinline__ double dev_sin(double x) { return sin(x); }

// Basis rows of one sample into a shared-memory column (stride kStride):
// basis 0 Legendre, 1 monomial, 2 Fourier.
template <typename T>
__device__ __forceinline__ void basis_rows(double* row, T t, T v,
                                           int n_moments, int basis) {
  row[0] = static_cast<double>(v);
  if (basis == 0) {
    if (n_moments > 1) row[kStride] = static_cast<double>(t);
    T p2 = v;
    T p1 = t;
    for (int n = 2; n < n_moments; ++n) {
      const T cur = (static_cast<T>(2 * n - 1) * t * p1 -
                     static_cast<T>(n - 1) * p2) /
                    static_cast<T>(n);
      row[n * kStride] = static_cast<double>(cur);
      p2 = p1;
      p1 = cur;
    }
  } else if (basis == 1) {
    T power = v;
    for (int n = 1; n < n_moments; ++n) {
      power = power * t;
      row[n * kStride] = static_cast<double>(power);
    }
  } else {
    const T c1 = dev_cos(t) * v;
    const T s1 = dev_sin(t) * v;
    T ck = c1;
    T sk = s1;
    for (int i = 1; i < n_moments; ++i) {
      if (i % 2 == 1) {
        row[i * kStride] = static_cast<double>(ck);
      } else {
        row[i * kStride] = static_cast<double>(sk);
        const T nc = ck * c1 - sk * s1;
        const T ns = sk * c1 + ck * s1;
        ck = nc;
        sk = ns;
      }
    }
  }
}

// Block table: [n_blocks, 4] int64 = (stream, first sample within the
// stream, sample count, offset of that first sample in fine/coarse).
// stream_coarse: [n_streams] int32, 1 where the stream has a coarse part.
// Slot codes: [n_slots] int32 = mode << 16 | a << 8 | b, where mode 0 is
// sum(phi_f[a] - phi_c[a]), 1 its square, 2 phi_f[a] phi_f[b], 3
// phi_c[a] phi_c[b].
template <typename T>
__global__ void __launch_bounds__(kThreads)
samples_kernel(const float* __restrict__ fine, const float* __restrict__ coarse,
               const int64_t* __restrict__ blk,
               const int32_t* __restrict__ stream_coarse,
               const int32_t* __restrict__ slot_codes, int n_slots,
               int n_moments, int basis, T scale, T shift, T offset, T lo,
               T hi, double* __restrict__ partial,
               long long* __restrict__ partial_n) {
  __shared__ double phi[2 * kRPad * kStride];
  __shared__ int warp_counts[kThreads / 32];

  const int tid = threadIdx.x;
  const int64_t* b = blk + 4 * static_cast<int64_t>(blockIdx.x);
  const int stream = static_cast<int>(b[0]);
  const int64_t count = b[2];
  const int64_t off = b[3];
  const bool has_coarse = stream_coarse[stream] != 0;

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

  // row-building role: threads [0, kTile) fine rows, the rest coarse rows
  const int side = tid / kTile;
  const int j = tid % kTile;
  double* row = phi + side * kRPad * kStride + j;
  int n_valid = 0;

  for (int64_t tile = 0; tile < count; tile += kTile) {
    const bool in_range = tile + j < count;
    T xf = static_cast<T>(0);
    T xc = static_cast<T>(0);
    if (in_range) {
      xf = static_cast<T>(fine[off + tile + j]);
      if (has_coarse) xc = static_cast<T>(coarse[off + tile + j]);
    }
    const T t_f = (xf - shift) * scale + offset;
    const T t_c = (xc - shift) * scale + offset;
    bool valid = in_range && (t_f >= lo) && (t_f <= hi);
    if (has_coarse) valid = valid && (t_c >= lo) && (t_c <= hi);
    if (side == 0 && valid) ++n_valid;

    if (side == 1 && !has_coarse) {
      for (int n = 0; n < n_moments; ++n) row[n * kStride] = 0.0;
    } else {
      const T t = valid ? (side == 0 ? t_f : t_c) : static_cast<T>(0);
      const T v = valid ? static_cast<T>(1) : static_cast<T>(0);
      basis_rows<T>(row, t, v, n_moments, basis);
    }
    __syncthreads();

    // each slot sums the tile's products, then adds the tile sum into its
    // running total with Kahan compensation
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

// One block per stream: each slot sums its stream's block partials in block
// order (fixed order, deterministic), then scatters into the outputs.
__global__ void samples_reduce(const double* __restrict__ partial,
                               const long long* __restrict__ partial_n,
                               const int64_t* __restrict__ stream_blocks,
                               const int32_t* __restrict__ slot_codes,
                               int n_slots, int n_moments,
                               double* __restrict__ sums,
                               double* __restrict__ sums2,
                               double* __restrict__ cov_f,
                               double* __restrict__ cov_c,
                               long long* __restrict__ n_valid) {
  const int s_id = blockIdx.x;
  const int64_t first = stream_blocks[2 * s_id];
  const int64_t n_blk = stream_blocks[2 * s_id + 1];
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
      sums[static_cast<int64_t>(s_id) * R + ra] = s;
    } else if (md == 1) {
      sums2[static_cast<int64_t>(s_id) * R + ra] = s;
    } else {
      double* cov = (md == 2 ? cov_f : cov_c) + static_cast<int64_t>(s_id) * R * R;
      cov[ra * R + rb] = s;
      cov[rb * R + ra] = s;
    }
  }
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int64_t i = 0; i < n_blk; ++i) total += partial_n[first + i];
    n_valid[s_id] = total;
  }
}

template <typename T>
int samples_launch(const float* fine, const float* coarse, const int64_t* blk,
                   int n_blocks, const int32_t* stream_coarse,
                   const int64_t* stream_blocks, int n_streams,
                   const int32_t* slot_codes, int n_slots, int n_moments,
                   int basis, double scale, double shift, double offset,
                   double lo, double hi, double* partial, long long* partial_n,
                   double* sums, double* sums2, double* cov_f, double* cov_c,
                   long long* n_valid, void* stream) {
  if (n_moments < 1 || n_moments > kRPad) return static_cast<int>(cudaErrorInvalidValue);
  if (n_slots > kMaxSlotsPerThread * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (basis < 0 || basis > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0 || n_streams <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  samples_kernel<T><<<n_blocks, kThreads, 0, s>>>(
      fine, coarse, blk, stream_coarse, slot_codes, n_slots, n_moments, basis,
      static_cast<T>(scale), static_cast<T>(shift), static_cast<T>(offset),
      static_cast<T>(lo), static_cast<T>(hi), partial, partial_n);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  samples_reduce<<<n_streams, 256, 0, s>>>(partial, partial_n, stream_blocks,
                                           slot_codes, n_slots, n_moments,
                                           sums, sums2, cov_f, cov_c, n_valid);
  return static_cast<int>(cudaGetLastError());
}

// has_coarse of a stream
struct StreamCoarse {
  const int32_t* flags;
  __device__ bool operator()(int stream) const { return flags[stream] != 0; }
};

// Per-sample input and rows of kernel C (see gram::block_span)
struct SampleRows {
  const float* fine;
  const float* coarse;
  int64_t off;  // offset of the block's first sample in fine / coarse
  float scale, shift, offset, lo, hi;
  int R, basis;

  struct Input {
    float f, c;
  };

  template <typename HCF>
  __device__ __forceinline__ Input fetch(int64_t s, bool in_range, HCF) const {
    Input in{0.0f, 0.0f};
    if (in_range) {
      in.f = fine[off + s];
      if constexpr (HCF::value) in.c = coarse[off + s];
    }
    return in;
  }

  template <typename HCF>
  __device__ __forceinline__ bool build(Input in, bool in_range, double* row_f,
                                        double* row_c, HCF) const {
    const float t_f = (in.f - shift) * scale + offset;
    bool valid = in_range && (t_f >= lo) && (t_f <= hi);
    float t_c = 0.0f;
    if constexpr (HCF::value) {
      t_c = (in.c - shift) * scale + offset;
      valid = valid && (t_c >= lo) && (t_c <= hi);
    }
    const float v = valid ? 1.0f : 0.0f;
    if constexpr (HCF::value) {
      double* const out[2] = {row_f, row_c};
      const float t[2] = {valid ? t_f : 0.0f, valid ? t_c : 0.0f};
      gram::basis_rows<2>(out, t, v, R, basis);
    } else {
      double* const out[1] = {row_f};
      const float t[1] = {valid ? t_f : 0.0f};
      gram::basis_rows<1>(out, t, v, R, basis);
    }
    return valid;
  }
};

// Kernel C: f32 transform and rows, Grams on the FP64 tensor cores. Block
// table and stream_coarse as for samples_kernel; codes: the tile schedule
// (moment_gram.cuh), n_codes = 2 n_tiles(NB).
template <int NB>
__global__ void __launch_bounds__(gram::kThreads)
samples_gram_kernel(const float* __restrict__ fine,
                    const float* __restrict__ coarse,
                    const int64_t* __restrict__ blk,
                    const int32_t* __restrict__ stream_coarse,
                    const int32_t* __restrict__ codes, int n_codes,
                    int n_moments, int basis, float scale, float shift,
                    float offset, float lo, float hi,
                    double* __restrict__ partial,
                    long long* __restrict__ partial_n) {
  const int64_t* b = blk + 4 * static_cast<int64_t>(blockIdx.x);
  const int stream = static_cast<int>(b[0]);
  const int64_t count = b[2];
  const SampleRows rows{fine, coarse, b[3], scale, shift, offset, lo, hi,
                        n_moments, basis};
  double* out = partial + static_cast<int64_t>(blockIdx.x) * gram::n_out(n_codes);
  if (stream_coarse[stream] != 0) {
    gram::block_span<NB, true>(count, n_moments, codes, n_codes, rows, out,
                               partial_n + blockIdx.x);
  } else {
    gram::block_span<NB, false>(count, n_moments, codes, n_codes, rows, out,
                                partial_n + blockIdx.x);
  }
}

template <int NB>
cudaError_t launch_samples_gram(const float* fine, const float* coarse,
                                const int64_t* blk, int n_blocks,
                                const int32_t* stream_coarse,
                                const int32_t* codes, int n_codes,
                                int n_moments, int basis, float scale,
                                float shift, float offset, float lo, float hi,
                                double* partial, long long* partial_n,
                                cudaStream_t s) {
  const size_t smem = gram::smem_bytes(n_moments);
  cudaError_t err = cudaFuncSetAttribute(
      samples_gram_kernel<NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  samples_gram_kernel<NB><<<n_blocks, gram::kThreads, smem, s>>>(
      fine, coarse, blk, stream_coarse, codes, n_codes, n_moments, basis,
      scale, shift, offset, lo, hi, partial, partial_n);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Kernel C: f32 transform and rows (the constants are f32 values passed
// as double), f64 sums. `codes` is the tile schedule of
// cuda_kernels._tile_schedule(n_moments) (n_codes entries); `partial` holds
// n_blocks x gram::n_out(n_codes) doubles. Returns the CUDA error code of
// the launches.
int samples_mlmc_launch(const float* fine, const float* coarse,
                        const int64_t* blk, int n_blocks,
                        const int32_t* stream_coarse,
                        const int64_t* stream_blocks, int n_streams,
                        const int32_t* codes, int n_codes, int n_moments,
                        int basis, double scale, double shift, double offset,
                        double lo, double hi, double* partial,
                        long long* partial_n, double* sums, double* sums2,
                        double* cov_f, double* cov_c, long long* n_valid,
                        void* stream) {
  if (n_moments < 1 || n_moments > gram::kRPad) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n_moments + 7) / 8;
  if (n_codes != 2 * gram::n_tiles(nb)) return static_cast<int>(cudaErrorInvalidValue);
  if (basis < 0 || basis > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0 || n_streams <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float f[5] = {static_cast<float>(scale), static_cast<float>(shift),
                      static_cast<float>(offset), static_cast<float>(lo),
                      static_cast<float>(hi)};
  cudaError_t err;
  switch (nb) {
    case 1: err = launch_samples_gram<1>(fine, coarse, blk, n_blocks, stream_coarse, codes, n_codes, n_moments, basis, f[0], f[1], f[2], f[3], f[4], partial, partial_n, s); break;
    case 2: err = launch_samples_gram<2>(fine, coarse, blk, n_blocks, stream_coarse, codes, n_codes, n_moments, basis, f[0], f[1], f[2], f[3], f[4], partial, partial_n, s); break;
    case 3: err = launch_samples_gram<3>(fine, coarse, blk, n_blocks, stream_coarse, codes, n_codes, n_moments, basis, f[0], f[1], f[2], f[3], f[4], partial, partial_n, s); break;
    default: err = launch_samples_gram<4>(fine, coarse, blk, n_blocks, stream_coarse, codes, n_codes, n_moments, basis, f[0], f[1], f[2], f[3], f[4], partial, partial_n, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram::launch_reduce(
      partial, partial_n, stream_blocks, n_streams,
      StreamCoarse{stream_coarse}, codes, n_codes, n_moments, sums, sums2,
      cov_f, cov_c, n_valid, s));
}

// Kernel D: the same function with the transform and rows in f64, on the
// slot loop of samples_kernel<double>.
int samples_ext_launch(const float* fine, const float* coarse,
                       const int64_t* blk, int n_blocks,
                       const int32_t* stream_coarse,
                       const int64_t* stream_blocks, int n_streams,
                       const int32_t* slot_codes, int n_slots, int n_moments,
                       int basis, double scale, double shift, double offset,
                       double lo, double hi, double* partial,
                       long long* partial_n, double* sums, double* sums2,
                       double* cov_f, double* cov_c, long long* n_valid,
                       void* stream) {
  return samples_launch<double>(fine, coarse, blk, n_blocks, stream_coarse,
                                stream_blocks, n_streams, slot_codes, n_slots,
                                n_moments, basis, scale, shift, offset, lo, hi,
                                partial, partial_n, sums, sums2, cov_f, cov_c,
                                n_valid, stream);
}

}  // extern "C"
