// Stored-sample -> moment kernels for Hopper (sm_90a).
//
// Kernel C (samples_gram_kernel<NB, float> + gram_reduce, entry
// samples_mlmc_launch) replaces the Pallas kernels _samples_mlmc_kernel and
// _samples_moment_kernel (mlmc_tpu/ops/pallas_kernels.py:815 and :324,
// body _accumulate_qoi_chunk :288): every (component, level) stream of
// stored fine/coarse QoIs in one launch. Kernel D
// (samples_gram_kernel<NB, double>, entry samples_ext_launch) replaces the
// double-float kernel _samples_kernel_ext
// (mlmc_tpu/ops/pallas_extended.py:269, body _accumulate_qoi_chunk_ext
// :223): the same function with the transform and the basis rows in f64.
// Hopper has native f64, so none of the double-float mechanics come over.
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
// Both kernels are one template: the Grams run on the FP64 tensor cores
// (csrc/moment_gram.cuh: DMMA m16n8k8 with register-level operand reuse,
// warp-private rows, a flush every 64 samples; its note states the fragment
// layout and register budget); a fine-only stream builds no coarse rows and
// runs no coarse tiles, and each lane reads its next sample before the
// tiles of the current chunk run. One block per 2^14-sample span of one
// stream from a block table over the streams' true counts, coarse-bearing
// streams first (NaN padding costs no work, and a zero-sample stream keeps
// one empty block so its outputs are written as zeros); a second kernel
// sums a stream's partials in block order. No atomics: results are
// deterministic.
//
// Kernel D differs from C in the scalar type of the row build alone: the
// stored f32 QoI is widened to f64 before the transform, and the
// recurrence runs in f64 (2(R - 2) correctly rounded f64 divisions per
// coarse-bearing sample for Legendre, gram::div_small; cos and sin in f64
// for Fourier). Rows sit in shared memory as f64 for both kernels, so the
// tiles, flushes and the reduction are the same code. Its deviation bound
// against the strict f64 reference
// (ops/precision.extended_error_bound) is derived for this summation
// order: 64-product chains in the DMMA accumulators, plain adds of a
// warp's flushes (span / 256 per warp), the 4 warps in order, Kahan across
// blocks.
//
// Build with --fmad=false (and IEEE division and square root, though the
// kernels of this file use neither operator): the transform must judge
// validity exactly as the host does (estimator._harmonize_validity), and a
// contracted x*scale + offset can move a sample across the domain edge.

#include <cstdint>
#include <cuda_runtime.h>

#include "moment_gram.cuh"

namespace {

// has_coarse of a stream
struct StreamCoarse {
  const int32_t* flags;
  __device__ bool operator()(int stream) const { return flags[stream] != 0; }
};

// Per-sample input and rows of kernels C (T = float) and D (T = double);
// see gram::block_span. The stored f32 QoI is widened to T before the
// shift is subtracted, as the strict f64 reference does.
template <typename T>
struct SampleRows {
  const float* fine;
  const float* coarse;
  int64_t off;  // offset of the block's first sample in fine / coarse
  T scale, shift, offset, lo, hi;
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
    const T zero = static_cast<T>(0);
    const T t_f = (static_cast<T>(in.f) - shift) * scale + offset;
    bool valid = in_range && (t_f >= lo) && (t_f <= hi);
    T t_c = zero;
    if constexpr (HCF::value) {
      t_c = (static_cast<T>(in.c) - shift) * scale + offset;
      valid = valid && (t_c >= lo) && (t_c <= hi);
    }
    const T v = valid ? static_cast<T>(1) : zero;
    if constexpr (HCF::value) {
      double* const out[2] = {row_f, row_c};
      const T t[2] = {valid ? t_f : zero, valid ? t_c : zero};
      gram::basis_rows<2>(out, t, v, R, basis);
    } else {
      double* const out[1] = {row_f};
      const T t[1] = {valid ? t_f : zero};
      gram::basis_rows<1>(out, t, v, R, basis);
    }
    return valid;
  }
};

// Kernels C and D: transform and rows in T, Grams on the FP64 tensor cores.
// Block table: [n_blocks, 4] int64 = (stream, first sample within the
// stream, sample count, offset of that first sample in fine/coarse).
// stream_coarse: [n_streams] int32, 1 where the stream has a coarse part.
// codes: the tile schedule (moment_gram.cuh), n_codes = 2 n_tiles(NB).
// `rows` carries the call's constants; its `off` is set per block.
template <int NB, typename T>
__global__ void __launch_bounds__(gram::kThreads)
samples_gram_kernel(SampleRows<T> rows, const int64_t* __restrict__ blk,
                    const int32_t* __restrict__ stream_coarse,
                    const int32_t* __restrict__ codes, int n_codes,
                    double* __restrict__ partial,
                    long long* __restrict__ partial_n) {
  const int64_t* b = blk + 4 * static_cast<int64_t>(blockIdx.x);
  const int stream = static_cast<int>(b[0]);
  const int64_t count = b[2];
  rows.off = b[3];
  double* out = partial + static_cast<int64_t>(blockIdx.x) * gram::n_out(n_codes);
  if (stream_coarse[stream] != 0) {
    gram::block_span<NB, true>(count, rows.R, codes, n_codes, rows, out,
                               partial_n + blockIdx.x);
  } else {
    gram::block_span<NB, false>(count, rows.R, codes, n_codes, rows, out,
                                partial_n + blockIdx.x);
  }
}

template <int NB, typename T>
cudaError_t launch_samples_gram(const SampleRows<T>& rows, const int64_t* blk,
                                int n_blocks, const int32_t* stream_coarse,
                                const int32_t* codes, int n_codes,
                                double* partial, long long* partial_n,
                                cudaStream_t s) {
  const size_t smem = gram::smem_bytes(rows.R);
  cudaError_t err = cudaFuncSetAttribute(
      samples_gram_kernel<NB, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  samples_gram_kernel<NB, T><<<n_blocks, gram::kThreads, smem, s>>>(
      rows, blk, stream_coarse, codes, n_codes, partial, partial_n);
  return cudaGetLastError();
}

// Both passes of kernel C (T = float: the constants are rounded to f32) or
// kernel D (T = double) on one stream. Returns the CUDA error code of the
// launches.
template <typename T>
int samples_launch(const float* fine, const float* coarse, const int64_t* blk,
                   int n_blocks, const int32_t* stream_coarse,
                   const int64_t* stream_blocks, int n_streams,
                   const int32_t* codes, int n_codes, int n_moments, int basis,
                   double scale, double shift, double offset, double lo,
                   double hi, double* partial, long long* partial_n,
                   double* sums, double* sums2, double* cov_f, double* cov_c,
                   long long* n_valid, void* stream) {
  if (n_moments < 1 || n_moments > gram::kRPad) return static_cast<int>(cudaErrorInvalidValue);
  const int nb = (n_moments + 7) / 8;
  if (n_codes != 2 * gram::n_tiles(nb)) return static_cast<int>(cudaErrorInvalidValue);
  if (basis < 0 || basis > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (n_blocks <= 0 || n_streams <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const SampleRows<T> rows{fine, coarse, 0, static_cast<T>(scale),
                           static_cast<T>(shift), static_cast<T>(offset),
                           static_cast<T>(lo), static_cast<T>(hi), n_moments,
                           basis};
  cudaError_t err;
  switch (nb) {
    case 1: err = launch_samples_gram<1, T>(rows, blk, n_blocks, stream_coarse, codes, n_codes, partial, partial_n, s); break;
    case 2: err = launch_samples_gram<2, T>(rows, blk, n_blocks, stream_coarse, codes, n_codes, partial, partial_n, s); break;
    case 3: err = launch_samples_gram<3, T>(rows, blk, n_blocks, stream_coarse, codes, n_codes, partial, partial_n, s); break;
    default: err = launch_samples_gram<4, T>(rows, blk, n_blocks, stream_coarse, codes, n_codes, partial, partial_n, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(gram::launch_reduce(
      partial, partial_n, stream_blocks, n_streams,
      StreamCoarse{stream_coarse}, codes, n_codes, n_moments, sums, sums2,
      cov_f, cov_c, n_valid, s));
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
  return samples_launch<float>(fine, coarse, blk, n_blocks, stream_coarse,
                               stream_blocks, n_streams, codes, n_codes,
                               n_moments, basis, scale, shift, offset, lo, hi,
                               partial, partial_n, sums, sums2, cov_f, cov_c,
                               n_valid, stream);
}

// Kernel D: the same function with the transform and the rows in f64; same
// arguments.
int samples_ext_launch(const float* fine, const float* coarse,
                       const int64_t* blk, int n_blocks,
                       const int32_t* stream_coarse,
                       const int64_t* stream_blocks, int n_streams,
                       const int32_t* codes, int n_codes, int n_moments,
                       int basis, double scale, double shift, double offset,
                       double lo, double hi, double* partial,
                       long long* partial_n, double* sums, double* sums2,
                       double* cov_f, double* cov_c, long long* n_valid,
                       void* stream) {
  return samples_launch<double>(fine, coarse, blk, n_blocks, stream_coarse,
                                stream_blocks, n_streams, codes, n_codes,
                                n_moments, basis, scale, shift, offset, lo, hi,
                                partial, partial_n, sums, sums2, cov_f, cov_c,
                                n_valid, stream);
}

}  // extern "C"
