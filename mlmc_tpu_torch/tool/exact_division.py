"""Is ``gram::div_small`` the IEEE quotient? Checked on the card.

Run from the root of a checkout, on a machine with a GPU:

    python3 -m mlmc_tpu_torch.tool.exact_division

The Legendre recurrence of the CUDA kernels divides by n = 2 .. 31 with a
reciprocal multiplication and two fused corrections
(``mlmc_tpu_torch/csrc/moment_gram.cuh``, which argues why the result is
the correctly rounded quotient). This tool builds a small kernel beside
that header with the kernels' own flags and compares ``div_small(a, n)``
bit for bit with ``a / n`` (``--prec-div=true``):

* f32: every finite one of the 2^32 bit patterns of ``a``, for every n;
* f64: 2^32 dividends per n: bit patterns from a 64-bit mixing function
  of the index, their exponents folded into 2^-300 .. 2^300.

Zeros of either sign compare equal. Dividends
whose quotient is subnormal are counted apart: there the remainder of the
correction need not be exact, and the recurrence never gets there. Prints
the counts and exits non-zero on a mismatch outside that range.
"""
import ctypes
import subprocess
import tempfile
from pathlib import Path

import torch

from mlmc_tpu_torch.ops import _build

SOURCE = r"""
#include <cstdint>
#include <cuda_runtime.h>
#include "moment_gram.cuh"

namespace {

__device__ __forceinline__ uint64_t mix(uint64_t z) {   // splitmix64
  z += 0x9E3779B97F4A7C15ull;
  z = (z ^ (z >> 30)) * 0xBF58476D1CE4E5B9ull;
  z = (z ^ (z >> 27)) * 0x94D049BB133111EBull;
  return z ^ (z >> 31);
}

template <typename T>
__device__ __forceinline__ void compare(T a, int n, T tiny,
                                        unsigned long long* out) {
  if (!isfinite(a)) return;
  const T want = a / static_cast<T>(n);
  const T got = gram::div_small(a, n);
  if (want == got) return;
  atomicAdd(out + (fabs(want) < tiny ? 1 : 0), 1ull);
}

// out[0]: mismatches with a normal quotient, out[1]: with a subnormal one
__global__ void check32(int n, unsigned long long* out) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    compare(__uint_as_float(static_cast<uint32_t>(i)), n, 1.17549435e-38f, out);
  }
}

__global__ void check64(int n, unsigned long long* out) {
  const uint64_t stride = static_cast<uint64_t>(gridDim.x) * blockDim.x;
  for (uint64_t i = static_cast<uint64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < (1ull << 32); i += stride) {
    uint64_t bits = mix(i * 32 + n);
    const uint64_t exponent = 1023 - 300 + ((bits >> 52) & 0x7ff) % 601;
    bits = (bits & 0x800fffffffffffffull) | (exponent << 52);
    compare(__longlong_as_double(static_cast<long long>(bits)), n,
            2.2250738585072014e-308, out);
  }
}

}  // namespace

extern "C" int check_division(int n, int f64, unsigned long long* out) {
  if (f64) {
    check64<<<132 * 16, 256>>>(n, out);
  } else {
    check32<<<132 * 16, 256>>>(n, out);
  }
  cudaError_t err = cudaGetLastError();
  return static_cast<int>(err != cudaSuccess ? err : cudaDeviceSynchronize());
}
"""


def main():
    if not torch.cuda.is_available():
        raise SystemExit("exact_division: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "exact_division.cu", Path(tmp) / "lib.so"
        src.write_text(SOURCE)
        subprocess.run([_build.find_nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.SOURCE_DIR),
                        "-o", str(lib_path), str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.check_division.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.check_division.restype = ctypes.c_int
        bad = 0
        for f64, what in ((0, "f32, all 2^32 dividends"), (1, "f64, 2^32 dividends")):
            normal = subnormal = 0
            for n in range(2, 32):
                out = torch.zeros(2, dtype=torch.int64, device="cuda")
                code = lib.check_division(n, f64, out.data_ptr())
                if code != 0:
                    raise RuntimeError("check_division: CUDA error %d" % code)
                counts = out.tolist()
                normal += counts[0]
                subnormal += counts[1]
            print("%s for each n in 2..31: %d mismatches with a normal quotient, %d with "
                  "a subnormal one" % (what, normal, subnormal))
            bad += normal
    if bad:
        raise SystemExit("exact_division: div_small differs from the IEEE quotient")


if __name__ == "__main__":
    main()
