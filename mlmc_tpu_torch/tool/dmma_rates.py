"""Throughput of the card's f64 matrix instructions, one shape at a time.

Run on a machine with the CUDA toolkit:

    python3 -m mlmc_tpu_torch.tool.dmma_rates

Compiles a microbenchmark (one kernel per ``mma.sync ... .f64`` shape, and
one of plain ``fma`` on doubles) with ``nvcc`` into a temporary directory,
runs each at 2, 4 and 8 blocks of 128 threads per SM, every warp issuing
8 independent accumulations per loop step, and prints TFLOP/s and f64
multiply-adds per clock per SM at the card's maximum SM clock. This is
the measurement behind the shape the Gram kernels use
(csrc/moment_gram.cuh).
"""
import ctypes
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mlmc_tpu_torch.ops import _build
from mlmc_tpu_torch.tool.timing import smi

ITERS = 4000
NACC = 8
#: name, PTX shape, f64 registers of A, B and C per lane, multiply-adds
SHAPES = [("m8n8k4", "m8n8k4", 1, 1, 2, 8 * 8 * 4),
          ("m16n8k4", "m16n8k4", 2, 1, 4, 16 * 8 * 4),
          ("m16n8k8", "m16n8k8", 4, 2, 4, 16 * 8 * 8),
          ("m16n8k16", "m16n8k16", 8, 4, 4, 16 * 8 * 16)]


def _mma_kernel(name, shape, na, nb, nc):
    regs = ", ".join("%%%d" % i for i in range(nc))
    a = ", ".join("%%%d" % (nc + i) for i in range(na))
    b = ", ".join("%%%d" % (nc + na + i) for i in range(nb))
    outs = ", ".join('"+d"(c[j][%d])' % i for i in range(nc))
    ins = ", ".join('"d"(%s)' % ("x" if i % 2 else "y") for i in range(na + nb))
    return r"""
__global__ void k_%(name)s(double* out, int iters) {
  double c[%(nacc)d][%(nc)d] = {};
  const double x = threadIdx.x * 1e-3, y = 1.0 + threadIdx.x * 1e-4;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < %(nacc)d; ++j)
      asm volatile("mma.sync.aligned.%(shape)s.row.col.f64.f64.f64.f64 "
                   "{%(regs)s}, {%(a)s}, {%(b)s}, {%(regs)s};" : %(outs)s : %(ins)s);
  }
  double s = 0;
  for (int j = 0; j < %(nacc)d; ++j)
    for (int e = 0; e < %(nc)d; ++e) s += c[j][e];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
""" % dict(name=name, shape=shape, nacc=NACC, nc=nc, regs=regs, a=a, b=b,
           outs=outs, ins=ins)


def _source():
    kernels = [_mma_kernel(n, s, na, nb, nc) for n, s, na, nb, nc, _ in SHAPES]
    kernels.append(r"""
__global__ void k_dfma(double* out, int iters) {
  double c[%(nacc)d] = {};
  double x = threadIdx.x * 1e-3;
  const double y = 1.0 + threadIdx.x * 1e-4;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < %(nacc)d; ++j) c[j] = fma(x, y, c[j]);
    x += 1e-9;
  }
  double s = 0;
  for (int j = 0; j < %(nacc)d; ++j) s += c[j];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
""" % dict(nacc=NACC))
    names = [n for n, *_ in SHAPES] + ["dfma"]
    cases = "\n".join("    case %d: k_%s<<<blocks, threads>>>(out, iters); break;" % (i, n)
                      for i, n in enumerate(names))
    return ("#include <cuda_runtime.h>\n" + "".join(kernels) +
            'extern "C" int run(int which, double* out, int blocks, int threads, int iters) {\n'
            "  switch (which) {\n" + cases + "\n    default: return -1;\n  }\n"
            "  return (int)cudaGetLastError();\n}\n")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("dmma_rates: needs a CUDA device")
    print(smi("name,power.limit"))
    with tempfile.TemporaryDirectory() as tmp:
        src, lib_path = Path(tmp) / "rates.cu", Path(tmp) / "librates.so"
        src.write_text(_source())
        subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib_path),
                        str(src)], check=True)
        lib = ctypes.CDLL(str(lib_path))
        lib.run.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int]
        n_sm = torch.cuda.get_device_properties(0).multi_processor_count
        sm_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
        out = torch.empty(n_sm * 8 * 128, dtype=torch.float64, device="cuda")
        fma_per = [f for *_, f in SHAPES] + [32]
        for which, name in enumerate([n for n, *_ in SHAPES] + ["dfma"]):
            for per_sm in (2, 4, 8):
                blocks = n_sm * per_sm
                if lib.run(which, out.data_ptr(), blocks, 128, 10) != 0:
                    raise RuntimeError("launch of %s failed" % name)
                torch.cuda.synchronize()
                times = []
                for _ in range(3):
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    lib.run(which, out.data_ptr(), blocks, 128, ITERS)
                    end.record()
                    end.synchronize()
                    times.append(start.elapsed_time(end))
                ms = float(np.median(times))
                fma = blocks * 4 * ITERS * NACC * fma_per[which]
                print("%-9s %d blocks/SM: %.3f ms, %.2f TFLOP/s, %.1f f64 FMA per clock per SM"
                      % (name, per_sm, ms, 2 * fma / ms / 1e9,
                         fma / (ms * 1e-3) / n_sm / sm_hz))


if __name__ == "__main__":
    main()
