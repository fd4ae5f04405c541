"""Where kernel A's time goes: the kernel timed with parts of it removed.

Run from the root of a checkout, on a machine with a GPU:

    python3 -m mlmc_tpu_torch.tool.gram_ablation [R ...]

Copies ``mlmc_tpu_torch/csrc`` into a temporary directory once per variant,
edits the copy's text, builds every variant with ``nvcc`` (all at once) and
times each with CUDA events (median of 5 warm calls) on one level of 2^26
samples: level 0 (no coarse part) and a coarse level in RNG mode, and the
coarse level in memory mode, for each moment count R (default 25 and 16).
The variants:

* ``as built``: the sources as they are;
* ``no DMMA``: the f64 mma instruction replaced by nothing (its operands
  are still loaded);
* ``no rows``: the basis recurrences and their stores to shared memory
  removed (the Gram tiles run on whatever the rows hold);
* ``no RNG``: Philox and Box-Muller replaced by a cheap function of the
  sample index;
* ``neither``: no DMMA and no rows;
* ``k blocks/SM``: the block's shared memory padded so that at most k
  blocks fit on an SM (occupancy).

A removed part's cost is the time it saves; only the ``as built`` results
are correct moments.
"""
import ctypes
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from mlmc_tpu_torch.ops import _build
from mlmc_tpu_torch.ops import cuda_kernels as ck

N = 1 << 26
DOMAIN = (-4.0, 4.0)

_DMMA = (re.compile(r'asm\("mma\.sync.*?\);', re.S),
         'asm volatile("" : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) '
         ': "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));')
_ROWS = ("  constexpr int S = kRowStride;\n",
         "  constexpr int S = kRowStride;\n  if (R > 0) return;\n")
_RNG = (re.compile(r"normal_at\(static_cast<uint64_t>\(start \+ s\), level, k0, k1\)"),
        "(static_cast<float>(static_cast<int>(s & 1023)) * 0.003f - 1.5f)")
_SMEM = "  return sizeof(double) * kWarps * warp_doubles(R, (R + 7) / 8);"


def _occupancy(blocks_per_sm):
    pad = 228 * 1024 // blocks_per_sm - 2048
    return (_SMEM, "  const size_t b = sizeof(double) * kWarps * warp_doubles(R, (R + 7) / 8);\n"
                   "  return b > %d ? b : %d;" % (pad, pad))


#: variant -> [(file, pattern, replacement)]
VARIANTS = {
    "as built": [],
    "no DMMA": [("moment_gram.cuh",) + _DMMA],
    "no rows": [("moment_gram.cuh",) + _ROWS],
    "no RNG": [("synth_mlmc.cu",) + _RNG],
    "neither": [("moment_gram.cuh",) + _DMMA, ("moment_gram.cuh",) + _ROWS],
    "1 block/SM": [("moment_gram.cuh",) + _occupancy(1)],
    "2 blocks/SM": [("moment_gram.cuh",) + _occupancy(2)],
    "3 blocks/SM": [("moment_gram.cuh",) + _occupancy(3)],
}


def _make(root, name, edits):
    d = root / re.sub(r"\W", "_", name)
    shutil.copytree(_build.SOURCE_DIR, d)
    for fname, pattern, repl in edits:
        path = d / fname
        text = path.read_text()
        new = pattern.sub(repl, text) if hasattr(pattern, "sub") else text.replace(pattern, repl)
        if new == text:
            raise RuntimeError("variant %r: the edit of %s no longer applies" % (name, fname))
        path.write_text(new)
    return d


def _load(path):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES["synth_mlmc"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _median_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main(moment_counts):
    if not torch.cuda.is_available():
        raise SystemExit("gram_ablation: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dirs = {name: _make(root, name, edits) for name, edits in VARIANTS.items()}
        procs = {name: subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "synth_mlmc.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for name, d in dirs.items()}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for %r:\n%s" % (name, out))
        print("kernel A per 2^26 samples of one level (ms, CUDA events, median of 5):")
        built = ck.load_library
        try:
            for name, d in dirs.items():
                lib = _load(d / "lib.so")
                ck.load_library = lambda _name, lib=lib: lib
                for R in moment_counts:
                    level0 = _median_ms(lambda: ck.synth_moment_pipeline(
                        1, R, N, fine_step=0.5, coarse_step=0.0, domain=DOMAIN,
                        is_level0=True, device=dev))
                    coarse = _median_ms(lambda: ck.synth_moment_pipeline(
                        1, R, N, fine_step=0.25, coarse_step=0.5, domain=DOMAIN, device=dev))
                    memory = _median_ms(lambda: ck.synth_moment_pipeline_from_noise(
                        x, R, fine_step=0.25, coarse_step=0.5, domain=DOMAIN))
                    print("  %-12s R=%2d  level 0 %8.3f  coarse %8.3f  coarse, memory mode %8.3f"
                          % (name, R, level0, coarse, memory), flush=True)
        finally:
            ck.load_library = built


if __name__ == "__main__":
    main([int(r) for r in sys.argv[1:]] or [25, 16])
