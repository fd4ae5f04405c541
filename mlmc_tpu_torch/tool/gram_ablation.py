"""Where the time of kernels A and D goes: each timed with parts of it
removed.

Run from the root of a checkout, on a machine with a GPU:

    python3 -m mlmc_tpu_torch.tool.gram_ablation [--kernel a|d] [R ...]

Copies ``mlmc_tpu_torch/csrc`` into a temporary directory once per variant,
edits the copy's text, builds every variant with ``nvcc`` (all at once) and
times each with CUDA events (median of 5 warm calls) at 2^26 samples, for
each moment count R (default 25 and 16; kernel D: 25).

Kernel A (``--kernel a``, the default) is timed on one level: level 0 (no
coarse part) and a coarse level in RNG mode, and the coarse level in memory
mode. Kernel D (``--kernel d``) is timed on one stored stream with a coarse
part and on a fine-only one, beside kernel C built from the same edited
sources (the two share every line but the scalar type of the row build).

The variants:

* ``as built``: the sources as they are;
* ``no DMMA``: the f64 mma instruction replaced by nothing (its operands
  are still loaded);
* ``no rows``: the basis recurrences and their stores to shared memory
  removed (the Gram tiles run on whatever the rows hold);
* ``no RNG`` (``--kernel a``): Philox and Box-Muller replaced by a cheap function
  of the sample index;
* ``no division``: the Legendre recurrence's division by n (a reciprocal
  multiplication and two corrections) replaced by one multiplication by a
  constant;
* ``IEEE division``: the same division by the ``/`` operator;
* ``sides in turn`` (``--kernel d``): the fine row built first, then the coarse
  one, instead of both recurrences in lockstep;
* ``neither``: no DMMA and no rows;
* ``k blocks/SM``: the block's shared memory padded so that at most k
  blocks fit on an SM (occupancy).

``as built, again`` times the unedited sources a second time at the end:
the two differ by the run's drift. A removed part's cost is the
time it saves; only the ``as built``, ``IEEE division`` and ``sides in
turn`` results are correct moments.
"""
import argparse
import ctypes
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np
import torch

from mlmc_tpu_torch.ops import _build
from mlmc_tpu_torch.ops import cuda_extended as cx
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
_EXACT_DIV = "  const T y = recip_of(a, n);\n"
_DIVISION = (_EXACT_DIV, "  return a * static_cast<T>(0.25);\n" + _EXACT_DIV)
_IEEE_DIV = (_EXACT_DIV, "  return a / static_cast<T>(n);\n" + _EXACT_DIV)
_IN_TURN = ("      gram::basis_rows<2>(out, t, v, R, basis);\n",
            "      for (int side = 0; side < 2; ++side) {\n"
            "        double* const one[1] = {out[side]};\n"
            "        const T t_one[1] = {t[side]};\n"
            "        gram::basis_rows<1>(one, t_one, v, R, basis);\n"
            "      }\n")
_SMEM = "  return sizeof(double) * kWarps * warp_doubles(R, (R + 7) / 8);"


def _occupancy(blocks_per_sm):
    pad = 228 * 1024 // blocks_per_sm - 2048
    return (_SMEM, "  const size_t b = sizeof(double) * kWarps * warp_doubles(R, (R + 7) / 8);\n"
                   "  return b > %d ? b : %d;" % (pad, pad))


def _time_a(moment_counts, dev, x):
    for R in moment_counts:
        level0 = _median_ms(lambda: ck.synth_moment_pipeline(
            1, R, N, fine_step=0.5, coarse_step=0.0, domain=DOMAIN,
            is_level0=True, device=dev))
        coarse = _median_ms(lambda: ck.synth_moment_pipeline(
            1, R, N, fine_step=0.25, coarse_step=0.5, domain=DOMAIN, device=dev))
        memory = _median_ms(lambda: ck.synth_moment_pipeline_from_noise(
            x, R, fine_step=0.25, coarse_step=0.5, domain=DOMAIN))
        yield R, "level 0 %8.3f  coarse %8.3f  coarse, memory mode %8.3f" % (
            level0, coarse, memory)


def _time_d(moment_counts, dev, x):
    """Kernels D and C on one stream of stored QoIs x + h*sqrt(1e-4 + |x|),
    with a coarse part and without."""
    err = torch.sqrt(1e-4 + x.abs())
    fine, coarse = x + 0.25 * err, x + 0.5 * err
    both = ck.pack_streams([fine], [coarse], [True])
    fine_only = ck.pack_streams([fine], [None], [False])
    consts = {f64: ck.transform_constants(DOMAIN, f64=f64) for f64 in (False, True)}
    for R in moment_counts:
        times = [_median_ms(lambda: fn(streams, R, basis="legendre", consts=consts[f64],
                                       device=dev))
                 for fn, f64 in ((cx.samples_ext_cuda, True), (ck.samples_mlmc_cuda, False))
                 for streams in (both, fine_only)]
        yield R, ("kernel D coarse %8.3f  fine only %8.3f   kernel C coarse %8.3f  "
                  "fine only %8.3f" % tuple(times))


#: kernel -> (source, what one call reduces, timer,
#: {variant -> [(file, pattern, replacement)]})
VARIANTS = {
    "a": ("synth_mlmc", "level", _time_a, {
        "as built": [],
        "no DMMA": [("moment_gram.cuh",) + _DMMA],
        "no rows": [("moment_gram.cuh",) + _ROWS],
        "no RNG": [("synth_mlmc.cu",) + _RNG],
        "no division": [("moment_gram.cuh",) + _DIVISION],
        "IEEE division": [("moment_gram.cuh",) + _IEEE_DIV],
        "neither": [("moment_gram.cuh",) + _DMMA, ("moment_gram.cuh",) + _ROWS],
        "1 block/SM": [("moment_gram.cuh",) + _occupancy(1)],
        "2 blocks/SM": [("moment_gram.cuh",) + _occupancy(2)],
        "3 blocks/SM": [("moment_gram.cuh",) + _occupancy(3)],
        "as built, again": [],
    }),
    "d": ("samples_mlmc", "stream", _time_d, {
        "as built": [],
        "no DMMA": [("moment_gram.cuh",) + _DMMA],
        "no rows": [("moment_gram.cuh",) + _ROWS],
        "no division": [("moment_gram.cuh",) + _DIVISION],
        "IEEE division": [("moment_gram.cuh",) + _IEEE_DIV],
        "sides in turn": [("samples_mlmc.cu",) + _IN_TURN],
        "neither": [("moment_gram.cuh",) + _DMMA, ("moment_gram.cuh",) + _ROWS],
        "1 block/SM": [("moment_gram.cuh",) + _occupancy(1)],
        "as built, again": [],
    }),
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


def _load(path, source):
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _build.SIGNATURES[source].items():
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


def main(kernel, moment_counts):
    if not torch.cuda.is_available():
        raise SystemExit("gram_ablation: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    source, unit, timer, variants = VARIANTS[kernel]
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dirs = {name: _make(root, name, edits) for name, edits in variants.items()}
        procs = {name: subprocess.Popen(
            [_build.find_nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / (source + ".cu"))], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for name, d in dirs.items()}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for %r:\n%s" % (name, out))
        print("kernel %s per 2^26 samples of one %s (ms, CUDA events, median of 5):"
              % (kernel.upper(), unit))
        built = ck.load_library
        try:
            for name, d in dirs.items():
                lib = _load(d / "lib.so", source)
                ck.load_library = lambda _name, lib=lib: lib
                for R, line in timer(moment_counts, dev, x):
                    print("  %-15s R=%2d  %s" % (name, R, line), flush=True)
        finally:
            ck.load_library = built


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(VARIANTS), default="a")
    parser.add_argument("moment_counts", nargs="*", type=int, metavar="R")
    args = parser.parse_args()
    main(args.kernel, args.moment_counts or ([25, 16] if args.kernel == "a" else [25]))
