"""Where the time of kernels A, B and D goes: each timed with parts of it
removed or its launch changed; or kernels A and B against another tree's.

Run from the root of a checkout, on a machine with a GPU:

    python3 -m mlmc_tpu_torch.tool.gram_ablation [--kernel a|b|d] [R ...]
    python3 -m mlmc_tpu_torch.tool.gram_ablation --parent DIR

Copies ``mlmc_tpu_torch/csrc`` into a temporary directory once per variant,
edits the copy's text, builds every variant with ``nvcc`` (all at once) and
times each with CUDA events (median of 5 warm calls) at 2^26 samples, for
each moment count R (default 25 and 16; kernel D: 25). Kernel B is timed
at 1e7 normals (``chip_smoke.py``'s size) and at 2^26, from an aligned and
from a misaligned first index.

Kernel A (``--kernel a``, the default) is timed on one level: level 0 (no
coarse part) and a coarse level in RNG mode, and the coarse level in memory
mode. Kernel D (``--kernel d``) is timed on one stored stream with a coarse
part and on a fine-only one, beside kernel C built from the same edited
sources (the two share every line but the scalar type of the row build).

The variants:

* ``as built``: the sources as they are;
* ``no DMMA``: the f64 mma instruction replaced by nothing (its operands
  are still loaded; kernel A's m16n8k4, kernels C and D's m16n8k8);
* ``no rows``: the basis recurrences and their stores to shared memory
  removed (the Gram tiles run on whatever the rows hold);
* ``no RNG`` (``--kernel a``): Philox and Box-Muller replaced by a cheap function
  of the sample index;
* ``stores only`` (``--kernel b``): the same for kernel B, which then only
  writes;
* ``sin, cos apart``: the sine and cosine of a Box-Muller pair from two
  copies of the angle that the compiler cannot merge, so that they are not
  fused into one ``sincosf`` (the same values);
* ``fast trig``: the sine and cosine by ``__sincosf`` (the special-function
  unit, no slow argument reduction; other values): what the accurate
  ``sinf``/``cosf`` cost in time, registers and local memory;
* ``k blocks/SM cap`` (``--kernel b``): kernel B's grid capped at k blocks
  of 256 threads per SM (``uncapped``: one quad per thread);
* ``no division``: the Legendre recurrence's division by n (a reciprocal
  multiplication and two corrections) replaced by one multiplication by a
  constant;
* ``IEEE division``: the same division by the ``/`` operator;
* ``sides in turn`` (``--kernel d``): the fine row built first, then the coarse
  one, instead of both recurrences in lockstep;
* ``neither``: no DMMA and no rows;
* ``serial`` (``--kernel a``): one producer warp and one stage per
  consumer, so that a producer builds a chunk only once its consumer has
  emptied the last: the roles hand over one stage at a time with no
  lookahead, and what is left of the overlap is the tiles of one chunk
  under the build of the next;
* ``k blocks/SM`` (``--kernel d``): the block's shared memory padded so
  that at most k blocks fit on an SM (occupancy).

``as built, again`` times the unedited sources a second time at the end:
the two differ by the run's drift. A removed part's cost is the
time it saves; only the ``as built``, ``IEEE division``, ``sides in
turn`` and ``sin, cos apart`` results are correct moments. Each variant
first prints its kernels' registers, stack frame, local loads and stores
and instruction counts (``tool/kernel_sass.summary``).

Kernel B's calls take a few tens of microseconds of device time, no more
than the host's launch path, so it is timed by ``tool/timing.queued_ms``:
its calls are queued behind a spin kernel and run back to back, and the
events measure the device alone.

``--parent DIR`` names an unpacked tree of another commit (``git
archive``). Its ``csrc/synth_mlmc.cu`` and this tree's are built alike and
timed in turns (other, this, this, other) through this tree's wrappers:
kernel A at ``chip_smoke.py``'s headline (1e8 samples over 5 levels, R =
25, RNG mode; median of 5 single calls), kernel B at its 1e7 normals,
both as the median of 5 single calls between events (the host's launch
path included) and queued (the device alone), beside ``torch.randn``
timed both ways, each build after its SASS summary. Moment counts given
with ``--parent`` add kernel A per 2^26 samples of one level at each R, as
``--kernel a`` times it (level 0, coarse, coarse in memory mode).
"""
import argparse
import ctypes
import json
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from mlmc_tpu_torch.ops import _build
from mlmc_tpu_torch.ops import cuda_extended as cx
from mlmc_tpu_torch.ops import cuda_kernels as ck
from mlmc_tpu_torch.tool import kernel_sass
from mlmc_tpu_torch.tool.timing import event_ms, queued_ms

N = 1 << 26
DOMAIN = (-4.0, 4.0)
#: chip_smoke.py's headline and normal-stream check
HEADLINE_SEED = 2024
HEADLINE_STEPS = [0.5, 0.25, 0.125, 0.0625, 0.03125]
HEADLINE_N = [64_000_000, 24_000_000, 8_000_000, 3_000_000, 1_000_000]
N_NORMALS = 10_000_000

_DMMA = (re.compile(r'asm\("mma\.sync.*?\);', re.S),
         'asm volatile("" : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) '
         ': "d"(a0), "d"(a1), "d"(a2), "d"(a3), "d"(b0), "d"(b1));')
_DMMA_K4 = (re.compile(r'asm\("mma\.sync.*?\);', re.S),
            'asm volatile("" : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3]) '
            ': "d"(a0), "d"(a1), "d"(b0));')
_ROWS = ("  constexpr int S = kRowStride;\n",
         "  constexpr int S = kRowStride;\n  if (R > 0) return;\n")

def _cheap_quad(i):
    """A float4 of cheap functions of the index expression ``i``."""
    return "make_float4(%s)" % ", ".join(
        "static_cast<float>(static_cast<int>((%s + %d) & 1023)) * 0.003f - 1.5f"
        % (i, j) for j in range(4))


_RNG = (re.compile(r"normal_at\(static_cast<uint64_t>\(start \+ s\), level, k0, k1\)"),
        "static_cast<float>(static_cast<int>((start + s) & 1023)) * 0.003f - 1.5f")
_B_RNG = (re.compile(r"normal_quad\(q0 \+ t, level, k0, k1\)"), _cheap_quad("t"))
_B_CAP = re.compile(r"constexpr int kNormalsBlocksPerSm = \d+;")
_SINCOS_APART = ("  return make_float2(r * cosf(angle), r * sinf(angle));\n",
                 "  float apart = angle;\n"
                 "  asm volatile(\"\" : \"+f\"(apart));\n"
                 "  return make_float2(r * cosf(angle), r * sinf(apart));\n")
_FAST_TRIG = (_SINCOS_APART[0],
              "  float sine, cosine;\n"
              "  __sincosf(angle, &sine, &cosine);\n"
              "  return make_float2(r * cosine, r * sine);\n")
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
    # below the SM's 228 KB by the static shared memory and 1 KB reserved
    # per block
    pad = 228 * 1024 // blocks_per_sm - 4096
    return (_SMEM, "  const size_t b = sizeof(double) * kWarps * warp_doubles(R, (R + 7) / 8);\n"
                   "  return b > %d ? b : %d;" % (pad, pad))


_SERIAL = (re.compile(r"constexpr int kRings = [^;]+;"), "constexpr int kRings = 1;")


def _time_a(moment_counts, dev, x):
    for R in moment_counts:
        level0 = event_ms(lambda: ck.synth_moment_pipeline(
            1, R, N, fine_step=0.5, coarse_step=0.0, domain=DOMAIN,
            is_level0=True, device=dev))
        coarse = event_ms(lambda: ck.synth_moment_pipeline(
            1, R, N, fine_step=0.25, coarse_step=0.5, domain=DOMAIN, device=dev))
        memory = event_ms(lambda: ck.synth_moment_pipeline_from_noise(
            x, R, fine_step=0.25, coarse_step=0.5, domain=DOMAIN))
        yield R, "level 0 %8.3f  coarse %8.3f  coarse, memory mode %8.3f" % (
            level0, coarse, memory)


def _b_cap(blocks_per_sm):
    return (_B_CAP, "constexpr int kNormalsBlocksPerSm = %d;" % blocks_per_sm)


def _time_b(moment_counts, dev, x):
    """Kernel B at chip_smoke.py's 1e7 normals and at 2^26, from an aligned
    first index and from a misaligned one, and torch.randn at both sizes
    (R is not used)."""
    times = [queued_ms(lambda: ck.normals_dump_cuda(3, n, level=1, start=start,
                                                    device=dev))
             for n in (10_000_000, N) for start in (0, 77)]
    gen = torch.Generator(device=dev).manual_seed(3)
    times += [queued_ms(lambda: torch.randn(n, device=dev, generator=gen))
              for n in (10_000_000, N)]
    yield 0, ("1e7 %7.4f  1e7 from 77 %7.4f  2^26 %7.4f  2^26 from 77 %7.4f   "
              "torch.randn 1e7 %7.4f  2^26 %7.4f" % tuple(times))


def _time_turns(moment_counts, dev, x):
    """Kernel A at chip_smoke.py's headline; kernel B and torch.randn at
    1e7 normals, single calls and queued; then kernel A per level at each
    of moment_counts (_time_a)."""
    a = event_ms(lambda: ck.synth_mlmc_pipeline(
        HEADLINE_SEED, 25, HEADLINE_N, HEADLINE_STEPS, domain=DOMAIN, device=dev))

    def b():
        return ck.synth_normals(HEADLINE_SEED + 1, N_NORMALS, device=dev)

    gen = torch.Generator(device=dev).manual_seed(HEADLINE_SEED + 1)

    def lib():
        return torch.randn(N_NORMALS, device=dev, generator=gen)

    yield 0, ("A %8.4f   B single %7.4f  queued %7.4f   torch.randn single %7.4f  "
              "queued %7.4f" % (a, event_ms(b), queued_ms(b), event_ms(lib),
                                queued_ms(lib)))
    yield from _time_a(moment_counts, dev, x)


def _time_d(moment_counts, dev, x):
    """Kernels D and C on one stream of stored QoIs x + h*sqrt(1e-4 + |x|),
    with a coarse part and without."""
    err = torch.sqrt(1e-4 + x.abs())
    fine, coarse = x + 0.25 * err, x + 0.5 * err
    both = ck.pack_streams([fine], [coarse], [True])
    fine_only = ck.pack_streams([fine], [None], [False])
    consts = {f64: ck.transform_constants(DOMAIN, f64=f64) for f64 in (False, True)}
    for R in moment_counts:
        times = [event_ms(lambda: fn(streams, R, basis="legendre", consts=consts[f64],
                                       device=dev))
                 for fn, f64 in ((cx.samples_ext_cuda, True), (ck.samples_mlmc_cuda, False))
                 for streams in (both, fine_only)]
        yield R, ("kernel D coarse %8.3f  fine only %8.3f   kernel C coarse %8.3f  "
                  "fine only %8.3f" % tuple(times))


#: kernel -> (source, what one call covers, timer,
#: {variant -> [(file, pattern, replacement)]})
VARIANTS = {
    "a": ("synth_mlmc", "2^26 samples of one level", _time_a, {
        "as built": [],
        "no DMMA": [("synth_mlmc.cu",) + _DMMA_K4],
        "no rows": [("moment_gram.cuh",) + _ROWS],
        "no RNG": [("synth_mlmc.cu",) + _RNG],
        "sin, cos apart": [("synth_mlmc.cu",) + _SINCOS_APART],
        "fast trig": [("synth_mlmc.cu",) + _FAST_TRIG],
        "no division": [("moment_gram.cuh",) + _DIVISION],
        "IEEE division": [("moment_gram.cuh",) + _IEEE_DIV],
        "neither": [("synth_mlmc.cu",) + _DMMA_K4, ("moment_gram.cuh",) + _ROWS],
        "serial": [("synth_mlmc.cu",) + _SERIAL],
        "as built, again": [],
    }),
    "b": ("synth_mlmc", "the normals of one level", _time_b, {
        "as built": [],
        "stores only": [("synth_mlmc.cu",) + _B_RNG],
        "sin, cos apart": [("synth_mlmc.cu",) + _SINCOS_APART],
        "fast trig": [("synth_mlmc.cu",) + _FAST_TRIG],
        "4 blocks/SM cap": [("synth_mlmc.cu",) + _b_cap(4)],
        "8 blocks/SM cap": [("synth_mlmc.cu",) + _b_cap(8)],
        "32 blocks/SM cap": [("synth_mlmc.cu",) + _b_cap(32)],
        "uncapped": [("synth_mlmc.cu",) + _b_cap(1 << 20)],
        "as built, again": [],
    }),
    "d": ("samples_mlmc", "2^26 samples of one stream", _time_d, {
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


def _make(root, name, edits, source_dir=_build.SOURCE_DIR):
    d = root / re.sub(r"\W", "_", name)
    shutil.copytree(source_dir, d)
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


def _against(parent):
    """The ``--parent`` mode as an entry of VARIANTS: the other tree's
    sources, this tree's, this tree's again and the other's again."""
    source_dir = Path(parent) / "mlmc_tpu_torch" / "csrc"
    if not (source_dir / "synth_mlmc.cu").is_file():
        raise SystemExit("gram_ablation: %s holds no synth_mlmc.cu" % source_dir)
    return ("synth_mlmc", "call", _time_turns, {
        "other": source_dir, "this": [], "this, again": [], "other, again": source_dir})


def main(kernel, moment_counts, parent=None):
    if not torch.cuda.is_available():
        raise SystemExit("gram_ablation: needs a CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    source, unit, timer, variants = VARIANTS[kernel] if parent is None else _against(parent)
    x = torch.randn(N, generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        dirs = {name: _make(root, name, [], edits) if isinstance(edits, Path)
                else _make(root, name, edits) for name, edits in variants.items()}
        procs = {name: subprocess.Popen(
            _build.nvcc_command(d / (source + ".cu"), d / "lib.so"),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, d in dirs.items()}
        for name, proc in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError("nvcc failed for %r:\n%s" % (name, out))
        print("kernel %s per %s (ms, CUDA events, median of 5):"
              % ("A, B" if parent else kernel.upper(), unit))
        built = ck.load_library
        try:
            for name, d in dirs.items():
                print("  %-16s SASS %s" % (name, json.dumps(kernel_sass.summary(d / "lib.so"))),
                      flush=True)
                lib = _load(d / "lib.so", source)
                ck.load_library = lambda _name, lib=lib: lib
                for R, line in timer(moment_counts, dev, x):
                    print("  %-16s %s  %s" % (name, "R=%2d" % R if R else "", line),
                          flush=True)
        finally:
            ck.load_library = built


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernel", choices=sorted(VARIANTS), default="a")
    parser.add_argument("--parent", metavar="DIR",
                        help="time kernels A and B against this tree's")
    parser.add_argument("moment_counts", nargs="*", type=int, metavar="R")
    args = parser.parse_args()
    default = [] if args.parent else {"a": [25, 16], "b": [0], "d": [25]}[args.kernel]
    main(args.kernel, args.moment_counts or default, args.parent)
