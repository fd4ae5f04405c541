"""What the compiler made of the CUDA kernels: registers, spills, shared
memory and f64 tensor-core instructions per kernel.

Run from the root of a checkout, on a machine with the CUDA toolkit:

    python3 -m mlmc_tpu_torch.tool.kernel_sass

Builds every ``mlmc_tpu_torch/csrc/*.cu`` (``ops/_build.build_all``), then
reads each library with ``cuobjdump``: ``-res-usage`` gives each kernel's
registers, stack frame, local memory and static shared memory, and
``-sass`` its instructions, of which the ``DMMA`` lines (f64
``mma.sync``), ``DFMA`` lines (f64 fused multiply-adds) and ``LDL``/``STL``
lines (local-memory loads and stores: register spills) are counted.
"""
import collections
import os
import re
import subprocess

from mlmc_tpu_torch.ops import _build

_RES = re.compile(r"Function ([^:\s]+):\s*REG:(\d+) STACK:(\d+) SHARED:(\d+) LOCAL:(\d+)")
_FUNC = re.compile(r"Function : (\S+)")


def _tool(name):
    path = os.path.join(os.path.dirname(_build.find_nvcc()), name)
    return path if os.path.isfile(path) else name


def _demangle(names):
    """Readable names through cu++filt (mangled ones where it is missing)."""
    try:
        out = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                             capture_output=True, text=True, timeout=60)
    except OSError:
        return dict(zip(names, names))
    lines = out.stdout.splitlines()
    return dict(zip(names, lines)) if len(lines) == len(names) else dict(zip(names, names))


def report(lib_path):
    """{mangled kernel name: dict(reg, stack, shared, local, DMMA, DFMA,
    LDL, STL)}."""
    cuobjdump = _tool("cuobjdump")
    res = subprocess.run([cuobjdump, "-res-usage", str(lib_path)],
                         capture_output=True, text=True, timeout=300, check=True)
    kernels = {}
    for m in _RES.finditer(res.stdout):
        kernels[m.group(1)] = dict(reg=int(m.group(2)), stack=int(m.group(3)),
                                   shared=int(m.group(4)), local=int(m.group(5)))
    if not kernels:
        raise RuntimeError("no kernel in cuobjdump -res-usage output:\n"
                           + res.stdout[:4000])
    sass =subprocess.run([cuobjdump, "-sass", str(lib_path)],
                          capture_output=True, text=True, timeout=300, check=True)
    counts = collections.defaultdict(collections.Counter)
    current = None
    for line in sass.stdout.splitlines():
        m = _FUNC.search(line)
        if m:
            current = m.group(1)
            continue
        if current is not None:
            for op in ("DMMA", "DFMA", "LDL", "STL"):
                if re.search(r"\b%s\b" % op, line):
                    counts[current][op] += 1
    for name, info in kernels.items():
        info.update({op: counts[name][op] for op in ("DMMA", "DFMA", "LDL", "STL")})
    return kernels


def main():
    for name, path in sorted(_build.build_all().items()):
        kernels = report(path)
        readable = _demangle(list(kernels))
        print("%s.cu (%s):" % (name, path.name))
        for mangled, info in sorted(kernels.items(), key=lambda kv: readable[kv[0]]):
            print("  %-60s REG %3d  STACK %4d  SHARED %6d  DMMA %4d  DFMA %5d  "
                  "LDL %3d  STL %3d"
                  % (readable[mangled][:60], info["reg"], info["stack"], info["shared"],
                     info["DMMA"], info["DFMA"], info["LDL"], info["STL"]))


if __name__ == "__main__":
    main()
