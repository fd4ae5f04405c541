"""Build and bind the CUDA kernels of ``mlmc_tpu_torch/csrc``.

Each source ``csrc/<name>.cu`` compiles with ``nvcc`` into its own shared
library with a plain C interface, loaded through ctypes. A library is built
at first use into ``mlmc_tpu_torch/_build/`` (ignored by git), named by a
hash of the source, every header ``csrc/*.cuh`` and the flags, so an
edited source or header rebuilds and an unchanged one is reused.
``build_all`` starts one ``nvcc`` per source, all at once, and waits for
them. Nothing here runs at import time.
"""
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
# no fast math: --fmad=false keeps a*b+c as two roundings, and division and
# square root stay correctly rounded, so per-sample values match the plain
# versions (and numpy) bit for bit
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "--prec-div=true", "--prec-sqrt=true",
              "-shared", "-Xcompiler", "-fPIC")

_p = ctypes.c_void_p
_i = ctypes.c_int
_f = ctypes.c_float
_d = ctypes.c_double
_u32 = ctypes.c_uint32
_ll = ctypes.c_longlong

#: C entry points of each source: name -> argtypes (every one returns int,
#: the CUDA error code of its launches)
SIGNATURES = {
    "synth_mlmc": {
        "synth_mlmc_launch": [_p, _p, _i, _p, _p, _i, _p, _i, _i, _f, _f,
                              _u32, _u32, _p, _p, _p, _p, _p, _p, _p, _p],
        "normals_dump_launch": [_p, _ll, _ll, _u32, _u32, _u32, _p],
    },
    "samples_mlmc": {
        "samples_mlmc_launch": [_p, _p, _p, _i, _p, _p, _i, _p, _i, _i, _i,
                                _d, _d, _d, _d, _d, _p, _p, _p, _p, _p, _p,
                                _p, _p],
        "samples_ext_launch": [_p, _p, _p, _i, _p, _p, _i, _p, _i, _i, _i,
                               _d, _d, _d, _d, _d, _p, _p, _p, _p, _p, _p,
                               _p, _p],
    },
}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then the default toolkit
    location, then ``PATH``."""
    candidates = [os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                  "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if os.path.isfile(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of mlmc_tpu_torch "
                           "need the CUDA toolkit to build")
    return found


def nvcc_command(source, target):
    """The ``nvcc`` command line that builds ``source`` into ``target``."""
    return [find_nvcc(), *NVCC_FLAGS, "-o", str(target), str(source)]


def library_path(name):
    """Where the library of ``csrc/<name>.cu`` is built for this source,
    the headers it may include (every ``csrc/*.cuh``) and these flags."""
    digest = hashlib.sha256((SOURCE_DIR / (name + ".cu")).read_bytes())
    for header in sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(header.name.encode() + b"\0" + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("lib%s_%s.so" % (name, digest.hexdigest()[:16]))


def build_all(names=None):
    """Compile every named source (default: every ``csrc/*.cu``) that has
    no library yet, one ``nvcc`` per source, all started together; return
    {name: library path}."""
    if names is None:
        names = sorted(path.stem for path in SOURCE_DIR.glob("*.cu"))
    targets = {name: library_path(name) for name in names}
    todo = [name for name in names if not targets[name].exists()]
    if not todo:
        return targets
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in todo:
            # build under a temporary name and rename: a concurrent or
            # interrupted build never leaves a half-written library under
            # the final name
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            procs[name] = (tmp, subprocess.Popen(
                nvcc_command(SOURCE_DIR / (name + ".cu"), tmp),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        errors = []
        for name, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append("nvcc %s.cu failed (%d):\n%s"
                              % (name, proc.returncode, out))
            else:
                os.replace(tmp, targets[name])
        if errors:
            raise RuntimeError("\n".join(errors))
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.unlink(tmp)
    return targets


@functools.lru_cache(maxsize=None)
def load_library(name):
    """Build (if needed) and load the library of ``csrc/<name>.cu``;
    cached per process."""
    lib = ctypes.CDLL(str(build_all([name])[name]))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
