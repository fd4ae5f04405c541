"""Build and bind the CUDA kernels of ``mlmc_tpu_torch/csrc``.

The sources compile with ``nvcc`` into a shared library with a plain C
interface, loaded through ctypes. The library is built at first use into
``mlmc_tpu_torch/_build/`` (ignored by git), named by a hash of the source
and the flags, so an edited source rebuilds and an unchanged one is reused.
Nothing here runs at import time.
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
SOURCE = PACKAGE_DIR / "csrc" / "synth_mlmc.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_p = ctypes.c_void_p


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


def build_library():
    """Compile ``csrc/synth_mlmc.cu`` unless a library for this source and
    these flags exists; return its path."""
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode())
    target = BUILD_DIR / ("libsynth_mlmc_%s.so" % digest.hexdigest()[:16])
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([find_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed (%d):\n%s%s" % (
                proc.returncode, proc.stdout, proc.stderr))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


@functools.lru_cache(maxsize=None)
def load_library():
    """Build (if needed) and load the kernel library; cached per process."""
    lib = ctypes.CDLL(str(build_library()))
    lib.synth_mlmc_launch.argtypes = [
        _p, _p, ctypes.c_int, _p, _p, ctypes.c_int, _p, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_uint32,
        ctypes.c_uint32, _p, _p, _p, _p, _p, _p, _p, _p]
    lib.synth_mlmc_launch.restype = ctypes.c_int
    lib.normals_dump_launch.argtypes = [
        _p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_uint32,
        ctypes.c_uint32, ctypes.c_uint32, _p]
    lib.normals_dump_launch.restype = ctypes.c_int
    return lib
