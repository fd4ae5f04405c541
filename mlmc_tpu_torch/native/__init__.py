"""ctypes bindings for the native sample log (``sample_log.cpp``),
counterpart of the ``SampleLogWriter`` / ``SampleLogReader`` half of
``mlmc_tpu/native/__init__.py``.

The library is host C++ and is built at first use, the way ``ops/_build.py``
builds the CUDA kernels: one direct compiler call, into
``mlmc_tpu_torch/_build/`` (ignored by git), under a name that hashes the
source and the flags, so an edited source rebuilds and an unchanged one is
reused. All consumers gate on ``available()``, so the other storages keep
working where no C++ compiler is present. The log format is that of
``mlmc_tpu``: a log written by one package is read by the other.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "sample_log.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")

_lib = None
_lock = threading.Lock()
_build_error = None


def find_cxx():
    """The C++ compiler: ``$CXX``, then ``g++``, ``c++``, ``clang++``."""
    for name in (os.environ.get("CXX"), "g++", "c++", "clang++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler found (tried $CXX, g++, c++, "
                       "clang++): the binary sample log needs one to build")


def library_path():
    """Where the library is built for this source and these flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / ("libsample_log_%s.so" % digest.hexdigest()[:16])


def build():
    """Compile ``sample_log.cpp`` unless its library exists; return the
    library's path. Raises with the compiler's output on failure."""
    target = library_path()
    if target.exists():
        return target
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s sample_log.cpp failed (%d):\n%s"
                               % (cxx, proc.returncode, proc.stdout))
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _load():
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(build()))
        except Exception as e:  # no compiler / load failure -> gate off
            _build_error = e
            return None

        lib.mlmc_writer_open.restype = ctypes.c_void_p
        lib.mlmc_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
        lib.mlmc_writer_append.restype = ctypes.c_int64
        lib.mlmc_writer_append.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double), ctypes.c_uint64]
        lib.mlmc_writer_flush.restype = ctypes.c_int
        lib.mlmc_writer_flush.argtypes = [ctypes.c_void_p]
        lib.mlmc_writer_close.restype = None
        lib.mlmc_writer_close.argtypes = [ctypes.c_void_p]

        lib.mlmc_reader_open.restype = ctypes.c_void_p
        lib.mlmc_reader_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.mlmc_reader_n_records.restype = ctypes.c_uint64
        lib.mlmc_reader_n_records.argtypes = [ctypes.c_void_p]
        lib.mlmc_reader_m.restype = ctypes.c_uint32
        lib.mlmc_reader_m.argtypes = [ctypes.c_void_p]
        lib.mlmc_reader_read.restype = ctypes.c_int64
        lib.mlmc_reader_read.argtypes = [
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_double)]
        lib.mlmc_reader_close.restype = None
        lib.mlmc_reader_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available():
    """True when the native C++ library is built and loadable."""
    return _load() is not None


def build_error():
    """The captured build/load failure (None when healthy)."""
    _load()
    return _build_error


class SampleLogWriter:
    """Append-only [n, 2, M] float64 record writer."""

    def __init__(self, path, m):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native engine unavailable: {}".format(_build_error))
        self._lib = lib
        self._handle = lib.mlmc_writer_open(os.fsencode(path), int(m))
        if not self._handle:
            raise IOError("cannot open sample log for writing: {}".format(path))
        self.m = int(m)

    def append(self, values):
        """:param values: array-like [n, 2, M] float64"""
        values = np.ascontiguousarray(values, dtype=np.float64)
        assert values.ndim == 3 and values.shape[1] == 2 \
            and values.shape[2] == self.m, values.shape
        n = self._lib.mlmc_writer_append(
            self._handle,
            values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            values.shape[0])
        if n != values.shape[0]:
            raise IOError("short write to sample log")
        return int(n)

    def flush(self):
        """Flush buffered records through the native writer."""
        self._lib.mlmc_writer_flush(self._handle)

    def close(self):
        """Close the native writer handle (idempotent)."""
        if self._handle:
            self._lib.mlmc_writer_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class SampleLogReader:
    """mmap reader with background page prefetch."""

    def __init__(self, path, prefetch_ahead_records=1 << 16):
        lib = _load()
        if lib is None:
            raise RuntimeError(
                "native engine unavailable: {}".format(_build_error))
        self._lib = lib
        self._handle = lib.mlmc_reader_open(os.fsencode(path),
                                            int(prefetch_ahead_records))
        if not self._handle:
            raise IOError("cannot open sample log for reading: {}".format(path))
        self.m = int(lib.mlmc_reader_m(self._handle))

    @property
    def n_records(self):
        return int(self._lib.mlmc_reader_n_records(self._handle))

    def read(self, start, n):
        """:return: np.ndarray [n', 2, M] (n' may be clipped at EOF)"""
        out = np.empty((n, 2, self.m), dtype=np.float64)
        got = self._lib.mlmc_reader_read(
            self._handle, int(start), int(n),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        if got < 0:
            raise IOError("sample log read failed")
        return out[:got]

    def close(self):
        """Close the native reader handle (idempotent)."""
        if self._handle:
            self._lib.mlmc_reader_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
