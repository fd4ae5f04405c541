"""ctypes bindings for the native engine (counterpart of
``mlmc_tpu/native/__init__.py``): the sample log (``sample_log.cpp``,
``SampleLogWriter`` / ``SampleLogReader``) and the gmsh v2 mesh parser and
``$ElementData`` writer (``gmsh_fast.cpp``, ``parse_gmsh_mesh`` /
``write_gmsh_fields``) of the FlowSim workflow.

Each source is host C++ built at first use into a library of its own, the
way ``ops/_build.py`` builds the CUDA kernels: one direct compiler call,
into ``mlmc_tpu_torch/_build/`` (ignored by git), under a name that hashes
the source and the flags, so an edited source rebuilds and an unchanged one
is reused. All consumers gate on ``available()`` / ``gmsh_available()``, so
the other storages and the Python mesh reader keep working where no C++
compiler is present. The formats are those of ``mlmc_tpu``: a log or a
mesh written by one package is read by the other.
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
GMSH_SOURCE = Path(__file__).resolve().parent / "gmsh_fast.cpp"
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


def library_path(source=SOURCE):
    """Where the library of ``source`` is built for it and these flags."""
    digest = hashlib.sha256(source.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / ("lib%s_%s.so" % (source.stem, digest.hexdigest()[:16]))


def build(source=SOURCE):
    """Compile ``source`` (default ``sample_log.cpp``) unless its library
    exists; return the library's path. Raises with the compiler's output on
    failure."""
    target = library_path(source)
    if target.exists():
        return target
    cxx = find_cxx()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a temporary name and rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(source)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError("%s %s failed (%d):\n%s"
                               % (cxx, source.name, proc.returncode, proc.stdout))
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


# ---------------------------------------------------------------------- #
# gmsh v2 mesh parser and $ElementData writer (gmsh_fast.cpp)
# ---------------------------------------------------------------------- #
_gmsh_lib = None
_gmsh_error = None


def _load_gmsh():
    global _gmsh_lib, _gmsh_error
    with _lock:
        if _gmsh_lib is not None or _gmsh_error is not None:
            return _gmsh_lib
        try:
            lib = ctypes.CDLL(str(build(GMSH_SOURCE)))
        except Exception as e:  # no compiler / load failure -> gate off
            _gmsh_error = e
            return None
        lib.gmsh_mesh_open.restype = ctypes.c_void_p
        lib.gmsh_mesh_open.argtypes = [ctypes.c_char_p]
        lib.gmsh_mesh_n_elements.restype = ctypes.c_uint64
        lib.gmsh_mesh_n_elements.argtypes = [ctypes.c_void_p]
        lib.gmsh_mesh_ele_ids.restype = None
        lib.gmsh_mesh_ele_ids.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
        lib.gmsh_mesh_region_ids.restype = None
        lib.gmsh_mesh_region_ids.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
        lib.gmsh_mesh_centers.restype = None
        lib.gmsh_mesh_centers.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_double)]
        lib.gmsh_mesh_regions.restype = ctypes.c_int64
        lib.gmsh_mesh_regions.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint64]
        lib.gmsh_mesh_close.restype = None
        lib.gmsh_mesh_close.argtypes = [ctypes.c_void_p]

        lib.gmsh_fields_open.restype = ctypes.c_void_p
        lib.gmsh_fields_open.argtypes = [ctypes.c_char_p]
        lib.gmsh_fields_add.restype = ctypes.c_int
        lib.gmsh_fields_add.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.c_uint64, ctypes.c_uint32]
        lib.gmsh_fields_close.restype = ctypes.c_int
        lib.gmsh_fields_close.argtypes = [ctypes.c_void_p]
        _gmsh_lib = lib
        return _gmsh_lib


def gmsh_available():
    """True when the native gmsh library is built and loadable."""
    return _load_gmsh() is not None


def gmsh_build_error():
    """The captured build/load failure of the gmsh library (None when
    healthy)."""
    _load_gmsh()
    return _gmsh_error


def parse_gmsh_mesh(path):
    """Native v2 ASCII parse -> bulk-element arrays.

    :return: dict(ele_ids int64[n], region_ids int32[n],
                  centers float64[n, 3], region_map {name: id})
             or None when the native library is unavailable or the file
             needs the Python reader (v1 format, malformed sections).
    """
    lib = _load_gmsh()
    if lib is None:
        return None
    handle = lib.gmsh_mesh_open(os.fsencode(path))
    if not handle:
        return None
    try:
        n = int(lib.gmsh_mesh_n_elements(handle))
        ele_ids = np.empty(n, dtype=np.int64)
        region_ids = np.empty(n, dtype=np.int32)
        centers = np.empty((n, 3), dtype=np.float64)
        if n:
            lib.gmsh_mesh_ele_ids(
                handle, ele_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
            lib.gmsh_mesh_region_ids(
                handle, region_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
            lib.gmsh_mesh_centers(
                handle, centers.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
        cap = 1 << 16
        buf = ctypes.create_string_buffer(cap)
        got = lib.gmsh_mesh_regions(handle, buf, cap)
        if got < 0:  # undersized: retry with the reported requirement
            cap = -got
            buf = ctypes.create_string_buffer(cap)
            got = lib.gmsh_mesh_regions(handle, buf, cap)
        region_map = {}
        try:
            names_blob = buf.value.decode()
        except UnicodeDecodeError:  # non-UTF-8 physical names
            names_blob = buf.value.decode("latin-1")
        for line in names_blob.splitlines():
            if "\t" in line:
                name, rid = line.rsplit("\t", 1)
                region_map[name] = int(rid)
        return dict(ele_ids=ele_ids, region_ids=region_ids, centers=centers,
                    region_map=region_map)
    finally:
        lib.gmsh_mesh_close(handle)


def write_gmsh_fields(path, ele_ids, fields):
    """Native $ElementData writer (FlowSim fields files).

    :param fields: {name: values [n] or [n, n_comp]}
    :return: True on success, False when the native library is unavailable
    """
    lib = _load_gmsh()
    if lib is None:
        return False
    ele_ids = np.ascontiguousarray(ele_ids, dtype=np.int64)
    handle = lib.gmsh_fields_open(os.fsencode(path))
    if not handle:
        raise IOError("cannot open fields file for writing: {}".format(path))
    try:
        for name, values in fields.items():
            values = np.ascontiguousarray(values, dtype=np.float64)
            if values.ndim == 1:
                values = values[:, None]
            if values.shape[0] != len(ele_ids):
                raise ValueError("one row of values per element id")
            rc = lib.gmsh_fields_add(
                handle, str(name).encode(),
                ele_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                values.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
                values.shape[0], values.shape[1])
            if rc != 0:
                raise IOError("short write to fields file")
    except BaseException:
        lib.gmsh_fields_close(handle)  # best effort; keep the real error
        raise
    if lib.gmsh_fields_close(handle) != 0:
        raise IOError("fields file close failed")
    return True
