"""ctypes binding of the C++ host library (``csrc/dcarl_host.cpp``):
native polyline geometry, the grid-hashed box store (a host-side R-tree
replacement for dataset tooling and single queries), the binary append
log, the background line writer and the ``.npy`` loader and stream
(``dcarl_tpu/utils/native.py``, the same names and signatures).

The library is built at first use with ``g++`` and ``csrc/Makefile``'s
flags into ``build/torch_host/`` beside the package (git-ignored), never
into ``csrc/``.  Its file name carries a hash of the source and the
flags, so an edited source builds anew and an unchanged one is reused;
the compiler writes a temporary file that is renamed into place, so two
processes building at once each see all of the library or none of it.

There is no quiet fallback: a failed build raises with the compiler's
output.  The plain versions stay callable by name:
``ops.geometry.dense_polyline2d_np`` and
``ops.geometry.project_point_to_polyline_np`` for the geometry,
``numpy.load`` for :func:`npy_mmap`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "csrc" / "dcarl_host.cpp"
BUILD_DIR = _ROOT / "build" / "torch_host"
# csrc/Makefile's CXXFLAGS and its -shared
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall",
             "-pthread", "-shared")

_lib = None
_lock = threading.Lock()


def lib_path() -> Path:
    tag = hashlib.sha256(SOURCE.read_bytes()
                         + " ".join(CXX_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libdcarl_host-{tag}.so"


def build(force: bool = False) -> Path:
    """Compile the library unless it is there (or ``force``); returns its
    path.  Raises with the compiler's output when the build fails."""
    out = lib_path()
    if out.exists() and not force:
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library builds from "
                           f"{SOURCE} with g++")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}-{threading.get_ident()}")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SOURCE}:\n{res.stdout}"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib: ctypes.CDLL) -> None:
    """argtypes and restype of every entry point."""
    c_dp = ctypes.POINTER(ctypes.c_double)
    c_vp, c_cp, c_i, c_i64 = (ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int,
                              ctypes.c_int64)
    sig = {
        "dcarl_wrap_angle": (ctypes.c_double, [ctypes.c_double]),
        "dcarl_dense_polyline2d": (c_i, [c_dp, c_i, ctypes.c_double, c_dp,
                                         c_i]),
        "dcarl_project_point_to_polyline": (None, [
            ctypes.c_double, ctypes.c_double, c_dp, c_i, c_dp]),
        "dcarl_boxstore_new": (c_vp, [c_i, c_dp]),
        "dcarl_boxstore_free": (None, [c_vp]),
        "dcarl_boxstore_insert": (c_i, [c_vp, c_dp, ctypes.c_double,
                                        ctypes.c_double]),
        "dcarl_boxstore_size": (c_i, [c_vp]),
        "dcarl_boxstore_query": (None, [c_vp, c_dp, c_dp]),
        "dcarl_boxstore_query_bruteforce": (None, [c_vp, c_dp, c_dp]),
        "dcarl_boxstore_save": (c_i, [c_vp, c_cp]),
        "dcarl_boxstore_load": (c_vp, [c_cp]),
        "dcarl_log_open": (c_vp, [c_cp, c_i]),
        "dcarl_log_append": (None, [c_vp, c_dp, c_i]),
        "dcarl_log_flush": (None, [c_vp]),
        "dcarl_log_close": (None, [c_vp]),
        "dcarl_log_read": (c_i64, [c_cp, c_i, c_dp, c_i64]),
        "dcarl_writer_open": (c_vp, [c_cp]),
        "dcarl_writer_append": (None, [c_vp, c_cp, c_i]),
        "dcarl_writer_flush": (None, [c_vp]),
        "dcarl_writer_lines_written": (c_i64, [c_vp]),
        "dcarl_writer_close": (None, [c_vp]),
        "dcarl_npy_open": (c_vp, [c_cp]),
        "dcarl_npy_info": (c_i, [c_vp, ctypes.POINTER(c_i64),
                                 ctypes.POINTER(c_i)]),
        "dcarl_npy_data": (c_vp, [c_vp]),
        "dcarl_npy_close": (None, [c_vp]),
        "dcarl_stream_open": (c_vp, [c_cp, c_i64, c_i]),
        "dcarl_stream_next": (c_i64, [c_vp, c_vp, c_i64]),
        "dcarl_stream_row_bytes": (c_i64, [c_vp]),
        "dcarl_stream_total_rows": (c_i64, [c_vp]),
        "dcarl_stream_close": (None, [c_vp]),
    }
    for name, (restype, argtypes) in sig.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes


def load_library(rebuild: bool = False) -> ctypes.CDLL:
    """The loaded host library, built first if missing (or ``rebuild``)."""
    global _lib
    with _lock:
        if _lib is None or rebuild:
            lib = ctypes.CDLL(str(build(force=rebuild)))
            _declare(lib)
            _lib = lib
        return _lib


def _dp(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _points(line) -> np.ndarray:
    line = np.ascontiguousarray(line, dtype=np.float64)
    if line.ndim != 2 or line.shape[1] != 2:
        raise ValueError(f"a polyline is [n, 2]; got {line.shape}")
    return line


def dense_polyline2d(line: np.ndarray, resolution: float) -> np.ndarray:
    lib = load_library()
    line = _points(line)
    max_out = int(1e7 // 16)
    out = np.empty((max_out, 2), dtype=np.float64)
    n = lib.dcarl_dense_polyline2d(_dp(line), len(line), resolution,
                                   _dp(out), max_out)
    return out[:n].copy()


def project_point_to_polyline(x: float, y: float, line: np.ndarray
                              ) -> Tuple[float, int, int, float, float]:
    lib = load_library()
    line = _points(line)
    res = np.empty(5, dtype=np.float64)
    lib.dcarl_project_point_to_polyline(x, y, _dp(line), len(line), _dp(res))
    return float(res[0]), int(res[1]), int(res[2]), float(res[3]), float(res[4])


class HostBoxStore:
    """Host-side spatial value store with R-tree query semantics
    (grid-hash index; exact containment check).  A query returns
    ``(count, mean, var)`` in float64: population variance, -1 for the
    mean and the variance of an empty match."""

    def __init__(self, half_widths: np.ndarray, _handle=None):
        self.lib = load_library()
        self.widths = np.ascontiguousarray(half_widths, dtype=np.float64)
        self.dim = len(self.widths)
        self.handle = _handle if _handle is not None else \
            self.lib.dcarl_boxstore_new(self.dim, _dp(self.widths))

    def _point(self, x) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float64)
        if x.shape != (self.dim,):
            raise ValueError(f"a key of this store is [{self.dim}]; got "
                             f"{x.shape}")
        return x

    def insert(self, key: np.ndarray, action: float, value: float) -> int:
        key = self._point(key)
        return self.lib.dcarl_boxstore_insert(self.handle, _dp(key),
                                              float(action), float(value))

    def query(self, q: np.ndarray, exact: bool = False
              ) -> Tuple[int, float, float]:
        q = self._point(q)
        out = np.empty(3, dtype=np.float64)
        if exact:
            self.lib.dcarl_boxstore_query_bruteforce(self.handle, _dp(q),
                                                     _dp(out))
        else:
            self.lib.dcarl_boxstore_query(self.handle, _dp(q), _dp(out))
        return int(out[0]), float(out[1]), float(out[2])

    def __len__(self) -> int:
        return self.lib.dcarl_boxstore_size(self.handle)

    def save(self, path: str) -> None:
        if self.lib.dcarl_boxstore_save(self.handle, path.encode()) != 0:
            raise IOError(f"cannot save box store to {path}")

    @classmethod
    def load(cls, path: str) -> "HostBoxStore":
        lib = load_library()
        handle = lib.dcarl_boxstore_load(path.encode())
        if not handle:
            raise IOError(f"cannot load box store from {path}")
        # the half-widths follow the (dim, n) header of the file
        with open(path, "rb") as f:
            dim, _n = struct.unpack("ii", f.read(8))
            widths = np.frombuffer(f.read(8 * dim), dtype=np.float64)
        return cls(widths, _handle=handle)

    def __del__(self):
        if getattr(self, "lib", None) is not None and \
                getattr(self, "handle", None):
            self.lib.dcarl_boxstore_free(self.handle)


class RecordLog:
    """Append-only binary record log (double[width] rows)."""

    def __init__(self, path: str, width: int):
        self.lib = load_library()
        self.path = path
        self.width = width
        self.handle = self.lib.dcarl_log_open(path.encode(), width)
        if not self.handle:
            raise IOError(f"cannot open {path}")

    def append(self, records: np.ndarray) -> None:
        records = np.ascontiguousarray(records, dtype=np.float64)
        if records.ndim == 1:
            records = records[None]
        if records.ndim != 2 or records.shape[1] != self.width:
            raise ValueError(f"records of this log are [n, {self.width}]; "
                             f"got {records.shape}")
        self.lib.dcarl_log_append(self.handle, _dp(records), len(records))

    def flush(self) -> None:
        self.lib.dcarl_log_flush(self.handle)

    def close(self) -> None:
        if self.handle:
            self.lib.dcarl_log_close(self.handle)
            self.handle = None

    @staticmethod
    def read(path: str, width: int, max_records: int = 1 << 22) -> np.ndarray:
        lib = load_library()
        out = np.empty((max_records, width), dtype=np.float64)
        n = lib.dcarl_log_read(path.encode(), width, _dp(out), max_records)
        if n < 0:
            raise IOError(f"cannot read {path}")
        return out[:n].copy()


class AsyncLogWriter:
    """Background-thread batched line writer (native).  Drop-in for the
    reference's synchronous ``open(path, 'a').write`` record logging —
    ``append`` never blocks on disk I/O."""

    def __init__(self, path: str):
        self.lib = load_library()
        self.handle = self.lib.dcarl_writer_open(path.encode())
        if not self.handle:
            raise IOError(f"cannot open {path}")

    def append(self, line: str) -> None:
        data = line.encode()
        self.lib.dcarl_writer_append(self.handle, data, len(data))

    def flush(self) -> None:
        self.lib.dcarl_writer_flush(self.handle)

    @property
    def lines_written(self) -> int:
        return int(self.lib.dcarl_writer_lines_written(self.handle))

    def close(self) -> None:
        if self.handle:
            self.lib.dcarl_writer_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


_NPY_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.int64,
               5: np.uint8}


def _npy_header(lib, handle) -> Tuple[type, tuple]:
    shape = (ctypes.c_int64 * 8)()
    code = ctypes.c_int()
    ndim = lib.dcarl_npy_info(handle, shape, ctypes.byref(code))
    return _NPY_DTYPES[code.value], tuple(shape[i] for i in range(ndim))


def npy_mmap(path: str) -> np.ndarray:
    """A ``.npy`` file through the native mmap loader (copied into an
    owning array on return so the mapping can close)."""
    lib = load_library()
    h = lib.dcarl_npy_open(path.encode())
    if not h:
        raise IOError(f"cannot open {path} as npy")
    try:
        dt, shp = _npy_header(lib, h)
        n = int(np.prod(shp))
        buf = (ctypes.c_char * (n * np.dtype(dt).itemsize)).from_address(
            lib.dcarl_npy_data(h))
        return np.frombuffer(buf, dtype=dt).reshape(shp).copy()
    finally:
        lib.dcarl_npy_close(h)


class NpyStream:
    """Chunked row stream over a ``.npy`` file with background read-ahead
    (double-buffered): the native data loader feeding device transfers
    while the previous chunk computes.

    Iterates [chunk_rows, ...] arrays; the final chunk may be short.
    """

    def __init__(self, path: str, chunk_rows: int, n_buffers: int = 2):
        self.lib = load_library()
        self.handle = self.lib.dcarl_stream_open(path.encode(),
                                                 chunk_rows, n_buffers)
        if not self.handle:
            raise IOError(f"cannot stream {path}")
        self.chunk_rows = chunk_rows
        self.row_bytes = int(self.lib.dcarl_stream_row_bytes(self.handle))
        self.total_rows = int(self.lib.dcarl_stream_total_rows(self.handle))
        # row dtype and shape from the header (a header-only open)
        h = self.lib.dcarl_npy_open(path.encode())
        try:
            self.dtype, shape = _npy_header(self.lib, h)
        finally:
            self.lib.dcarl_npy_close(h)
        self.row_shape = shape[1:]

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        buf = np.empty(self.chunk_rows * self.row_bytes, np.uint8)
        rows = self.lib.dcarl_stream_next(
            self.handle, buf.ctypes.data_as(ctypes.c_void_p), buf.nbytes)
        if rows < 0:
            raise IOError("stream chunk larger than buffer")
        if rows == 0:
            raise StopIteration
        out = buf[: rows * self.row_bytes].view(self.dtype)
        return out.reshape((rows,) + self.row_shape)

    def close(self) -> None:
        if self.handle:
            self.lib.dcarl_stream_close(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
