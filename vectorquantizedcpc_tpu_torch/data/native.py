"""ctypes binding of the native clip engine (``native/clip_sampler.cpp``).

The engine maps ``.npy`` feature files once and copies a whole batch of
clip windows per call on a small C++ thread pool; ``ctypes`` releases the
GIL for the call, so the loader's thread assembles batches without holding
back the trainer's thread. The JAX package's ``data/native.py``, with one
difference: there is no fallback. The first use builds the engine with
``g++`` into ``build/host_native/`` beside the package (the library named
by a hash of the source and the flags, built under a per-process name and
renamed into place, so concurrent processes may build at once); where
``g++`` is missing or the build fails, it raises ``RuntimeError`` with the
compiler's output. The datasets' per-item ``__getitem__`` is the plain
version of :meth:`NpyWindowStore.sample`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

SRC = Path(__file__).resolve().parents[1] / "native" / "clip_sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host_native"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]
LINK_FLAGS = ["-lpthread"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    digest.update(SRC.read_bytes())
    return BUILD_DIR / f"libclip_sampler_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the engine unless this exact build exists; returns its path."""
    lib_path = _library_path()
    if lib_path.exists():
        return lib_path
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(f"g++ not found on PATH: the native clip engine ({SRC.name}) "
                           "needs a C++17 compiler")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_name(f"{lib_path.name}.tmp.{os.getpid()}")
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp), *LINK_FLAGS],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build {SRC.name}:\n{proc.stdout}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded engine, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            lib.cs_open.restype = p
            lib.cs_open.argtypes = [ctypes.POINTER(ctypes.c_char_p), i32]
            lib.cs_close.argtypes = [p]
            for fn, res in (("cs_rows", i64), ("cs_cols", i64), ("cs_esize", i32)):
                getattr(lib, fn).restype = res
                getattr(lib, fn).argtypes = [p, i32]
            lib.cs_sample.restype = i32
            lib.cs_sample.argtypes = [p, ctypes.POINTER(i32), ctypes.POINTER(i64), i32, i64, p,
                                      i32]
            _lib = lib
    return _lib


class NpyWindowStore:
    """Memory-mapped ``.npy`` files and batched window copies.

    Every file has ``rows`` leading rows (1 for 1-D files) and ``dtype``;
    windows run over the trailing (time) axis. :meth:`sample` returns
    ``(count, rows, clip)``, or ``(count, clip)`` for 1-D files.
    """

    def __init__(self, paths: Sequence[Path], dtype, rows: int):
        lib = library()
        self._lib = lib
        self.dtype = np.dtype(dtype)
        self.rows = rows
        arr = (ctypes.c_char_p * len(paths))(*[str(p).encode() for p in paths])
        self._h = lib.cs_open(arr, len(paths))
        if not self._h:
            raise ValueError(f"cs_open failed: an unreadable or unsupported .npy among "
                             f"{len(paths)} files (C order, at most 2-D)")
        for i, path in enumerate(paths):
            if lib.cs_rows(self._h, i) != rows or lib.cs_esize(self._h, i) != self.dtype.itemsize:
                n_rows, esize = lib.cs_rows(self._h, i), lib.cs_esize(self._h, i)
                self.close()
                raise ValueError(f"{path}: rows {n_rows} / itemsize {esize} mismatch the "
                                 f"store's rows {rows} / itemsize {self.dtype.itemsize}")
        self.n_files = len(paths)

    def sample(self, file_ids, starts, clip: int, n_threads: int = 4) -> np.ndarray:
        """Windows ``[start, start + clip)`` of the files ``file_ids``."""
        file_ids = np.ascontiguousarray(file_ids, np.int32)
        starts = np.ascontiguousarray(starts, np.int64)
        if not self._h:
            raise ValueError("the store is closed")
        if file_ids.ndim != 1 or starts.shape != file_ids.shape:
            raise ValueError(f"file_ids {file_ids.shape} and starts {starts.shape} must be "
                             "1-D of one length")
        count = file_ids.shape[0]
        out = np.empty((count, self.rows, clip), self.dtype)
        rc = self._lib.cs_sample(
            self._h,
            file_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            starts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            count, clip, out.ctypes.data_as(ctypes.c_void_p), n_threads,
        )
        if rc != 0:
            i = rc - 1
            raise IndexError(f"window out of bounds: request {i} (file {file_ids[i]}, "
                             f"start {starts[i]}, clip {clip})")
        return out[:, 0, :] if self.rows == 1 else out

    def close(self) -> None:
        if self._h:
            self._lib.cs_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
