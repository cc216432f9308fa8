"""ctypes bindings for the native C++ trajectory loader.

The port of ``molann_tpu/io/native_loader.py``. The loader's source is the
port's own copy, ``molann_tpu_torch/csrc/traj_loader.cpp``; it is compiled
with ``g++`` at first use into ``molann_tpu_torch/_build/`` under a name
keyed by a hash of the source and flags, written to a temporary name and
renamed into place, so processes that build at once (test workers) never
load a half-written library. :func:`available` reports whether the native
path can be used; the readers of :mod:`molann_tpu_torch.io.reader` fall
back to the numpy decoders under ``backend="auto"``, so the package never
needs a compiler to read a trajectory.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

__all__ = ["available", "NativeTrajLoader", "build"]

_PKG = Path(__file__).resolve().parent.parent
_SRC_PATH = _PKG / "csrc" / "traj_loader.cpp"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-shared",
          "-pthread"]

_lib = None
_lib_lock = threading.Lock()


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC_PATH.read_bytes())
    return _BUILD_DIR / f"libtrajloader_{h.hexdigest()[:16]}.so"


def build(force=False):
    """Compile the native library with ``g++`` (once; cached by content).
    Returns its path."""
    out = _so_path()
    if out.exists() and not force:
        return str(out)
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_FLAGS, str(_SRC_PATH), "-o", str(tmp)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed to build the trajectory loader "
                           f"({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return str(out)


def _load():
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(build())
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.tl_open.restype = ctypes.c_void_p
        lib.tl_open.argtypes = [ctypes.c_char_p, i64p, i64p]
        lib.tl_close.restype = None
        lib.tl_close.argtypes = [ctypes.c_void_p]
        lib.tl_read_batch.restype = ctypes.c_int
        lib.tl_read_batch.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_float),
                                      ctypes.c_int]
        lib.tl_read_range.restype = ctypes.c_int
        lib.tl_read_range.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_float)]
        lib.tl_prefetch.restype = None
        lib.tl_prefetch.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int64]
        lib.tl_last_error.restype = ctypes.c_char_p
        lib.tl_last_error.argtypes = []
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native loader can be used (builds on first call)."""
    try:
        _load()
        return True
    except (OSError, RuntimeError):
        return False


class NativeTrajLoader:
    """Native mmap + threaded-gather reader for ``.npy`` / ``.dcd`` /
    ``.trr`` / ``.xtc`` / Amber ``.nc`` trajectories.

    The format is detected by its magic; DCD frames (X/Y/Z component
    planes) are interleaved to the packed atom-major layout during the
    gather. Frames come back packed, ``[count, 3n]`` float32.
    """

    def __init__(self, path, n_threads: int | None = None):
        lib = _load()
        nf = ctypes.c_int64()
        fpf = ctypes.c_int64()
        handle = lib.tl_open(str(path).encode(), ctypes.byref(nf),
                             ctypes.byref(fpf))
        if not handle:
            raise OSError(lib.tl_last_error().decode())
        self._lib = lib
        self._handle = handle
        self.n_frames = nf.value
        self.floats_per_frame = fpf.value
        self.n_atoms = self.floats_per_frame // 3
        self.n_threads = n_threads or min(8, os.cpu_count() or 1)

    def _check_open(self):
        if not self._handle:
            raise ValueError("the trajectory loader is closed")

    def read_batch(self, indices) -> np.ndarray:
        """Frames at ``indices`` as ``[len(indices), 3n]`` float32."""
        self._check_open()
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        out = np.empty((len(idx), self.floats_per_frame), dtype=np.float32)
        rc = self._lib.tl_read_batch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_threads)
        if rc != 0:
            raise IndexError(self._lib.tl_last_error().decode())
        return out

    def read_range(self, start: int, count: int) -> np.ndarray:
        """Frames ``start .. start + count`` as ``[count, 3n]`` float32."""
        self._check_open()
        out = np.empty((count, self.floats_per_frame), dtype=np.float32)
        rc = self._lib.tl_read_range(
            self._handle, start, count,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        if rc != 0:
            raise IndexError(self._lib.tl_last_error().decode())
        return out

    def prefetch(self, indices) -> None:
        """Queue an asynchronous page prefetch of the given frames (the C
        side copies the index list before it returns)."""
        self._check_open()
        idx = np.ascontiguousarray(indices, dtype=np.int64)
        self._lib.tl_prefetch(
            self._handle, idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx))

    def close(self):
        if self._handle:
            self._lib.tl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except (AttributeError, OSError):
            pass

    def __len__(self):
        return self.n_frames
