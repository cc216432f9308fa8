"""Build and load the port's CUDA kernels at first use.

The sources under ``molann_tpu_torch/csrc/`` are compiled by ``nvcc`` into
one shared library with a plain C interface, loaded with ``ctypes``. The
library goes to ``molann_tpu_torch/_build/`` under a name keyed by a hash
of the sources and flags, so an edited source builds anew and an unchanged
one is reused. Nothing is built at import: the CPU tests import every
module without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "nvcc_path", "BUILD_INFO"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# What the last build (or cache hit) in this process did: library path,
# seconds spent in nvcc (0.0 on a cache hit) and nvcc's -Xptxas -v report.
BUILD_INFO: dict = {}

_lock = threading.Lock()
_lib = None


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME``, ``PATH`` or ``/usr/local/cuda``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of molann_tpu_torch cannot be built")


def _sources():
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


def _digest(files) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib):
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.molann_caps.argtypes = [vp]
    lib.molann_caps.restype = i32
    lib.molann_fused_forward.argtypes = [vp, vp, vp, i64, i32, i32, i32, vp]
    lib.molann_fused_forward.restype = i32
    lib.molann_fused_cv_forces.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32,
                                           i32, vp]
    lib.molann_fused_cv_forces.restype = i32
    return lib


def load_library():
    """The kernel library, built with ``nvcc`` for ``sm_90a`` on first call.
    Raises if ``nvcc`` is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        files = _sources()
        out = BUILD_DIR / f"libmolann_fused_{_digest(files)}.so"
        seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   *(str(p) for p in files if p.suffix == ".cu")]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
            os.replace(tmp, out)
        _lib = _bind(ctypes.CDLL(str(out)))
        BUILD_INFO.update(path=str(out), seconds=seconds, log=log)
        return _lib
