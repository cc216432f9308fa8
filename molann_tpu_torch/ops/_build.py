"""Build and load the port's CUDA kernels at first use.

The sources under ``molann_tpu_torch/csrc/`` are compiled by ``nvcc``, one
process per ``.cu`` file, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``. A file whose
kernels are large template instances names a macro and a count in a line
``// nvcc-variants: MACRO N`` and is compiled N times, with ``-DMACRO=0`` to
``-DMACRO=N-1``, each process building the instances of its variant: one
``ptxas`` run per kernel, side by side, in place of one after another. The
library goes to ``molann_tpu_torch/_build/`` under a name keyed by a hash of
the sources and flags, so an edited source builds anew and an unchanged one
is reused. Nothing is built at import: the CPU tests import every module
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["load_library", "nvcc_path", "BUILD_INFO"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*GENCODE, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

# What the last build (or cache hit) in this process did: library path,
# seconds spent in nvcc (0.0 on a cache hit) and nvcc's -Xptxas -v report,
# one "== <source>" section per file.
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
    lib.molann_fused_frames.argtypes = [vp, i32]
    lib.molann_fused_frames.restype = i32
    lib.molann_fused_forward.argtypes = [vp, vp, i32, i32, vp]
    lib.molann_fused_forward.restype = i32
    lib.molann_grads_frames.argtypes = [vp, i32, i32, i32]
    lib.molann_grads_frames.restype = i32
    lib.molann_fused_grads.argtypes = [vp, vp, i32, vp, i32, vp]
    lib.molann_fused_grads.restype = i32
    lib.molann_blocked_caps.argtypes = [vp]
    lib.molann_blocked_caps.restype = i32
    lib.molann_blocked_threads.argtypes = [vp, i32]
    lib.molann_blocked_threads.restype = i32
    lib.molann_blocked_smem_bytes.argtypes = [vp, i32]
    lib.molann_blocked_smem_bytes.restype = i64
    lib.molann_blocked_partial_rows.argtypes = [vp, i64]
    lib.molann_blocked_partial_rows.restype = i64
    lib.molann_blocked_forward.argtypes = [vp, vp, i32, vp]
    lib.molann_blocked_forward.restype = i32
    lib.molann_blocked_cv_forces.argtypes = [vp, vp, i32, vp]
    lib.molann_blocked_cv_forces.restype = i32
    lib.molann_blocked_backward.argtypes = [vp, vp, vp, i32, vp]
    lib.molann_blocked_backward.restype = i32
    lib.molann_blocked_train.argtypes = [vp, vp, vp, i32, vp]
    lib.molann_blocked_train.restype = i32
    lib.molann_edge_mm_scratch.argtypes = [i32, i32]
    lib.molann_edge_mm_scratch.restype = i64
    lib.molann_edge_mm.argtypes = [i32, vp, vp, vp, i32, i32, i64, vp, vp, vp,
                                   vp, i32, vp]
    lib.molann_edge_mm.restype = i32
    return lib


def _variants(src):
    """``[(object stem, extra nvcc flags)]`` of one ``.cu``: one entry, or
    one per variant its ``// nvcc-variants: MACRO N`` line declares."""
    m = re.search(r"^// nvcc-variants: (\w+) (\d+)$", src.read_text(),
                  re.MULTILINE)
    if m is None:
        return [(src.stem, [])]
    return [(f"{src.stem}.{i}", [f"-D{m.group(1)}={i}"])
            for i in range(int(m.group(2)))]


def _compile(files, out):
    """Compile each ``.cu`` of ``files`` (each variant of it) in its own
    ``nvcc``, all at once, and link the objects into ``out``. Returns
    nvcc's combined report, one ``== <file> [flags]`` section per process."""
    nvcc = nvcc_path()
    objs = out.with_suffix(f".{os.getpid()}.obj")
    objs.mkdir(parents=True, exist_ok=True)
    try:
        jobs = []
        for src in (p for p in files if p.suffix == ".cu"):
            for stem, flags in _variants(src):
                cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", str(src), "-o",
                       str(objs / (stem + ".o"))]
                jobs.append((f"{src.name} {' '.join(flags)}".strip(), cmd,
                             objs / (stem + ".o"), subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True)))
        log = []
        for name, cmd, _, proc in jobs:
            text = proc.communicate()[0]
            log.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                for _, _, _, other in jobs:
                    other.wait()
                raise RuntimeError(f"nvcc failed ({proc.returncode}): "
                                   f"{' '.join(cmd)}\n{text}")
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *GENCODE, "-shared", "-o", str(tmp),
               *(str(obj) for _, _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}): "
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
        return "".join(log)
    finally:
        shutil.rmtree(objs, ignore_errors=True)


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
            t0 = time.perf_counter()
            log = _compile(files, out)
            seconds = time.perf_counter() - t0
        _lib = _bind(ctypes.CDLL(str(out)))
        BUILD_INFO.update(path=str(out), seconds=seconds, log=log)
        return _lib
