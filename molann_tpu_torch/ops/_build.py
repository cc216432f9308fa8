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

The engine artifact's pieces are built with ``g++`` against PyTorch
(:func:`load_op_library`, :func:`build_serve_torch`): the torch custom ops'
schemas (``csrc/torch_ops.cpp``, PyTorch alone, so that a machine without
a card or ``nvcc`` can script, save and load a fused artifact), their CUDA
implementations (``csrc/torch_ops_cuda.cpp`` and
``csrc/torch_ops_launch.cpp``, linked with the schema library and the
kernel library above), and the serving container ``serve_torch``
(``csrc/serve_torch.cpp`` with the trajectory loader). Only the include
paths, library paths and ABI flag come from ``torch.utils.cpp_extension``;
each output is keyed by a hash of its sources, flags and PyTorch's
version, written to a temporary name and renamed into place, so that
processes that build at once never load a half-written file.
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

__all__ = ["load_library", "load_op_library", "build_serve_torch",
           "nvcc_path", "BUILD_INFO"]

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
GXX_FLAGS = ["-std=c++20", "-O2", "-fPIC", "-Wno-unknown-pragmas"]
# The engine artifact's libraries loaded in this process, by kind.
_op_libs: dict = {}
_op_lock = threading.Lock()


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
    lib.molann_fused_grid.argtypes = [vp, i32, i32, vp]
    lib.molann_fused_grid.restype = i32
    lib.molann_fused_forward.argtypes = [vp, vp, i32, i32, i32, i32, vp]
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
    lib.molann_edge_mm_caps.argtypes = [vp]
    lib.molann_edge_mm_caps.restype = i32
    lib.molann_edge_mm_resources.argtypes = [i32, i32, i32, i32, i32, vp]
    lib.molann_edge_mm_resources.restype = i32
    lib.molann_edge_mm.argtypes = [i32, vp, vp, i32, vp, vp, i32, vp, vp, i32,
                                   i32, i64, i32, vp]
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


def _torch_flags():
    """``(compile flags, library directory)`` for g++ against PyTorch:
    include paths and library path from ``torch.utils.cpp_extension``, the
    C++ ABI PyTorch was built with."""
    import torch
    from torch.utils import cpp_extension

    abi = int(torch.compiled_with_cxx11_abi())
    return ([f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
             *(f"-I{p}" for p in cpp_extension.include_paths())],
            cpp_extension.library_paths()[0])


def _gxx_output(stem, files, flags, suffix=".so"):
    """The output path of a g++ build: keyed by the sources, the flags and
    PyTorch's version."""
    import torch

    h = hashlib.sha256(" ".join([*flags, torch.__version__]).encode())
    for p in files:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{stem}_{h.hexdigest()[:16]}{suffix}"


def _run_all(jobs):
    """Run each ``(name, argv)`` at once; raise with its output where one
    fails. Returns the combined output, one ``== <name>`` section each."""
    procs = [(name, cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True))
             for name, cmd in jobs]
    log, failed = [], []
    for name, cmd, proc in procs:
        text = proc.communicate()[0]
        log.append(f"== {name}\n{text}")
        if proc.returncode != 0:
            failed.append(f"{' '.join(cmd)}\n{text}")
    if failed:
        raise RuntimeError("g++ failed:\n" + "\n".join(failed))
    return "".join(log)


def _link_torch(libdir, *names):
    """Link flags for PyTorch's libraries ``names``, found at run time in
    ``libdir``."""
    return [f"-L{libdir}", f"-Wl,-rpath,{libdir}", "-Wl,--no-as-needed",
            *(f"-l{n}" for n in names), "-Wl,--as-needed"]


def _build_gxx(out, compile_jobs, link):
    """Compile ``compile_jobs`` (``[(source, extra flags)]``) into objects
    at once, then link them with ``link`` into ``out``, via temporary
    names. Returns the seconds taken and g++'s output."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    objs = out.with_suffix(f".{os.getpid()}.obj")
    objs.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        jobs, paths = [], []
        for src, flags in compile_jobs:
            obj = objs / (src.stem + ".o")
            paths.append(str(obj))
            jobs.append((src.name, ["g++", *GXX_FLAGS, *flags, f"-I{SRC_DIR}",
                                    "-c", str(src), "-o", str(obj)]))
        log = _run_all(jobs)
        log += _run_all([(out.name, ["g++", *paths, "-o", str(tmp), *link])])
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
        shutil.rmtree(objs, ignore_errors=True)
    return time.perf_counter() - t0, log


def _cuda_include():
    return str(Path(nvcc_path()).resolve().parent.parent / "include")


def _op_libraries(cuda):
    """``[(path, compile jobs, link flags)]`` of the engine artifact's
    libraries: the schemas and, with ``cuda``, their CUDA implementations
    (which needs the kernel library built first)."""
    cflags, libdir = _torch_flags()
    schema_src = SRC_DIR / "torch_ops.cpp"
    schema = _gxx_output("libmolann_ops", [schema_src], cflags)
    libs = [(schema, [(schema_src, cflags)],
             ["-shared", *_link_torch(libdir, "c10", "torch_cpu")])]
    if cuda:
        kernels = Path(load_library()._name)
        srcs = [SRC_DIR / "torch_ops_cuda.cpp", SRC_DIR / "torch_ops_launch.cpp"]
        deps = [*srcs, *sorted(SRC_DIR.glob("*.cuh")),
                SRC_DIR / "torch_ops_launch.h"]
        cuda_flags = [*cflags, f"-I{_cuda_include()}"]
        out = _gxx_output("libmolann_ops_cuda", deps,
                          [*cuda_flags, schema.name, kernels.name])
        libs.append((out, [(srcs[0], cuda_flags), (srcs[1], [])],
                     ["-shared", str(schema), str(kernels),
                      *_link_torch(libdir, "c10", "c10_cuda", "torch_cpu")]))
    return libs


def load_op_library(cuda=True):
    """Build (at first use) and load the engine artifact's torch custom
    ops, ``torch.ops.molann_tpu_torch.*``: their schemas and, with
    ``cuda``, their CUDA implementations, which launch K1, K4, K6 and K8
    from the kernel library (built with ``nvcc`` first). Returns the path
    of the library a serving process loads (``serve_torch --ops``): the
    CUDA one, which loads the schemas itself, or the schemas. Records the
    build seconds in ``BUILD_INFO["ops_seconds"]``."""
    import torch

    kind = "cuda" if cuda else "schemas"
    with _op_lock:
        if kind in _op_libs:
            return _op_libs[kind]
        seconds, log = 0.0, ""
        for out, jobs, link in _op_libraries(cuda):
            if not out.exists():
                dt, text = _build_gxx(out, jobs, link)
                seconds, log = seconds + dt, log + text
            torch.ops.load_library(str(out))
        BUILD_INFO.update(ops_seconds=seconds, ops_log=log)
        _op_libs[kind] = str(out)
        return _op_libs[kind]


def build_serve_torch():
    """Build (at first use) the serving container ``serve_torch`` against
    LibTorch (with its CUDA libraries where PyTorch has them) and the
    port's trajectory loader. Returns its path; records the build seconds
    in ``BUILD_INFO["serve_seconds"]``."""
    cflags, libdir = _torch_flags()
    srcs = [SRC_DIR / "serve_torch.cpp", SRC_DIR / "traj_loader.cpp"]
    out = _gxx_output("serve_torch", [*srcs, SRC_DIR / "traj_loader.h"],
                      cflags, suffix="")
    seconds = 0.0
    if not out.exists():
        libs = ["torch", "torch_cpu", "c10"]
        if (Path(libdir) / "libtorch_cuda.so").exists():
            libs += ["torch_cuda", "c10_cuda"]
        seconds, _ = _build_gxx(out, [(srcs[0], cflags), (srcs[1], ["-O3"])],
                                [*_link_torch(libdir, *libs), "-pthread",
                                 "-ldl"])
    BUILD_INFO["serve_seconds"] = seconds
    return str(out)
