"""The unrolled kernels' times on the alanine model, on one CUDA card.

    python molann_tpu_torch/probes/unrolled_probe.py [times|phases|knockouts|alternatives|suspects|host|tiles] [tag]

``times`` (the default) prints one JSON line: the mean CUDA-event time of
one call, after five warm-up calls, of the forward (K1), cv+forces (K4,
``[l, n, 3]`` and ``[3n, l]``), backward (K2, as ``torch.autograd.grad``
through a retained graph, with gx and for the parameters alone), forward
and backward together, and train (K3, both layouts) kernels on one
65,536-frame batch of ``alanine_model()`` (weights from seed 0, frames from
seed 3); beside each, from ``torch.profiler`` over 20 calls of the same
kind, the kernel's own time (``alone``) and the device's time a call
(``device``: the kernel, ``reduce_partials`` and any copy the wrapper
launched). The event time less the device time is the host's share: the
wrapper and autograd, where they outlast the kernel.

With ``times`` also: the cv+forces kernel as the bench op runs it
(``fused_cv_forces(model, x, tile=2048, transposed_input=True)``) and on
``[l, n, 3]``, and the forward kernel, on 1,048,576 frames made on the card
from a seeded generator (554 MB of frames and gradients, past the 50 MB
L2): each alone by ``torch.profiler`` and by CUDA events, with frames/s and
the share of the bound: the bytes a frame of ``frame_bytes`` (for the
bench op 492: the 18 atoms alanine's features read, 216 B, then gx and y;
on ``[l, n, 3]`` 540 for cv+forces, 276 for the forward) over 3.35 TB/s.

``phases`` builds ``csrc/fused_unrolled.cu`` again with a clock read in
lane 0 of every warp at each step of the forward and cv+forces kernels (a
step is a line of the kernel that starts with a call of an ``unr_*``
step; the read comes before that call, so that a step's cycles run from
its start to the next step's, its barrier wait included) and adds the
cycles to a counter of the step's name (the probe passes the counters in
``UnrIO.partials``, which those two kernels do not use). Prints each
step's share of the warps' cycles times the kernel's time with the clock
reads, for K4 (both layouts) and K1, one 65,536-frame batch; and the
warps of each kernel an SM holds and the warps a block
(``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` of the instrumented
build) beside the registers and stack of the package's own build
(``-Xptxas -v``, from its build log where this process built it).

``knockouts`` builds K1 and K4 again with one part taken out at a time
(the gradient store, QCP's adjoint, the feature adjoints, the head's
weight loads, QCP's forward; their results are wrong, so these builds only
time the parts), and times each alone against the tree's build (first and
last) on 65,536 frames and as the bench op on 1,048,576, and the tree's
build on a grid of half the warps an SM: what a part costs, and whether
the kernels are bound by latency (half the warps: slower in proportion)
or by issue.

``alternatives`` does the same with builds that take, in place of the
tree's choice, what was tried and dropped (stores and ``[3n, l]`` staging
that allocate L1 lines, ``[l, 3n]`` staging by loads, weights marked
evict-last, 96 and 80 registers, QCP's adjugate column chosen at run
time), with each build's registers and stack. A patch of either list
whose text the tree no longer holds exactly once stops the probe.

``host`` times the host's work alone: the same calls on a batch of 256
frames, whose kernels take a few microseconds, by the wall clock over 200
calls and one synchronise; and ``cProfile``'s heaviest functions of the
backward and train calls.

``tiles`` times each kernel alone with every block taking 128, 64 and 32
frames in turn (the tile the wrapper would choose is overridden); a tile
the tree's kernels cannot launch (more threads than their launch bounds)
is reported as such. K1 and K4 take warp tiles of 32 frames whatever is
asked.

``suspects`` builds the unrolled sources of the current tree (K1-K4 only,
``csrc/fused_unrolled.cu`` and ``csrc/fused_train.cu``) again in variants
and prints each kernel's time alone in each, one JSON line:

- ``base``: as the package builds them;
- ``envelope``: the compile-time envelope (``MOLANN_MAX_ATOMS``,
  ``MOLANN_MAX_COLS``, ``MOLANN_MAX_WIDTH``) cut to the alanine model's
  sizes (22 atoms, 38 columns, width 5), so that arrays sized by it shrink;
- ``regcap64``: at most 64 registers a thread (``__launch_bounds__(128,
  8)``: a bare ``-maxrregcount`` is overridden by the kernels' launch
  bounds);
- ``nosums``: the sums of the parameter gradients over frames taken out
  (their code replaced by nothing, so the train kernel is the forward, the
  cotangent and what the compiler keeps of the rest);

and, as a yardstick, the blocked kernels on the same model and batch
through ``mode="blocked"``: K6 and K7 under autograd, K5. A variant whose
source patch finds nothing to patch in this tree is reported as such.

Run as a file it imports ``molann_tpu_torch`` from the current directory,
not from beside itself. So two commits compare in one call on one card:
unpack the other commit into a directory git ignores (``git archive``),
and run this same file from both roots in turns (parent, change, change,
parent), with a tag to tell the lines apart.
"""

import ctypes
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import types
from pathlib import Path
from unittest import mock

import numpy as np
import torch

BATCH = 65536
BIG = 1 << 20
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
ALANINE = {"MOLANN_MAX_ATOMS": 22, "MOLANN_MAX_COLS": 38, "MOLANN_MAX_WIDTH": 5}
# Source patches that take the parameter sums out, by tree: the warp
# shuffle tree of a sink (PR 5's fused_train.cu) or the block-product step
# (its redesign); whichever matches.
NOSUMS = [
    (re.compile(r"for \(int o = 16; o > 0; o >>= 1\) v \+= __shfl_down_sync"
                r"\(0xffffffffu, v, o\);\s*if \(lane == 0\) row\[k\] = v;"),
     "(void)k; (void)v;"),
    (re.compile(r"^(\s*)unr_param_sums\(", re.MULTILINE),
     r"\1if (0) unr_param_sums("),
]


def cuda_ms(fn, reps=100):
    for _ in range(5):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, pattern, calls=20):
    """``(alone, device)``: ms a call of the kernels whose name matches
    ``pattern``, and of all device work, by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    alone = total = 0.0
    for event in prof.key_averages():
        t = getattr(event, "device_time_total", None)
        if t is None:
            t = event.cuda_time_total
        total += t
        if re.search(pattern, event.key):
            alone += t
    return alone / calls / 1e3, total / calls / 1e3


def setup(dev):
    from molann_tpu_torch.systems import alanine_model

    model, u = alanine_model(generator=torch.Generator().manual_seed(0),
                             device=dev)
    n = u.atoms.n_atoms
    x = torch.as_tensor((u.atoms.positions[None] + 0.05 * np.random.default_rng(
        3).normal(size=(BATCH, n, 3))).astype(np.float32), device=dev)
    gy = torch.as_tensor(np.random.default_rng(7).normal(
        size=(BATCH, 3)).astype(np.float32), device=dev)
    return model, x, gy


def calls(F, model, x, gy, mode="unrolled"):
    """``{name: (fn, kernel-name pattern)}`` of the calls timed."""
    n3 = x.shape[1] * 3
    xt = x.reshape(BATCH, n3).T.contiguous()
    gyt = gy.T.contiguous()
    xg = x.clone().requires_grad_(True)
    yk = F.fused_model_forward(model, xg, mode=mode)
    params = list(model.parameters())
    yp = F.fused_model_forward(model, x, mode=mode)  # x needs no gradient

    def fwd():
        with torch.no_grad():
            return F.fused_model_forward(model, x, mode=mode)

    def both():
        y = F.fused_model_forward(model, xg, mode=mode)
        return torch.autograd.grad(y, [xg, *params], gy)

    if mode == "blocked":
        return {
            "K6": (fwd, r"blocked_kernel<(false|0), "),
            "K7": (lambda: torch.autograd.grad(yk, [xg, *params], gy,
                                               retain_graph=True),
                   r"blocked_grads_kernel<(false|0), (true|1)"),
            "K7 no gx": (lambda: torch.autograd.grad(yp, params, gy,
                                                     retain_graph=True),
                         r"blocked_grads_kernel<(false|0), (false|0)"),
            "K5": (lambda: F.fused_train_grads(model, x, gy, mode=mode),
                   r"blocked_grads_kernel<(true|1)"),
        }
    return {
        "K1": (fwd, r"fused_unrolled_kernel<(false|0)"),
        "K4 [l, n, 3]": (lambda: F.fused_cv_forces(model, x),
                         r"fused_unrolled_kernel<(true|1)"),
        "K4 [3n, l]": (lambda: F.fused_cv_forces(model, xt,
                                                 transposed_input=True),
                       r"fused_unrolled_kernel<(true|1)"),
        "K2": (lambda: torch.autograd.grad(yk, [xg, *params], gy,
                                           retain_graph=True),
               r"fused_grads_kernel<(false|0)"),
        "K2 no gx": (lambda: torch.autograd.grad(yp, params, gy,
                                                 retain_graph=True),
                     r"fused_grads_kernel<(false|0)"),
        "K1 + K2": (both, r"fused_(unrolled|grads)_kernel<(false|0)"),
        "K3 [3n, l]": (lambda: F.fused_train_grads(model, xt, gyt,
                                                   transposed_input=True),
                       r"fused_grads_kernel<(true|1)"),
        "K3 [l, n, 3]": (lambda: F.fused_train_grads(model, x, gy),
                         r"fused_grads_kernel<(true|1)"),
    }


def timed(table, events=True):
    out = {}
    for name, (fn, pattern) in table.items():
        alone, dev_ms = device_ms(fn, pattern)
        row = {"alone": alone, "device": dev_ms}
        if events:
            row["event"] = cuda_ms(fn)
            row["host share"] = row["event"] - dev_ms
        out[name] = row
    return out


# A step of the forward and cv+forces kernels: a line of the kernel that
# starts with the call of an unr_* step.
STEP_LINE = re.compile(r"^([ \t]*)(?:unr|uw)_(\w+?)\s*(?:<[^;(]*>)?\(", re.MULTILINE)
KERNEL_HEAD = re.compile(r"fused_unrolled_kernel\([^)]*\)\s*\{")
PROBE_MARK = """
#define PROBE_MARK(k) do { const long long probe_t1 = clock64(); \\
  if ((threadIdx.x & 31) == 0 && probe_k >= 0) \\
    atomicAdd((unsigned long long*)io.partials + probe_k, \\
              (unsigned long long)(probe_t1 - probe_t0)); \\
  probe_t0 = probe_t1; probe_k = (k); } while (0)
"""
def instrument(text):
    """``(source, step names)``: ``fused_unrolled.cu`` with a clock read
    before every step of its kernel, and at its end."""
    head = KERNEL_HEAD.search(text)
    if head is None:
        raise SystemExit("fused_unrolled.cu no longer reads as the phases "
                         "probe expects: no fused_unrolled_kernel body")
    depth, end = 1, head.end()
    while depth:
        depth += {"{": 1, "}": -1}.get(text[end], 0)
        end += 1
    body = text[head.end():end - 1]
    names = []

    def mark(match):
        name = match.group(2)
        if name not in names:
            names.append(name)
        return f"{match.group(1)}PROBE_MARK({names.index(name)});\n" \
            + match.group(0)

    body = STEP_LINE.sub(mark, body).replace(
        "return;", "{ PROBE_MARK(-1); return; }")
    if not names:
        raise SystemExit("fused_unrolled.cu: no unr_* step in the kernel")
    body = ("\n  long long probe_t0 = clock64();\n  int probe_k = -1;" + body
            + "  PROBE_MARK(-1);\n")
    out = text[:head.end()] + body + text[end - 1:]
    out = out.replace('#include "frame_math.cuh"\n',
                      '#include "frame_math.cuh"\n' + PROBE_MARK, 1)
    return out, names


# K1 and K4 built again with one part taken out (their results are then
# wrong: these builds time the parts, nothing more): {kind: [(file, text,
# replacement)]}.
KNOCKOUTS = {
    "no gradient store": [(
        "fused_unrolled.cu", "    uw_store(m, io, ws, o, tile, lane);",
        "    if (io.l < 0) uw_store(m, io, ws, o, tile, lane);")],
    "no QCP adjoint": [(
        "frame_math.cuh", "  qcp_rotation_vjp<true>(H, gR, al.lam0, R, gH, al.best);",
        "  for (int i = 0; i < 9; ++i) gH[i / 3][i % 3] = gR[i / 3][i % 3] * al.lam0;")],
    "no feature adjoints": [(
        "fused_unrolled.cu", "    uw_adj_feat(m, io, st, o);",
        "    if (io.l < 0) uw_adj_feat(m, io, st, o);")],
    "no weight loads in the head": [(
        "frame_math.cuh",
        "    for (int u = 0; u < kG; ++u) a[u] += MOLANN_LDG(w[u] + k) * v;",
        "    for (int u = 0; u < kG; ++u) a[u] += (float)(u + k) * v;")],
    "no QCP forward": [(
        "frame_math.cuh",
        "    qcp_rotation<float, true>(H, al.R, &al.lam0, &al.best);",
        "    for (int i = 0; i < 9; ++i) al.R[i / 3][i % 3] = H[i / 3][i % 3];\n"
        "    al.lam0 = H[0][0];\n    al.best = 0;")],
}


# The choices K1 and K4 made against what was tried in their place, as
# builds of the tree with the other choice: {kind: [(file, text, replacement)]}.
ALTERNATIVES = {
    "stores allocating in L1": [(
        "frame_math.cuh",
        '  asm volatile("st.global.L1::no_allocate.f32 [%0], %1;" ::"l"(p), "f"(v) : "memory");',
        "  *p = v;")],
    "[3n, l] frames by cp.async": [(
        "frame_math.cuh",
        "#pragma unroll 18\n    for (int q = 0; q < s3; ++q) dst[q] = uw_get(src + (long long)m.slot_col[q] * io.l);",
        "#pragma unroll 6\n    for (int q = 0; q < s3; ++q) uw_copy(dst + q, src + (long long)m.slot_col[q] * io.l);")],
    "[l, 3n] frames by loads without L1 lines": [(
        "frame_math.cuh",
        '  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(',
        '  *dst = uw_get(src);\n  if (0) asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\\n" ::"r"(')],
    "weights marked evict-last": [(
        "frame_math.cuh", "#define MOLANN_LDG(p) __ldg(p)",
        '#define MOLANN_LDG(p) ([&] { float v_; asm("ld.global.nc.L1::evict_last.f32 %0, [%1];" '
        ': "=f"(v_) : "l"(p)); return v_; }())')],
    "96 registers": [(
        "fused_unrolled.cu", "__global__ void __launch_bounds__(32 * MOLANN_UW_MAX_WARPS, 1)",
        "__global__ void __maxnreg__(96)")],
    "80 registers": [(
        "fused_unrolled.cu", "__global__ void __launch_bounds__(32 * MOLANN_UW_MAX_WARPS, 1)",
        "__global__ void __maxnreg__(80)")],
    "QCP's column chosen at run time": [(
        "frame_math.cuh",
        "    qcp_rotation<float, true>(H, al.R, &al.lam0, &al.best);",
        "    qcp_rotation<float, false>(H, al.R, &al.lam0, &al.best);")],
}


def variant_sources(kind, dst):
    """Copy the tree's kernel sources into ``dst`` patched for ``kind``;
    returns the extra nvcc flags, or None where no patch of a ``suspects``
    variant applies. A KNOCKOUTS or ALTERNATIVES patch whose text the tree
    no longer holds once is an error."""
    from molann_tpu_torch.ops import _build

    for p in _build.SRC_DIR.iterdir():
        if p.suffix in (".cu", ".cuh"):
            shutil.copy(p, dst / p.name)
    if kind == "base":
        return []
    applied = False
    for p in dst.iterdir():
        text = p.read_text()
        new = text
        if kind == "phases":
            if p.name == "fused_unrolled.cu":
                new, names = instrument(text)
                (dst / "steps.json").write_text(json.dumps(names))
        elif kind in KNOCKOUTS or kind in ALTERNATIVES:
            for name, old, rep in {**KNOCKOUTS, **ALTERNATIVES}[kind]:
                if p.name == name:
                    if new.count(old) != 1:
                        raise SystemExit(f"{kind}: {name} holds the text its "
                                         f"patch replaces {new.count(old)} "
                                         "times, not once")
                    new = new.replace(old, rep)
        elif kind == "regcap64":
            new = new.replace("__launch_bounds__(128)", "__launch_bounds__(128, 8)")
        elif kind == "envelope":
            for macro, value in ALANINE.items():
                new = re.sub(rf"^#define {macro} \d+", f"#define {macro} {value}",
                             new, flags=re.MULTILINE)
        else:
            for pat, rep in NOSUMS:
                new = pat.sub(rep, new)
        if new != text:
            p.write_text(new)
            applied = True
    return [] if applied else None


def build_variants(kinds, root):
    """``{kind: library or None}``: each variant's unrolled kernels built
    together, one nvcc per source and variant, then linked."""
    from molann_tpu_torch.ops import _build

    nvcc = _build.nvcc_path()
    jobs, flags_of = [], {}
    for kind in kinds:
        d = root / kind
        d.mkdir()
        flags = variant_sources(kind, d)
        flags_of[kind] = flags
        if flags is None:
            continue
        for name in ("fused_unrolled.cu", "fused_train.cu"):
            obj = d / (name + ".o")
            cmd = [nvcc, *_build.NVCC_FLAGS, *flags, "-c", str(d / name),
                   "-o", str(obj)]
            jobs.append((kind, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    logs = {}
    for kind, obj, proc in jobs:
        text = proc.communicate()[0]
        logs[kind] = logs.get(kind, "") + text
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kind}:\n{text}")
    libs = {}
    for kind in kinds:
        if flags_of[kind] is None:
            libs[kind] = None
            continue
        d = root / kind
        so = d / "libunrolled.so"
        subprocess.run([nvcc, *_build.GENCODE, "-shared", "-o", str(so),
                        str(d / "fused_unrolled.cu.o"),
                        str(d / "fused_train.cu.o")], check=True)
        libs[kind] = _bind_partial(ctypes.CDLL(str(so)))
    return libs, logs


class _Partial:
    """A library with the unrolled kernels only, for the tree's own
    ``_bind``: the symbols it lacks take their argtypes and are dropped."""

    def __init__(self, lib):
        self.__dict__["_lib"] = lib

    def __getattr__(self, name):
        try:
            return getattr(self._lib, name)
        except AttributeError:
            return types.SimpleNamespace()


def _bind_partial(lib):
    from molann_tpu_torch.ops import _build

    return _build._bind(_Partial(lib))


def resources(log):
    """Registers, stack and spills of each kernel in an ``-Xptxas -v`` log."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            name = m.group(1)
            name = next((k for k in ("fused_unrolled_kernelILb0", "fused_unrolled_kernelILb1",
                                     "fused_grads_kernelILb0", "fused_grads_kernelILb1",
                                     "reduce_partials") if k in name), name)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name] = out.get(name, "") + f"{m.group(1)} B stack, " \
                f"{m.group(2)}/{m.group(3)} B spills; "
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = out.get(name, "") + f"{m.group(1)} registers; "
    return out


def suspects(dev, tag):
    from molann_tpu_torch.ops import fused as F

    kinds = ("base", "envelope", "regcap64", "nosums")
    main = {}
    t = threading.Thread(target=lambda: main.setdefault("lib", F._library()))
    t.start()  # the package's own library, for the blocked yardstick
    with tempfile.TemporaryDirectory() as tmp:
        libs, logs = build_variants(kinds, Path(tmp))
        t.join()
        model, x, gy = setup(dev)
        out = {"tag": tag, "mode": "suspects", "card": card()}
        original = F._library
        try:
            for kind in kinds:
                if libs[kind] is None:
                    out[kind] = "no patch applies"
                    continue
                lib = libs[kind]
                F._library = lambda lib=lib: lib
                getattr(F, "_STATICS", {}).clear()  # tiles are per build
                out[kind] = {name: row["alone"] for name, row in
                             timed(calls(F, model, x, gy), events=False).items()}
                out[kind]["resources"] = resources(logs[kind])
        finally:
            F._library = original
            getattr(F, "_STATICS", {}).clear()
        out["blocked"] = timed(calls(F, model, x, gy, mode="blocked"))
    print(json.dumps(out))


def knockouts(dev, tag, group=None):
    """K1 and K4 alone in each KNOCKOUTS (or ``group``) build and the
    tree's, in turns (the tree's first and last): the time a part costs, or
    an alternative. With KNOCKOUTS also the tree's build on a grid of half
    the warps an SM (half the blocks an SM that the wrapper's grid query
    gave, each warp walking twice the tiles)."""
    from molann_tpu_torch.ops import fused as F

    kinds = ("base", *(KNOCKOUTS if group is None else group))
    with tempfile.TemporaryDirectory() as tmp:
        libs, logs = build_variants(kinds, Path(tmp))
    model, x, _ = setup(dev)
    xt = x.reshape(BATCH, -1).T.contiguous()
    xb, xbt = big_frames(dev)

    def fwd():
        with torch.no_grad():
            return F.fused_model_forward(model, x)

    k4 = r"fused_unrolled_kernel<(true|1)"
    table = {"K4 [3n, l]": (lambda: F.fused_cv_forces(
                 model, xt, transposed_input=True), k4),
             "K4 [l, n, 3]": (lambda: F.fused_cv_forces(model, x), k4),
             "K1": (fwd, r"fused_unrolled_kernel<(false|0)"),
             "bench op 1M": (lambda: F.fused_cv_forces(
                 model, xbt, tile=2048, transposed_input=True), k4)}
    out = {"tag": tag, "mode": "knockouts" if group is None else "alternatives",
           "card": card(),
           "resources": {k: resources(v) for k, v in logs.items()}}
    half = ("half the warps",) if group is None else ()
    original = F._library
    try:
        for kind in (*kinds, *half, "base"):
            F._library = lambda lib=libs.get(kind, libs["base"]): lib
            F._STATICS.clear()  # tiles and grids are per build
            if kind in half:
                for fn, _ in table.values():
                    fn()  # each grid asked of the library once
                for st in F._STATICS.values():
                    st.grids = {k: (w, max(1, per_sm // 2), sms)
                                for k, (w, per_sm, sms) in st.grids.items()}
            row = {name: device_ms(fn, pat)[0]
                   for name, (fn, pat) in table.items()}
            out.setdefault(kind, []).append(row)
    finally:
        F._library = original
        F._STATICS.clear()
    print(json.dumps(out))


def frame_bytes(F, model, transposed, gx, floats):
    """Bytes a frame that the unrolled kernels' functions must move from
    and to device memory: of the frame the coordinates of the atoms that
    some feature or the alignment reads, gx over every atom where ``gx`` is
    formed, and ``floats`` more floats (y, gy or a target), each read or
    written once. On ``[3n, l]`` (``transposed``) a coordinate is a row of
    its own, and the rows of atoms nothing reads are skipped whole; on
    ``[l, 3n]`` a frame is one row, and what counts are the 32-byte sectors
    that hold a coordinate read, each once (on alanine every one: the four
    atoms nothing reads share their sectors with atoms read)."""
    spec, align_idx, _, _, _ = F._extract_model(model)
    atoms = {i for t in (*spec.angle_idx, *spec.bond_idx, *spec.dihedral_idx,
                         *spec.coord_pairs) for i in t}
    atoms |= set(spec.position_idx) | set(align_idx or ())
    read = [3 * a + c for a in atoms for c in range(3)]
    n = spec.n_input_atoms
    if transposed:
        x_bytes = 4 * len(read)
    else:  # rows of 12 n bytes repeat their sector offsets every `period`
        period = 32 // math.gcd(12 * n, 32)
        x_bytes = 32 * len({(12 * n * f + 4 * q) // 32 for f in range(period)
                            for q in read}) / period
    return x_bytes + 4 * (floats + (3 * n if gx else 0))


def big_frames(dev, l=BIG):
    """``(x [l, n, 3], xt [3n, l])``: alanine frames made on the card from
    a seeded generator, 0.05 of noise about the fixture frame."""
    from molann_tpu_torch.systems import alanine_universe

    u = alanine_universe()
    pos = torch.as_tensor(u.atoms.positions, dtype=torch.float32,
                          device=dev).reshape(-1, 1)
    gen = torch.Generator(device=dev).manual_seed(5)
    xt = pos + 0.05 * torch.randn(pos.shape[0], l, generator=gen, device=dev)
    return xt.T.contiguous().reshape(l, -1, 3), xt


def big_times(F, model, dev):
    """The bench op and the forward on ``BIG`` device-resident frames:
    ``{name: {alone, device, event, host share, frames/s, share of
    bound}}`` (frames/s and the share from the kernel alone)."""
    x, xt = big_frames(dev)

    def fwd():
        with torch.no_grad():
            return F.fused_model_forward(model, x)

    table = {
        "bench op K4 [3n, l] 1M": (
            lambda: F.fused_cv_forces(model, xt, tile=2048,
                                      transposed_input=True),
            r"fused_unrolled_kernel<(true|1)"),
        "K4 [l, n, 3] 1M": (lambda: F.fused_cv_forces(model, x),
                            r"fused_unrolled_kernel<(true|1)"),
        "K1 1M": (fwd, r"fused_unrolled_kernel<(false|0)"),
    }
    out = timed(table)
    for name, row in out.items():
        n_bytes = frame_bytes(F, model, "[3n, l]" in name, "K4" in name, 3)
        row["bytes a frame"] = n_bytes
        row["frames/s"] = BIG / (row["alone"] * 1e-3)
        row["share of bound"] = 1e3 * BIG * n_bytes / HBM_BYTES_PER_S \
            / row["alone"]
    return out


def occupancy(lib, F, model, dev, forces):
    """``(warps an SM, warps a block)`` of the forward (or cv+forces)
    kernel in ``lib``, from the wrapper's grid query
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    spec, align_idx, _, params, act = F._extract_model(model)
    st = F._statics(spec, align_idx, act, params, dev)
    warps, per_sm, _ = st.grid(lib, "cv_forces" if forces else "forward", dev)
    return warps * per_sm, warps


def phases(dev, tag):
    out = {"tag": tag, "mode": "phases", "card": card()}
    out.update(phase_table(dev))
    print(json.dumps(out))


def phase_table(dev):
    """Each step's share of K4's and K1's time, from a build with clock
    reads; the warps an SM holds; registers and stack of the package's own
    build (its ``-Xptxas -v`` log, where this process built it)."""
    from molann_tpu_torch.ops import _build
    from molann_tpu_torch.ops import fused as F

    F._library()
    with tempfile.TemporaryDirectory() as tmp:
        libs, _ = build_variants(("phases",), Path(tmp))
        names = json.loads((Path(tmp) / "phases" / "steps.json").read_text())
    lib = libs["phases"]
    model, x, _ = setup(dev)
    xt = x.reshape(BATCH, -1).T.contiguous()
    cycles = torch.zeros(64, dtype=torch.int64, device=dev)

    class ProbeIO(F.UnrIO):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.partials = cycles.data_ptr()

    def fwd():
        with torch.no_grad():
            return F.fused_model_forward(model, x)

    out = {"resources": {k: v for k, v in resources(
        _build.BUILD_INFO.get("log", "")).items() if "unrolled" in k}
        or "not in this process's build log (the library was cached)"}
    original = F._library
    try:
        F._library = lambda: lib
        F._STATICS.clear()  # tiles are per build
        for forces in (True, False):
            warps, wpb = occupancy(lib, F, model, dev, forces)
            out["K4" if forces else "K1"] = {"warps an SM": warps,
                                             "warps a block": wpb}
        with mock.patch.object(F, "UnrIO", ProbeIO):
            for kernel, fn in (
                    ("K4 [3n, l]", lambda: F.fused_cv_forces(
                        model, xt, transposed_input=True)),
                    ("K4 [l, n, 3]", lambda: F.fused_cv_forces(model, x)),
                    ("K1", fwd)):
                ms = cuda_ms(fn)
                cycles.zero_()
                fn()
                torch.cuda.synchronize()
                got = cycles.cpu().numpy().astype(np.float64)
                total = got.sum()
                out[kernel + " phases"] = {
                    "ms with the clock reads": ms,
                    **{name: got[k] / total * ms
                       for k, name in enumerate(names) if got[k]}}
    finally:
        F._library = original
        F._STATICS.clear()
    return out


def card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()


def host(dev, tag):
    import cProfile
    import io
    import pstats
    import time

    from molann_tpu_torch.ops import fused as F

    global BATCH
    BATCH = 256
    model, x, gy = setup(dev)
    table = calls(F, model, x, gy)
    out = {"tag": tag, "mode": "host", "frames": BATCH}
    for name, (fn, _) in table.items():
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        torch.cuda.synchronize()
        out[name + " us"] = (time.perf_counter() - t0) / 200 * 1e6
    for name in ("K2", "K3 [l, n, 3]"):
        prof = cProfile.Profile()
        prof.enable()
        for _ in range(200):
            table[name][0]()
        prof.disable()
        text = io.StringIO()
        pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(14)
        out[name + " profile"] = [ln.strip() for ln in text.getvalue().splitlines()
                                  if ln.strip()][-16:]
    print(json.dumps(out))


def tiles(dev, tag):
    from molann_tpu_torch.ops import fused as F

    model, x, gy = setup(dev)
    table = calls(F, model, x, gy)
    for fn, _ in table.values():
        fn()  # every kernel's tile chosen once, then overridden below
    out = {"tag": tag, "mode": "tiles",
           "chosen": {f"{k[0]}{' ref' if k[1] else ''}": v
                      for st in F._STATICS.values() for k, v in st.tiles.items()}}
    for frames in (128, 64, 32):
        for st in F._STATICS.values():
            for key in st.tiles:
                st.tiles[key] = frames
        try:
            out[frames] = {name: row["alone"] for name, row in
                           timed(table, events=False).items()}
        except RuntimeError as err:
            out[frames] = f"does not launch: {err}"
    print(json.dumps(out))


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("unrolled_probe: no CUDA card")
    dev = torch.device("cuda:0")
    modes = ("times", "suspects", "host", "tiles", "phases", "knockouts",
             "alternatives")
    mode = argv[0] if argv and argv[0] in modes else "times"
    tag = argv[-1] if argv and argv[-1] != mode else ""
    if mode != "times":
        {"suspects": suspects, "host": host, "tiles": tiles,
         "phases": phases, "knockouts": knockouts,
         "alternatives": lambda d, t: knockouts(d, t, ALTERNATIVES)}[mode](
            dev, tag)
        return
    from molann_tpu_torch.ops import _build
    from molann_tpu_torch.ops import fused as F

    model, x, gy = setup(dev)
    out = {"tag": tag, "mode": "times", "card": card()}
    out.update(timed(calls(F, model, x, gy)))
    out.update(big_times(F, model, dev))
    out["resources"] = resources(_build.BUILD_INFO.get("log", ""))
    print(json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main(sys.argv[1:])
