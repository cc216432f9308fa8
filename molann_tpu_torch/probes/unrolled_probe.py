"""The unrolled kernels' times on the alanine model, on one CUDA card.

    python molann_tpu_torch/probes/unrolled_probe.py [times|suspects] [tag]

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

``host`` times the host's work alone: the same calls on a batch of 256
frames, whose kernels take a few microseconds, by the wall clock over 200
calls and one synchronise; and ``cProfile``'s heaviest functions of the
backward and train calls.

``tiles`` times each kernel alone with every block taking 128, 64 and 32
frames in turn (the tile the wrapper would choose is overridden); a tile
the tree's kernels cannot launch (more threads than their launch bounds)
is reported as such.

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
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import types
from pathlib import Path

import numpy as np
import torch

BATCH = 65536
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


def variant_sources(kind, dst):
    """Copy the tree's kernel sources into ``dst`` patched for ``kind``;
    returns the extra nvcc flags, or None where no patch applies."""
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
        if kind == "regcap64":
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
        out = {"tag": tag, "mode": "suspects",
               "card": subprocess.run(
                   ["nvidia-smi", "--query-gpu=name,power.limit",
                    "--format=csv,noheader"], capture_output=True,
                   text=True).stdout.strip()}
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
    modes = ("times", "suspects", "host", "tiles")
    mode = argv[0] if argv and argv[0] in modes else "times"
    tag = argv[-1] if argv and argv[-1] != mode else ""
    if mode != "times":
        {"suspects": suspects, "host": host, "tiles": tiles}[mode](dev, tag)
        return
    from molann_tpu_torch.ops import fused as F

    model, x, gy = setup(dev)
    out = {"tag": tag, "mode": "times"}
    out.update(timed(calls(F, model, x, gy)))
    print(json.dumps(out))


if __name__ == "__main__":
    sys.path.insert(0, os.getcwd())
    main(sys.argv[1:])
