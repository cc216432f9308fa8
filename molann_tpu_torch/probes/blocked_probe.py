"""Where the blocked kernels' time goes, measured on one CUDA card.

    python -m molann_tpu_torch.probes.blocked_probe [phases] [tiles] [scaling]
    python molann_tpu_torch/probes/blocked_probe.py grads [aligned] [tag]
    python molann_tpu_torch/probes/blocked_probe.py sass

With no argument the first three parts run (about three minutes on an H100,
two builds of the kernels among them). Every time is the mean CUDA-event
time of one call after two warm-up calls, on ``peptide_model(60)`` and
``lj_fluid_model(5)`` with weights from seed 0 and 65,536 frames from seed 2.

- ``phases``: the four kernels (K6 forward, K8 cv+forces, K7 backward as
  ``torch.autograd.grad`` through a retained graph, with gx and the
  parameter sums and with the sums alone, K5 train with a frozen reference)
  by step of a tile, on both models. A copy of ``csrc/`` is built in which
  thread 0 of every block reads the SM's clock after each step's barrier
  and adds the cycles since the last to a counter of the step's kind: each
  step's share of the blocks' cycles, and that share of the kernel's time.
  Barrier waits count for the step they end.
- ``tiles``: the four kernels at 32, 16, 8 and 4 frames a block against the
  tile ``choose_frames`` picks, and K8 on ``[l, n, 3]`` against ``[3, n, l]``.
- ``scaling``: K6 and K8 at 1,024 to 262,144 frames, the wall time of a
  wrapper call on 8 frames, ``x.sum()`` and ``x.clone()`` on the peptide
  batch as yardsticks of reading and of reading and writing 236 MB, and
  ``torch.profiler``'s kernel times by name.
- ``grads`` (only when named): one JSON line with the times of K7 (with gx,
  and the parameter sums alone), K5, K6 and K8 on both models, each kernel's
  own time by name from ``torch.profiler``, and the seconds ``nvcc`` took.
  Run as a file, this part imports ``molann_tpu_torch`` from the current
  directory, not from beside itself, and calls only the package's public
  functions. So two commits compare in one call on one card: unpack the
  other commit into a directory git ignores (``git archive``), and run this
  same file from both roots in turns (parent, change, change, parent), with a
  tag to tell the lines apart.

- ``aligned`` (only when named): K6 and K8 with alignment (alanine through
  ``mode="blocked"``, and alanine with a ``[38, 65, 3]`` head under
  ``"auto"``), alone by ``torch.profiler``, one JSON line; runs as a file
  from any tree's root, as ``grads`` does.
- ``sass``: the pair loops under a box of every blocked kernel, from
  ``cuobjdump -sass`` of the built library: instructions a loop turn, pairs
  a turn, instructions a pair, the opcodes of the first such loop; and any
  device function left as a call.

A development script: nothing in the package imports it. ``phases`` rebuilds
the kernels from a patched copy of ``csrc/`` and ``tiles`` forces tiles by
patching ``_build.SRC_DIR`` / ``_build._lib`` and
``fused_blocked.choose_frames`` for the duration of a measurement, as a test
would.
"""

import contextlib
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

BATCH = 65536
def cuda_ms(fn, reps=10):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def frames(u, l, sigma, dev, chunk=16384):
    rng = np.random.default_rng(2)
    n = u.atoms.n_atoms
    return torch.cat([torch.as_tensor(
        (u.atoms.positions[None] + sigma * rng.normal(
            size=(min(chunk, l - s), n, 3))).astype(np.float32), device=dev)
        for s in range(0, l, chunk)])


def k6_k8(F, model, x):
    with torch.no_grad():
        t6 = cuda_ms(lambda: F.fused_model_forward(model, x))
    return t6, cuda_ms(lambda: F.fused_cv_forces(model, x))


def k7_k5(F, model, x, with_params_only=False):
    """K7 as ``torch.autograd.grad`` through a retained graph (gx and the
    parameter sums; with ``with_params_only`` also the sums alone) and K5
    with a frozen reference."""
    spec, _, _, params, _ = F._extract_model(model)
    gy = torch.as_tensor(np.random.default_rng(17).normal(
        size=(x.shape[0], F._out_dim(spec, params))).astype(np.float32),
        device=x.device)
    xg = x.clone().requires_grad_(True)
    yk = F.fused_model_forward(model, xg)
    leaves = [xg, *model.parameters()]
    out = [cuda_ms(lambda: torch.autograd.grad(yk, leaves, gy,
                                               retain_graph=True))]
    if with_params_only:  # a graph in which x asks for no gradient
        yp = F.fused_model_forward(model, x)
        out.append(cuda_ms(lambda: torch.autograd.grad(
            yp, leaves[1:], gy, retain_graph=True)))
    out.append(cuda_ms(lambda: F.fused_train_grads(model, x, gy)))
    return out


STEP_KINDS = ["LOAD", "FEAT", "REDUCE", "QCP", "POS", "MLP", "MLP_SUM", "OUT",
              "SEED", "PGRAD", "BWD", "GR", "GH", "GREF", "GC", "SCATTER",
              "GATHER", "PAIRS"]
# What the instrumented copy patches: the call's struct gets a pointer to the
# counters, the clock is read where the step loop starts and after each
# step's barrier, and once more after the block has stored its sums.
IO_END = ("  float* partials;  // [blocks, 1 + G] per-block sums, then "
          "reduced by column\n};")
# (the first form is the step list's since the head's depth sized it)
LOOP_STARTS = ("  const int n_steps = steps[0];\n",
               "  const int n_steps = steps[MOLANN_BLK_MAX_STEPS - 1];\n")
STEP_END = "__syncthreads();  // the step's barrier\n"
CLOCK = ("if (threadIdx.x == 0) { const long long t1 = clock64(); atomicAdd("
         "io.probe + st.kind * 4 + ((st.kind == BLK_SCATTER || st.kind > "
         "BLK_GATHER) ? 0 : st.arg < 3 "
         "? st.arg : 3), (unsigned long long)(t1 - t0)); t0 = t1; }\n")
GRADS_END = "  blk_grad_end(m, io, acc, rect, row, tid, nt);\n"
KERNEL_FILES = ("fused_blocked.cu", "fused_blocked_grads.cu")


def phases(F, FB, _build, models, kernels=("K6", "K8", "K7", "K7 without gx",
                                           "K5")):
    """Each step's share of the blocks' cycles, from one instrumented build,
    for the ``kernels`` named."""
    import ctypes

    src_dir = _build.SRC_DIR
    texts = {n: (src_dir / n).read_text()
             for n in ("blocked_math.cuh", *KERNEL_FILES)}
    loop_start = next(n for n in LOOP_STARTS
                      if n in texts["fused_blocked.cu"])
    for name, needle in (("blocked_math.cuh", IO_END),
                         *((n, loop_start) for n in KERNEL_FILES),
                         *((n, STEP_END) for n in KERNEL_FILES),
                         ("fused_blocked_grads.cu", GRADS_END)):
        if texts[name].count(needle) != 1:
            raise SystemExit(f"{name} no longer reads as this probe expects: "
                             f"{needle!r}")
    dev = next(iter(models.values()))[1].device
    cycles = torch.zeros(128, dtype=torch.int64, device=dev)

    class ProbeIO(ctypes.Structure):
        _fields_ = [*FB.BlockedIO._fields_, ("probe", ctypes.c_void_p)]

        def __init__(self):
            super().__init__()
            self.probe = cycles.data_ptr()

    with tempfile.TemporaryDirectory() as tmp:
        cut = Path(tmp) / "csrc_timed"
        shutil.copytree(src_dir, cut)
        (cut / "blocked_math.cuh").write_text(
            texts["blocked_math.cuh"].replace(
                IO_END, IO_END[:-2] + "  unsigned long long* probe;\n};"))
        for name in KERNEL_FILES:
            (cut / name).write_text(
                texts[name].replace(
                    loop_start, loop_start + "  long long t0 = clock64();\n")
                .replace(STEP_END, STEP_END + CLOCK)
                .replace(GRADS_END, GRADS_END + "  if (threadIdx.x == 0) "
                         "atomicAdd(io.probe + 127, (unsigned long long)("
                         "clock64() - t0));\n"))
        with mock.patch.multiple(_build, SRC_DIR=cut, _lib=None), \
                mock.patch.object(F, "_LIB", None), \
                mock.patch.object(FB, "BlockedIO", ProbeIO):
            for name, (model, x) in models.items():
                spec, _, _, params, _ = F._extract_model(model)
                gy = torch.as_tensor(np.random.default_rng(17).normal(size=(
                    x.shape[0], F._out_dim(spec, params))).astype(np.float32),
                    device=dev)
                graphs = {}

                def graph(with_gx):  # K7's forward, run once
                    if with_gx not in graphs:
                        xg = x.clone().requires_grad_(with_gx)
                        leaves = [xg, *model.parameters()]
                        graphs[with_gx] = (F.fused_model_forward(model, xg),
                                           leaves if with_gx else leaves[1:])
                    return graphs[with_gx]

                def k6():
                    with torch.no_grad():
                        F.fused_model_forward(model, x)

                def k7(with_gx):
                    y, leaves = graph(with_gx)
                    return torch.autograd.grad(y, leaves, gy,
                                               retain_graph=True)

                for kernel, fn in (
                        ("K6", k6),
                        ("K8", lambda: F.fused_cv_forces(model, x)),
                        ("K7", lambda: k7(True)),
                        ("K7 without gx", lambda: k7(False)),
                        ("K5", lambda: F.fused_train_grads(model, x, gy))):
                    if kernel not in kernels:
                        continue
                    ms = cuda_ms(fn)
                    cycles.zero_()
                    fn()
                    torch.cuda.synchronize()
                    got = cycles.cpu().numpy().astype(np.float64)
                    total = got.sum()
                    rows = []
                    for k, kind in enumerate(STEP_KINDS):
                        for arg in range(4):
                            c = got[4 * k + arg]
                            if c:
                                label = kind + (str(arg) if kind in (
                                    "MLP", "MLP_SUM", "PGRAD", "BWD") else "")
                                rows.append(f"{label} {c / total * ms:.4f}")
                    if got[127]:
                        rows.append(f"sums out {got[127] / total * ms:.4f}")
                    print(f"phases: {name}, {kernel} {ms:.4f} ms (with the "
                          f"clock reads), by step, ms: " + ", ".join(rows),
                          flush=True)


def tiles(F, FB, models):
    for n_frames in (None, 32, 16, 8, 4):
        forced = (mock.patch.object(
            FB, "choose_frames", lambda smem, l=None, backward=False,
            pairs=False, fr=n_frames: fr)
            if n_frames is not None else contextlib.nullcontext())
        with forced:
            for name, (model, x) in models.items():
                try:
                    t6, t8 = k6_k8(F, model, x)
                    xc = x.permute(2, 1, 0).contiguous()
                    t8c = cuda_ms(lambda: F.fused_cv_forces(model, xc))
                    t7, t5 = k7_k5(F, model, x)
                except RuntimeError as e:  # a tile past 227 KB is refused
                    print(f"tiles: {name}, frames a block {n_frames}: {e}")
                    continue
                print(f"tiles: {name}, frames a block "
                      f"{n_frames or 'as chosen'}: K6 {t6:.4f} ms, K8 "
                      f"[l, n, 3] {t8:.4f} ms, K8 [3, n, l] {t8c:.4f} ms, "
                      f"K7 {t7:.4f} ms, K5 {t5:.4f} ms", flush=True)


def scaling(F, models):
    from torch.profiler import ProfilerActivity, profile

    for name, (model, x) in models.items():
        u_frames = x
        for l in (1024, 16384, 65536, 262144):
            reps = -(-l // x.shape[0])
            xl = u_frames.repeat(reps, 1, 1)[:l].contiguous()
            t6, t8 = k6_k8(F, model, xl)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(20):
                with torch.no_grad():
                    F.fused_model_forward(model, xl[:8])
            torch.cuda.synchronize()
            host = (time.perf_counter() - t0) / 20 * 1e3
            print(f"scaling: {name}, {l} frames: K6 {t6:.4f} ms, K8 "
                  f"{t8:.4f} ms; a wrapper call on 8 frames {host:.4f} ms "
                  f"wall", flush=True)
            del xl
    model, x = models["peptide_model(60)"]
    print(f"scaling: x.sum() on the peptide batch {cuda_ms(x.sum):.4f} ms, "
          f"x.clone() {cuda_ms(x.clone):.4f} ms")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with torch.no_grad():
                F.fused_model_forward(model, x)
            F.fused_cv_forces(model, x)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=4,
                                    max_name_column_width=70))


def cuobjdump_path():
    """``cuobjdump`` beside the ``nvcc`` the kernels were built with."""
    from molann_tpu_torch.ops import _build

    path = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not path.exists():
        raise SystemExit(f"blocked_probe: no cuobjdump at {path}")
    return path


SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def sass_pair_loops(lib_path):
    """The pair loops under a box of every blocked kernel in the built
    library, from ``cuobjdump -sass``: ``{kernel: [(instructions, pairs,
    {opcode: count}), ...]}``. Such a loop is a backward branch whose body
    holds ``FRND`` (three per pair evaluation: the minimum image) and no
    smaller such loop; ``pairs`` is a third of its ``FRND``, so instructions
    / pairs is what one pair evaluation under a box costs as compiled (the
    contact model's two features both have a box)."""
    text = subprocess.run([str(cuobjdump_path()), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for chunk in re.split(r"\n\s*Function : ", text)[1:]:
        name = chunk.split("\n", 1)[0].strip()
        kernel = re.search(r"blocked(_grads)?_kernel", name)
        if not kernel:
            continue
        args = re.search(r"I((?:L[bi]\d+E)+)E", name)
        label = kernel.group(0) + (
            "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1))) + ">"
            if args else "")
        ins = [(int(a, 16), op) for a, op in SASS_LINE.findall(chunk)]
        loops = []
        for i, (addr, op) in enumerate(ins):
            m = re.search(r"\bBRA\b.*?0x([0-9a-f]+)", op)
            if not m or int(m.group(1), 16) >= addr:
                continue
            body = [o for a, o in ins[:i + 1] if a >= int(m.group(1), 16)]
            frnd = sum(o.split()[0].startswith("FRND") for o in body
                       if o.split())
            if frnd >= 3:
                ops = {}
                for o in body:
                    op = o.split()[0] if not o.startswith("@") else \
                        o.split()[1]
                    ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
                loops.append((int(m.group(1), 16), addr, len(body),
                              frnd // 3, ops))
        inner = [lp for lp in loops if not any(
            o is not lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops)]
        if inner:
            out.setdefault(label, []).extend(
                (n, p, ops) for _, _, n, p, ops in inner)
    return out


def sass(_build, FB):
    """Print the instructions of each pair loop of the blocked kernels."""
    FB._library()
    loops = sass_pair_loops(_build.BUILD_INFO["path"])
    text = subprocess.run([str(cuobjdump_path()), "-sass",
                           _build.BUILD_INFO["path"]], capture_output=True,
                          text=True, check=True).stdout
    calls = sorted({m for m in re.findall(r"Function : (\S+)", text)
                    if "kernel" not in m and "reduce" not in m})
    print(f"sass: device functions that are not kernels (called, not "
          f"inlined): {calls or 'none'}", flush=True)
    for kernel, found in sorted(loops.items()):
        print(f"sass: {kernel}: pair loops under a box (instructions, pairs "
              f"per iteration, instructions a pair): " + ", ".join(
                  f"({n}, {p}, {n / p:.1f})" for n, p, _ in found)
              + "; opcodes of the first: " + ", ".join(
                  f"{k} {v}" for k, v in sorted(
                      found[0][2].items(), key=lambda kv: -kv[1])),
              flush=True)
    return loops


def aligned(F, dev, tag, card):
    """One JSON line: K8 and K6 with alignment, on ``alanine_model()``
    through ``mode="blocked"`` and on alanine with a ``[38, 65, 3]`` head
    under ``"auto"``, 65,536 frames, each kernel alone by name from
    ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from molann_tpu_torch.systems import alanine_model

    out = {"tag": tag, "card": card}
    for name, dims, mode in (("alanine, mode='blocked'", (5, 3), "blocked"),
                             ("alanine [38, 65, 3], auto", (65, 3), "auto")):
        model, u = alanine_model(hidden_dims=dims, device=dev,
                                 generator=torch.Generator().manual_seed(0))
        x = frames(u, BATCH, 0.05, dev)

        def calls():
            with torch.no_grad():
                F.fused_model_forward(model, x, mode=mode)
            F.fused_cv_forces(model, x, mode=mode)

        for _ in range(3):
            calls()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                calls()
            torch.cuda.synchronize()
        out[name] = {}
        for event in prof.key_averages():
            kernel = re.search(r"blocked_kernel<[^>]*>", event.key)
            if kernel:
                total = getattr(event, "device_time_total", None)
                if total is None:
                    total = event.cuda_time_total
                out[name][kernel.group(0) + " alone ms"] = \
                    total / event.count / 1e3
    print(json.dumps(out), flush=True)


def grads(F, _build, models, tag, card):
    """One JSON line: the kernels' times on both models, by CUDA events with
    their wrappers and alone by name from ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    out = {"tag": tag, "card": card, "nvcc_s": _build.BUILD_INFO["seconds"]}
    for name, (model, x) in models.items():
        t7, t7p, t5 = k7_k5(F, model, x, with_params_only=True)
        t6, t8 = k6_k8(F, model, x)
        out[name] = {"K7 ms": t7, "K7 without gx ms": t7p, "K5 ms": t5,
                     "K6 ms": t6, "K8 ms": t8}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            k7_k5(F, model, x, with_params_only=True)
            k6_k8(F, model, x)
            torch.cuda.synchronize()
        for event in prof.key_averages():
            kernel = re.search(r"blocked(_grads)?_kernel<[^>]*>", event.key)
            if kernel:
                total = getattr(event, "device_time_total", None)
                if total is None:
                    total = event.cuda_time_total
                out[name][kernel.group(0) + " alone ms"] = \
                    total / event.count / 1e3
    print(json.dumps(out), flush=True)


def main(argv):
    from molann_tpu_torch.ops import _build
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.systems import lj_fluid_model, peptide_model

    parts = [a for a in argv if a in ("phases", "tiles", "scaling", "grads",
                                      "sass", "aligned")]
    tag = next((a for a in argv if a not in parts), "")
    parts = parts or ["phases", "tiles", "scaling"]
    if not torch.cuda.is_available():
        raise SystemExit("blocked_probe: no CUDA card")
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    seed = torch.Generator().manual_seed(0)
    peptide, pu = peptide_model(60, generator=seed, device=dev)
    fluid, fu, _ = lj_fluid_model(5, generator=seed, device=dev)
    models = {"peptide_model(60)": (peptide, frames(pu, BATCH, 0.05, dev)),
              "lj_fluid_model(5)": (fluid, frames(fu, BATCH, 0.5, dev))}
    FB._library()
    log = _build.BUILD_INFO["log"]  # empty when the library was built before
    print("registers of the blocked kernels: " + ("; ".join(
        ln.split("info    :")[-1].strip()
        for section in log.split("== ")[1:]
        if section.startswith("fused_blocked")
        for ln in section.splitlines()
        if "registers" in ln or "spill" in ln)
        if log else "not rebuilt in this run"))
    if "sass" in parts:
        sass(_build, FB)
    if "phases" in parts:
        phases(F, FB, _build, models)
    if "tiles" in parts:
        tiles(F, FB, models)
    if "scaling" in parts:
        scaling(F, models)
    if "grads" in parts:
        grads(F, _build, models, tag, card)
    if "aligned" in parts:
        aligned(F, dev, tag, card)


if __name__ == "__main__":
    if not __package__:
        sys.path.insert(0, ".")
    main(sys.argv[1:])
