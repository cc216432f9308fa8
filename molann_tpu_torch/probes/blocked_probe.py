"""Where the blocked kernels' time goes, measured on one CUDA card.

    python -m molann_tpu_torch.probes.blocked_probe [phases] [tiles] [scaling] [grads]

With no argument the first three parts run (about two minutes on an H100,
most of it ``nvcc``). Every time is the mean CUDA-event time of one call after
two warm-up calls, on ``peptide_model(60)`` and ``lj_fluid_model(5)`` with
weights from seed 0 and frames from seed 2.

- ``phases``: the kernels cut short after each phase (a copy of
  ``csrc/`` with ``blk_n_phases`` patched is built for every cut), 65,536
  peptide frames: what each phase adds.
- ``tiles``: both kernels at 32, 16, 8 and 4 frames a block against the
  tile ``choose_frames`` picks, and ``[l, n, 3]`` against ``[3, n, l]``.
- ``scaling``: both kernels at 1,024 to 262,144 frames, the wall time of a
  wrapper call on 8 frames, ``x.sum()`` and ``x.clone()`` on the peptide
  batch as yardsticks of reading and of reading and writing 236 MB, and
  ``torch.profiler``'s kernel times by name.
- ``grads`` (only when named): the backward (K7, as ``torch.autograd.grad``
  through a retained graph) and train (K5) kernels on 65,536 frames of both
  models, as built and with the 64-register variant for models that fit
  four blocks on an SM taken out (a patched copy of ``csrc/``), in turns.

A development script: nothing in the package imports it. It rebuilds the
kernels from patched copies of ``csrc/`` and forces tiles by patching
``_build.SRC_DIR`` / ``_build._lib`` and ``fused_blocked.choose_frames``
for the duration of a measurement, as a test would.
"""

import contextlib
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from ..ops import _build
from ..ops import fused as F
from ..ops import fused_blocked as FB
from ..systems import lj_fluid_model, peptide_model

BATCH = 65536
PHASES = ["LOAD", "FEAT", "REDUCE", "QCP", "POS", "MLP0", "MLP1", "OUT",
          "BWD1", "BWD0", "GR", "GH", "GC", "GATHER"]
N_PHASES = "return forces ? 10 + 2 * m.n_layers : 6 + m.n_layers;"


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


def k6_k8(model, x):
    with torch.no_grad():
        t6 = cuda_ms(lambda: F.fused_model_forward(model, x))
    return t6, cuda_ms(lambda: F.fused_cv_forces(model, x))


def phases(peptide, xp):
    """Cut the kernels short after n phases, for the n that end a group."""
    src_dir = _build.SRC_DIR
    text = (src_dir / "blocked_math.cuh").read_text()
    if N_PHASES not in text:
        raise SystemExit("blk_n_phases no longer reads as this probe expects")
    prev6 = prev8 = 0.0
    with tempfile.TemporaryDirectory() as tmp:
        for n in (1, 2, 6, 8, 10, 13, 14):
            cut = Path(tmp) / f"csrc_{n}"
            shutil.copytree(src_dir, cut)
            (cut / "blocked_math.cuh").write_text(text.replace(
                N_PHASES, f"return forces ? {n} : {min(n, 8)};"))
            with mock.patch.multiple(_build, SRC_DIR=cut, _lib=None):
                t6, t8 = k6_k8(peptide, xp)
            print(f"phases: up to {PHASES[n - 1]} ({n}): K6 {t6:.4f} ms "
                  f"(+{t6 - prev6:.4f}), K8 {t8:.4f} ms "
                  f"(+{t8 - prev8:.4f})", flush=True)
            prev6, prev8 = t6, t8


FOUR_BLOCKS = "return smem <= 56 * 1024 ?"


def grads(models):
    """K7 and K5 as built, and without the four-blocks-an-SM variant."""
    src_dir = _build.SRC_DIR
    text = (src_dir / "fused_blocked.cu").read_text()
    if FOUR_BLOCKS not in text:
        raise SystemExit("launch_grads no longer reads as this probe expects")
    with tempfile.TemporaryDirectory() as tmp:
        cut = Path(tmp) / "csrc_two_blocks"
        shutil.copytree(src_dir, cut)
        (cut / "fused_blocked.cu").write_text(
            text.replace(FOUR_BLOCKS, "return false ?"))
        for tag, src in (("as built", src_dir), ("two blocks", cut),
                         ("two blocks", cut), ("as built", src_dir)):
            with mock.patch.multiple(_build, SRC_DIR=src, _lib=None):
                for name, (model, x) in models.items():
                    spec, _, _, params, _ = F._extract_model(model)
                    d = F._out_dim(spec, params)
                    gy = torch.as_tensor(np.random.default_rng(17).normal(
                        size=(x.shape[0], d)).astype(np.float32),
                        device=x.device)
                    xg = x.clone().requires_grad_(True)
                    yk = F.fused_model_forward(model, xg)
                    leaves = [xg, *model.parameters()]
                    t7 = cuda_ms(lambda: torch.autograd.grad(
                        yk, leaves, gy, retain_graph=True))
                    t5 = cuda_ms(lambda: F.fused_train_grads(model, x, gy))
                    print(f"grads: {name}, {tag}: K7 {t7:.4f} ms, K5 "
                          f"{t5:.4f} ms", flush=True)


def tiles(models):
    for n_frames in (None, 32, 16, 8, 4):
        forced = (mock.patch.object(
            FB, "choose_frames", lambda smem, l=None, fr=n_frames: fr)
            if n_frames is not None else contextlib.nullcontext())
        with forced:
            for name, (model, x) in models.items():
                t6, t8 = k6_k8(model, x)
                xc = x.permute(2, 1, 0).contiguous()
                t8c = cuda_ms(lambda: F.fused_cv_forces(model, xc))
                print(f"tiles: {name}, frames a block "
                      f"{n_frames or 'as chosen'}: K6 {t6:.4f} ms, K8 "
                      f"[l, n, 3] {t8:.4f} ms, K8 [3, n, l] {t8c:.4f} ms",
                      flush=True)


def scaling(models, dev):
    from torch.profiler import ProfilerActivity, profile

    for name, (model, x) in models.items():
        u_frames = x
        for l in (1024, 16384, 65536, 262144):
            reps = -(-l // x.shape[0])
            xl = u_frames.repeat(reps, 1, 1)[:l].contiguous()
            t6, t8 = k6_k8(model, xl)
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


def main(argv):
    parts = argv or ["phases", "tiles", "scaling"]
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
    print("registers of fused_blocked.cu: " + ("; ".join(
        ln.split("info    :")[-1].strip()
        for ln in log.split("== ")[1].splitlines() if "registers" in ln)
        if log else "not rebuilt in this run"))
    if "phases" in parts:
        phases(*models["peptide_model(60)"])
    if "tiles" in parts:
        tiles(models)
    if "scaling" in parts:
        scaling(models, dev)
    if "grads" in parts:
        grads(models)


if __name__ == "__main__":
    main(sys.argv[1:])
