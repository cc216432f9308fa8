#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Runs the port's serving path on the card and checks it, phase by phase:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from ``molann_tpu_torch/csrc/``;
3. goldens: the fixture frame through the forward kernel (FeatureLayer
   only) must give d1 = [-1, 0], b1 = 1.5296831, a1 = -0.33281142 (1e-6);
4. kernels vs plain: both kernels against their plain PyTorch versions on
   8192 alanine frames, components None and 0, layouts [l, n, 3] and
   [3n, l]; values within 1e-5, gradients within 2e-4·max(1, max|g|);
5. serving: 1,048,576 frames from a ``.npy`` file through
   ``serve.evaluate_trajectory`` with and without forces (16 batches of
   65536 each), checked on 4096 sampled rows, with each kernel's launch
   count over that run and the CUDA-event time of one 65536-frame batch.

Prints one JSON line describing the kernels, then as its last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
Imports no JAX. Usage: ``python3 chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

N_FRAMES = 1 << 20
BATCH = 65536
CHECK_FRAMES = 8192
SAMPLE_ROWS = 4096
VAL_TOL = 1e-5
GRAD_RTOL = 2e-4
GOLDEN = np.array([-1.0, 0.0, 1.5296831, -0.33281142], np.float32)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def grad_tol(g_ref):
    return GRAD_RTOL * max(1.0, float(g_ref.abs().max()))


def cuda_ms(fn, reps):
    """Mean CUDA-event time of one call of fn, after two warm-up calls."""
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


def alternate(plain_fn, kernel_fn, reps_plain, reps_kernel):
    """Times in turns (plain, kernel, kernel, plain); means of both turns."""
    p1 = cuda_ms(plain_fn, reps_plain)
    k1 = cuda_ms(kernel_fn, reps_kernel)
    k2 = cuda_ms(kernel_fn, reps_kernel)
    p2 = cuda_ms(plain_fn, reps_plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def main():
    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    print(f"device: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")

    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import FeatureLayer
    from molann_tpu_torch.ops import _build
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.systems import alanine_model, alanine_universe

    # 2. build
    t0 = time.perf_counter()
    F._library()  # builds, loads and checks the envelope/ABI of the kernels
    regs = [ln.split("info    :")[-1].strip() for ln in
            _build.BUILD_INFO["log"].splitlines() if "registers" in ln]
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.BUILD_INFO['seconds']:.1f} s) -> "
          f"{os.path.basename(_build.BUILD_INFO['path'])}; {regs}")

    # 3. goldens through the forward kernel
    u = alanine_universe()

    def group(*nums):
        ag = u.select_atoms(f"bynum {nums[0]}")
        for n in nums[1:]:
            ag = ag + u.select_atoms(f"bynum {n}")
        return ag

    flayer = FeatureLayer([Feature("d1", "dihedral", group(5, 7, 9, 15)),
                           Feature("b1", "bond", group(2, 5)),
                           Feature("a1", "angle", group(20, 19, 21))],
                          u.atoms)
    x0 = torch.as_tensor(u.atoms.positions[None], dtype=torch.float32,
                         device=dev)
    got = F.fused_model_forward(flayer, x0).cpu().numpy()[0]
    err = float(np.abs(got - GOLDEN).max())
    if not err <= 1e-6:
        fail(f"goldens through the forward kernel: {got} vs {GOLDEN}")
    print(f"goldens: d1, b1, a1 = {got.tolist()} (max err {err:.3g})")

    # 4. kernels vs their plain versions
    model, u = alanine_model(generator=torch.Generator().manual_seed(0),
                             device=dev)
    parts = F._extract_model(model)
    n = u.atoms.n_atoms
    rng = np.random.default_rng(0)
    x = torch.as_tensor(
        (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(CHECK_FRAMES, n, 3))).astype(np.float32),
        device=dev)
    x_t = x.reshape(CHECK_FRAMES, 3 * n).T.contiguous()
    max_err = {"forward": 0.0, "cv_forces": 0.0}
    y_ref = F.forward_plain(*parts, x).detach()
    for xin in (x, x.reshape(CHECK_FRAMES, 3 * n)):
        e = float((F.fused_model_forward(model, xin) - y_ref).abs().max())
        if not e <= VAL_TOL:
            fail(f"forward kernel vs plain on {tuple(xin.shape)}: {e}")
        max_err["forward"] = max(max_err["forward"], e)
    for comp in (None, 0):
        y_ref, g_ref = F.cv_forces_plain(*parts, x, comp)
        y, g = F.fused_cv_forces(model, x, component=comp)
        yt, gt = F.fused_cv_forces(model, x_t, component=comp,
                                   transposed_input=True)
        for name, yy, gg in (("[l, n, 3]", y, g),
                             ("[3n, l]", yt.T, gt.T.reshape(-1, n, 3))):
            ev = float((yy - y_ref).abs().max())
            eg = float((gg - g_ref).abs().max())
            if not (ev <= VAL_TOL and eg <= grad_tol(g_ref)):
                fail(f"cv+forces kernel vs plain, {name}, component={comp}: "
                     f"values {ev}, gradients {eg}")
            max_err["cv_forces"] = max(max_err["cv_forces"], ev, eg)
    torch.cuda.synchronize()
    print(f"kernels vs plain on {CHECK_FRAMES} frames: max abs err "
          f"forward {max_err['forward']:.3g}, cv_forces "
          f"{max_err['cv_forces']:.3g}")

    # 5. serving from a .npy trajectory
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traj.npy")
        frames = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                           shape=(N_FRAMES, n, 3))
        rng = np.random.default_rng(1)
        for s in range(0, N_FRAMES, BATCH):
            frames[s:s + BATCH] = (u.atoms.positions[None] + 0.05 * rng.normal(
                size=(BATCH, n, 3))).astype(np.float32)
        frames.flush()
        del frames

        for k in F.KERNEL_LAUNCHES:
            F.KERNEL_LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cvs, grads = evaluate_trajectory(model, path, device=dev, forces=True,
                                         batch_size=BATCH)
        t_forces = time.perf_counter() - t0
        t0 = time.perf_counter()
        cvs_only = evaluate_trajectory(model, path, device=dev, forces=False,
                                       batch_size=BATCH)
        t_values = time.perf_counter() - t0
        launches = dict(F.KERNEL_LAUNCHES)
        n_batches = N_FRAMES // BATCH
        if launches != {"forward": n_batches, "cv_forces": n_batches}:
            fail(f"launch counts over the serving run: {launches}, expected "
                 f"{n_batches} of each")
        if not (np.isfinite(cvs).all() and np.isfinite(grads).all()
                and np.isfinite(cvs_only).all()):
            fail("non-finite serving outputs")
        if cvs.shape != (N_FRAMES, 3) or grads.shape != (N_FRAMES, n, 3):
            fail(f"serving output shapes {cvs.shape}, {grads.shape}")

        rows = np.sort(np.random.default_rng(2).choice(
            N_FRAMES, SAMPLE_ROWS, replace=False))
        xs = torch.as_tensor(np.load(path, mmap_mode="r")[rows], device=dev)
        y_ref, g_ref = F.cv_forces_plain(*parts, xs)
        ev = max(float(np.abs(cvs[rows] - y_ref.cpu().numpy()).max()),
                 float(np.abs(cvs_only[rows] - y_ref.cpu().numpy()).max()))
        eg = float(np.abs(grads[rows] - g_ref.cpu().numpy()).max())
        if not (ev <= VAL_TOL and eg <= grad_tol(g_ref)):
            fail(f"served rows vs plain: values {ev}, gradients {eg}")

    xb = torch.as_tensor(
        (u.atoms.positions[None] + 0.05 * np.random.default_rng(3).normal(
            size=(BATCH, n, 3))).astype(np.float32), device=dev)
    ms_k4, ms_p4 = alternate(lambda: F.cv_forces_plain(*parts, xb),
                             lambda: F.fused_cv_forces(model, xb), 5, 50)
    with torch.no_grad():
        ms_k1, ms_p1 = alternate(lambda: F.forward_plain(*parts, xb),
                                 lambda: F.fused_model_forward(model, xb),
                                 5, 50)
    print(f"serving: {N_FRAMES} frames in {n_batches} batches of {BATCH}: "
          f"cv+forces {N_FRAMES / t_forces:.6g} frames/s, values only "
          f"{N_FRAMES / t_values:.6g} frames/s end to end; sampled rows max "
          f"err values {ev:.3g}, gradients {eg:.3g}; one {BATCH}-frame batch "
          f"on the card: cv_forces kernel {ms_k4:.4f} ms (plain "
          f"{ms_p4:.4f} ms), forward kernel {ms_k1:.4f} ms (plain "
          f"{ms_p1:.4f} ms); card: {card}")

    src = "molann_tpu_torch/csrc/fused_unrolled.cu"
    print(json.dumps({"kernels": [
        {"name": "cv_forces", "route": "cuda", "source": src,
         "replaces": "molann_tpu/ops/fused.py:1116",
         "launches": launches["cv_forces"],
         "max_abs_err": max_err["cv_forces"], "ms": ms_k4,
         "plain_ms": ms_p4},
        {"name": "forward", "route": "cuda", "source": src,
         "replaces": "molann_tpu/ops/fused.py:578",
         "launches": launches["forward"],
         "max_abs_err": max_err["forward"], "ms": ms_k1,
         "plain_ms": ms_p1},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
