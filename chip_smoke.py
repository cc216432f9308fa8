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
   count over that run and the CUDA-event time of one 65536-frame batch;
6. training: (a) the backward kernel (autograd through
   ``fused_model_forward``, ``ref_x`` requiring grad) and (b) the train
   kernel (``train_ref`` False and True, ``[l, n, 3]`` and ``[3n, l]``,
   8192 and 8191 frames) against float64 plain versions, the steadier
   reference for sums over thousands of float32 terms; (c) two launches of
   each give the same bits; (d) ``fit(student, fused_mse_loss, ...)`` and
   ``make_fused_train_step`` on ``[3n, l]`` each take 40 Adam steps of
   65536 frames from a 262,144-frame ``.npy`` trajectory labelled by a
   teacher model, with the launch counts of each run, lower losses at the
   end, and a resume from the step-20 checkpoint that repeats steps 21-40
   bit for bit; (e) CUDA-event times of both kernels and their plain
   versions on 65536 frames, and training steps per second.

Tolerances: values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52); losses 1e-5 relative against float64
(the per-frame float32 values differ from float64 by up to ~2e-7).
Prints one JSON line describing the kernels, then as its last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
Imports no JAX. Usage: ``python3 chip_smoke.py``.
"""

import functools
import itertools
import json
import os
import shutil
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
TRAIN_FRAMES = 1 << 18
TRAIN_STEPS = 40
CKPT_EVERY = 20
VAL_TOL = 1e-5
GRAD_RTOL = 2e-4
LOSS_RTOL = 1e-5
GOLDEN = np.array([-1.0, 0.0, 1.5296831, -0.33281142], np.float32)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def grad_tol(g_ref):
    return GRAD_RTOL * max(1.0, float(g_ref.abs().max()))


def f64(parts):
    """The model's parts with float64 tensors, for a float64 plain version."""
    spec, align_idx, ref_x, params, act = parts
    return (spec, align_idx, ref_x.double(),
            tuple((w.double(), b.double()) for w, b in params), act)


def flat(gparams):
    return [t for wb in gparams for t in wb]


def worst(got, want, what):
    """Max abs error of each tensor against its reference; fails past
    2e-4·max(1, max|ref|)."""
    err = 0.0
    for g, r in zip(got, want):
        e = float((g.double() - r).abs().max())
        if not e <= grad_tol(r):
            fail(f"{what}: error {e} > {grad_tol(r)}")
        err = max(err, e)
    return err


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
        y = F.fused_model_forward(model, xin).detach()
        e = float((y - y_ref).abs().max())
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
        if launches != {"forward": n_batches, "cv_forces": n_batches,
                        "backward": 0, "train": 0}:
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

    # 6. training
    from molann_tpu_torch.train import (
        TrajectoryDataset,
        batch_iterator,
        fit,
        fused_mse_loss,
        make_fused_train_step,
        masked_optimizer,
        trainable_mask,
    )

    # (a) the backward kernel against backward_plain
    ref_x = parts[2].requires_grad_(True)
    gy = torch.as_tensor(np.random.default_rng(4).normal(
        size=(CHECK_FRAMES, 3)).astype(np.float32), device=dev)
    xg = x.clone().requires_grad_(True)
    y = F.fused_model_forward(model, xg)
    leaves = [xg, ref_x, *flat(parts[3])]
    got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, gy)
    ref_x.requires_grad_(False)
    gx_ref, gp_ref, gref_ref = F.backward_plain(*f64(parts), x.double(),
                                                gy.double())
    max_err["backward"] = worst(got, [gx_ref, gref_ref, *flat(gp_ref)],
                                "backward kernel vs plain")
    # (b) the train kernel against train_grads_plain
    yt = torch.as_tensor(np.random.default_rng(5).normal(
        size=(CHECK_FRAMES, 3)).astype(np.float32), device=dev)
    max_err["train"] = 0.0
    for l in (CHECK_FRAMES, CHECK_FRAMES - 1):
        for train_ref in (False, True):
            loss_ref, gp_ref, gref_ref = F.train_grads_plain(
                *f64(parts), x[:l].double(), yt[:l].double(), train_ref)
            for layout in ("[l, n, 3]", "[3n, l]"):
                if layout == "[3n, l]":
                    loss, grads = F.fused_train_grads(
                        model, x_t[:, :l].contiguous(), yt[:l].T.contiguous(),
                        transposed_input=True, train_ref=train_ref)
                else:
                    loss, grads = F.fused_train_grads(model, x[:l], yt[:l],
                                                      train_ref=train_ref)
                what = f"train kernel vs plain, {layout}, {l} frames, " \
                       f"train_ref={train_ref}"
                el = abs(float(loss) - float(loss_ref))
                if not el <= LOSS_RTOL * abs(float(loss_ref)):
                    fail(f"{what}: loss {float(loss)} vs {float(loss_ref)}")
                e = worst(list(grads.values()), [*flat(gp_ref), gref_ref],
                          what)
                max_err["train"] = max(max_err["train"], e, el)
    # (c) the sums over frames repeat bit for bit
    loss2, grads2 = F.fused_train_grads(model, x, yt, train_ref=True)
    loss3, grads3 = F.fused_train_grads(model, x, yt, train_ref=True)
    if not (all(torch.equal(a, b) for a, b in zip(got, again))
            and torch.equal(loss2, loss3)
            and all(torch.equal(grads2[k], grads3[k]) for k in grads2)):
        fail("two launches of the backward or train kernel differ")
    torch.cuda.synchronize()
    print(f"training kernels vs float64 plain on {CHECK_FRAMES} frames: max "
          f"abs err backward {max_err['backward']:.3g}, train "
          f"{max_err['train']:.3g}; repeated launches bit-identical")

    # (d) two trainers on a labelled trajectory, and a resume
    adam = functools.partial(torch.optim.Adam, lr=1e-3)

    def seeded(seed):
        return alanine_model(generator=torch.Generator().manual_seed(seed),
                             device=dev)[0]

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.npy")
        frames = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                           shape=(TRAIN_FRAMES, n, 3))
        labels = np.empty((TRAIN_FRAMES, 3), np.float32)
        teacher = seeded(1)
        rng = np.random.default_rng(6)
        for s in range(0, TRAIN_FRAMES, BATCH):
            frames[s:s + BATCH] = (u.atoms.positions[None] + 0.05 * rng.normal(
                size=(BATCH, n, 3))).astype(np.float32)
            with torch.no_grad():
                labels[s:s + BATCH] = F.fused_model_forward(
                    teacher, torch.as_tensor(frames[s:s + BATCH],
                                             device=dev)).cpu().numpy()
        frames.flush()
        del frames
        data = TrajectoryDataset(path)

        def batches():
            return ((xb, labels[idx]) for xb, idx in batch_iterator(
                data, BATCH, seed=0, return_indices=True))

        # one untimed step first, so that steps/s measures the loop and not
        # the process's first autograd and optimizer calls; its time is
        # printed beside it
        t0 = time.perf_counter()
        fit(seeded(0), fused_mse_loss, batches(), num_steps=1)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        ckpt = os.path.join(tmp, "ckpt")
        for k in F.KERNEL_LAUNCHES:
            F.KERNEL_LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(seeded(0), fused_mse_loss, batches(), num_steps=TRAIN_STEPS,
                  checkpoint_dir=ckpt, checkpoint_every=CKPT_EVERY)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        fit_launches = dict(F.KERNEL_LAUNCHES)
        if fit_launches != {"forward": TRAIN_STEPS, "cv_forces": 0,
                            "backward": TRAIN_STEPS, "train": 0}:
            fail(f"launch counts over fit: {fit_launches}")

        student = seeded(0)
        opt = masked_optimizer(adam, trainable_mask(student))(student)
        step = make_fused_train_step(transposed_input=True)
        fused_losses = []
        for k in F.KERNEL_LAUNCHES:
            F.KERNEL_LAUNCHES[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for xs, ys in itertools.islice(batches(), TRAIN_STEPS):
            xs = torch.as_tensor(xs, device=dev).reshape(BATCH, 3 * n)
            ys = torch.as_tensor(ys, device=dev)
            student, opt, loss = step(
                student, opt, (xs.T.contiguous(), ys.T.contiguous()))
            fused_losses.append(loss)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        fused_launches = dict(F.KERNEL_LAUNCHES)
        if fused_launches != {"forward": 0, "cv_forces": 0, "backward": 0,
                              "train": TRAIN_STEPS}:
            fail(f"launch counts over the fused trainer: {fused_launches}")
        fused_losses = [float(v) for v in fused_losses]
        for name, losses in (("fit", res.losses), ("fused", fused_losses)):
            if not (len(losses) == TRAIN_STEPS and np.isfinite(losses).all()
                    and losses[-1] < losses[0]):
                fail(f"{name} trainer did not lower the loss: {losses}")

        resume_dir = os.path.join(tmp, "resume")
        os.makedirs(resume_dir)
        for suffix in (".model.npz", ".opt.npz"):
            shutil.copy(os.path.join(ckpt, f"ckpt_{CKPT_EVERY:010d}{suffix}"),
                        resume_dir)
        resumed = fit(seeded(0), fused_mse_loss, batches(),
                      num_steps=TRAIN_STEPS, checkpoint_dir=resume_dir)
        same = resumed.losses == res.losses[CKPT_EVERY:] and all(
            torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                              res.model.parameters()))
        if not same:
            fail(f"resume from step {CKPT_EVERY} differs: {resumed.losses} "
                 f"vs {res.losses[CKPT_EVERY:]}")
    print(f"training: {TRAIN_STEPS} steps of {BATCH} frames from "
          f"{TRAIN_FRAMES} labelled frames; fit(fused_mse_loss) loss "
          f"{res.losses[0]:.6g} -> {res.losses[-1]:.6g}, "
          f"{TRAIN_STEPS / t_fit:.6g} steps/s (after a first step of "
          f"{t_warm:.4g} s), launches {fit_launches}; "
          f"make_fused_train_step [3n, l] loss {fused_losses[0]:.6g} -> "
          f"{fused_losses[-1]:.6g}, {TRAIN_STEPS / t_fused:.6g} steps/s, "
          f"launches {fused_launches}; resume from step {CKPT_EVERY} "
          "bit-identical")

    # (e) kernel times against the plain versions on one batch
    gyb = torch.as_tensor(np.random.default_rng(7).normal(
        size=(BATCH, 3)).astype(np.float32), device=dev)
    xg = xb.clone().requires_grad_(True)
    yk = F.fused_model_forward(model, xg)
    k_leaves = [xg, *flat(parts[3])]
    with torch.enable_grad():
        xp = xb.clone().requires_grad_(True)
        pp = tuple((w.detach().requires_grad_(True),
                    b.detach().requires_grad_(True)) for w, b in parts[3])
        yp = F.forward_plain(parts[0], parts[1], parts[2], pp, parts[4], xp)
    p_leaves = [xp, *flat(pp)]
    ms_k2, ms_p2 = alternate(
        lambda: torch.autograd.grad(yp, p_leaves, gyb, retain_graph=True),
        lambda: torch.autograd.grad(yk, k_leaves, gyb, retain_graph=True),
        5, 50)
    xbt = xb.reshape(BATCH, 3 * n).T.contiguous()
    ytb = gyb.T.contiguous()
    ms_k3, ms_p3 = alternate(
        lambda: F.train_grads_plain(*parts, xb, gyb),
        lambda: F.fused_train_grads(model, xbt, ytb, transposed_input=True),
        5, 50)
    ms_k3f = cuda_ms(lambda: F.fused_train_grads(model, xb, gyb), 50)
    print(f"one {BATCH}-frame batch on the card: backward kernel "
          f"{ms_k2:.4f} ms (plain backward {ms_p2:.4f} ms), train kernel "
          f"[3n, l] {ms_k3:.4f} ms, [l, n, 3] {ms_k3f:.4f} ms (plain "
          f"{ms_p3:.4f} ms); card: {card}")

    src = "molann_tpu_torch/csrc/fused_unrolled.cu"
    src_train = "molann_tpu_torch/csrc/fused_train.cu"
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
        {"name": "backward", "route": "cuda", "source": src_train,
         "replaces": "molann_tpu/ops/fused.py:586",
         "launches": fit_launches["backward"],
         "max_abs_err": max_err["backward"], "ms": ms_k2,
         "plain_ms": ms_p2},
        {"name": "train", "route": "cuda", "source": src_train,
         "replaces": "molann_tpu/ops/fused.py:900",
         "launches": fused_launches["train"],
         "max_abs_err": max_err["train"], "ms": ms_k3,
         "plain_ms": ms_p3},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
