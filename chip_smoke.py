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
   versions on 65536 frames, and training steps per second; each unrolled
   kernel's time alone (``torch.profiler``) beside its event time with the
   wrapper, and the host's share; (f) alanine with a gelu and with a swish
   head through K1-K4 and, under ``mode="blocked"``, K5-K8, and alanine
   with a ``[38, 65, 3]`` head (past the unrolled kernels' width) through
   the blocked kernels under ``mode="auto"``, each against float64 plain
   versions on 8192 frames with the launch counts.

7. the blocked serving path: (a) the blocked forward and cv+forces kernels
   against float64 plain versions on 8192 and 8191 frames of
   ``peptide_model(60)`` (components None and 0; ``[l, n, 3]``,
   ``[3, n, l]``, ``[3n, l]``), ``lj_fluid_model(5)`` (``c_mat`` given and
   not), alanine through ``mode="blocked"`` (also against the unrolled
   kernels) and a 2,000-atom peptide with four sparse features (full and
   ``compact_grads``; inactive atoms exactly 0); (b) two launches of each
   give the same bits; (c) ``evaluate_trajectory`` serves 131,072 peptide
   frames (two batches of 65536) and 65,536 fluid frames from ``.npy``
   files with and without forces, checked on sampled rows, with the launch
   counts of each run; (d) CUDA-event times of both kernels on one
   65536-frame batch of each model, the plain versions' times (the fluid's
   at 4096 frames) and each kernel's bound.

8. the blocked training path: (a) the blocked backward kernel (autograd
   through ``fused_model_forward``: gx in the layout of x, every weight,
   ``ref_x``) and the blocked train kernel (``train_ref`` False and, where
   the model aligns, True) against float64 plain versions on 8192 and 8191
   frames of the four models of phase 7 in each input layout, the backward
   kernel also asked for the parameter sums alone (no gx: a kernel of its
   own, one evaluation a pair); two launches of each give the same bits,
   and whether the sums without gx equal those with gx bit for bit is
   printed; (b) ``fit(fused_mse_loss)`` and
   ``make_fused_train_step`` train ``peptide_model(60)`` for 20 Adam steps
   of 65536 frames from the ``.npy`` file of phase 7c and
   ``lj_fluid_model(5)`` for 10, labelled by a teacher model, with the
   launch counts of each run, a lower loss at the end and a resume from a
   checkpoint that repeats the remaining steps bit for bit; where a step's
   time goes (fetch, copy, kernels, optimizer); (c) CUDA-event times of both
   kernels and their plain versions on one 65536-frame batch, and bounds.
9. the edge-product probe: every body of ``edge_mm`` against its plain
   version and float64; then the probe's own run (T = 512, 64 tiles) with
   its launch count, times per body, the gather beside them, and
   ``torch.matmul`` as the library yardstick.
10. coordination features in the unrolled kernels: a 22-atom model with two
   coordination features (one under a box with ``d_max``), a bond and an
   aligned position through the forward, cv+forces, backward and train
   kernels against float64 plain versions.

Each kernel's bound is the larger of its bytes (every staged input
coordinate read once, every output written once) over 3.35 TB/s and the
f32 operations the function needs (every feature, adjoint and pair once),
counted from the model's sizes and this run's share of pairs inside
``d_max``, over 67 TFLOP/s. What the blocked kernels do beyond that, by
evaluating a pair from both its atoms where a gradient is formed, is
printed beside it and enters no bound; nor do the per-block partial sums of the backward and train kernels,
which the function does not need and whose bytes are printed beside it.

Gradients of the fluid are compared on every frame and atom. Where a pair
sits within 4e-6 of ``d_max`` or of half a box length, float32 and float64
may take different sides and the gradient of its two atoms jumps; there,
and only there, the comparison allows the jump the pair can make
(``fused_blocked.gradient_jump_slack``).

Tolerances: values 1e-5 abs (5e-5 for the fluid's sums over 7,750 pairs,
tests/test_condensed.py:101-118); gradients 2e-4·max(1, max|g|)
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
import re
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
BLK_CHECK_FRAMES = 8192
PEPTIDE_FRAMES = 1 << 17
LJ_FRAMES = 1 << 16
LJ_PLAIN_FRAMES = 4096
PEPTIDE_TRAIN_STEPS = 20
LJ_TRAIN_STEPS = 10
BF16_OPS_PER_S = 989e12    # dense bf16 on the tensor cores, same sheet
LJ_SIGMA = 0.5
VAL_TOL_PAIRS = 5e-5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
FP32_OPS_PER_S = 67e12     # f32 outside the tensor cores, same sheet
# f32 operations of one call of each per-feature function in
# csrc/frame_math.cuh and csrc/blocked_math.cuh, counted by hand, a square
# root or a division as one: forward and adjoint of an angle, a bond and a
# dihedral; a pair up to the d_max test, and the rest of it without and
# with the derivative.
OPS = {"angle": 25, "bond": 9, "dihedral": 50, "angle_bwd": 70,
       "bond_bwd": 20, "dihedral_bwd": 150, "pair_head": 22, "pair_tail": 9,
       "pair_tail_bwd": 26}
# f32 operations a frame of the unrolled kernels on the alanine model,
# counted by hand from csrc/frame_math.cuh (QCP with 12 Newton steps, the
# adjugate, for the adjoints its last steps on 9-tangent duals, 38 feature
# columns, MLP 38 -> 5 -> 3).
ALANINE_OPS = {"forward": 1500, "cv_forces": 5000, "backward": 6000,
               "train": 2400}
ALANINE_BYTES = {"forward": 276, "cv_forces": 540, "backward": 540,
                 "train": 276}
GOLDEN = np.array([-1.0, 0.0, 1.5296831, -0.33281142], np.float32)


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def grad_tol(g_ref):
    return GRAD_RTOL * max(1.0, float(g_ref.abs().max()))


def f64(parts):
    """The model's parts with float64 tensors, for a float64 plain version."""
    spec, align_idx, ref_x, params, act = parts
    return (spec, align_idx, None if ref_x is None else ref_x.double(),
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


def rel_err(got, want):
    """The largest error of a tensor as a fraction of max(1, max|ref|), the
    scale the gradient tolerance is stated in."""
    return max(float((g.double() - r).abs().max())
               / max(1.0, float(r.abs().max())) for g, r in zip(got, want))


def worst_gx(g, g_ref, slack, what):
    """Max abs error of a coordinate gradient ``[l, n, 3]`` off the atoms
    that carry a jump slack; fails where the error past the slack exceeds
    2e-4·max(1, max|ref|)."""
    err = (g.double() - g_ref).abs().amax(dim=-1)
    over = float((err - slack).max())
    if not over <= grad_tol(g_ref):
        fail(f"{what}: error past the jump slack {over} > {grad_tol(g_ref)}")
    return float(err[slack == 0].max())


def counts(**launched):
    """The launch counts a run must show: the named kernels as given, every
    other kernel 0."""
    from molann_tpu_torch.ops.fused import KERNEL_LAUNCHES
    return {**dict.fromkeys(KERNEL_LAUNCHES, 0), **launched}


def reset_counts():
    from molann_tpu_torch.ops.fused import KERNEL_LAUNCHES
    for k in KERNEL_LAUNCHES:
        KERNEL_LAUNCHES[k] = 0


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


def kernel_resources(log):
    """``nvcc -Xptxas -v``'s report as ``{kernel<template arguments>:
    "R registers, S B stack, A/B B spill stores/loads"}``."""
    out, name = {}, None
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        if m:
            sym = m.group(1)
            at = re.search(r"(\d{2})(?=fused|blocked|edge_mm|reduce)", sym)
            name = sym
            if at:
                end = at.end() + int(at.group(1))
                args = re.match(r"I((?:L[bi]\d+E)+)E", sym[end:])
                name = sym[at.end():end] + (
                    "<" + ",".join(re.findall(r"L[bi](\d+)E", args.group(1)))
                    + ">" if args else "")
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m and name:
            out[name] = f"{m.group(1)} B stack, {m.group(2)}/{m.group(3)} " \
                        "B spill stores/loads"
        m = re.search(r"Used (\d+) registers", ln)
        if m and name:
            out[name] = f"{m.group(1)} registers, " + out.get(name, "")
            name = None
    return out


def bound(n_bytes, n_ops):
    """``(bound_ms, bound_by)``: the least time the card could take."""
    t_bytes = 1e3 * n_bytes / HBM_BYTES_PER_S
    t_ops = 1e3 * n_ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def as_layout(x, layout):
    """``x [l, n, 3]`` in ``layout``."""
    l, n = x.shape[:2]
    if layout == "[3, n, l]":
        return x.permute(2, 1, 0).contiguous()
    if layout == "[3n, l]":
        return x.reshape(l, 3 * n).T.contiguous()
    return x


def to_standard(y, g, layout, n):
    """Outputs of ``layout`` back as ``y [l, d]``, ``g [l, n, 3]``."""
    if layout == "[3, n, l]":
        return y.T, g.permute(2, 1, 0)
    if layout == "[3n, l]":
        return y.T, g.T.reshape(-1, n, 3)
    return y, g


def blocked_work(F, FB, model, within, forces, frames, grads=False):
    """``(bytes, operations, operations as written)`` of one blocked kernel
    call on ``frames`` frames. Bytes: the staged coordinates in, y (and the
    gradient) out; with ``grads`` (the backward and train kernels) gy or
    the labels in, in the place of y out, and the parameter gradients out
    once. With ``grads`` the operations gain each layer's parameter product
    (as many as its forward) and, without forces (the train kernel with a
    frozen reference), the MLP backwards above the first layer.
    Operations, for the bound: what the function needs, that is every
    feature and the MLP once and, with forces, the MLP backwards, every
    feature's adjoint once and every pair's ``s`` and ``s'`` in one pass,
    with the adds into the gradient (3 per atom of a feature, 6 per pair
    inside ``d_max``). The kernel as written computes every feature's
    adjoint once too; with forces it evaluates every pair from both its
    atoms (``s`` and ``s'`` together, 3 adds each into the atom's pair
    gradient) and multiplies each atom's pair gradient by the feature's
    cotangent (6 operations per atom and coordination feature); without
    forces it evaluates every pair once. That count is the third value and
    enters no bound.
    ``within``: per coordination feature, the share of this run's pairs
    inside ``d_max``."""
    spec, align_idx, _, params, _ = F._extract_model(model)
    lay = FB.blocked_layout(spec, align_idx)
    d_out = F._out_dim(spec, params)
    n_bytes = 4 * (3 * lay.n_active + d_out
                   + (3 * lay.n_atoms if forces else 0))
    mlp = sum(2 * w.numel() for w, _ in params)
    fwd = (spec.n_angles * OPS["angle"] + spec.n_bonds * OPS["bond"]
           + spec.n_dihedrals * OPS["dihedral"] + mlp)
    pair_fwd = sum(npairs * (OPS["pair_head"] + w * OPS["pair_tail"])
                   for npairs, w in zip(lay.coord_npairs, within))
    g_bytes = 4 * (1 + F._grad_width(
        lay.align_idx if lay.has_align else None, params)) if grads else 0
    if not forces:
        ops = fwd + pair_fwd
        if grads:
            ops += mlp + sum(2 * w.numel() for w, _ in params[1:])
        return frames * n_bytes + g_bytes, frames * ops, frames * ops
    pair_bwd = sum(npairs * (OPS["pair_head"] + w * OPS["pair_tail_bwd"])
                   for npairs, w in zip(lay.coord_npairs, within))
    pair_adds = sum(npairs * w * 6
                    for npairs, w in zip(lay.coord_npairs, within))
    needed = (fwd + mlp + spec.n_angles * (OPS["angle_bwd"] + 9)
              + spec.n_bonds * (OPS["bond_bwd"] + 6)
              + spec.n_dihedrals * (OPS["dihedral_bwd"] + 12)
              + pair_bwd + pair_adds)
    written = needed + pair_bwd + 6 * len(lay.coord_npairs) * lay.n_active
    if grads:
        needed, written = needed + mlp, written + mlp
    return frames * n_bytes + g_bytes, frames * needed, frames * written


def pairs_within(spec, x):
    """Per coordination feature, the share of pairs of ``x [l, n, 3]``
    whose minimum-image distance is inside the feature's ``d_max`` (1.0 for
    a feature without one)."""
    from molann_tpu_torch.ops.features import min_image_components

    pairs = torch.as_tensor(spec.coord_pairs, device=x.device)
    out = []
    for (start, npairs), box, dmax in zip(spec.coord_slices, spec.coord_boxes,
                                          spec.coord_dmax):
        if dmax is None:
            out.append(1.0)
            continue
        p = pairs[start:start + npairs]
        d = x[:, p[:, 1]] - x[:, p[:, 0]]
        comps = tuple(d[..., i] for i in range(3))
        if box is not None:
            comps = min_image_components(comps, box)
        r = torch.sqrt(sum(c * c for c in comps))
        out.append(float((r < dmax).float().mean()))
    return out


def sparse_peptide_model(n_residues, dev):
    """A large peptide with four features on a handful of atoms (the
    features of tests/test_fused_blocked.py:234-242): compaction engages."""
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import (
        AlignmentLayer,
        FeatureLayer,
        MolANN,
        PreprocessingANN,
        create_sequential_nn,
    )
    from molann_tpu_torch.systems import synthetic_peptide

    u = synthetic_peptide(n_residues)

    def sel(name, resid):
        return u.select_atoms(f"name {name} and resid {resid}")

    feats = [
        Feature("b1", "bond", sel("CA", 3) + sel("CA", 17)),
        Feature("a1", "angle", sel("N", 9) + sel("CA", 9) + sel("C", 9)),
        Feature("d1", "dihedral",
                sel("C", 24) + sel("N", 25) + sel("CA", 25) + sel("C", 25)),
        Feature("p1", "position", sel("CA", 30) + sel("CA", 31)),
    ]
    align = AlignmentLayer(u.select_atoms("name CA and resid 1:5"), u.atoms,
                           device=dev)
    pp = PreprocessingANN(align, FeatureLayer(feats, u.atoms))
    head = create_sequential_nn([pp.output_dimension(), 8, 2],
                                generator=torch.Generator().manual_seed(3),
                                device=dev)
    return MolANN(pp, head), u


def noisy_frames(u, l, seed, sigma, dev, chunk=16384):
    rng = np.random.default_rng(seed)
    n = u.atoms.n_atoms
    return torch.cat([torch.as_tensor(
        (u.atoms.positions[None] + sigma * rng.normal(
            size=(min(chunk, l - s), n, 3))).astype(np.float32), device=dev)
        for s in range(0, l, chunk)])


def blocked_phase(dev, card, alanine, x_alanine, tmp):
    """Phase 7. Returns per blocked kernel its launches on the serving
    runs, worst error, times and bounds, and the models with the ``.npy``
    files written under ``tmp`` for phase 8."""
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.systems import lj_fluid_model, peptide_model

    seed = torch.Generator().manual_seed(0)
    peptide, pu = peptide_model(60, generator=seed, device=dev)
    fluid, fu, _ = lj_fluid_model(5, generator=seed, device=dev)
    sparse, su = sparse_peptide_model(400, dev)
    if F.model_select_mode(peptide) != "blocked" or \
            F.model_select_mode(fluid) != "blocked":
        fail("mode='auto' does not select the blocked kernels")
    c_fluid = torch.as_tensor(F.model_chunk_matrix(fluid), device=dev)
    if F.model_chunk_matrix(peptide) is not None:
        fail("peptide_model(60) has a pair operand")
    err = {"blocked_forward": 0.0, "blocked_cv_forces": 0.0}
    at_jump = {}
    L = BLK_CHECK_FRAMES

    def check(name, model, x, comps, layouts, val_tol, **kw):
        """Both kernels against the float64 plain version, on L and L - 1
        frames; then two launches of each must give the same bits."""
        parts = F._extract_model(model)
        n = x.shape[1]
        slack = FB.gradient_jump_slack(parts[0], parts[3], x.double())
        at_jump[name] = [int((slack > 0).sum()), 0.0]
        for comp in comps:
            y_ref, g_ref = FB.blocked_cv_forces_plain(
                *f64(parts), x.double(), comp)
            for l in (L, L - 1):
                for layout in layouts:
                    xin = as_layout(x[:l], layout)
                    t_in = layout == "[3n, l]"
                    y, g = F.fused_cv_forces(model, xin, component=comp,
                                             transposed_input=t_in, **kw)
                    y, g = to_standard(y, g, layout, n)
                    with torch.no_grad():
                        y6 = F.fused_model_forward(model, xin, **kw)
                    what = f"{name}, {layout}, {l} frames, component={comp}"
                    e6 = float((y6 - y_ref[:l]).abs().max())
                    ev = float((y - y_ref[:l]).abs().max())
                    eg_all = (g - g_ref[:l]).abs().amax(dim=-1)
                    eg = float(eg_all[slack[:l] == 0].max())
                    over = float((eg_all - slack[:l]).max())
                    if not (e6 <= val_tol and ev <= val_tol
                            and over <= grad_tol(g_ref)):
                        fail(f"blocked kernels vs float64 plain, {what}: "
                             f"forward {e6}, values {ev}, gradients {eg}, "
                             f"past the jump slack {over}")
                    there = eg_all[slack[:l] > 0]
                    if there.numel():
                        at_jump[name][1] = max(at_jump[name][1],
                                               float(there.max()))
                    err["blocked_forward"] = max(err["blocked_forward"], e6)
                    err["blocked_cv_forces"] = max(err["blocked_cv_forces"],
                                                   ev, eg)
        a = F.fused_cv_forces(model, x, **kw)
        b = F.fused_cv_forces(model, x, **kw)
        with torch.no_grad():
            a6 = F.fused_model_forward(model, x, **kw)
            b6 = F.fused_model_forward(model, x, **kw)
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
                and torch.equal(a6, b6)):
            fail(f"two launches of a blocked kernel differ: {name}")
        return y_ref, g_ref

    # (a), (b)
    xp = noisy_frames(pu, L, 10, 0.05, dev)
    check("peptide_model(60)", peptide, xp, (None, 0),
          ("[l, n, 3]", "[3, n, l]", "[3n, l]"), VAL_TOL)
    xf = noisy_frames(fu, L, 11, LJ_SIGMA, dev)
    check("lj_fluid_model(5), c_mat given", fluid, xf, (None,),
          ("[l, n, 3]", "[3, n, l]"), VAL_TOL_PAIRS, c_mat=c_fluid)
    check("lj_fluid_model(5), c_mat=None", fluid, xf, (None,),
          ("[l, n, 3]",), VAL_TOL_PAIRS)
    check("alanine, mode='blocked'", alanine, x_alanine, (None, 0),
          ("[l, n, 3]", "[3n, l]"), VAL_TOL, mode="blocked")
    y4, g4 = F.fused_cv_forces(alanine, x_alanine)
    y8, g8 = F.fused_cv_forces(alanine, x_alanine, mode="blocked")
    e_k = max(float((y8 - y4).abs().max()), float((g8 - g4).abs().max()))
    if not e_k <= grad_tol(g4):
        fail(f"alanine: blocked against unrolled kernels: {e_k}")
    xs = noisy_frames(su, L, 12, 0.05, dev)
    _, gs_ref = check("2000-atom sparse peptide", sparse, xs, (None,),
                      ("[l, n, 3]", "[3, n, l]"), VAL_TOL)
    active = F.active_atom_indices(sparse)
    inactive = np.setdiff1d(np.arange(su.atoms.n_atoms), active)
    y_s, g_s = F.fused_cv_forces(sparse, xs)
    y_c, g_c = F.fused_cv_forces(sparse, xs, compact_grads=True)
    if g_s[:, torch.as_tensor(inactive, device=dev)].any():
        fail("inactive atoms of the sparse model have non-zero gradients")
    if not (tuple(g_c.shape) == (3, len(active), L) and torch.equal(y_c, y_s)
            and torch.equal(g_c, g_s.permute(2, 1, 0)[
                :, torch.as_tensor(active, device=dev)])):
        fail("compact_grads differs from the gathered full gradient")
    if F.KERNEL_LAUNCHES["blocked_cv_forces"] == 0:
        fail("the blocked cv+forces kernel was never launched")
    torch.cuda.synchronize()
    print(f"blocked kernels vs float64 plain on {L} and {L - 1} frames "
          f"(peptide_model(60), lj_fluid_model(5), alanine, 2000-atom sparse "
          f"peptide with {len(active)} active atoms): max abs err forward "
          f"{err['blocked_forward']:.3g}, cv_forces "
          f"{err['blocked_cv_forces']:.3g}; blocked vs unrolled on alanine "
          f"{e_k:.3g}; repeated launches bit-identical; (atom, frame) entries "
          f"with a pair within 4e-6 of d_max or of half a box length, where "
          f"the gradient may jump and is held to the jump's size, and the "
          f"worst error there: "
          f"{ {k: v for k, v in at_jump.items() if v[0]} }")
    del xs, y_s, g_s, y_c, g_c, gs_ref

    # (c) serving from .npy files
    launches = {"blocked_forward": 0, "blocked_cv_forces": 0}
    served = []
    paths = {}
    for name, model, u, n_frames, sigma, tol, rows_n in (
            ("peptide_model(60)", peptide, pu, PEPTIDE_FRAMES, 0.05,
             VAL_TOL, 2048),
            ("lj_fluid_model(5)", fluid, fu, LJ_FRAMES, LJ_SIGMA,
             VAL_TOL_PAIRS, 512)):
        n = u.atoms.n_atoms
        path = paths[name] = os.path.join(
            tmp, name.split("_model")[0] + ".npy")
        frames = np.lib.format.open_memmap(
            path, mode="w+", dtype=np.float32, shape=(n_frames, n, 3))
        rng = np.random.default_rng(13)
        for s0 in range(0, n_frames, 16384):
            frames[s0:s0 + 16384] = (
                u.atoms.positions[None] + sigma * rng.normal(
                    size=(16384, n, 3))).astype(np.float32)
        frames.flush()
        del frames
        n_batches = n_frames // BATCH
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cvs, grads = evaluate_trajectory(model, path, forces=True,
                                         batch_size=BATCH)
        t_forces = time.perf_counter() - t0
        got_forces = dict(F.KERNEL_LAUNCHES)
        if got_forces != counts(blocked_cv_forces=n_batches):
            fail(f"launch counts serving {name} with forces: "
                 f"{got_forces}")
        reset_counts()
        t0 = time.perf_counter()
        cvs_only = evaluate_trajectory(model, path, batch_size=BATCH)
        t_values = time.perf_counter() - t0
        got_values = dict(F.KERNEL_LAUNCHES)
        if got_values != counts(blocked_forward=n_batches):
            fail(f"launch counts serving {name} without forces: "
                 f"{got_values}")
        for kind in launches:
            launches[kind] += got_forces[kind] + got_values[kind]
        spec, _, _, params, _ = F._extract_model(model)
        d_out = F._out_dim(spec, params)
        if cvs.shape != (n_frames, d_out) or \
                grads.shape != (n_frames, n, 3):
            fail(f"serving output shapes {cvs.shape}, {grads.shape}")
        if not (np.isfinite(cvs).all() and np.isfinite(grads).all()
                and np.isfinite(cvs_only).all()):
            fail(f"non-finite serving outputs for {name}")
        rows = np.sort(np.random.default_rng(14).choice(
            n_frames, rows_n, replace=False))
        xr = torch.as_tensor(np.load(path, mmap_mode="r")[rows],
                             device=dev)
        y_ref, g_ref = FB.blocked_cv_forces_plain(
            *f64(F._extract_model(model)), xr.double())
        slack = FB.gradient_jump_slack(spec, params,
                                       xr.double()).cpu().numpy()
        y_ref, g_ref = y_ref.cpu().numpy(), g_ref.cpu().numpy()
        ev = max(float(np.abs(cvs[rows] - y_ref).max()),
                 float(np.abs(cvs_only[rows] - y_ref).max()))
        eg_all = np.abs(grads[rows] - g_ref).max(axis=-1)
        eg = float(eg_all[slack == 0].max())
        over = float((eg_all - slack).max())
        if not (ev <= tol and over <= GRAD_RTOL * max(
                1.0, float(np.abs(g_ref).max()))):
            fail(f"served rows of {name} vs float64 plain: values {ev}, "
                 f"gradients {eg}, past the jump slack {over}")
        served.append(
            f"{name}: {n_frames} frames in {n_batches} batches of "
            f"{BATCH}, cv+forces {n_frames / t_forces:.6g} frames/s "
            f"(launches: blocked_cv_forces "
            f"{got_forces['blocked_cv_forces']}, every other kernel 0), "
            f"values only {n_frames / t_values:.6g} frames/s end to end "
            f"(launches: blocked_forward "
            f"{got_values['blocked_forward']}, every other kernel 0), "
            f"{rows_n} sampled rows max err values {ev:.3g}, gradients "
            f"{eg:.3g} ({int((slack > 0).sum())} (atom, row) entries "
            f"held to a jump's size instead)")
        del cvs, grads, cvs_only
    print("blocked serving: " + "; ".join(served) + f"; card: {card}")

    # (d) kernel times, plain times and bounds on one batch of each model
    out = {}
    timed = []
    for name, model, u, sigma, plain_frames, reps in (
            ("peptide_model(60)", peptide, pu, 0.05, BATCH, 20),
            ("lj_fluid_model(5)", fluid, fu, LJ_SIGMA, LJ_PLAIN_FRAMES, 5)):
        parts = F._extract_model(model)
        xb = noisy_frames(u, BATCH, 15, sigma, dev)
        xpl = xb[:plain_frames]
        within = pairs_within(parts[0], xb[:256])
        with torch.no_grad():
            ms6, pl6 = alternate(
                lambda: FB.blocked_forward_plain(*parts, xpl),
                lambda: F.fused_model_forward(model, xb), 2, reps)
        ms8, pl8 = alternate(
            lambda: FB.blocked_cv_forces_plain(*parts, xpl),
            lambda: F.fused_cv_forces(model, xb), 2, reps)
        for kind, ms, pl, forces in (("blocked_forward", ms6, pl6, False),
                                     ("blocked_cv_forces", ms8, pl8, True)):
            n_bytes, n_ops, n_written = blocked_work(F, FB, model, within,
                                                     forces, BATCH)
            b_ms, b_by = bound(n_bytes, n_ops)
            out.setdefault(kind, {})[name] = {
                "ms": ms, "plain_ms": pl, "plain_frames": plain_frames,
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes_per_frame": n_bytes // BATCH,
                "operations_per_frame": round(n_ops / BATCH),
                "operations_as_written_per_frame": round(n_written / BATCH)}
            timed.append(f"{name} {kind} {ms:.4f} ms (bound {b_ms:.4f} ms by "
                         f"{b_by}: {n_bytes // BATCH} B and "
                         f"{n_ops / BATCH:.0f} operations a frame needed, "
                         f"{n_written / BATCH:.0f} as written; plain "
                         f"{pl:.4f} ms on {plain_frames} frames)")
        if within != [1.0] * len(within):
            timed.append(f"{name} pairs inside d_max: "
                         f"{[round(w, 4) for w in within]}")
        del xb, xpl
    print(f"one {BATCH}-frame batch on the card: " + "; ".join(timed)
          + f"; card: {card}")
    models = {"peptide_model(60)": (peptide, pu, paths["peptide_model(60)"]),
              "lj_fluid_model(5)": (fluid, fu, paths["lj_fluid_model(5)"]),
              "sparse": (sparse, su, None), "c_fluid": c_fluid}
    return blocked_entries(launches, err, out, (
        ("blocked_forward", 1179), ("blocked_cv_forces", 1398))), models


def blocked_entries(launches, err, out, kinds,
                    source="molann_tpu_torch/csrc/fused_blocked.cu"):
    """The ``kernels`` entries of blocked kernels: the peptide's numbers,
    the fluid's under ``also``."""
    return [{
        "name": kind, "route": "cuda",
        "source": source,
        "replaces": f"molann_tpu/ops/fused_blocked.py:{line}",
        "launches": launches[kind], "max_abs_err": err[kind],
        **{k: out[kind]["peptide_model(60)"][k]
           for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
        "library_ms": None, "model": "peptide_model(60)",
        "also": {"lj_fluid_model(5)": out[kind]["lj_fluid_model(5)"]},
    } for kind, line in kinds]


def g_standard(g, layout, n):
    """A gradient of ``layout`` back as ``[l, n, 3]``."""
    if layout == "[3, n, l]":
        return g.permute(2, 1, 0)
    if layout == "[3n, l]":
        return g.T.reshape(-1, n, 3)
    return g


def blocked_train_phase(dev, card, alanine, x_alanine, models, tmp):
    """Phase 8. Returns the ``kernels`` entries of the blocked backward and
    train kernels."""
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.systems import lj_fluid_model, peptide_model
    from molann_tpu_torch.train import (
        TrajectoryDataset,
        batch_iterator,
        fit,
        fused_mse_loss,
        make_fused_train_step,
        masked_optimizer,
        trainable_mask,
    )

    peptide, pu, peptide_path = models["peptide_model(60)"]
    fluid, fu, fluid_path = models["lj_fluid_model(5)"]
    sparse, su, _ = models["sparse"]
    err = {"blocked_backward": 0.0, "blocked_train": 0.0}
    rel = dict(err)
    at_jump = {}
    same_sums = {}  # the sums of K7 without gx equal those with it, bit for bit
    L = BLK_CHECK_FRAMES

    def check(name, model, x, layouts, **kw):
        """K7 under autograd and K5 against the float64 plain versions, on
        L and L - 1 frames in every layout; then two launches of each must
        give the same bits."""
        parts = F._extract_model(model)
        n = x.shape[1]
        d = F._out_dim(parts[0], parts[3])
        has_ref = FB.blocked_layout(parts[0], parts[1]).has_align
        gy = torch.as_tensor(np.random.default_rng(16).normal(
            size=(L, d)).astype(np.float32), device=dev)
        slack = FB.gradient_jump_slack(parts[0], parts[3], x.double())
        at_jump[name] = [int((slack > 0).sum()), 0.0]
        for l in (L, L - 1):
            gx_r, gp_r, gref_r = FB.blocked_backward_plain(
                *f64(parts), x[:l].double(), gy[:l].double())
            want = [*flat(gp_r)] + ([gref_r] if has_ref else [])
            for layout in layouts:
                what = f"{name}, {layout}, {l} frames"
                xin = as_layout(x[:l], layout).requires_grad_(True)
                leaves = [xin, *flat(parts[3])]
                if has_ref:
                    leaves.append(parts[2].requires_grad_(True))
                y = F.fused_model_forward(model, xin, **kw)
                got = torch.autograd.grad(y, leaves, gy[:l])
                if has_ref:
                    parts[2].requires_grad_(False)
                if got[0].shape != xin.shape:
                    fail(f"blocked backward, {what}: gx is "
                         f"{tuple(got[0].shape)}")
                eg_all = (g_standard(got[0], layout, n).double()
                          - gx_r).abs().amax(dim=-1)
                eg = float(eg_all[slack[:l] == 0].max())
                over = float((eg_all - slack[:l]).max())
                if not over <= grad_tol(gx_r):
                    fail(f"blocked backward vs float64 plain, {what}: gx "
                         f"{eg}, past the jump slack {over}")
                there = eg_all[slack[:l] > 0]
                if there.numel():
                    at_jump[name][1] = max(at_jump[name][1],
                                           float(there.max()))
                e = worst(got[1:], want, f"blocked backward, {what}")
                # without gx: no pair gradient, no accumulators, no gather
                if has_ref:
                    parts[2].requires_grad_(True)
                sums = torch.autograd.grad(
                    F.fused_model_forward(model, xin, **kw), leaves[1:],
                    gy[:l])
                if has_ref:
                    parts[2].requires_grad_(False)
                e = max(e, worst(sums, want,
                                 f"blocked backward without gx, {what}"))
                same_sums[name] = same_sums.get(name, True) and all(
                    torch.equal(p, q) for p, q in zip(sums, got[1:]))
                err["blocked_backward"] = max(err["blocked_backward"], eg, e)
                rel["blocked_backward"] = max(
                    rel["blocked_backward"], rel_err(got[1:], want),
                    eg / max(1.0, float(gx_r.abs().max())))
            for train_ref in (False, True) if has_ref else (False,):
                loss_r, gp_r, gref_r = FB.blocked_train_grads_plain(
                    *f64(parts), x[:l].double(), gy[:l].double(), train_ref)
                want = [*flat(gp_r)] + ([gref_r] if gref_r is not None
                                        else [])
                for layout in layouts:
                    what = f"blocked train vs float64 plain, {name}, " \
                           f"{layout}, {l} frames, train_ref={train_ref}"
                    yt = gy[:l] if layout == "[l, n, 3]" \
                        else gy[:l].T.contiguous()
                    loss, grads = F.fused_train_grads(
                        model, as_layout(x[:l], layout), yt,
                        train_ref=train_ref, **kw)
                    el = abs(float(loss) - float(loss_r))
                    if not el <= LOSS_RTOL * abs(float(loss_r)):
                        fail(f"{what}: loss {float(loss)} vs {float(loss_r)}")
                    e = worst(list(grads.values()), want, what)
                    err["blocked_train"] = max(err["blocked_train"], e, el)
                    rel["blocked_train"] = max(
                        rel["blocked_train"],
                        rel_err(list(grads.values()), want))
        xg = x.clone().requires_grad_(True)
        leaves = [xg, *flat(parts[3])]
        y = F.fused_model_forward(model, xg, **kw)
        a = torch.autograd.grad(y, leaves, gy, retain_graph=True)
        a_sums = torch.autograd.grad(y, leaves[1:], gy, retain_graph=True)
        b_sums = torch.autograd.grad(y, leaves[1:], gy, retain_graph=True)
        b = torch.autograd.grad(y, leaves, gy)
        same = all(torch.equal(p, q) for p, q in zip(a + a_sums, b + b_sums))
        for train_ref in (False, True) if has_ref else (False,):
            l1, g1 = F.fused_train_grads(model, x, gy, train_ref=train_ref,
                                         **kw)
            l2, g2 = F.fused_train_grads(model, x, gy, train_ref=train_ref,
                                         **kw)
            same = (same and torch.equal(l1, l2)
                    and all(torch.equal(g1[k], g2[k]) for k in g1))
        if not same:
            fail(f"two launches of a blocked training kernel differ: {name}")

    # (a), and two launches with the same bits
    reset_counts()
    every = ("[l, n, 3]", "[3, n, l]", "[3n, l]")
    check("peptide_model(60)", peptide, noisy_frames(pu, L, 10, 0.05, dev),
          every)
    xf = noisy_frames(fu, L, 11, LJ_SIGMA, dev)
    check("lj_fluid_model(5), c_mat given", fluid, xf,
          ("[l, n, 3]", "[3, n, l]"), c_mat=models["c_fluid"])
    check("lj_fluid_model(5), c_mat=None", fluid, xf, ("[l, n, 3]",))
    del xf
    check("alanine, mode='blocked'", alanine, x_alanine,
          ("[l, n, 3]", "[3n, l]"), mode="blocked")
    check("2000-atom sparse peptide", sparse,
          noisy_frames(su, L, 12, 0.05, dev), ("[l, n, 3]", "[3, n, l]"))
    if not (F.KERNEL_LAUNCHES["blocked_backward"]
            and F.KERNEL_LAUNCHES["blocked_train"]):
        fail("a blocked training kernel was never launched")
    torch.cuda.synchronize()
    print(f"blocked training kernels vs float64 plain on {L} and {L - 1} "
          f"frames (peptide_model(60), lj_fluid_model(5), alanine with "
          f"train_ref, 2000-atom sparse peptide; every layout): max abs err "
          f"backward {err['blocked_backward']:.3g}, train "
          f"{err['blocked_train']:.3g} (sums over {L} frames; as a fraction "
          f"of max(1, max|g|), which the tolerance {GRAD_RTOL} is stated in: "
          f"{rel['blocked_backward']:.3g} and {rel['blocked_train']:.3g}); "
          f"the backward kernel with and without gx and the train kernel "
          f"with and without train_ref, each against float64 and repeated "
          f"bit-identically; the parameter sums without gx equal those with "
          f"gx bit for bit: {same_sums}; "
          f"(atom, frame) entries held to a jump's size and the worst error "
          f"there: { {k: v for k, v in at_jump.items() if v[0]} }")

    # (b) two trainers on labelled trajectories, and a resume. Adam at
    # 1e-4: at 1e-3 its first steps move the 355 unnormalised inputs'
    # weights far enough for the loss to rise before it falls
    adam = functools.partial(torch.optim.Adam, lr=1e-4)
    launches = {"blocked_backward": 0, "blocked_train": 0}
    trained = []
    for name, build, path, steps in (
            ("peptide_model(60)",
             lambda seed: peptide_model(
                 60, generator=torch.Generator().manual_seed(seed),
                 device=dev)[0], peptide_path, PEPTIDE_TRAIN_STEPS),
            ("lj_fluid_model(5)",
             lambda seed: lj_fluid_model(
                 5, generator=torch.Generator().manual_seed(seed),
                 device=dev)[0], fluid_path, LJ_TRAIN_STEPS)):
        data = TrajectoryDataset(path)
        n_frames = len(data)
        teacher = build(1)
        frames = np.load(path, mmap_mode="r")
        with torch.no_grad():
            labels = np.concatenate([F.fused_model_forward(
                teacher, torch.as_tensor(np.array(frames[s:s + BATCH]),
                                         device=dev)).cpu().numpy()
                for s in range(0, n_frames, BATCH)])
        del frames

        def batches():
            return ((xb, labels[idx]) for xb, idx in batch_iterator(
                data, BATCH, seed=0, return_indices=True))

        half = steps // 2
        t0 = time.perf_counter()
        fit(build(0), fused_mse_loss, batches(), optimizer=adam, num_steps=1)
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t0
        ckpt = os.path.join(tmp, f"ckpt_{steps}")
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fit(build(0), fused_mse_loss, batches(), optimizer=adam,
                  num_steps=steps, checkpoint_dir=ckpt, checkpoint_every=half)
        torch.cuda.synchronize()
        t_fit = time.perf_counter() - t0
        fit_launches = dict(F.KERNEL_LAUNCHES)
        if fit_launches != counts(blocked_forward=steps,
                                  blocked_backward=steps):
            fail(f"launch counts over fit on {name}: {fit_launches}")

        student = build(0)
        opt = masked_optimizer(adam, trainable_mask(student))(student)
        step = make_fused_train_step()
        fused_losses = []
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for batch in itertools.islice(batches(), steps):
            student, opt, loss = step(student, opt, batch)
            fused_losses.append(loss)
        torch.cuda.synchronize()
        t_fused = time.perf_counter() - t0
        fused_launches = dict(F.KERNEL_LAUNCHES)
        if fused_launches != counts(blocked_train=steps):
            fail(f"launch counts over the fused trainer on {name}: "
                 f"{fused_launches}")
        fused_losses = [float(v) for v in fused_losses]
        for trainer, losses in (("fit", res.losses), ("fused", fused_losses)):
            if not (len(losses) == steps and np.isfinite(losses).all()
                    and losses[-1] < losses[0]):
                fail(f"{trainer} trainer did not lower the loss on {name}: "
                     f"{losses}")
        gap = max(abs(a - b) / abs(a) for a, b in zip(res.losses,
                                                      fused_losses))
        if not gap <= 1e-3:
            fail(f"the two trainers part on {name}: {res.losses} vs "
                 f"{fused_losses}")
        launches["blocked_backward"] += fit_launches["blocked_backward"]
        launches["blocked_train"] += fused_launches["blocked_train"]

        resume_dir = os.path.join(tmp, f"resume_{steps}")
        os.makedirs(resume_dir)
        for suffix in (".model.npz", ".opt.npz"):
            shutil.copy(os.path.join(ckpt, f"ckpt_{half:010d}{suffix}"),
                        resume_dir)
        resumed = fit(build(0), fused_mse_loss, batches(), optimizer=adam,
                      num_steps=steps, checkpoint_dir=resume_dir)
        same = resumed.losses == res.losses[half:] and all(
            torch.equal(a, b) for a, b in zip(resumed.model.parameters(),
                                              res.model.parameters()))
        if not same:
            fail(f"resume from step {half} differs on {name}: "
                 f"{resumed.losses} vs {res.losses[half:]}")

        # where a step's time goes: each stage ends in a synchronise
        stages = {"fetch": 0.0, "h2d": 0.0, "forward_loss": 0.0,
                  "backward": 0.0, "adam": 0.0, "train_kernel": 0.0}
        model = build(0)
        opt = masked_optimizer(adam, trainable_mask(model))(model)
        it = batches()
        n_timed = 4
        for _ in range(n_timed):
            t = [time.perf_counter()]
            xb, yb = next(it)
            t.append(time.perf_counter())
            xb, yb = torch.as_tensor(xb, device=dev), \
                torch.as_tensor(yb, device=dev)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            opt.zero_grad(set_to_none=True)
            loss = fused_mse_loss(model, (xb, yb))
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            loss.backward()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            opt.step()
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            F.fused_train_grads(model, xb, yb)
            torch.cuda.synchronize()
            t.append(time.perf_counter())
            for key, a, b in zip(stages, t, t[1:]):
                stages[key] += (b - a) * 1e3 / n_timed
        trained.append(
            f"{name}: {steps} steps of {BATCH} frames from {n_frames} "
            f"labelled frames; fit(fused_mse_loss) loss {res.losses[0]:.6g} "
            f"-> {res.losses[-1]:.6g}, {steps / t_fit:.6g} steps/s (after a "
            f"first step of {t_warm:.4g} s), launches blocked_forward "
            f"{fit_launches['blocked_forward']}, blocked_backward "
            f"{fit_launches['blocked_backward']}, every other kernel 0; "
            f"make_fused_train_step loss {fused_losses[0]:.6g} -> "
            f"{fused_losses[-1]:.6g}, {steps / t_fused:.6g} steps/s, "
            f"launches blocked_train {fused_launches['blocked_train']}, "
            f"every other kernel 0; the two loss traces within {gap:.3g}; "
            f"resume from step {half} bit-identical; one step's stages, ms, "
            f"mean of {n_timed}: "
            + ", ".join(f"{k} {v:.3f}" for k, v in stages.items()))
        del data, labels
    print("blocked training: " + "; ".join(trained) + f"; card: {card}")

    # (c) kernel times, plain times and bounds on one batch of each model
    out = {}
    timed = []
    for name, model, u, sigma, plain_frames, reps in (
            ("peptide_model(60)", peptide, pu, 0.05, BATCH, 20),
            ("lj_fluid_model(5)", fluid, fu, LJ_SIGMA, LJ_PLAIN_FRAMES, 5)):
        parts = F._extract_model(model)
        d = F._out_dim(parts[0], parts[3])
        xb = noisy_frames(u, BATCH, 15, sigma, dev)
        gyb = torch.as_tensor(np.random.default_rng(17).normal(
            size=(BATCH, d)).astype(np.float32), device=dev)
        xpl, gpl = xb[:plain_frames], gyb[:plain_frames]
        within = pairs_within(parts[0], xb[:256])
        xg = xb.clone().requires_grad_(True)
        yk = F.fused_model_forward(model, xg)
        leaves = [xg, *flat(parts[3])]
        ms7, pl7 = alternate(
            lambda: FB.blocked_backward_plain(*parts, xpl, gpl),
            lambda: torch.autograd.grad(yk, leaves, gyb, retain_graph=True),
            2, reps)
        del xg, yk, leaves
        ms5, pl5 = alternate(
            lambda: FB.blocked_train_grads_plain(*parts, xpl, gpl),
            lambda: F.fused_train_grads(model, xb, gyb), 2, reps)
        lay = FB.blocked_layout(parts[0], parts[1])
        width = 1 + F._grad_width(lay.align_idx if lay.has_align else None,
                                  parts[3])
        for kind, ms, pl, forces in (("blocked_backward", ms7, pl7, True),
                                     ("blocked_train", ms5, pl5, False)):
            n_bytes, n_ops, n_written = blocked_work(
                F, FB, model, within, forces, BATCH, grads=True)
            b_ms, b_by = bound(n_bytes, n_ops)
            partial_bytes = 2 * 4 * width * min(
                FB.BLK_GRAD_BLOCKS, BATCH // 8)
            out.setdefault(kind, {})[name] = {
                "ms": ms, "plain_ms": pl, "plain_frames": plain_frames,
                "bound_ms": b_ms, "bound_by": b_by,
                "bytes_per_frame": n_bytes // BATCH,
                "operations_per_frame": round(n_ops / BATCH),
                "operations_as_written_per_frame": round(n_written / BATCH),
                "partial_sum_bytes_at_most": partial_bytes}
            timed.append(f"{name} {kind} {ms:.4f} ms (bound {b_ms:.4f} ms by "
                         f"{b_by}: {n_bytes // BATCH} B and "
                         f"{n_ops / BATCH:.0f} operations a frame needed, "
                         f"{n_written / BATCH:.0f} as written, at most "
                         f"{partial_bytes} B of per-block partial sums "
                         f"written and read; plain {pl:.4f} ms on "
                         f"{plain_frames} frames)")
        del xb, gyb
    print(f"one {BATCH}-frame batch on the card: " + "; ".join(timed)
          + f"; card: {card}")
    entries = blocked_entries(launches, err, out, (
        ("blocked_backward", 1192), ("blocked_train", 1285)),
        source="molann_tpu_torch/csrc/fused_blocked_grads.cu")
    for entry in entries:
        entry["max_err_over_scale"] = rel[entry["name"]]
    return entries


def edge_phase(dev, card):
    """Phase 9. Returns the ``kernels`` entry of the edge-product probe."""
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.probes import edge_mm_probe as EP

    # kernel against plain and against float64, as fractions of max|truth|;
    # the one-pass int8 body multiplies round(x / 256) and is held to that
    vs_plain = 5e-7
    vs_f64 = {"f32": 5e-7, "gather": 5e-7, "split3": 5e-7, "fixed4": 5e-7,
              "bf16": 4e-3, "fixed2": 2e-4, "int8": 1.0}
    T, reps = 512, 8
    D_host, x_host = EP.probe_inputs(T)
    D = torch.as_tensor(D_host, device=dev)
    x = torch.as_tensor(x_host, device=dev)
    truth = D.double() @ x.double()
    top = float(truth.abs().max())
    errs, worst_plain = {}, 0.0
    for variant in EP.VARIANTS:
        got = EP.edge_mm(D, x, variant)
        torch.cuda.synchronize()
        e_plain = float((got - EP.edge_mm_plain(D, x, variant)).abs().max())
        e_f64 = float((got.double() - truth).abs().max())
        if not (e_plain <= vs_plain * top and e_f64 <= vs_f64[variant] * top):
            fail(f"edge_mm {variant}: {e_plain / top} off its plain version, "
                 f"{e_f64 / top} off float64 (of max|truth|)")
        if not torch.equal(got, EP.edge_mm(D, x, variant)):
            fail(f"two launches of edge_mm {variant} differ")
        errs[variant] = e_f64 / top
        worst_plain = max(worst_plain, e_plain)
    del truth, got
    reset_counts()
    res = EP.run_probe(T, reps)
    launches = dict(F.KERNEL_LAUNCHES)
    if launches != counts(edge_mm=len(EP.VARIANTS) * (reps + 3)):
        fail(f"launch counts over the edge probe: {launches}")
    ms_plain = cuda_ms(lambda: EP.edge_mm_plain(D, x, "split3"), reps)
    m, k = D.shape
    n = x.shape[1]
    t_bytes = 1e3 * 4 * (m * k + k * n + m * n) / HBM_BYTES_PER_S
    t_ops = 1e3 * 3 * 2.0 * m * k * n / BF16_OPS_PER_S
    print(f"edge product D [{m}, {k}] @ x [{k}, {n}] (T = {T}, 64 tiles), "
          f"ms per body (TFLOP/s of the dense count; error against float64 "
          f"as a fraction of max|truth|): " + "; ".join(
              f"{v} {res[v]['ms']:.4f} ({res[v]['tflops']:.2f}; "
              f"{errs[v]:.3g})" for v in EP.VARIANTS)
          + f"; torch.matmul float32 {res['library']['ms']:.4f}; plain "
          f"split3 {ms_plain:.4f}; worst distance of a body from its plain "
          f"version {worst_plain / top:.3g}; launches edge_mm "
          f"{launches['edge_mm']}; card: {card}")
    return {"name": "edge_mm", "route": "cuda",
            "source": "molann_tpu_torch/csrc/edge_mm.cu",
            "replaces": "scripts/int8_mm_probe.py:70",
            "launches": launches["edge_mm"],
            "max_abs_err": max(errs[v] for v in ("f32", "split3", "fixed4",
                                                 "gather")) * top,
            "ms": res["split3"]["ms"], "plain_ms": ms_plain,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": res["library"]["ms"], "body": "split3",
            "bodies_ms": {v: res[v]["ms"] for v in EP.VARIANTS}}


def profiled_ms(fn, pattern, calls=20):
    """``(alone, device)``: ms a call of the kernels whose name matches
    ``pattern``, and of all the call's device work, by ``torch.profiler``."""
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


def unrolled_split(calls):
    """``{kernel: (alone, event, host share)}`` of the unrolled kernels'
    calls ``{kernel: (fn, kernel-name pattern)}``: the kernel alone, the
    event time of the call with its wrapper, and that less the call's device
    time."""
    out = {}
    for name, (fn, pattern) in calls.items():
        alone, device = profiled_ms(fn, pattern)
        event = cuda_ms(fn, 50)
        if not alone > 0:
            fail(f"the profiler saw no {name} kernel")
        out[name] = (alone, event, event - device)
    return out


def head_phase(dev):
    """Phase 6f: heads the unrolled kernels took only from PR 6 on (gelu and
    swish, whose derivative needs the pre-activation) through K1-K4 and
    K5-K8, and a head past the unrolled kernels' width through the blocked
    kernels under ``mode="auto"``, against float64 plain versions."""
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.systems import alanine_model

    out = []
    for label, kw, mode in (
            ("gelu", dict(activation="gelu"), "unrolled"),
            ("gelu", dict(activation="gelu"), "blocked"),
            ("swish", dict(activation="swish"), "unrolled"),
            ("swish", dict(activation="swish"), "blocked"),
            ("[38, 65, 3]", dict(hidden_dims=(65, 3)), "auto")):
        model, u = alanine_model(generator=torch.Generator().manual_seed(11),
                                 device=dev, **kw)
        parts = F._extract_model(model)
        d = parts[3][-1][0].shape[0]
        x = noisy_frames(u, CHECK_FRAMES, 24, 0.05, dev)
        gy = torch.as_tensor(np.random.default_rng(25).normal(
            size=(CHECK_FRAMES, d)).astype(np.float32), device=dev)
        what = f"{label} head, mode={mode}"
        reset_counts()
        with torch.no_grad():
            y1 = F.fused_model_forward(model, x, mode=mode)
        y_r, g_r = F.cv_forces_plain(*f64(parts), x.double())
        y, g = F.fused_cv_forces(model, x, mode=mode)
        ev = max(float((y1 - y_r).abs().max()), float((y - y_r).abs().max()))
        if not ev <= VAL_TOL:
            fail(f"{what}: values {ev}")
        err = max(ev, worst([g], [g_r], f"{what}, cv+forces"))
        xg = x.clone().requires_grad_(True)
        ref_x = parts[2].requires_grad_(True)
        got = torch.autograd.grad(F.fused_model_forward(model, xg, mode=mode),
                                  [xg, ref_x, *flat(parts[3])], gy)
        ref_x.requires_grad_(False)
        gx_r, gp_r, gref_r = F.backward_plain(*f64(parts), x.double(),
                                              gy.double())
        err = max(err, worst(got, [gx_r, gref_r, *flat(gp_r)],
                             f"{what}, backward"))
        loss_r, gp_r, gref_r = F.train_grads_plain(*f64(parts), x.double(),
                                                   gy.double(), True)
        loss, grads = F.fused_train_grads(model, x, gy, mode=mode,
                                          train_ref=True)
        el = abs(float(loss) - float(loss_r))
        if not el <= LOSS_RTOL * abs(float(loss_r)):
            fail(f"{what}, train: loss {float(loss)} vs {float(loss_r)}")
        err = max(err, el, worst(list(grads.values()), [*flat(gp_r), gref_r],
                                 f"{what}, train"))
        pre = "" if mode == "unrolled" else "blocked_"
        want = counts(**{pre + "forward": 2, pre + "cv_forces": 1,
                         pre + "backward": 1, pre + "train": 1})
        if dict(F.KERNEL_LAUNCHES) != want:
            fail(f"launch counts, {what}: {dict(F.KERNEL_LAUNCHES)}")
        out.append(f"{what}: {'K1-K4' if not pre else 'K5-K8'} max abs err "
                   f"{err:.3g}")
    torch.cuda.synchronize()
    print("heads vs float64 plain on "
          f"{CHECK_FRAMES} frames (launch counts checked): " + "; ".join(out))


def coordination_model(dev):
    """A 22-atom model inside the unrolled envelope with two coordination
    features (9 and 36 pairs, the second under a box with ``d_max``), a bond
    and two aligned position atoms."""
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import (
        AlignmentLayer,
        FeatureLayer,
        MolANN,
        PreprocessingANN,
        create_sequential_nn,
    )
    from molann_tpu_torch.systems import alanine_universe

    u = alanine_universe()
    feats = [
        Feature("c1", "coordination", u.select_atoms("bynum 2 5 7"),
                group_b=u.select_atoms("bynum 15 17 19"), r0=3.0),
        Feature("b1", "bond", u.select_atoms("bynum 2 5")),
        Feature("c2", "coordination", u.select_atoms("bynum 1:9"), r0=2.5,
                nn=3, mm=7, pbc_box=np.asarray([9.0, 10.0, 11.0]), d_max=4.0),
        Feature("p1", "position", u.select_atoms("bynum 9 11")),
    ]
    align = AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms, device=dev)
    pp = PreprocessingANN(align, FeatureLayer(feats, u.atoms))
    head = create_sequential_nn([pp.output_dimension(), 4, 2],
                                generator=torch.Generator().manual_seed(5),
                                device=dev)
    return MolANN(pp, head), u


def coordination_phase(dev):
    """Phase 10: the unrolled kernels on a model with coordination
    features, against float64 plain versions."""
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.ops.fused_blocked import gradient_jump_slack

    model, u = coordination_model(dev)
    if F.model_select_mode(model) != "unrolled":
        fail("the coordination model is not inside the unrolled envelope")
    parts = F._extract_model(model)
    n = u.atoms.n_atoms
    x = noisy_frames(u, CHECK_FRAMES, 18, 0.15, dev)
    gy = torch.as_tensor(np.random.default_rng(19).normal(
        size=(CHECK_FRAMES, 2)).astype(np.float32), device=dev)
    slack = gradient_jump_slack(parts[0], parts[3], x.double())
    reset_counts()
    errs = {}
    y_r, g_r = F.cv_forces_plain(*f64(parts), x.double())
    y, g = F.fused_cv_forces(model, x)
    yt, gt = F.fused_cv_forces(
        model, x.reshape(CHECK_FRAMES, 3 * n).T.contiguous(),
        transposed_input=True)
    with torch.no_grad():
        y1 = F.fused_model_forward(model, x)
    errs["forward"] = float((y1 - y_r).abs().max())
    ev = max(float((y - y_r).abs().max()), float((yt.T - y_r).abs().max()))
    if not (errs["forward"] <= VAL_TOL and ev <= VAL_TOL):
        fail(f"coordination model: values {errs['forward']}, {ev}")
    errs["cv_forces"] = max(
        ev, worst_gx(g, g_r, slack, "coordination, cv+forces"),
        worst_gx(gt.T.reshape(-1, n, 3), g_r, slack,
                 "coordination, cv+forces on [3n, l]"))
    xg = x.clone().requires_grad_(True)
    ref_x = parts[2].requires_grad_(True)
    got = torch.autograd.grad(F.fused_model_forward(model, xg),
                              [xg, ref_x, *flat(parts[3])], gy)
    ref_x.requires_grad_(False)
    gx_r, gp_r, gref_r = F.backward_plain(*f64(parts), x.double(),
                                          gy.double())
    errs["backward"] = max(
        worst_gx(got[0], gx_r, slack, "coordination, backward"),
        worst(got[1:], [gref_r, *flat(gp_r)], "coordination, backward"))
    loss_r, gp_r, gref_r = F.train_grads_plain(*f64(parts), x.double(),
                                               gy.double(), True)
    loss, grads = F.fused_train_grads(model, x, gy, train_ref=True)
    el = abs(float(loss) - float(loss_r))
    if not el <= LOSS_RTOL * abs(float(loss_r)):
        fail(f"coordination, train: loss {float(loss)} vs {float(loss_r)}")
    errs["train"] = max(el, worst(list(grads.values()),
                                  [*flat(gp_r), gref_r],
                                  "coordination, train"))
    got = dict(F.KERNEL_LAUNCHES)
    if got != counts(forward=2, cv_forces=2, backward=1, train=1):
        fail(f"launch counts of the coordination phase: {got}")
    torch.cuda.synchronize()
    print(f"coordination features in the unrolled kernels (22 atoms, 9 + 36 "
          f"pairs, a box with d_max, a bond, aligned positions) vs float64 "
          f"plain on {CHECK_FRAMES} frames: max abs err "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; {int((slack > 0).sum())} (atom, frame) entries held to a "
          f"jump's size instead")


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
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{_build.BUILD_INFO['seconds']:.1f} s) -> "
          f"{os.path.basename(_build.BUILD_INFO['path'])}; "
          f"{kernel_resources(_build.BUILD_INFO['log'])}")

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
        if launches != counts(forward=n_batches, cv_forces=n_batches):
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
        if fit_launches != counts(forward=TRAIN_STEPS, backward=TRAIN_STEPS):
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
        if fused_launches != counts(train=TRAIN_STEPS):
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
    with torch.no_grad():
        split = unrolled_split({
            "forward": (lambda: F.fused_model_forward(model, xb),
                        r"fused_unrolled_kernel<(false|0)")})
    split.update(unrolled_split({
        "cv_forces": (lambda: F.fused_cv_forces(model, xb),
                      r"fused_unrolled_kernel<(true|1)"),
        "backward": (lambda: torch.autograd.grad(yk, k_leaves, gyb,
                                                 retain_graph=True),
                     r"fused_grads_kernel<(false|0)"),
        "train": (lambda: F.fused_train_grads(model, xbt, ytb,
                                              transposed_input=True),
                  r"fused_grads_kernel<(true|1)")}))
    print(f"unrolled kernels on one {BATCH}-frame batch, ms alone / with "
          "the wrapper (CUDA events) / the host's share (events less the "
          "call's device time): " + "; ".join(
              f"{k} {a:.4f} / {e:.4f} / {h:.4f}"
              for k, (a, e, h) in split.items()) + f"; card: {card}")

    # (f) the heads PR 6 added, and a wide head under "auto"
    head_phase(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # 7. the blocked serving path
        blocked_kernels, blocked_models = blocked_phase(dev, card, model, x,
                                                        tmp)
        # 8. the blocked training path
        blocked_kernels += blocked_train_phase(dev, card, model, x,
                                               blocked_models, tmp)
    # 9. the edge-product probe
    edge_kernel = edge_phase(dev, card)
    # 10. coordination features in the unrolled kernels
    coordination_phase(dev)

    def alanine_bound(kind):
        b_ms, b_by = bound(BATCH * ALANINE_BYTES[kind],
                           BATCH * ALANINE_OPS[kind])
        return {"bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    src = "molann_tpu_torch/csrc/fused_unrolled.cu"
    src_train = "molann_tpu_torch/csrc/fused_train.cu"
    print(json.dumps({"kernels": [
        {"name": "cv_forces", "route": "cuda", "source": src,
         "replaces": "molann_tpu/ops/fused.py:1116",
         "launches": launches["cv_forces"],
         "max_abs_err": max_err["cv_forces"], "ms": ms_k4,
         "plain_ms": ms_p4, "alone_ms": split["cv_forces"][0],
         **alanine_bound("cv_forces")},
        {"name": "forward", "route": "cuda", "source": src,
         "replaces": "molann_tpu/ops/fused.py:578",
         "launches": launches["forward"],
         "max_abs_err": max_err["forward"], "ms": ms_k1,
         "plain_ms": ms_p1, "alone_ms": split["forward"][0],
         **alanine_bound("forward")},
        {"name": "backward", "route": "cuda", "source": src_train,
         "replaces": "molann_tpu/ops/fused.py:586",
         "launches": fit_launches["backward"],
         "max_abs_err": max_err["backward"], "ms": ms_k2,
         "plain_ms": ms_p2, "alone_ms": split["backward"][0],
         **alanine_bound("backward")},
        {"name": "train", "route": "cuda", "source": src_train,
         "replaces": "molann_tpu/ops/fused.py:900",
         "launches": fused_launches["train"],
         "max_abs_err": max_err["train"], "ms": ms_k3,
         "plain_ms": ms_p3, "alone_ms": split["train"][0],
         **alanine_bound("train")},
        *blocked_kernels,
        edge_kernel,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
