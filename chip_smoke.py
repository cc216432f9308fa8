#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Runs the port's serving path on the card and checks it, phase by phase:

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the CUDA kernels from ``molann_tpu_torch/csrc/``;
3. goldens: the fixture frame through the forward kernel (FeatureLayer
   only) must give d1 = [-1, 0], b1 = 1.5296831, a1 = -0.33281142 (1e-6);
4. kernels vs plain: both kernels against their plain PyTorch versions on
   8192 and 8191 alanine frames (a ragged tile), components None and 0,
   layouts [l, n, 3] and [3n, l]; values within 1e-5, gradients within
   2e-4·max(1, max|g|);
5. serving: 1,048,576 frames from a ``.npy`` file through
   ``serve.evaluate_trajectory`` with and without forces (16 batches of
   65536 each), checked on 4096 sampled rows, with each kernel's launch
   count over that run and the CUDA-event time of one 65536-frame batch;
   (b) the bench op as ``bench.py`` runs it, ``fused_cv_forces(model, x,
   tile=2048, transposed_input=True)``, on 1,048,576 ``[3n, l]`` frames made
   on the card from a seeded generator: 4096 sampled frames against the
   float64 plain version, a repeat to the same bits, the kernel's time
   alone, frames/s and its share of its bound (492 B a frame: the 18
   atoms the model reads, then gx and y);
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
   wrapper, and the host's share; K4's and K1's time by step
   (``probes/unrolled_probe.py phases``), their registers and warps an SM;
   (f) alanine with a gelu and with a swish
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
   at 4096 frames) and each kernel's bound; then the pair walk as compiled
   (SASS instructions a pair evaluation under a box, ``cuobjdump``), the
   pair evaluations a frame of the fluid needed and made, and K6's and K8's
   time by step (``probes/blocked_probe.py phases``) on both models. (a)
   and (b) also run alanine with a 12-layer head under ``mode="auto"``.

8. the blocked training path: (a) the blocked backward kernel (autograd
   through ``fused_model_forward``: gx in the layout of x, every weight,
   ``ref_x``) and the blocked train kernel (``train_ref`` False and, where
   the model aligns, True) against float64 plain versions on 8192 and 8191
   frames of the five models of phase 7 in each input layout, the backward
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
9. the edge-product probe: D prepared once (``prepare_edge_matrix``),
   every body of ``edge_mm`` against its plain version and float64, two
   launches to the same bits; then the probe's own run (T = 512, 64 tiles)
   with its launch count (every call of ``edge_mm`` it made) and, per body,
   the kernel alone (on one x, and on x rotated over four copies so that
   none is found in L2) and with its wrapper, its bound (x, out and the
   prepared form of D the body reads), the library call for the same
   function on both x (``torch.matmul`` float32, ``torch.sparse.mm`` on
   CSR, ``torch.mm`` to float32 and ``torch._int_mm`` after x's
   conversion; one that fails fails the phase), registers, shared memory
   and blocks an SM, and the preparation's time. A cold reading under the
   body's bound fails the phase; a warm reading (one x, which the 50 MB L2
   may keep) fails under its warm bound (out and D's form over HBM, or the
   operations: ``edge_mm_probe.body_bound``) or more than 25% under the
   CUDA-event time of 20 bare launches of the body on the same x, queued
   behind a spin of the card so that the events time the card and not the
   host's launch rate. Every profiler reading closes its trace with a spin
   timed by CUDA events too, and a trace whose spin is missing or more than
   10% off its events (the profiler's conversion of the card's timestamps
   is now and then off by one factor for a whole trace) or that dropped
   more than half of a kernel's launches is taken again
   (``edge_mm_probe.device_ms``; the retakes printed).
10. coordination features in the unrolled kernels: a 22-atom model with two
   coordination features (one under a box with ``d_max``), a bond and an
   aligned position through the forward, cv+forces, backward and train
   kernels against float64 plain versions.
11. the CV-learning objectives: ``molann_tpu_torch.cli.main(["train",
   ...])`` in process on the card for ``mse``, ``eigenfunction``,
   ``committor``, ``vamp``, ``autoencoder`` and ``tae`` (``--lag 10``),
   20 steps of 8192 frames each, ``committor`` once more with ``rmsprop``,
   ``warmup-cosine`` and ``--grad-clip 1``, and ``eigenfunction
   --ensemble 4 --bagging`` for 10 steps, on the full alanine model (weights
   from a seeded generator, saved to ``.npz``) and a 65,536-frame ``.npy``
   trajectory (``noisy_frames``' displacements filtered in time, AR(1) at
   0.95 a frame) with positive weights and basin labels from a numpy seed.
   Each run must exit 0, write a model that loads, log a finite loss at
   every step, step optimizers whose tensors are all on the card, and
   launch no fused kernel (the objectives are eager). Each objective's
   loss and parameter gradients (second order for the eigenfunction and
   committor losses) on the command's first batch are held against the
   eager float64 CPU version, the committee's mean and std against the
   same members on the CPU, and the weights the ``rmsprop`` run wrote
   against its 20 steps replayed with float64 on the CPU (the same
   optimizer, weights and batches). One JSON line per run: steps/s between the
   first and the last step's log line (each logged loss is a
   synchronise), the loss trace's ends, the errors, the diagnostics, and
   the first batch's loss and gradients alone: host-clock ms, the device
   ms and count of its kernels (``torch.profiler``), and their ratio, the
   device's busy share.
12. serving from trajectory files: the commands in process through
   ``molann_tpu_torch.cli.main``, each with every launch count set to 0
   before it and held to what its batches imply after it (K1 or K4 once a
   batch on alanine, K6 or K8 on the fluid and the sparse peptide, none for
   ``convert``, ``unwrap``, ``committee`` and ``info``). (a) ``forces`` and
   ``evaluate`` on 1,048,576 seeded alanine frames written as ``.dcd``,
   read by the native loader at the default batch size, bit-identical to
   ``serve.evaluate_trajectory`` on the same frames from ``.npy`` and held
   to the float64 plain version on 4096 rows, with frames/s end to end and
   the command's read / copy / kernel / store split; (b) 8,192 frames in
   ``.trr`` and ``.xtc`` (native loader, bit-identical to the numpy
   readers) and ``.nc`` (``--backend auto``) in batches of 3000, each
   bit-identical to the serve route on the decoded frames; ``convert``
   ``.dcd`` -> ``.xtc`` -> ``.npy`` with boxes; ``unwrap --mode
   whole+nojump`` on 8,192 alanine frames drifting through a 15 A box,
   against the same command with ``--device cpu``; a committee of four
   with ``--calibrate`` against the same members on the CPU; ``info``;
   (c) ``lj_fluid_model(5)``, 65,536 frames wrapped into its box as
   ``.trr``: ``forces --cull`` and ``evaluate --cull`` (the CullReport
   printed) against the unculled model's float64 plain version on 1024
   rows (the cull is exact under ``d_max`` while no atom moves past
   skin/2, which is checked), then ``unwrap --mode nojump`` against
   ``pbc.unwrap_time`` on the CPU; (d) the 2,000-atom sparse peptide,
   8,192 frames as ``.dcd``: ``forces`` through K8's compact gradients,
   inactive rows exactly 0, 512 rows against the float64 plain version.
13. the enhanced-sampling loop: ``sample`` in process on the card with the
   alanine model (seeded weights, saved as ``.npz``) and its PDB, each run
   with every launch count set to 0 before it and held after it to exactly
   what the run implies (K1 once a step and once a deposit, K2 once a step
   for metad and OPES; once a step each for steered; none without a bias;
   twice a step with ``--path --tube-k``). (a) metad, well-tempered metad,
   adaptive OPES, steered, and no bias (overdamped and BAOAB) at 4 and 256
   walkers: steps/s of the command, K1/K2 launches a step, kernels a step
   and the card's busy share (device time of a profiled 50-step run over
   the timed run's wall time a step), one JSON line each; (b) 200 steps of
   well-tempered metad through K1/K2 against the same run through the eager
   model on the card from the same seed of the CUDA generator, and 100
   steps with a ``[38, 65, 3]`` head through K6/K7 (also through the
   command), coordinates and deposits within 1e-4; neither run makes the
   host wait for the card (``torch.cuda.set_sync_debug_mode``), nor does a
   steered run, and adaptive OPES once (its count, read at the end); (c)
   the escape check of ``tests/test_cli.py`` (metad, 4000 steps, 3
   walkers, max cos(phi) > 0; no bias, 2000 steps, max cos(phi) < 0) on the
   model ``build`` makes from that test's features (without its MLP, whose
   JAX weights torch cannot draw); (d) ``fes`` of the metad run's hills on
   a 16^3 grid, ``mep`` on it between the start's CV and the flipped
   torsion's, and ``sample --path --tube-k`` along that path (deposits of
   the progress in [0, 1]); (e) ``evaluate`` and ``reweight`` on the metad
   run, ``msm`` on the 256-walker run's CVs, ``umbrella_sampling`` of 8
   windows (torsions rotated over [0, pi]) through K1/K2 and ``pmf`` on
   its samples.
14. the engine artifact: the op libraries (``csrc/torch_ops.cpp``, and
   ``csrc/torch_ops_cuda.cpp`` with ``csrc/torch_ops_launch.cpp`` over the
   kernel library) and the container ``serve_torch`` built with g++ side by
   side; for ``alanine_model()`` (unrolled: K1, K4), ``peptide_model(60)``
   and ``lj_fluid_model(5)`` (blocked: K6, K8; the fluid's pair operand a
   buffer of the artifact) the fused and eager artifacts, with and without
   the gradient, exported from a host copy of the model and loaded on the
   card: on 65,536 frames the fused artifact bit-identical to the Python
   route (``fused_model_forward``, ``fused_cv_forces``) with one launch of
   each op (``launch_counts()``), against the float32 plain versions on
   65,536 alanine, 8,192 peptide and 4,096 fluid frames (the float64
   error of both printed), the eager artifacts against the eager model;
   each op's CUDA-event time per 65,536 frames through the artifact and
   through the Python route, in turns; a fused artifact on CPU tensors
   raises; ``serve_torch`` on 1,048,576 alanine frames from ``.dcd``
   through the fused gradient artifact (K4 once a batch, ``--verbose``
   split and frames/s beside the ``forces`` command's on the same file)
   and on 131,072 peptide frames from ``.npy`` through the fused forward
   artifact (K6), each bit-identical to ``evaluate_trajectory``; without
   ``--ops`` the container refuses the fused artifact. The ``kernels``
   line gains ``artifact_launches``, ``artifact_ms``, ``route_ms`` and
   ``artifact_max_abs_err`` on K1, K4, K6 and K8 (K6/K8's times on the
   peptide).
15. data parallelism and multi-device serving
   (``molann_tpu_torch/probes/mesh_probe.py``, its ranks child processes
   under a timeout): (a) a world of one over NCCL
   (``initialize_multihost()``): ``make_fused_train_step(mesh)`` on ``[3n,
   l]`` (K3) and ``fit(fused_mse_loss, mesh=)`` (K1, K2), 10 Adam steps of
   65,536 alanine frames, the same two on ``peptide_model(60)`` (K5; K6,
   K7), 5 steps, and ``evaluate_trajectory(mesh=)`` of 1,048,576 alanine
   frames with and without forces (K4, K1) and of 131,072 peptide frames
   with forces (K8), all from ``.npy``: each the bits of the same call
   without a mesh; (b) two ranks sharing the card over gloo with CUDA
   tensors (NCCL refuses two ranks on one card): the same runs, 32,768
   frames a rank, the served rows into memmaps: both ranks hold the same
   bits after every step, losses within 1e-5 relative and weights within
   2e-4·max(1, max|w|) of the run of one rank (phase 11's rule for trained
   weights), served rows the bits of one rank's (each frame is computed
   alone), each rank's launches exactly its batches and steps, and a
   ``fit`` resumed from its step-5 checkpoint (written by rank 0 alone)
   repeats steps 6-10 bit for bit; a loss with a weight decay over the
   ``parameters()`` of the model it receives (``fit``, 10 steps, K1/K2)
   keeps those rules, one step of it counts the decay's gradient once on
   the two ranks (its share of the all-reduced gradient, within 1e-3) and
   gives the bits of the step without a mesh in the world of one, and a
   loss that reads the decay from the unwrapped model raises a
   ``RuntimeError`` naming ``ann_layers.layers.0.weight`` on both ranks
   and runs in the world of one; (c) ``forces --devices 2`` and ``train
   --devices 2 --loss eigenfunction`` (clamped to the cards there are,
   the ranks printed), and ``serve_torch`` on phase 14's ``.dcd`` through
   the fused gradient artifact with one and with two batches in flight
   (in turns: 1, 2, 2, 1), each bit-identical to phase 14's outputs,
   frames/s and the split printed. The ``kernels`` line gains
   ``mesh_launches`` on K1-K8: their launches over (a) and (b), every
   rank's.
16. the ten workflow examples (``molann_tpu_torch/examples/``) on the card,
   in a process of their own (``--phase 16``, after a warm-up of
   TorchScript and of a training step: the earlier phases' profiler
   traces slow a process's later launches), within a budget of 150 s:
   ``serve_biased_md`` at full size (4,096 frames from ``.dcd``; K4
   launched ``ceil(4096/1024)`` times and nothing else, its first batch
   against K4's plain version at the values and gradients tolerances
   below, outputs on the card),
   ``train_autoencoder_cv`` at full size (the loss falls tenfold; its
   engine artifact, loaded, gives the model's CVs and the forces of
   ``force_fn`` summed over the two CVs), ``condensed_phase_cv`` quick
   (``mode="blocked"``, K6 launched once, its parity under 1e-4, the
   shells' loss of neighbours, the held-out frames classified better than
   0.8), ``committor_cv`` and ``committee_uncertainty`` quick (their JAX
   tests' assertions), and the five long sampling examples at a cut depth
   (``EXAMPLE_STEPS``, printed): ``biased_dynamics`` and
   ``adaptive_cv_loop`` through ``main``, whose library calls are cut to
   that depth, ``train_eigenfunction_cv``, ``train_timelagged_cv`` and
   ``path_kinetics`` through their stage functions, called at that depth
   (the MSM of ``path_kinetics`` is host numpy and a cut run gives it too
   few transitions). The phase fails past its budget. Every dynamics
   stage's outputs stay on the card, finite,
   with one deposit a walker a period; the first stage of each kind is run
   again alone for its kernels a step and the card's busy share
   (``torch.profiler``) and for its host waits in one period and in two,
   which must be equal. One JSON line per example: wall seconds, each
   stage's seconds, steps and steps/s, kernels a step, busy share, K4/K6
   launches and the example's scalars. The ``kernels`` line gains
   ``examples_launches`` on K4 and K6.

17. the walkthrough: every ```python block of
   ``molann_tpu_torch/docs/quickstart.md``, verbatim, in one namespace in a
   temporary directory, on the card (the blocks name ``device =
   torch.device("cuda")`` once), within a budget of 60 s (its 4,000 steps
   of two-walker metadynamics along an eager dihedral CV are most of it, a
   host-bound loop of a few hundred small kernels a step): each block
   must run, the fit lower its loss, ``model.npz`` and the artifact
   ``model.pt`` be written, the model, the forces, the trajectory, the
   wrapped frames and the string stay on the card and be finite, and no
   fused kernel be launched (the blocks call the eager modules, as the JAX
   walkthrough reaches no Pallas kernel). The ``kernels`` line gains
   ``walkthrough_launches`` on every kernel.
18. K1-K4 at the edge of the unrolled envelope, in a process of its own
   (``--phase 18``), within a budget of 60 s:
   ``chignolin_model()`` (``scripts/tpu_validation.py``'s config 5: 50
   atoms, 85 columns, ``[85, 32, 2]``) and ``envelope_corner_model()`` (60
   atoms, 92 columns, 91 coordination pairs, ``[92, 64, 64, 64, 2]``),
   both routed to the unrolled kernels by ``mode="auto"``. K4 on config 5's
   2,048 frames, 8,191 frames (a ragged tile) and a 65,536-frame batch in
   ``[l, n, 3]`` and ``[3n, l]``, components None and 0; K1; K2 under
   autograd (gx, every weight, ``ref_x``); K3 in both layouts with and
   without ``ref_x``, then ``make_fused_train_step`` for 10 Adam steps (a
   lower loss), with the launch counts of that drive; each against its
   float64 plain version, then repeated to the same bits. One JSON line a
   model: each kernel's CUDA-event time on the batch beside its plain
   version's, its time alone (``torch.profiler``), its bound, the warps a
   block and blocks an SM of K1 and K4 and the frames a block of K2 and K3.
   The ``kernels`` line gains ``edge_models`` on K1-K4.

Every ``torch.profiler`` reading outside phase 9 (phases 5b, 6e, 11, 13,
16, 18) comes from a trace that opens with 16 short spins and closes with
a spin timed by CUDA events too, taken again where the closing spin is
missing or more than 10% off its events (``edge_mm_probe.clocked_trace``).
A trace that lost every opening spin lost its first launches: a kernel's
time alone (5b, 6e, 18) is then taken again (the last trace kept if none
caught its start), and is each kernel's mean over the launches caught
times its launches a call; a busy share and kernels a step (11, 13, 16)
keep the trace, as a lower bound. The retakes and kept traces are
printed before the ``kernels`` line.

Each kernel's bound is the larger of its bytes (every input coordinate
the model reads once, every output written once; for the unrolled kernels
``unrolled_probe.frame_bytes``) over 3.35 TB/s and the
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
(the per-frame float32 values differ from float64 by up to ~2e-7); phase
11's objectives: losses 1e-5 relative and parameter gradients
2e-4·max(1, max|g|) against float64 on the CPU, committee mean and std 1e-5,
the weights after the replayed steps 2e-4·max(1, max|w|); phase 12: the
commands' outputs bit-identical to the serve route where they run the same
kernel on the same frames, values and gradients against float64 plain
versions as above, ``unwrap`` on the card against the CPU 1e-5, the
calibrated committee against float64 on the CPU 1e-5·max(1, max|z|) (its
outputs are z-scores: a member's float32 rounding is divided by its sd);
phase 13: sampling through the kernels against the eager path on the card
1e-4 on coordinates and deposits (the same bar the CPU tests hold the port
to against JAX after at most 100 steps); phase 14: the fused artifact bit
for bit against the Python route and the container against
``evaluate_trajectory``, the fused artifact against the float32 plain
versions and the eager artifacts against the eager model at the values
and gradients tolerances above (the fluid's with its jump slack).
Prints one JSON line describing the kernels, then as its last line
``{"ok": true, "device": {...}}``. Any failure exits non-zero before that.
Imports no JAX. Usage: ``python3 chip_smoke.py`` runs every phase once.
``--phase 9``, ``--phase 16``, ``--phase 17`` or ``--phase 18`` runs the
build and that phase alone, and
``--repeat N`` runs phase 9 (or the phase named) N times, one JSON line a
run, stopping at the first failure. ``--k9-readings ROUNDS OUT`` runs
phases 1-8, then ``edge_mm_probe.readings(ROUNDS)`` written to OUT, then
phase 9 (``--repeat`` times), and stops.
"""

import copy
import functools
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

N_FRAMES = 1 << 20
BENCH_FRAMES = 1 << 20
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
# widths of a 12-layer head on alanine (the blocked kernels take any depth)
DEEP_HEAD = (8,) * 11 + (2,)
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
    from molann_tpu_torch.systems import (
        alanine_model,
        lj_fluid_model,
        peptide_model,
    )

    seed = torch.Generator().manual_seed(0)
    peptide, pu = peptide_model(60, generator=seed, device=dev)
    fluid, fu, _ = lj_fluid_model(5, generator=seed, device=dev)
    sparse, su = sparse_peptide_model(400, dev)
    deep, _ = alanine_model(hidden_dims=DEEP_HEAD, generator=seed, device=dev)
    if F.model_select_mode(peptide) != "blocked" or \
            F.model_select_mode(fluid) != "blocked" or \
            F.model_select_mode(deep) != "blocked":
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
    check(f"alanine, {len(DEEP_HEAD)}-layer head, mode='auto'", deep,
          x_alanine, (None, 0), ("[l, n, 3]", "[3n, l]"), VAL_TOL)
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
          f"(peptide_model(60), lj_fluid_model(5), alanine, alanine with a "
          f"{len(DEEP_HEAD)}-layer head, 2000-atom sparse peptide with "
          f"{len(active)} active atoms): max abs err forward "
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
    pair_walk(F, FB, card, {"peptide_model(60)": (peptide, pu, 0.05),
                            "lj_fluid_model(5)": (fluid, fu, LJ_SIGMA)})
    models = {"peptide_model(60)": (peptide, pu, paths["peptide_model(60)"]),
              "lj_fluid_model(5)": (fluid, fu, paths["lj_fluid_model(5)"]),
              "sparse": (sparse, su, None), "c_fluid": c_fluid,
              "deep": (deep, None, None)}
    return blocked_entries(launches, err, out, (
        ("blocked_forward", 1179), ("blocked_cv_forces", 1398))), models


def pair_walk(F, FB, card, models):
    """Phase 7d's second half: the pair walk as compiled (SASS instructions
    of a pair evaluation under a box, every such loop of the fluid's
    kernels), the pair evaluations a frame the function needs and the
    kernels make, and K6's and K8's time by step (``probes/blocked_probe.py
    phases``) on one batch of each model."""
    from molann_tpu_torch.ops import _build
    from molann_tpu_torch.probes import blocked_probe

    loops = blocked_probe.sass_pair_loops(_build.BUILD_INFO["path"])
    per_pair = {}
    for kernel, label in (("K6", "blocked_kernel<0,0,1>"),
                          ("K8", "blocked_kernel<1,0,1>")):
        found = loops.get(label)
        if not found:
            fail(f"no pair loop under a box in {label}'s SASS")
        per_pair[kernel] = sorted(round(n / p, 1) for n, p, _ in found)
    fluid = models["lj_fluid_model(5)"][0]
    lay = FB.blocked_layout(*F._extract_model(fluid)[:2])
    pairs = sum(lay.coord_npairs)
    print(f"the pair walk as compiled, SASS instructions a pair evaluation "
          f"under a box, each loop of the pair kernels (four pairs a loop "
          f"turn, the last group's loop apart): K6 {per_pair['K6']}, K8 "
          f"{per_pair['K8']}; pair evaluations a frame of lj_fluid_model(5): "
          f"needed {pairs} (each pair once, with its derivative for K8); "
          f"as written, K6 {pairs} (each pair from its owner) and K8 "
          f"{2 * pairs} (each pair from both its atoms)")
    blocked_probe.phases(F, FB, _build, {
        name: (model, noisy_frames(u, BATCH, 15, sigma, model_device(model)))
        for name, (model, u, sigma) in models.items()},
        kernels=("K6", "K8"))
    print(f"card: {card}")


def model_device(model):
    return next(model.parameters()).device


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
    check(f"alanine, {len(DEEP_HEAD)}-layer head", models["deep"][0],
          x_alanine, ("[l, n, 3]", "[3n, l]"))
    if not (F.KERNEL_LAUNCHES["blocked_backward"]
            and F.KERNEL_LAUNCHES["blocked_train"]):
        fail("a blocked training kernel was never launched")
    torch.cuda.synchronize()
    print(f"blocked training kernels vs float64 plain on {L} and {L - 1} "
          f"frames (peptide_model(60), lj_fluid_model(5), alanine with "
          f"train_ref, 2000-atom sparse peptide, alanine with a "
          f"{len(DEEP_HEAD)}-layer head; every layout): max abs err "
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
    prep = EP.prepare_edge_matrix(D)
    truth = D.double() @ x.double()
    top = float(truth.abs().max())
    errs, worst_plain = {}, 0.0
    for variant in EP.VARIANTS:
        got = EP.edge_mm(prep, x, variant)
        torch.cuda.synchronize()
        e_plain = float((got - EP.edge_mm_plain(D, x, variant)).abs().max())
        e_f64 = float((got.double() - truth).abs().max())
        if not (e_plain <= vs_plain * top and e_f64 <= vs_f64[variant] * top):
            fail(f"edge_mm {variant}: {e_plain / top} off its plain version, "
                 f"{e_f64 / top} off float64 (of max|truth|)")
        if not torch.equal(got, EP.edge_mm(prep, x, variant)):
            fail(f"two launches of edge_mm {variant} differ")
        errs[variant] = e_f64 / top
        worst_plain = max(worst_plain, e_plain)
    del truth, got
    reset_counts()
    res = EP.run_probe(T, reps)
    launches = dict(F.KERNEL_LAUNCHES)
    # every call of edge_mm the probe made (its own count, retaken traces
    # included) launched its kernel once
    made = {v: res[v]["launches"] for v in EP.VARIANTS}
    if launches != counts(edge_mm=sum(made.values())) or min(made.values()) < 1:
        fail(f"launch counts over the edge probe: {launches}, calls {made}")
    ms_plain = cuda_ms(lambda: EP.edge_mm_plain(D, x, "split3"), reps)
    m, k = D.shape
    n = x.shape[1]
    print(f"edge product D [{m}, {k}] @ x [{k}, {n}] (T = {T}, 64 tiles), "
          f"prepare_edge_matrix {res['prepare_ms']:.3f} ms once (host "
          f"clock); per body: kernel alone (torch.profiler) / with its "
          f"wrapper (CUDA events), ms, and alone on x rotated over "
          f"{EP.COLD_BUFFERS} copies (cold: no x left in L2); its bound and "
          f"what sets it; the library call for the same function, warm / "
          f"cold; registers, shared memory, blocks an SM; calls; error "
          f"against float64 (of max|truth|):")
    for v in EP.VARIANTS:
        r = res[v]
        # cold: no copy of x in L2, so the HBM bound of x, out and D is a
        # floor; warm: x may sit in the 50 MB L2, so only out, D and the
        # operations bound it, and the reading must agree with CUDA events
        # over 20 bare launches on the same x, queued ahead of the card
        if r["cold_ms"] < r["bound_ms"]:
            fail(f"edge_mm {v}: {r['cold_ms']} ms alone on a cold x, under "
                 f"its bound {r['bound_ms']}: a time the profiler cut short")
        if r["ms"] < r["warm_bound_ms"] or r["ms"] < 0.75 * r["bare_ms"]:
            fail(f"edge_mm {v}: {r['ms']} ms alone on a warm x, against its "
                 f"warm bound {r['warm_bound_ms']} and {r['bare_ms']} ms a "
                 f"bare launch by CUDA events: a time the profiler cut short")
        lib = ("none" if r["library"] is None
               else f"{r['library_ms']:.4f} / {r['library_cold_ms']:.4f} "
                    f"({r['library']})")
        rs = r["resources"]
        print(f"  {v}: {r['ms']:.4f} / {r['call_ms']:.4f} (bare launches "
              f"{r['bare_ms']:.4f}), cold {r['cold_ms']:.4f}; bound "
              f"{r['bound_ms']:.4f} ({r['bound_by']}, "
              f"{100 * r['bound_ms'] / r['cold_ms']:.1f}% of cold; warm bound "
              f"{r['warm_bound_ms']:.4f}, "
              f"{100 * r['warm_bound_ms'] / r['ms']:.1f}% of warm); library "
              f"{lib}; {rs['registers']} registers, {rs['smem']} B, "
              f"{rs['blocks_per_sm']} x {rs['threads']} threads an SM; "
              f"{r['launches']} calls; {errs[v]:.3g}")
    print(f"  torch.matmul float32 {res['library']['ms']:.4f}; plain split3 "
          f"{ms_plain:.4f}; worst distance of a body from its plain version "
          f"{worst_plain / top:.3g}; launches edge_mm {launches['edge_mm']}; "
          f"profiler traces taken again since the process began (clock off, "
          f"launches dropped): {json.dumps(EP.RETAKES)}, their spins' traced "
          f"over timed: {json.dumps(EP.CLOCK_RATIOS)}; card: {card}")
    return {"name": "edge_mm", "route": "cuda",
            "source": "molann_tpu_torch/csrc/edge_mm.cu",
            "replaces": "scripts/int8_mm_probe.py:70",
            "launches": launches["edge_mm"],
            "max_abs_err": max(errs[v] for v in ("f32", "split3", "fixed4",
                                                 "gather")) * top,
            "ms": res["split3"]["ms"], "plain_ms": ms_plain,
            "bound_ms": res["split3"]["bound_ms"],
            "bound_by": res["split3"]["bound_by"],
            "library_ms": res["library"]["ms"], "body": "split3",
            "bodies_ms": {v: res[v]["ms"] for v in EP.VARIANTS},
            "bodies_cold_ms": {v: res[v]["cold_ms"] for v in EP.VARIANTS},
            "bodies_call_ms": {v: res[v]["call_ms"] for v in EP.VARIANTS},
            "bodies_bound_ms": {v: res[v]["bound_ms"] for v in EP.VARIANTS},
            "bodies_warm_bound_ms": {v: res[v]["warm_bound_ms"]
                                     for v in EP.VARIANTS},
            "bodies_bare_ms": {v: res[v]["bare_ms"] for v in EP.VARIANTS},
            "bodies_library_ms": {v: res[v]["library_ms"]
                                  for v in EP.VARIANTS},
            "bodies_library_cold_ms": {v: res[v]["library_cold_ms"]
                                       for v in EP.VARIANTS},
            "prepare_ms": res["prepare_ms"],
            "trace_retakes": dict(EP.RETAKES)}


def k9_readings(rounds, path, card):
    """``edge_mm_probe.readings(rounds)`` in this process, after phases
    1-8, written to ``path``; its summary printed."""
    from molann_tpu_torch.probes import edge_mm_probe as EP

    res = EP.readings(rounds=rounds)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(res, f)
    print(json.dumps({"k9_readings": res["summary"], "card": card}))


# the retakes of every profiler reading outside phase 9 (whose own are
# edge_mm_probe.RETAKES): traces whose clock was off, and traces that lost
# their first launches (taken again by profiled_ms, kept by device_ms);
# and the off spins' traced over timed ratios
TRACE_RETAKES = {"clock": 0, "start_lost": 0}
TRACE_RATIOS = []


def profiled_ms(fn, pattern, calls=20):
    """``(alone, device)``: ms a call of the kernels whose name matches
    ``pattern``, and of all the call's device work, by ``torch.profiler``
    (``edge_mm_probe.clocked_trace``: a trace taken again where its clock
    is off or it lost its first launches), after one warm-up call."""
    from molann_tpu_torch.probes.edge_mm_probe import (
        clocked_trace,
        per_call_ms,
    )

    fn()
    launches = clocked_trace(fn, calls, retakes=TRACE_RETAKES,
                             ratios=TRACE_RATIOS, retake_start=True)
    return per_call_ms(launches, calls, pattern), per_call_ms(launches, calls)


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


def bench_op_phase(F, model, parts, u, dev, card):
    """Phase 5b: the bench op, ``fused_cv_forces(model, x, tile=2048,
    transposed_input=True)`` (``bench.py:44-54``), on ``BENCH_FRAMES``
    ``[3n, l]`` frames made on the card from a seeded generator: finite
    outputs of the expected shapes, ``SAMPLE_ROWS`` sampled frames against
    the float64 plain version, a repeat to the same bits, and the kernel's
    time alone, frames/s and share of its bound (the bytes a frame of
    ``unrolled_probe.frame_bytes``: the coordinates read, gx and y)."""
    from molann_tpu_torch.probes.unrolled_probe import frame_bytes

    n = u.atoms.n_atoms
    pos = torch.as_tensor(u.atoms.positions, dtype=torch.float32,
                          device=dev).reshape(3 * n, 1)
    gen = torch.Generator(device=dev).manual_seed(11)
    x = pos + 0.05 * torch.randn(3 * n, BENCH_FRAMES, generator=gen,
                                 device=dev)

    def op():
        return F.fused_cv_forces(model, x, tile=2048, transposed_input=True)

    y, g = op()
    y2, g2 = op()
    torch.cuda.synchronize()
    if y.shape != (3, BENCH_FRAMES) or g.shape != (3 * n, BENCH_FRAMES):
        fail(f"bench op output shapes {tuple(y.shape)}, {tuple(g.shape)}")
    if not (torch.isfinite(y).all() and torch.isfinite(g).all()):
        fail("non-finite bench op outputs")
    if not (torch.equal(y, y2) and torch.equal(g, g2)):
        fail("two launches of the bench op differ")
    rows = torch.as_tensor(np.sort(np.random.default_rng(12).choice(
        BENCH_FRAMES, SAMPLE_ROWS, replace=False)), device=dev)
    xs = x[:, rows].T.reshape(-1, n, 3)
    y_ref, g_ref = F.cv_forces_plain(*f64(parts), xs.double())
    ev = float((y[:, rows].T.double() - y_ref).abs().max())
    eg = float((g[:, rows].T.reshape(-1, n, 3).double() - g_ref).abs().max())
    if not (ev <= VAL_TOL and eg <= grad_tol(g_ref)):
        fail(f"bench op vs float64 plain on {SAMPLE_ROWS} sampled frames: "
             f"values {ev}, gradients {eg}")
    alone, _ = profiled_ms(op, r"fused_unrolled_kernel<(true|1)")
    event = cuda_ms(op, 20)
    n_bytes = frame_bytes(F, model, True, True, 3)
    b_ms, _ = bound(BENCH_FRAMES * n_bytes, 0)
    print(f"bench op on {BENCH_FRAMES} [3n, l] frames on the card: kernel "
          f"alone {alone:.4f} ms ({BENCH_FRAMES / alone * 1e3:.6g} frames/s, "
          f"{100 * b_ms / alone:.1f}% of its {b_ms:.4f} ms bound, "
          f"{n_bytes:g} B a frame), "
          f"{event:.4f} ms with the wrapper; {SAMPLE_ROWS} sampled frames vs "
          f"float64 plain: values {ev:.3g}, gradients {eg:.3g}; repeat "
          f"bit-identical; card: {card}")
    del x, y, g, y2, g2


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


OBJ_FRAMES = 1 << 16
OBJ_BATCH = 8192
OBJ_STEPS = 20
OBJ_ENSEMBLE_STEPS = 10
OBJ_LAG = 10
OBJ_AR = 0.95
OBJ_AR_NOISE = float(np.sqrt(1 - OBJ_AR ** 2))
# the train command's runs of phase 11: (name, the loss, its flags)
OBJ_RUNS = (
    ("mse", "mse", ["--targets", "{d}/targets.npy"]),
    ("eigenfunction", "eigenfunction", ["--weights", "{d}/weights.npy"]),
    ("committor", "committor", ["--labels", "{d}/labels.npy",
                                "--weights", "{d}/weights.npy"]),
    ("vamp", "vamp", ["--lag", str(OBJ_LAG)]),
    ("autoencoder", "autoencoder", ["--decoder-out", "{d}/decoder.npz"]),
    ("tae", "tae", ["--lag", str(OBJ_LAG)]),
    ("committor rmsprop warmup-cosine clip", "committor",
     ["--labels", "{d}/labels.npy", "--optimizer", "rmsprop",
      "--lr-schedule", "warmup-cosine", "--warmup-steps", "5",
      "--grad-clip", "1"]),
    ("eigenfunction committee", "eigenfunction",
     ["--ensemble", "4", "--bagging", "--steps", str(OBJ_ENSEMBLE_STEPS)]),
)


class _TimedLines:
    """A text stream that keeps each line written with the host's clock at
    its end (the train command prints a step's line after the step's loss
    has come back from the card)."""

    def __init__(self):
        self.lines = []
        self._part = ""

    def write(self, text):
        now = time.perf_counter()
        self._part += text
        while "\n" in self._part:
            line, self._part = self._part.split("\n", 1)
            self.lines.append((now, line))
        return len(text)

    def flush(self):
        pass


def objective_loss(loss, pair, batch):
    """The train command's loss for ``loss`` on one of its batches."""
    from molann_tpu_torch import train as T

    model, dec = pair
    if loss == "mse":
        return T.mse_loss(model, batch)
    if loss == "eigenfunction":
        return T.make_eigenfunction_loss(alpha=10.0)(model, batch)
    if loss == "committor":
        return T.make_committor_loss(alpha=100.0)(model, batch)
    if loss == "vamp":
        return T.make_vamp_loss()(model, batch)
    if loss == "autoencoder":
        x, w = batch
        return T.autoencoder_loss(model.ann_layers, dec,
                                  model.preprocessing_layer, x, weights=w)
    return T.timelagged_autoencoder_loss(model.ann_layers, dec,
                                         model.preprocessing_layer, *batch)


def objectives_phase(dev, card):
    """Phase 11: ``python -m molann_tpu_torch train`` in process for every
    objective on the full alanine model; prints one JSON line per run."""
    import contextlib

    from torch.optim.optimizer import register_optimizer_step_post_hook

    from molann_tpu_torch import train as T
    from molann_tpu_torch.cli import main as cli_main
    from molann_tpu_torch.io import load_model, save_model
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.systems import alanine_model

    records = []
    with tempfile.TemporaryDirectory() as d:
        model, u = alanine_model(generator=torch.Generator().manual_seed(20),
                                 device=dev)
        save_model(os.path.join(d, "model.npz"), model)
        # a trajectory: noisy_frames' displacements from the reference,
        # filtered in time (AR(1), 0.95 a frame) so that the lagged
        # objectives see correlation at the lag; the same spread per frame
        ref = u.atoms.positions[None].astype(np.float32)
        noise = noisy_frames(u, OBJ_FRAMES, 21, 0.05, dev).cpu().numpy() - ref
        frames = np.empty_like(noise)
        frames[0] = noise[0]
        for t in range(1, OBJ_FRAMES):
            frames[t] = OBJ_AR * frames[t - 1] + OBJ_AR_NOISE * noise[t]
        np.save(os.path.join(d, "traj.npy"), frames + ref)
        rng = np.random.default_rng(22)
        weights = rng.uniform(0.5, 2.0, OBJ_FRAMES).astype(np.float32)
        labels = rng.choice([0, 1, 2], OBJ_FRAMES, p=[0.5, 0.25, 0.25]
                            ).astype(np.int32)
        targets = rng.normal(size=(OBJ_FRAMES, 3)).astype(np.float32)
        if not ((labels == 1).any() and (labels == 2).any()):
            fail("phase 11: a basin is missing from the labels")
        for name, arr in (("weights", weights), ("labels", labels),
                          ("targets", targets)):
            np.save(os.path.join(d, f"{name}.npy"), arr)
        ds = T.TrajectoryDataset(os.path.join(d, "traj.npy"))

        def first_batch(loss, use_weights):
            """The command's first batch, on the card."""
            if loss in ("vamp", "tae"):
                b = next(T.lagged_pair_iterator(ds, OBJ_BATCH, OBJ_LAG,
                                                seed=0))
                return tuple(torch.as_tensor(a, device=dev) for a in b)
            x, idx = next(T.batch_iterator(ds, OBJ_BATCH, seed=0,
                                           return_indices=True))
            side = {"mse": [targets[idx]],
                    "committor": [labels[idx]]}.get(loss, [])
            if use_weights:
                side.append(weights[idx])
            if not side:
                return torch.as_tensor(x, device=dev)
            return tuple(torch.as_tensor(a, device=dev) for a in (x, *side))

        devices = set()
        hook = register_optimizer_step_post_hook(
            lambda opt, args, kwargs: devices.update(
                p.device.type for g in opt.param_groups for p in g["params"]))
        try:
            for name, loss, flags in OBJ_RUNS:
                flags = [f.format(d=d) for f in flags]
                out = os.path.join(d, f"{loss}_{len(records)}.npz")
                argv = ["train", os.path.join(d, "model.npz"),
                        os.path.join(d, "traj.npy"), "--loss", loss,
                        "--steps", str(OBJ_STEPS), "--batch-size",
                        str(OBJ_BATCH), "--log-every", "1", "--device",
                        dev.type, "--out", out, *flags]
                stream = _TimedLines()
                devices.clear()
                reset_counts()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with contextlib.redirect_stdout(stream):
                    rc = cli_main(argv)
                torch.cuda.synchronize()
                t_run = time.perf_counter() - t0
                launched = dict(F.KERNEL_LAUNCHES)
                if rc != 0:
                    fail(f"phase 11, {name}: the train command returned {rc}")
                if launched != counts():
                    fail(f"phase 11, {name}: the eager objectives launched "
                         f"fused kernels: {launched}")
                if devices != {dev.type}:
                    fail(f"phase 11, {name}: parameters trained on "
                         f"{sorted(devices)}, not on the card")
                steps = [(t, float(line.split("loss=")[1].split()[0]))
                         for t, line in stream.lines
                         if line.startswith("step ")]
                n_steps = OBJ_ENSEMBLE_STEPS if "--ensemble" in flags \
                    else OBJ_STEPS
                losses = [v for _, v in steps]
                if len(losses) != n_steps or not np.isfinite(losses).all():
                    fail(f"phase 11, {name}: losses {losses}")
                steps_per_s = (n_steps - 1) / (steps[-1][0] - steps[0][0])
                if "--ensemble" in flags:
                    stem = out[:-len(".npz")]
                    members = [load_model(f"{stem}.member{i}.npz", device=dev)
                               for i in range(4)]
                    x = first_batch(loss, False)[:SAMPLE_ROWS]
                    with torch.no_grad():
                        mean, std = T.committee(members, x)
                        members64 = [load_model(f"{stem}.member{i}.npz",
                                                device="cpu").double()
                                     for i in range(4)]
                        mean64, std64 = T.committee(members64,
                                                    x.double().cpu())
                    err = max(float((mean.double().cpu() - mean64).abs().max()),
                              float((std.double().cpu() - std64).abs().max()))
                    if not err <= VAL_TOL:
                        fail(f"phase 11, {name}: committee on the card vs "
                             f"float64 on the CPU: {err}")
                    if not float(std.max()) > 0:
                        fail(f"phase 11, {name}: the members agree exactly")
                    rec = {"committee_max_abs_err": err}
                else:
                    load_model(out, device=dev)
                    if "--decoder-out" in flags:
                        load_model(flags[flags.index("--decoder-out") + 1],
                                   device=dev)
                    rec = plain_check(name, loss, flags, d, dev, first_batch)
                    if "--optimizer" in flags:
                        rec.update(optimizer_replay(name, argv, out, d,
                                                    labels, ds))
                records.append({
                    "objective": name, "steps": n_steps,
                    "steps_per_s": steps_per_s, "run_s": t_run,
                    "loss_first": losses[0], "loss_last": losses[-1],
                    **rec, "launches": sum(launched.values()),
                    "diagnostics": stream.lines[-1][1], "card": card})
                print(json.dumps(records[-1]))
        finally:
            hook.remove()


def step_profile(fn, calls=3):
    """One call of ``fn`` on the card: its time on the host's clock up to a
    synchronise, the device time of its kernels (``torch.profiler``) and
    their count, each a call's mean."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls * 1e3
    busy, kernels, _ = device_ms(lambda: [fn() for _ in range(calls)])
    return {"step_wall_ms": wall, "step_device_ms": busy / calls,
            "step_kernels": kernels / calls,
            "device_busy": busy / calls / wall}


def plain_check(name, loss, flags, d, dev, first_batch):
    """The objective's loss and parameter gradients on the command's first
    batch, on the card, against the eager float64 CPU version."""
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.models.ann import create_sequential_nn

    model = load_model(os.path.join(d, "model.npz"), device=dev)
    dec = create_sequential_nn([3, 38],
                               generator=torch.Generator().manual_seed(1),
                               device=dev)
    batch = first_batch(loss, "--weights" in flags)
    if loss == "autoencoder" and not isinstance(batch, tuple):
        batch = (batch, None)
    pair = (model, dec)
    params = [p for m in pair for p in m.parameters()]
    got = objective_loss(loss, pair, batch)
    grads = torch.autograd.grad(got, params, allow_unused=True)
    pair64 = tuple(copy.deepcopy(m).to("cpu", torch.float64) for m in pair)
    params64 = [p for m in pair64 for p in m.parameters()]

    def to64(a):
        if a is None or not a.is_floating_point():
            return None if a is None else a.cpu()
        return a.double().cpu()

    batch64 = (tuple(to64(a) for a in batch) if isinstance(batch, tuple)
               else to64(batch))
    want = objective_loss(loss, pair64, batch64)
    grads64 = torch.autograd.grad(want, params64, allow_unused=True)
    rel = abs(got.item() - want.item()) / abs(want.item())
    if not rel <= LOSS_RTOL:
        fail(f"phase 11, {name}: loss on the card {got.item()} vs float64 "
             f"{want.item()}")
    pairs = [(g, r) for g, r in zip(grads, grads64) if r is not None]
    if any(g is None for g, _ in pairs):
        fail(f"phase 11, {name}: a parameter lost its gradient on the card")
    got_g, want_g = [g for g, _ in pairs], [r.to(dev) for _, r in pairs]
    # the step's loss and gradients alone (no fetch, no optimizer)
    prof = step_profile(lambda: torch.autograd.grad(
        objective_loss(loss, pair, batch), params, allow_unused=True))
    return {**prof, "loss_rel_err": rel,
            "grad_max_abs_err": worst(got_g, want_g,
                                      f"phase 11, {name}, gradients"),
            "grad_rel_err": rel_err(got_g, want_g)}


def optimizer_replay(name, argv, out, d, labels, ds):
    """The committor run's steps again with float64 on the CPU: the same
    optimizer from the same flags, the same weights and the same batches
    (the command's ``(x, labels)`` from ``batch_iterator``). The weights
    the card wrote must agree with the replay's within the gradient
    tolerance."""
    import argparse

    from molann_tpu_torch import train as T
    from molann_tpu_torch.cli import train as CT
    from molann_tpu_torch.io import load_model

    p = argparse.ArgumentParser()
    CT.register(p.add_subparsers())
    args = p.parse_args(argv)
    if args.loss != "committor" or args.weights:
        fail(f"phase 11, {name}: the replay makes the committor's (x, "
             f"labels) batches only")
    model = load_model(os.path.join(d, "model.npz"), device="cpu").double()
    batches = ((torch.as_tensor(x, dtype=torch.float64),
                torch.as_tensor(labels[idx]))
               for x, idx in T.batch_iterator(ds, args.batch_size,
                                              seed=args.seed,
                                              return_indices=True))
    res = T.fit(model, lambda m, b: objective_loss(args.loss, (m, None), b),
                batches, optimizer=CT._make_optimizer(args),
                num_steps=args.steps)
    want = res.model.state_dict()
    got = load_model(out, device="cpu").state_dict()
    if list(got) != list(want):
        fail(f"phase 11, {name}: the written model's tensors {list(got)} "
             f"are not the replay's {list(want)}")
    got, want = list(got.values()), list(want.values())
    return {"replay_weights_max_abs_err": worst(
                got, want, f"phase 11, {name}, weights against the float64 "
                           f"replay"),
            "replay_weights_rel_err": rel_err(got, want)}


FILE_FRAMES = 1 << 20     # alanine, as .dcd, through forces and evaluate
FORMAT_FRAMES = 8192      # alanine in .trr, .xtc and .nc; unwrap; committee
FORMAT_BATCH = 3000       # three batches, the last one short
FILE_LJ_FRAMES = 1 << 16  # the fluid with --cull, then unwrap nojump
FILE_LJ_SIGMA = 0.05
FILE_LJ_ROWS = 1024       # the fluid's rows held to the float64 plain version
SPARSE_FRAMES = 8192      # the 2,000-atom sparse peptide, compact gradients
SPARSE_ROWS = 512
UNWRAP_BOX = 15.0         # the alanine frames' cubic box, Angstrom


def run_cli(argv, expect):
    """``molann_tpu_torch.cli.main(argv)`` in process with every launch
    count set to 0 first; fails unless it returns 0 and launched exactly
    ``expect`` (``counts(...)``). Returns ``(stdout, stderr, seconds)``."""
    import contextlib
    import io

    from molann_tpu_torch.cli import main as cli_main
    from molann_tpu_torch.ops.fused import KERNEL_LAUNCHES

    out, err = io.StringIO(), io.StringIO()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli_main(argv)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    got = dict(KERNEL_LAUNCHES)
    if rc != 0:
        fail(f"{' '.join(argv[:1])} exited {rc}: {err.getvalue()[-2000:]}")
    if got != expect:
        fail(f"launch counts of `{' '.join(argv)}`: {got}, expected {expect}")
    return out.getvalue(), err.getvalue(), seconds


def timing_line(err):
    """The ``timing:`` line a serving command prints with ``--verbose``."""
    lines = [ln for ln in err.splitlines() if ln.startswith("timing:")]
    if len(lines) != 1:
        fail(f"no timing line in the command's stderr: {err[-500:]}")
    return lines[0][len("timing: "):]


def same_bits(got, want, what):
    if not np.array_equal(got, want):
        fail(f"{what}: not bit-identical (max abs difference "
             f"{float(np.abs(got - want).max())})")


def held_to_plain(F, model, frames, cvs, forces, rows, what, tol=VAL_TOL,
                  fluid=False):
    """Rows ``rows`` of a command's outputs (``forces`` = -gradient, ``[l,
    3n]``, or None) against the float64 plain version of ``model``; the
    fluid's gradients with the jump slack of phase 7. Returns the errors."""
    from molann_tpu_torch.ops import fused_blocked as FB

    dev = model_device(model)
    parts = F._extract_model(model)
    n = parts[0].n_input_atoms
    xr = torch.as_tensor(np.asarray(frames[rows]), device=dev).double()
    blocked = F.model_select_mode(model) == "blocked"
    plain = FB.blocked_cv_forces_plain if blocked else F.cv_forces_plain
    y_ref, g_ref = plain(*f64(parts), xr)
    y_ref, g_ref = y_ref.cpu().numpy(), g_ref.cpu().numpy()
    ev = float(np.abs(cvs[rows] - y_ref).max())
    if not ev <= tol:
        fail(f"{what}: values {ev} off the float64 plain version")
    if forces is None:
        return ev, None
    g = -np.asarray(forces[rows]).reshape(len(rows), n, 3)
    err = np.abs(g - g_ref).max(axis=-1)
    slack = (FB.gradient_jump_slack(parts[0], parts[3], xr).cpu().numpy()
             if fluid else np.zeros_like(err))
    over = float((err - slack).max())
    tol_g = GRAD_RTOL * max(1.0, float(np.abs(g_ref).max()))
    if not over <= tol_g:
        fail(f"{what}: gradients {over} past the slack, tolerance {tol_g}")
    return ev, float(err[slack == 0].max())


def wrapped_alanine(u, l, seed):
    """``(frames, boxes)``: ``l`` noisy alanine frames drifting by a random
    walk through a cubic box of :data:`UNWRAP_BOX`, each atom wrapped into
    it, so that molecules break across the faces and jump between frames."""
    rng = np.random.default_rng(seed)
    n = u.atoms.n_atoms
    drift = np.cumsum(rng.normal(scale=0.4, size=(l, 1, 3)), axis=0)
    x = (u.atoms.positions[None] + drift
         + 0.05 * rng.normal(size=(l, n, 3))).astype(np.float32)
    x = np.mod(x, np.float32(UNWRAP_BOX)).astype(np.float32)
    boxes = np.broadcast_to(np.diag([UNWRAP_BOX] * 3).astype(np.float32),
                            (l, 3, 3)).copy()
    return x, boxes


def files_phase(dev, card, tmp):
    """Phase 12: serving from trajectory files through the commands, in
    process. Returns ``{kernel: launches over the commands}``."""
    from molann_tpu_torch import pbc
    from molann_tpu_torch.io import (DCDWriter, load_model, save_model,
                                     write_dcd, write_netcdf, write_trr,
                                     write_xtc)
    from molann_tpu_torch.io.reader import open_frame_reader, read_traj_boxes
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.systems import (alanine_model, alanine_pdb_text,
                                          lj_fluid_model)
    from molann_tpu_torch.train import (calibrated_committee,
                                        committee_calibration, stack_models)

    def p(name):
        return os.path.join(tmp, name)

    launched = dict.fromkeys(("forward", "cv_forces", "blocked_forward",
                              "blocked_cv_forces"), 0)

    def tally(expect):
        for k in launched:
            launched[k] += expect[k]
        return expect

    lines = []
    model, u = alanine_model(generator=torch.Generator().manual_seed(21),
                             device=dev)
    save_model(p("ala.npz"), model)
    n = u.atoms.n_atoms
    with open(p("ala.pdb"), "w") as fh:
        fh.write(alanine_pdb_text())

    # (a) 1,048,576 alanine frames as .dcd (and as .npy for the serve route)
    rng = np.random.default_rng(22)
    frames = np.lib.format.open_memmap(p("ala.npy"), mode="w+",
                                       dtype=np.float32,
                                       shape=(FILE_FRAMES, n, 3))
    with DCDWriter(p("ala.dcd")) as w:
        for s in range(0, FILE_FRAMES, BATCH):
            blk = (u.atoms.positions[None] + 0.05 * rng.normal(
                size=(BATCH, n, 3))).astype(np.float32)
            frames[s:s + BATCH] = blk
            w.append(blk)
    frames.flush()
    one = counts(cv_forces=1)
    _, err, t_f = run_cli(["forces", p("ala.npz"), p("ala.dcd"), "--out",
                           p("y.npy"), "--forces-out", p("f.npy"),
                           "--backend", "native", "--verbose"], tally(one))
    split_f = timing_line(err)
    _, err, t_e = run_cli(["evaluate", p("ala.npz"), p("ala.dcd"), "--out",
                           p("ye.npy"), "--backend", "native", "--verbose"],
                          tally(counts(forward=1)))
    split_e = timing_line(err)
    y, f, ye = np.load(p("y.npy")), np.load(p("f.npy")), np.load(p("ye.npy"))
    if not (np.isfinite(y).all() and np.isfinite(f).all()
            and y.shape == (FILE_FRAMES, 3) and f.shape == (FILE_FRAMES,
                                                            3 * n)):
        fail(f"alanine command outputs {y.shape}, {f.shape}")
    cvs, grads = evaluate_trajectory(model, p("ala.npy"), forces=True,
                                     batch_size=FILE_FRAMES)
    cvs_e = evaluate_trajectory(model, p("ala.npy"), batch_size=FILE_FRAMES)
    # same kernel, same frames, same batch and layout: the same bits
    same_bits(y, cvs, "forces .dcd vs serve .npy, values")
    same_bits(f, -grads.reshape(FILE_FRAMES, 3 * n),
              "forces .dcd vs serve .npy, forces")
    same_bits(ye, cvs_e, "evaluate .dcd vs serve .npy")
    rows = np.sort(np.random.default_rng(23).choice(FILE_FRAMES, SAMPLE_ROWS,
                                                    replace=False))
    ev, eg = held_to_plain(F, model, frames, y, f, rows, "alanine forces")
    ev_e, _ = held_to_plain(F, model, frames, ye, None, rows,
                            "alanine evaluate")
    lines.append(
        f"alanine {FILE_FRAMES} frames from .dcd (native loader), one batch: "
        f"forces {FILE_FRAMES / t_f:.6g} frames/s end to end ({split_f}), "
        f"evaluate {FILE_FRAMES / t_e:.6g} frames/s ({split_e}); outputs "
        f"bit-identical to serve.evaluate_trajectory from .npy; "
        f"{SAMPLE_ROWS} rows against float64 plain: values "
        f"{max(ev, ev_e):.3g}, gradients {eg:.3g}")
    del frames, y, f, ye, cvs, grads, cvs_e

    # (b) the other formats, 8,192 frames each; convert; committee; info
    rng = np.random.default_rng(24)
    small = (u.atoms.positions[None] + 0.05 * rng.normal(
        size=(FORMAT_FRAMES, n, 3))).astype(np.float32)
    write_trr(p("ala.trr"), small)
    write_xtc(p("ala.xtc"), small)
    write_netcdf(p("ala.nc"), small)
    fmt = []
    n_batches = -(-FORMAT_FRAMES // FORMAT_BATCH)
    for ext, backend in (("trr", "native"), ("xtc", "native"),
                         ("nc", "auto")):
        path = p(f"ala.{ext}")
        read, l, _ = open_frame_reader(path, backend="numpy")
        decoded = read(0, l)
        read.close()
        if ext != "nc":
            read, _, _ = open_frame_reader(path, backend="native")
            same_bits(read(0, l), decoded, f".{ext} native vs numpy reader")
            read.close()
        if ext != "xtc":  # XTC keeps 1/1000 nm: its frames are decoded
            same_bits(decoded, small, f".{ext} frames read back")
        np.save(p(f"dec_{ext}.npy"), decoded)
        run_cli(["forces", p("ala.npz"), path, "--out", p("y.npy"),
                 "--forces-out", p("f.npy"), "--batch-size",
                 str(FORMAT_BATCH), "--backend", backend],
                tally(counts(cv_forces=n_batches)))
        y, f = np.load(p("y.npy")), np.load(p("f.npy"))
        cvs, grads = evaluate_trajectory(model, p(f"dec_{ext}.npy"),
                                         forces=True,
                                         batch_size=FORMAT_BATCH)
        same_bits(y, cvs, f"forces .{ext} vs serve .npy, values")
        same_bits(f, -grads.reshape(l, 3 * n),
                  f"forces .{ext} vs serve .npy, forces")
        fmt.append(f".{ext} ({backend})")
    lines.append(f"alanine {FORMAT_FRAMES} frames in {n_batches} batches "
                 f"(the last short) from " + ", ".join(fmt) + ": forces "
                 "bit-identical to serve.evaluate_trajectory from the "
                 "decoded frames; native and numpy readers bit-identical")

    # convert .dcd -> .xtc -> .npy, boxes kept
    wx, wboxes = wrapped_alanine(u, FORMAT_FRAMES, 25)
    write_dcd(p("wrapped.dcd"), wx, cell=pbc.box_to_dcd_cell(wboxes))
    zero = counts()
    run_cli(["convert", p("wrapped.dcd"), p("wrapped.xtc")], zero)
    run_cli(["convert", p("wrapped.xtc"), p("wrapped_x.npy")], zero)
    xtc_boxes = read_traj_boxes(p("wrapped.xtc"))
    if xtc_boxes is None or np.abs(xtc_boxes - wboxes).max() > 1e-4:
        fail("convert .dcd -> .xtc lost the boxes")
    read, _, _ = open_frame_reader(p("wrapped.xtc"), backend="numpy")
    same_bits(np.load(p("wrapped_x.npy")), read(0, FORMAT_FRAMES),
              "convert .xtc -> .npy")
    read.close()
    if np.abs(np.load(p("wrapped_x.npy")) - wx).max() > 6e-3:
        fail("convert .dcd -> .xtc -> .npy moved frames past XTC's 1/1000 nm")

    # unwrap whole+nojump on the card against the same command on the CPU
    outs = {}
    for device in ("cuda", "cpu"):
        out, _, _ = run_cli(["unwrap", p("wrapped.dcd"), p("ala.pdb"),
                             p(f"unwrapped_{device}.npy"), "--mode",
                             "whole+nojump", "--device", device], zero)
        outs[device] = out.strip().splitlines()[-1]
    un_c = np.load(p("unwrapped_cuda.npy"))
    un_h = np.load(p("unwrapped_cpu.npy"))
    e_unwrap = float(np.abs(un_c - un_h).max())
    if outs["cuda"].split("(")[1] != outs["cpu"].split("(")[1] or \
            not e_unwrap <= VAL_TOL:
        fail(f"unwrap on the card vs the CPU: {outs} (max abs {e_unwrap})")
    bond = max(float(np.linalg.norm(un_c[:, i] - un_c[:, j], axis=-1).max())
               for i, j in pbc.guess_bonds(u))
    if bond > 2.0:
        fail(f"unwrap left a bond of {bond} A")

    # a committee of four with --calibrate, against the same on the CPU
    paths = []
    for k in range(4):
        m, _ = alanine_model(generator=torch.Generator().manual_seed(30 + k),
                             device=dev)
        save_model(p(f"member{k}.npz"), m)
        paths.append(p(f"member{k}.npz"))
    out, _, _ = run_cli(["committee", *paths, p("ala.trr"), "--calibrate",
                         p("dec_trr.npy"), "--out", p("cm.npy"), "--std-out",
                         p("cs.npy"), "--batch-size", str(FORMAT_BATCH),
                         "--backend", "native"], zero)
    members = stack_models([load_model(q, device="cpu").double()
                            for q in paths])
    # the command's calibration frames: 4,096 evenly spaced (its default)
    sel = np.unique(np.linspace(0, FORMAT_FRAMES - 1,
                                min(FORMAT_FRAMES, 4096)).astype(int))
    x64 = torch.as_tensor(small).double()
    with torch.no_grad():
        calib = committee_calibration(members, x64[sel])
        m_ref, s_ref = calibrated_committee(members, x64, calibration=calib)
    # calibrated outputs are z-scores over the reference frames: float32
    # rounding of a member's output is scaled by 1/sd, so the tolerance is
    # 1e-5 of the z-scores' scale
    scale_c = max(1.0, float(m_ref.abs().max()), float(s_ref.abs().max()))
    e_comm = max(float(np.abs(np.load(p("cm.npy")) - m_ref.numpy()).max()),
                 float(np.abs(np.load(p("cs.npy")) - s_ref.numpy()).max()))
    if not e_comm <= VAL_TOL * scale_c:
        fail(f"committee on the card vs float64 on the CPU: {e_comm}, "
             f"outputs up to {scale_c}")
    info, _, _ = run_cli(["info", p("ala.npz")], zero)
    if "model: MolANN" not in info or "MLP dims: [38, 5, 3]" not in info:
        fail(f"info printed {info!r}")
    lines.append(
        f"convert .dcd -> .xtc -> .npy with boxes; unwrap whole+nojump on "
        f"{FORMAT_FRAMES} frames in a {UNWRAP_BOX} A box, card vs --device "
        f"cpu max abs {e_unwrap:.3g}, '{outs['cuda']}', longest bond after "
        f"{bond:.3f} A; committee of 4 --calibrate vs float64 on the CPU "
        f"{e_comm:.3g} (z-scores up to {scale_c:.3g}); "
        f"info; no kernel launched by these")

    # (c) the fluid with --cull, then unwrap nojump on the wrapped frames
    fluid, fu, lengths = lj_fluid_model(
        5, generator=torch.Generator().manual_seed(26), device=dev)
    save_model(p("lj.npz"), fluid)
    nf = fu.atoms.n_atoms
    box = np.diag(lengths).astype(np.float32)
    ref = fu.atoms.positions.astype(np.float32)
    np.save(p("lj_ref.npy"), ref)
    rng = np.random.default_rng(27)
    lj = np.concatenate([(ref[None] + FILE_LJ_SIGMA * rng.normal(
        size=(min(BATCH, FILE_LJ_FRAMES - s), nf, 3))).astype(np.float32)
        for s in range(0, FILE_LJ_FRAMES, BATCH)])
    lj = pbc.wrap(torch.as_tensor(lj), torch.as_tensor(box)).numpy()
    lj_boxes = np.broadcast_to(box, (FILE_LJ_FRAMES, 3, 3))
    write_trr(p("lj.trr"), lj, box=lj_boxes)
    from molann_tpu_torch.ops.neighbor import max_displacement

    disp = max_displacement(ref, lj, box)
    if not disp <= 0.5:
        fail(f"fluid frames move {disp} A from the cull reference, past "
             "skin/2")
    cull = ["--cull", "--cull-ref", p("lj_ref.npy"), "--skin", "1.0",
            "--backend", "native", "--verbose"]
    out, err, t_lf = run_cli(["forces", p("lj.npz"), p("lj.trr"), "--out",
                              p("ly.npy"), "--forces-out", p("lf.npy"),
                              *cull], tally(counts(blocked_cv_forces=1)))
    report = [ln for ln in out.splitlines() if ln.startswith("CullReport[")]
    split_lf = timing_line(err)
    _, err, t_le = run_cli(["evaluate", p("lj.npz"), p("lj.trr"), "--out",
                            p("lye.npy"), *cull],
                           tally(counts(blocked_forward=1)))
    if len(report) != 1:
        fail(f"forces --cull printed no CullReport: {out!r}")
    ly, lf, lye = np.load(p("ly.npy")), np.load(p("lf.npy")), np.load(
        p("lye.npy"))
    rows = np.sort(np.random.default_rng(28).choice(
        FILE_LJ_FRAMES, FILE_LJ_ROWS, replace=False))
    ev_l, eg_l = held_to_plain(F, fluid, lj, ly, lf, rows,
                               "fluid forces --cull", tol=VAL_TOL_PAIRS,
                               fluid=True)
    ev_le, _ = held_to_plain(F, fluid, lj, lye, None, rows,
                             "fluid evaluate --cull", tol=VAL_TOL_PAIRS)
    out, _, t_un = run_cli(["unwrap", p("lj.trr"), p("ala.pdb"),
                            p("lj_un.npy"), "--mode", "nojump"], zero)
    un_ref = pbc.unwrap_time(torch.as_tensor(lj),
                             torch.as_tensor(np.ascontiguousarray(lj_boxes)),
                             device="cpu").numpy()
    e_lun = float(np.abs(np.load(p("lj_un.npy")) - un_ref).max())
    if not e_lun <= VAL_TOL:
        fail(f"unwrap nojump on the card vs unwrap_time on the CPU: {e_lun}")
    lines.append(
        f"lj_fluid_model(5) {FILE_LJ_FRAMES} frames from .trr, wrapped into "
        f"its box, max displacement {disp:.3f} A from the reference: "
        f"{report[0]}; forces --cull {FILE_LJ_FRAMES / t_lf:.6g} frames/s "
        f"({split_lf}), evaluate --cull {FILE_LJ_FRAMES / t_le:.6g} "
        f"frames/s; against the unculled model's float64 plain version on "
        f"{FILE_LJ_ROWS} rows: values {max(ev_l, ev_le):.3g}, gradients {eg_l:.3g}; "
        f"unwrap nojump {t_un:.3g} s, vs unwrap_time on the CPU {e_lun:.3g}")
    del lj, ly, lf, lye, un_ref

    # (d) the 2,000-atom sparse peptide: compact gradients
    sparse, su = sparse_peptide_model(400, dev)
    save_model(p("sparse.npz"), sparse)
    ns = su.atoms.n_atoms
    active = F.active_atom_indices(sparse)
    if active is None:
        fail("the sparse peptide has no active-atom compaction")
    sx = noisy_frames(su, SPARSE_FRAMES, 29, 0.05, "cpu").numpy()
    write_dcd(p("sparse.dcd"), sx)
    run_cli(["forces", p("sparse.npz"), p("sparse.dcd"), "--out",
             p("sy.npy"), "--forces-out", p("sf.npy"), "--backend",
             "native"], tally(counts(blocked_cv_forces=1)))
    sy, sf = np.load(p("sy.npy")), np.load(p("sf.npy"))
    inactive = np.setdiff1d(np.arange(ns), active)
    if np.any(sf.reshape(-1, ns, 3)[:, inactive] != 0.0):
        fail("the sparse peptide's inactive atoms have non-zero forces")
    rows = np.sort(np.random.default_rng(30).choice(
        SPARSE_FRAMES, SPARSE_ROWS, replace=False))
    ev_s, eg_s = held_to_plain(F, sparse, sx, sy, sf, rows,
                               "sparse peptide forces (compact)")
    lines.append(
        f"sparse peptide ({ns} atoms, {len(active)} active) "
        f"{SPARSE_FRAMES} frames from .dcd: forces through the compact "
        f"route, inactive rows exactly 0, {SPARSE_ROWS} rows against "
        f"float64 plain: "
        f"values {ev_s:.3g}, gradients {eg_s:.3g}")
    lines.append("launches over the commands: " + json.dumps(launched))
    print("serving from trajectory files (phase 12): " + "; ".join(lines)
          + f"; card: {card}")
    return launched


# the enhanced-sampling loop of phase 13: walkers and steps of the timed runs
SAMPLE_WALKERS = (4, 256)
SAMPLE_STEPS = {4: 250, 256: 200}
SAMPLE_PROFILE_STEPS = 50   # the run profiled for the card's busy share
SAMPLE_STRIDE = 50          # the command's default deposit stride and thin
ESCAPE_STEPS = 4000         # tests/test_cli.py::test_sample_cli_metadynamics_escapes
STAY_STEPS = 2000           # tests/test_cli.py::test_sample_cli_unbiased_stays
PLAIN_STEPS = 200           # the metad run through the kernels vs the eager path
BLOCKED_STEPS = 100
UMBRELLA_WINDOWS = 8
UMBRELLA_STEPS = 1000
UMBRELLA_K = 50.0
# kernels vs the eager path on the card, the same CUDA generator: coordinates
# (Angstrom), deposit centers and weights after every step of the run
SAMPLE_TOL = 1e-4
# the command's runs of phase 13: (name, flags)
SAMPLE_RUNS = (
    ("metad", ["--bias", "metad"]),
    ("metad well-tempered", ["--bias", "metad", "--well-tempered-gamma",
                             "10"]),
    ("opes adaptive", ["--bias", "opes", "--opes-adaptive"]),
    ("steered", ["--bias", "steered"]),
    ("none", ["--bias", "none"]),
    ("none baoab", ["--bias", "none", "--integrator", "baoab", "--dt",
                    "5e-3"]),
)


def sample_counts(name, steps, cv_calls=1, blocked=False):
    """The launches a ``sample`` run must show: the model's forward and
    backward kernels once a step for each call of the CV in the step's
    energy, and the forward kernel once more a period for the deposits of
    metadynamics and OPES; none without a bias."""
    if name.startswith("none"):
        return counts()
    fwd = cv_calls * steps + (0 if name == "steered"
                              else steps // SAMPLE_STRIDE)
    pre = "blocked_" if blocked else ""
    return counts(**{pre + "forward": fwd, pre + "backward": cv_calls * steps})


FUSED_KERNELS = r"fused_unrolled_kernel|fused_grads_kernel|blocked|reduce_partials"


def device_ms(fn):
    """``(device ms, kernels, ms of the fused kernels)`` of one call of fn
    by ``torch.profiler`` (``edge_mm_probe.clocked_trace``: a trace taken
    again where its clock is off; one that lost its first launches is kept
    and counted, as a long call's trace loses them however often it is
    taken, and its busy share is then a lower bound)."""
    from molann_tpu_torch.probes.edge_mm_probe import clocked_trace

    launches = clocked_trace(fn, retakes=TRACE_RETAKES, ratios=TRACE_RATIOS)
    fused = sum(d for name, _, d in launches
                if re.search(FUSED_KERNELS, name))
    return sum(d for *_, d in launches) / 1e3, len(launches), fused / 1e3


def cos_phi(path):
    from molann_tpu_torch.sampling import ToyPeptidePotential
    from molann_tpu_torch.systems import alanine_universe

    pot = ToyPeptidePotential(alanine_universe())
    return np.cos(pot.phi(torch.from_numpy(np.load(path))).numpy())


def host_syncs(fn):
    """The calls of ``fn`` that made the host wait for the card, counted
    by ``torch.cuda.set_sync_debug_mode("warn")``."""
    import warnings

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # ("called a synchronizing CUDA operation"; the mode's own note that it
    # is "a prototype feature" is not a wait)
    return sum("synchronizing" in str(w.message)
               and "prototype" not in str(w.message) for w in caught)


def held_to_eager(model, label, steps, expect, dev):
    """A well-tempered metadynamics run through the fused kernels against
    the same run through the eager model on the card, from one seed of the
    CUDA generator; fails past ``SAMPLE_TOL`` or on other launch counts.
    Returns the largest error."""
    from molann_tpu_torch import sampling as S
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.systems import alanine_universe

    u = alanine_universe()
    pot = S.ToyPeptidePotential(u)
    x0 = torch.as_tensor(np.repeat(u.atoms.positions[None], 4, axis=0),
                         device=dev)
    for p in model.parameters():
        p.requires_grad_(False)
    xw = x0.clone().requires_grad_(True)  # the tables each puts on the
    torch.autograd.grad(  # card at its first forward and backward
        (pot.energy(xw) + F.fused_model_forward(model, xw).sum(-1)).sum(), xw)

    def run(cv):
        g = torch.Generator(device=dev).manual_seed(5)
        return S.metadynamics_langevin(
            pot.energy, cv, x0, n_steps=steps, dt=2e-4, kT=0.25, generator=g,
            height=0.5, sigma=0.25, stride=SAMPLE_STRIDE,
            well_tempered_gamma=10.0)

    reset_counts()
    got = []
    syncs = host_syncs(lambda: got.append(run(
        lambda x: F.fused_model_forward(model, x))))
    tk, xk, bk = got[0]
    torch.cuda.synchronize()
    if syncs:
        fail(f"phase 13, {label}: the run made the host wait {syncs} times")
    if dict(F.KERNEL_LAUNCHES) != expect:
        fail(f"phase 13, {label}: launches {dict(F.KERNEL_LAUNCHES)}, "
             f"expected {expect}")
    reset_counts()
    te, xe, be = run(model)
    if dict(F.KERNEL_LAUNCHES) != counts():
        fail(f"phase 13, {label}: the eager run launched a kernel")
    err = max(float((tk - te).abs().max()), float((xk - xe).abs().max()),
              float((bk.centers - be.centers).abs().max()),
              float((bk.weights - be.weights).abs().max()))
    if not err <= SAMPLE_TOL:
        fail(f"phase 13, {label}: kernels vs the eager path {err} > "
             f"{SAMPLE_TOL}")
    if not (torch.isfinite(tk).all() and bk.weights.min() > 0):
        fail(f"phase 13, {label}: non-finite walkers or empty deposits")
    return err


def sampling_phase(dev, card, tmp):
    """Phase 13: the enhanced-sampling loop through the commands, in
    process. Returns ``{kernel: launches over the phase's runs}``."""
    from molann_tpu_torch import sampling as S
    from molann_tpu_torch.io import save_model
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.systems import (alanine_model, alanine_pdb_text,
                                          alanine_universe)

    def p(name):
        return os.path.join(tmp, name)

    launched = dict.fromkeys(("forward", "backward", "blocked_forward",
                              "blocked_backward"), 0)

    def tally(expect):
        for k in launched:
            launched[k] += expect[k]
        return expect

    def cli(argv, expect):
        return run_cli(argv, tally(expect))

    t_phase = time.perf_counter()
    lines = []
    model, u = alanine_model(generator=torch.Generator().manual_seed(31),
                             device=dev)
    save_model(p("ala.npz"), model)
    with open(p("ala.pdb"), "w") as fh:
        fh.write(alanine_pdb_text())
    n = u.atoms.n_atoms
    with torch.no_grad():
        cv0 = model(torch.as_tensor(u.atoms.positions[None], device=dev))
    cv0 = cv0[0].cpu().numpy()
    steer = ["--s0=" + ",".join(f"{v:.6f}" for v in cv0),
             "--s1=" + ",".join(f"{v + 0.5:.6f}" for v in cv0)]
    base = ["sample", p("ala.npz"), p("ala.pdb")]

    # (a) every bias at W = 4 and 256: exact launch counts, steps/s, and the
    # card's busy share (device time of a profiled run over the wall time)
    rates = {}
    for W in SAMPLE_WALKERS:
        steps = SAMPLE_STEPS[W]
        cli(base + ["--walkers", str(W), "--steps", str(SAMPLE_STRIDE),
                    "--out", p("warm.npy")], sample_counts("metad",
                                                           SAMPLE_STRIDE))
        for name, flags in SAMPLE_RUNS:
            flags = flags + (steer if name == "steered" else [])
            tag = f"{name.replace(' ', '_')}_{W}"
            argv = base + flags + ["--walkers", str(W), "--steps",
                                   str(steps), "--out", p(f"{tag}.npy"),
                                   "--bias-out", p(f"{tag}.npz")]
            _, _, sec = cli(argv, sample_counts(name, steps))
            frames = np.load(p(f"{tag}.npy"))
            if not (frames.shape == (steps // SAMPLE_STRIDE * W, n, 3)
                    and np.isfinite(frames).all()):
                fail(f"phase 13, sample {name} W={W}: frames "
                     f"{frames.shape}, finite {np.isfinite(frames).all()}")
            prof_steps = SAMPLE_PROFILE_STEPS
            ms, kernels, fused_ms = device_ms(lambda: cli(
                base + flags + ["--walkers", str(W), "--steps",
                                str(prof_steps), "--out", p("prof.npy")],
                sample_counts(name, prof_steps)))
            want = sample_counts(name, steps)
            per_step = (sum(want.values())) / steps
            wall_ms = 1e3 * sec / steps
            rates[name, W] = {
                "steps_per_s": steps / sec, "kernel_launches_per_step":
                per_step, "device_ms_per_step": ms / prof_steps,
                "fused_kernel_ms_per_step": fused_ms / prof_steps,
                "kernels_per_step": kernels / prof_steps,
                "busy": ms / prof_steps / wall_ms}
    for (name, W), r in rates.items():
        print(json.dumps({"phase": 13, "sample": name, "walkers": W,
                          "steps": SAMPLE_STEPS[W], **r, "card": card}))
    dep = np.load(p("metad_4.npz"))
    if dep["centers"].shape != (SAMPLE_STEPS[4] // SAMPLE_STRIDE * 4, 3):
        fail(f"phase 13: metad deposits {dep['centers'].shape}")
    wt = np.load(p("metad_well-tempered_4.npz"))
    if not (wt["weights"].max() <= 1.0 + 1e-6 and "gamma" in wt):
        fail("phase 13: well-tempered deposits carry no decaying weights")
    op = np.load(p("opes_adaptive_256.npz"))
    if not ("opes" in op and op["centers"].shape[0] <= 512):
        fail("phase 13: the adaptive OPES kernels file")

    # (b) the kernels against the eager path, the same CUDA noise: the
    # unrolled kernels (K1, K2) and a head past their width (K6, K7)
    err_u = held_to_eager(model, "unrolled kernels", PLAIN_STEPS,
                          tally(sample_counts("metad", PLAIN_STEPS)), dev)
    wide, _ = alanine_model(hidden_dims=(65, 3), device=dev,
                            generator=torch.Generator().manual_seed(11))
    if F.model_select_mode(wide) != "blocked":
        fail("phase 13: the [38, 65, 3] head is not blocked under auto")
    err_b = held_to_eager(wide, "[38, 65, 3] head, blocked kernels",
                          BLOCKED_STEPS, tally(sample_counts(
                              "metad", BLOCKED_STEPS, blocked=True)), dev)
    save_model(p("wide.npz"), wide)
    cli(["sample", p("wide.npz"), p("ala.pdb"), "--steps",
         str(BLOCKED_STEPS), "--out", p("wide.npy")],
        sample_counts("metad", BLOCKED_STEPS, blocked=True))
    # no step waits for the host: steered and adaptive OPES through the
    # kernels, whose one read is OPES's count of kernels at the end
    pot = S.ToyPeptidePotential(u)
    x0 = torch.as_tensor(np.repeat(u.atoms.positions[None], 4, axis=0),
                         device=dev)
    cv = torch.as_tensor(cv0, device=dev)
    pot.energy(x0)  # its tables on the card, before the runs are watched
    reset_counts()
    waits = {
        "steered": host_syncs(lambda: S.steered_langevin(
            pot.energy, lambda x: F.fused_model_forward(model, x), x0,
            s0=cv, s1=cv + 0.5, k_spring=10.0, n_steps=100, dt=2e-4, kT=0.25,
            generator=torch.Generator(device=dev))),
        "opes adaptive": host_syncs(lambda: S.opes_langevin(
            pot.energy, lambda x: F.fused_model_forward(model, x), x0,
            n_steps=100, dt=2e-4, kT=0.25, sigma=0.05, stride=SAMPLE_STRIDE,
            barrier=8.0, adaptive=True, generator=torch.Generator(
                device=dev)))}
    if waits != {"steered": 0, "opes adaptive": 1}:
        fail(f"phase 13: host waits {waits}, expected none but OPES's one "
             "read of its count")
    want = tally(counts(forward=100 + 100 + 100 // SAMPLE_STRIDE,
                        backward=200))
    if dict(F.KERNEL_LAUNCHES) != want:
        fail(f"phase 13: launches of the steered and OPES runs "
             f"{dict(F.KERNEL_LAUNCHES)}, expected {want}")
    lines.append(f"kernels vs the eager path on the card (the same CUDA "
                 f"generator), well-tempered metad, W=4: K1/K2 "
                 f"{PLAIN_STEPS} steps max abs err {err_u:.3g}, K6/K7 "
                 f"([38, 65, 3] head) {BLOCKED_STEPS} steps {err_b:.3g} "
                 f"(tolerance {SAMPLE_TOL}); host waits "
                 f"(torch.cuda.set_sync_debug_mode): 0 in both, steered 0, "
                 f"adaptive OPES 1 (its count, read once at the end)")

    # (c) the escape check of tests/test_cli.py on its features. The test's
    # "--mlp 5 2" head has weights from JAX's PRNGKey(0), which torch cannot
    # draw; the port's seed-0 head couples its CVs to phi too weakly to
    # cross in 4000 steps, so the check runs on the aligned features (cos
    # phi, sin phi, the bond) themselves, through K1 and K2 without a head
    with open(p("features.txt"), "w") as fh:
        fh.write("[Output]\nd1, dihedral, bynum 5, bynum 7, bynum 9, "
                 "bynum 15\nb1, bond, bynum 2 5\n[End]\n")
    cli(["build", p("ala.pdb"), p("features.txt"), "--section", "Output",
         "--align", "bynum 1 2 5", "--out", p("built.npz")], counts())
    built = ["sample", p("built.npz"), p("ala.pdb")]
    _, _, t_esc = cli(built + ["--bias", "metad", "--steps",
                               str(ESCAPE_STEPS), "--walkers", "3", "--out",
                               p("escape.npy"), "--bias-out",
                               p("escape.npz")],
                      sample_counts("metad", ESCAPE_STEPS))
    _, _, t_stay = cli(built + ["--bias", "none", "--steps",
                                str(STAY_STEPS), "--walkers", "2",
                                "--out", p("stay.xtc")], counts())
    from molann_tpu_torch.io.xdr import read_xtc

    frames_stay, _, _ = read_xtc(p("stay.xtc"))
    np.save(p("stay.npy"), frames_stay)
    up, stay = cos_phi(p("escape.npy")).max(), cos_phi(p("stay.npy")).max()
    if np.load(p("escape.npz"))["centers"].shape[0] != 3 * (
            ESCAPE_STEPS // SAMPLE_STRIDE):
        fail("phase 13: the escape run's deposits")
    if not (up > 0.0 and stay < 0.0):
        fail(f"phase 13: metad max cos(phi) {up} (must cross 0), unbiased "
             f"{stay} (must stay below 0)")
    lines.append(f"escape check: metad {ESCAPE_STEPS} steps W=3 max "
                 f"cos(phi) {up:+.3f} in {t_esc:.3g} s, unbiased {STAY_STEPS} "
                 f"steps W=2 {stay:+.3f} in {t_stay:.3g} s")

    # (d) fes -> mep -> sample --path --tube-k, on the metad run's hills
    u_flip = alanine_universe()
    pos_b = S.rotate_torsion(u_flip, (4, 6, 8, 14), np.pi)
    with torch.no_grad():
        cv_b = model(torch.as_tensor(pos_b[None], device=dev))[0].cpu().numpy()
    pts = np.concatenate([dep["centers"], cv0[None], cv_b[None]])
    lo, hi = pts.min(axis=0) - 0.5, pts.max(axis=0) + 0.5
    grid = ",".join(f"{a:.4f}:{b:.4f}:16" for a, b in zip(lo, hi))
    cli(["fes", p("metad_4.npz"), f"--grid={grid}", "--out", p("fes.npy")],
        counts())
    out, _, _ = cli(["mep", p("fes.npy"), f"--grid={grid}",
                     "--start=" + ",".join(f"{v:.6f}" for v in cv0),
                     "--end=" + ",".join(f"{v:.6f}" for v in cv_b),
                     "--images", "16", "--iterations", "500", "--step",
                     "1e-3", "--out", p("path.npy")], counts())
    steps = SAMPLE_STEPS[4]
    _, _, t_path = cli(base + ["--bias", "metad", "--path", p("path.npy"),
                               "--tube-k", "5.0", "--tube-max", "0.1",
                               "--sigma", "0.1", "--steps", str(steps),
                               "--out", p("path_s.npy"), "--bias-out",
                               p("path_b.npz")],
                       sample_counts("metad", steps, cv_calls=2))
    c = np.load(p("path_b.npz"))["centers"]
    if not (c.shape == (4 * steps // SAMPLE_STRIDE, 1) and c.min() >= 0.0
            and c.max() <= 1.0):
        fail(f"phase 13: path-progress deposits {c.shape}, "
             f"[{c.min()}, {c.max()}]")
    lines.append(f"fes -> mep ({out.strip().splitlines()[0]}) -> sample "
                 f"--path --tube-k: {steps / t_path:.4g} steps/s, two CV "
                 "calls a step")

    # (e) reweight and msm on the sampled CVs, pmf on umbrella windows
    cli(["evaluate", p("ala.npz"), p("metad_4.npy"), "--out",
         p("cvs4.npy")], counts(forward=1))
    cli(["reweight", p("metad_4.npz"), p("cvs4.npy"), "--kT", "0.25",
         "--out", p("w.npy")], counts())
    w = np.load(p("w.npy"))
    if not (np.isfinite(w).all() and abs(float(w.mean()) - 1.0) < 1e-5):
        fail(f"phase 13: reweight weights mean {w.mean()}")
    cli(["evaluate", p("ala.npz"), p("metad_256.npy"), "--out",
         p("cvs256.npy")], counts(forward=1))
    cvs = np.load(p("cvs256.npy"))
    msm_grid = ",".join(f"{a:.4f}:{b:.4f}:3" for a, b in
                        zip(cvs.min(axis=0) - 1e-3, cvs.max(axis=0) + 1e-3))
    out_msm, _, _ = cli(["msm", p("cvs256.npy"), "--lag", "1", "--walkers",
                         "256", f"--grid={msm_grid}", "--out",
                         p("msm.npz")], counts())
    if abs(float(np.load(p("msm.npz"))["pi"].sum()) - 1.0) > 1e-9:
        fail("phase 13: msm stationary distribution")
    angles = np.linspace(0.0, np.pi, UMBRELLA_WINDOWS)
    xu = torch.as_tensor(np.stack([S.rotate_torsion(u_flip, (4, 6, 8, 14), a)
                                   for a in angles]), device=dev)
    with torch.no_grad():
        centers = model(xu)[:, 0]
    pot = S.ToyPeptidePotential(u_flip)
    reset_counts()
    t0 = time.perf_counter()
    samples, _ = S.umbrella_sampling(
        pot.energy, lambda x: F.fused_model_forward(model, x)[:, 0], xu,
        centers, k_spring=UMBRELLA_K, n_steps=UMBRELLA_STEPS, dt=2e-4,
        kT=0.25, generator=torch.Generator(device=dev).manual_seed(9),
        thin=10, n_equil=10)
    torch.cuda.synchronize()
    t_umb = time.perf_counter() - t0
    T = UMBRELLA_STEPS // 10 - 10
    if dict(F.KERNEL_LAUNCHES) != tally(counts(forward=UMBRELLA_STEPS + T,
                                               backward=UMBRELLA_STEPS)):
        fail(f"phase 13: umbrella launches {dict(F.KERNEL_LAUNCHES)}")
    np.save(p("umb.npy"), samples.cpu().numpy())
    c_all = samples.cpu().numpy()
    out_pmf, _, _ = cli(["pmf", p("umb.npy"), "--centers=" + ",".join(
        f"{v:.6f}" for v in centers.cpu().numpy()), "--k-spring",
        str(UMBRELLA_K), "--kT", "0.25",
        f"--grid={c_all.min() - 1e-3:.4f}:{c_all.max() + 1e-3:.4f}:20",
        "--out", p("pmf.npy")], counts())
    pmf = np.load(p("pmf.npy"))
    if not (pmf.shape == (2, 20) and np.isfinite(pmf[1]).sum() >= 10):
        fail(f"phase 13: pmf {pmf}")
    lines.append(f"reweight on {len(w)} frames; msm ({out_msm.splitlines()[0]}); "
                 f"umbrella {UMBRELLA_WINDOWS} windows x {UMBRELLA_STEPS} "
                 f"steps {UMBRELLA_STEPS / t_umb:.4g} steps/s, pmf "
                 f"({out_pmf.splitlines()[1]})")
    lines.append("launches over the phase: " + json.dumps(launched))
    print("enhanced sampling (phase 13, "
          f"{time.perf_counter() - t_phase:.1f} s): " + "; ".join(lines)
          + f"; card: {card}")
    return launched


ENGINE_FRAMES = 1 << 16
SERVE_FRAMES = 1 << 20
PEPTIDE_SERVE_FRAMES = 1 << 17
# the artifact ops' launch counters, in launch_counts()'s order
ARTIFACT_OPS = (("unrolled_forward", "forward"), ("unrolled_cv_forces",
                                                  "cv_forces"),
                ("blocked_forward", "blocked_forward"),
                ("blocked_cv_forces", "blocked_cv_forces"))


def artifact_counts():
    """The launches of the artifact's ops since the last reset, by kernel."""
    got = torch.ops.molann_tpu_torch.launch_counts().tolist()
    return {k: int(v) for (_, k), v in zip(ARTIFACT_OPS, got)}


def serve_line(err, prefix):
    lines = [ln for ln in err.splitlines() if ln.startswith(prefix)]
    if len(lines) != 1:
        fail(f"serve_torch printed no {prefix!r} line: {err[-1500:]}")
    return lines[0]


def engine_phase(dev, card, tmp):
    """Phase 14: the engine artifact on the card. Returns per kernel (K1,
    K4, K6, K8) its launches through the artifacts and both times."""
    import concurrent.futures

    from molann_tpu_torch.io import (DCDWriter, export_artifact,
                                     load_artifact, save_model)
    from molann_tpu_torch.ops import _build
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.systems import (alanine_model, lj_fluid_model,
                                          peptide_model)

    def p(name):
        return os.path.join(tmp, name)

    # build: the op libraries and the container, g++ side by side
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        serve_job = pool.submit(_build.build_serve_torch)
        ops_lib = _build.load_op_library()
        serve_bin = serve_job.result()
    print(f"engine build: {time.perf_counter() - t0:.1f} s (op libraries "
          f"{_build.BUILD_INFO['ops_seconds']:.1f} s, serve_torch "
          f"{_build.BUILD_INFO['serve_seconds']:.1f} s, side by side) -> "
          f"{os.path.basename(ops_lib)}, {os.path.basename(serve_bin)}")
    ops = torch.ops.molann_tpu_torch

    gen = torch.Generator().manual_seed(0)
    alanine, au = alanine_model(generator=gen, device=dev)
    peptide, pu = peptide_model(60, generator=torch.Generator().manual_seed(0),
                                device=dev)
    fluid, fu, _ = lj_fluid_model(5, generator=torch.Generator().manual_seed(0),
                                  device=dev)
    cases = (("alanine_model()", alanine, au, 0.05, ENGINE_FRAMES, VAL_TOL,
              "unrolled", ("forward", "cv_forces")),
             ("peptide_model(60)", peptide, pu, 0.05, BLK_CHECK_FRAMES,
              VAL_TOL, "blocked", ("blocked_forward", "blocked_cv_forces")),
             ("lj_fluid_model(5)", fluid, fu, LJ_SIGMA, LJ_PLAIN_FRAMES,
              VAL_TOL_PAIRS, "blocked",
              ("blocked_forward", "blocked_cv_forces")))
    tally = dict.fromkeys((k for _, k in ARTIFACT_OPS), 0)
    times, lines = {}, []
    max_err = {}
    for seed, (name, model, u, sigma, plain_l, val_tol, mode, kinds) in \
            enumerate(cases):
        if F.model_select_mode(model) != mode:
            fail(f"{name}: mode {F.model_select_mode(model)}, expected {mode}")
        n = u.atoms.n_atoms
        host = copy.deepcopy(model).to("cpu")  # exported on the host
        arts = {(fused, grad): load_artifact(export_artifact(
            host, n, fused=fused, with_gradient=grad), device=dev)
            for fused in (True, False) for grad in (False, True)}
        x = noisy_frames(u, ENGINE_FRAMES, 40 + seed, sigma, dev)
        # the fused artifact against the Python route: one launch each,
        # the same kernel on the same stream, the same bits
        reset_counts()
        ops.reset_launch_counts()
        y_a = arts[True, False](x)
        y_ag, g_ag = arts[True, True](x)
        got = artifact_counts()
        if got != {**dict.fromkeys(tally, 0), kinds[0]: 1, kinds[1]: 1}:
            fail(f"{name}: artifact launch counts {got}")
        with torch.no_grad():
            y_r = F.fused_model_forward(model, x)
        y_rg, g_rg = F.fused_cv_forces(model, x)
        if dict(F.KERNEL_LAUNCHES) != counts(**{kinds[0]: 1, kinds[1]: 1}):
            fail(f"{name}: Python route launch counts {F.KERNEL_LAUNCHES}")
        for k in kinds:
            tally[k] += 1
        for what, a, b in (("values", y_a, y_r), ("cv+forces values", y_ag,
                                                  y_rg),
                           ("gradients", g_ag, g_rg)):
            same_bits(a.cpu().numpy(), b.cpu().numpy(),
                      f"{name}: fused artifact vs Python route, {what}")
        # the fused and the eager artifacts against the plain versions
        y_e = arts[False, False](x[:plain_l]).detach()
        y_eg, g_eg = arts[False, True](x[:plain_l])
        if artifact_counts() != got:
            fail(f"{name}: an eager artifact launched an op")
        parts = F._extract_model(model)
        xp = x[:plain_l]
        # the plain versions in float32, as phase 4 holds K1 and K4 (a
        # frame's float32 rounding is its own: the error of both against
        # float64 is printed)
        if mode == "unrolled":
            y_ref = F.forward_plain(*parts, xp).detach()
            y_ref_g, g_ref = F.cv_forces_plain(*parts, xp)
            slack = torch.zeros(xp.shape[:2], dtype=torch.float64,
                                device=dev)
        else:
            y_ref = FB.blocked_forward_plain(*parts, xp).detach()
            y_ref_g, g_ref = FB.blocked_cv_forces_plain(*parts, xp)
            slack = FB.gradient_jump_slack(parts[0], parts[3], xp.double())
        y64, g64 = (FB.blocked_cv_forces_plain if mode == "blocked"
                    else F.cv_forces_plain)(*f64(parts), xp.double())
        # the eager artifacts against the eager model on the card, the same
        # float32 math (the eager model's own error against the plain
        # float64 version is its own, and is printed)
        xe = xp.clone().requires_grad_(True)
        y_m = model(xe)
        (g_m,) = torch.autograd.grad(y_m.sum(), xe)
        y_m = y_m.detach()
        errs = {}
        for what, y, yr in (("fused values", y_a[:plain_l], y_ref),
                            ("fused cv+forces values", y_ag[:plain_l],
                             y_ref_g),
                            ("eager values", y_e, y_m),
                            ("eager gradient artifact values", y_eg, y_m)):
            e = float((y.double() - yr.double()).abs().max())
            if not e <= val_tol:
                fail(f"{name}: {what}: {e} > {val_tol}")
            errs[what] = e
        for what, g, gr in (("fused gradients", g_ag[:plain_l], g_ref),
                            ("eager gradients", g_eg, g_m)):
            errs[what] = worst_gx(g, gr.double(), slack,
                                  f"{name}: {what}")
        errs["vs float64: fused gradients"] = float(
            ((g_ag[:plain_l].double() - g64).abs().amax(-1)
             [slack == 0]).max())
        errs["vs float64: float32 plain gradients"] = float(
            ((g_ref.double() - g64).abs().amax(-1)[slack == 0]).max())
        for k in kinds:
            max_err[k] = max(max_err.get(k, 0.0), *(
                v for w, v in errs.items() if w.startswith("fused")))
        # each op per 65,536 frames through the loaded artifact and through
        # the Python route (ctypes), in turns
        with torch.no_grad():
            fwd_route = cuda_ms(lambda: F.fused_model_forward(model, x), 20)
        fwd_art = cuda_ms(lambda: arts[True, False](x), 20)
        fwd_art2 = cuda_ms(lambda: arts[True, False](x), 20)
        with torch.no_grad():
            fwd_route2 = cuda_ms(lambda: F.fused_model_forward(model, x), 20)
        cv_route = cuda_ms(lambda: F.fused_cv_forces(model, x), 20)
        cv_art = cuda_ms(lambda: arts[True, True](x), 20)
        cv_art2 = cuda_ms(lambda: arts[True, True](x), 20)
        cv_route2 = cuda_ms(lambda: F.fused_cv_forces(model, x), 20)
        t = {kinds[0]: ((fwd_art + fwd_art2) / 2,
                        (fwd_route + fwd_route2) / 2),
             kinds[1]: ((cv_art + cv_art2) / 2, (cv_route + cv_route2) / 2)}
        if name != "lj_fluid_model(5)":
            times.update(t)
        lines.append(
            f"{name} ({mode}): fused artifact bit-identical to the Python "
            f"route on {ENGINE_FRAMES} frames, launches {got}; fused vs "
            f"plain, eager vs the eager model on {plain_l} frames: "
            + ", ".join(f"{w} {v:.3g}"
                                             for w, v in errs.items())
            + "; ms per " + f"{ENGINE_FRAMES} frames, artifact / Python "
            "route: " + ", ".join(f"{k} {a:.4f} / {r:.4f}"
                                  for k, (a, r) in t.items()))

    # refusals: a fused artifact on CPU tensors, and without its op library
    x_cpu = torch.zeros(4, au.atoms.n_atoms, 3)
    on_cpu = load_artifact(export_artifact(copy.deepcopy(alanine).to("cpu"),
                                           au.atoms.n_atoms, fused=True),
                           device="cpu")
    try:
        on_cpu(x_cpu)
    except (RuntimeError, NotImplementedError) as e:
        refusal = next((ln.strip() for ln in str(e).splitlines()
                        if "Could not run" in ln and "'CPU'" in ln), None)
        if refusal is None:
            fail(f"a fused artifact on CPU tensors raised otherwise: {e}")
    else:
        fail("a fused artifact ran on CPU tensors")

    # the container: 1,048,576 alanine frames from a .dcd through the
    # fused gradient artifact (K4), against evaluate_trajectory
    n = au.atoms.n_atoms
    rng = np.random.default_rng(44)
    with DCDWriter(p("ala.dcd")) as w:
        for s in range(0, SERVE_FRAMES, BATCH):
            w.append((au.atoms.positions[None] + 0.05 * rng.normal(
                size=(BATCH, n, 3))).astype(np.float32))
    host = copy.deepcopy(alanine).to("cpu")
    export_artifact(host, n, p("ala_forces.pt"), fused=True,
                    with_gradient=True)
    save_model(p("ala.npz"), host)

    def serve(args):
        proc = subprocess.run([serve_bin, *args], capture_output=True,
                              text=True, timeout=600)
        return proc.returncode, proc.stderr

    rc, err = serve([p("ala_forces.pt"), p("ala.dcd"), p("out.npy"),
                     "--ops", ops_lib, "--verbose"])
    if rc != 0:
        fail(f"serve_torch exited {rc}: {err[-2000:]}")
    served, timing = serve_line(err, "served"), serve_line(err, "timing:")
    launched = serve_line(err, "launches:")
    want = (f"launches: unrolled_forward 0, unrolled_cv_forces "
            f"{-(-SERVE_FRAMES // BATCH)}, blocked_forward 0, "
            "blocked_cv_forces 0")
    if launched != want:
        fail(f"serve_torch launches: {launched!r}, expected {want!r}")
    tally["cv_forces"] += -(-SERVE_FRAMES // BATCH)
    cvs, grads = evaluate_trajectory(alanine, p("ala.dcd"), device=dev,
                                     forces=True, backend="native")
    same_bits(np.load(p("out.npy")), cvs, "serve_torch vs "
              "evaluate_trajectory, values")
    same_bits(np.load(p("out.grad.npy")), grads.reshape(SERVE_FRAMES, 3 * n),
              "serve_torch vs evaluate_trajectory, gradients")
    _, cmd_err, _ = run_cli(["forces", p("ala.npz"), p("ala.dcd"), "--out",
                             p("y.npy"), "--forces-out", p("f.npy"),
                             "--batch-size", str(BATCH), "--backend",
                             "native", "--verbose"],
                            counts(cv_forces=-(-SERVE_FRAMES // BATCH)))
    rc, err = serve([p("ala_forces.pt"), p("ala.dcd"), p("out.npy")])
    missing = serve_line(err, "serve_torch: cannot load")
    if rc != 1 or "molann_tpu_torch::" not in err:
        fail(f"serve_torch ran a fused artifact without its op library "
             f"(exit {rc}): {err[-500:]}")

    # the container on the peptide's fused forward artifact (K6)
    n_p = pu.atoms.n_atoms
    np.save(p("pep.npy"), noisy_frames(pu, PEPTIDE_SERVE_FRAMES, 45, 0.05,
                                       dev).cpu().numpy())
    export_artifact(copy.deepcopy(peptide).to("cpu"), n_p, p("pep.pt"),
                    fused=True)
    rc, err = serve([p("pep.pt"), p("pep.npy"), p("pep_out.npy"), "--ops",
                     ops_lib, "--verbose"])
    if rc != 0:
        fail(f"serve_torch on the peptide exited {rc}: {err[-2000:]}")
    want = (f"launches: unrolled_forward 0, unrolled_cv_forces 0, "
            f"blocked_forward {-(-PEPTIDE_SERVE_FRAMES // BATCH)}, "
            "blocked_cv_forces 0")
    if serve_line(err, "launches:") != want:
        fail(f"serve_torch peptide launches: {serve_line(err, 'launches:')}")
    tally["blocked_forward"] += -(-PEPTIDE_SERVE_FRAMES // BATCH)
    same_bits(np.load(p("pep_out.npy")),
              evaluate_trajectory(peptide, p("pep.npy"), device=dev),
              "serve_torch peptide vs evaluate_trajectory")
    pep_served = serve_line(err, "served")
    print("engine artifact (phase 14): " + "; ".join(lines)
          + f"; on CPU tensors the fused artifact raises ({refusal!r}); "
          f"serve_torch, {SERVE_FRAMES} alanine frames from .dcd through "
          f"the fused gradient artifact: {served}, {timing}, {launched}, "
          "bit-identical to evaluate_trajectory; the forces command on the "
          f"same file and batch: {timing_line(cmd_err)}; without --ops: {missing!r}; "
          f"peptide, {PEPTIDE_SERVE_FRAMES} frames from .npy through the "
          f"fused forward artifact: {pep_served}, bit-identical to "
          f"evaluate_trajectory; card: {card}")
    return {k: {"artifact_launches": tally[k],
                "artifact_ms": times[k][0], "route_ms": times[k][1],
                "artifact_max_abs_err": max_err[k]} for k in tally}


MESH_TIMEOUT_S = 600
# the launches of each case of probes/mesh_probe.py, on every rank: a
# batch of 65,536 frames, 32,768 a rank on two
MESH_LAUNCHES = {
    "ala_fused": {"train": 10}, "ala_fit": {"forward": 10, "backward": 10},
    "ala_resume": {"forward": 5, "backward": 5},
    "ala_serve": {"cv_forces": 16}, "ala_values": {"forward": 16},
    "pep_fused": {"blocked_train": 5},
    "pep_fit": {"blocked_forward": 5, "blocked_backward": 5},
    "pep_serve": {"blocked_cv_forces": 2},
    "ala_decay": {"forward": 10, "backward": 10},
    "ala_penalty": {"forward": 2, "backward": 2}}
MESH_TRAINERS = ("ala_fused", "ala_fit", "pep_fused", "pep_fit", "ala_decay")
MESH_SERVERS = {"ala_serve": ("cvs", "grads"), "ala_values": ("cvs",),
                "pep_serve": ("cvs", "grads")}


def mesh_inputs(d, dev):
    """The probe's inputs: per system its model, frames and a teacher
    model's outputs on them (through K1/K6 on the card)."""
    from molann_tpu_torch.io import save_model
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.systems import alanine_model, peptide_model

    systems = (("ala", alanine_model, {}, SERVE_FRAMES, 60),
               ("pep", peptide_model, {"n_residues": 60},
                PEPTIDE_SERVE_FRAMES, 61))
    for name, make, kw, n_frames, seed in systems:
        model, u = make(**kw, generator=torch.Generator().manual_seed(seed),
                        device=dev)
        teacher, _ = make(**kw, device=dev,
                          generator=torch.Generator().manual_seed(seed + 1))
        save_model(os.path.join(d, f"{name}.npz"),
                   copy.deepcopy(model).to("cpu"))
        n = u.atoms.n_atoms
        frames = np.lib.format.open_memmap(
            os.path.join(d, f"{name}.npy"), mode="w+", dtype=np.float32,
            shape=(n_frames, n, 3))
        ys = []
        rng = np.random.default_rng(seed)
        for s in range(0, n_frames, BATCH):
            xb = (u.atoms.positions[None] + 0.05 * rng.normal(
                size=(BATCH, n, 3))).astype(np.float32)
            frames[s:s + BATCH] = xb
            with torch.no_grad():
                ys.append(F.fused_model_forward(
                    teacher, torch.as_tensor(xb, device=dev)).cpu().numpy())
        frames.flush()
        del frames
        np.save(os.path.join(d, f"{name}_y.npy"), np.concatenate(ys))


def mesh_ranks(argvs, what):
    """Run ``python -m molann_tpu_torch.probes.mesh_probe`` once per argv,
    all at once, under one timeout; fail with their output where one
    fails. Returns the seconds taken."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "molann_tpu_torch.probes.mesh_probe", *argv],
        cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for argv in argvs]
    outs = []
    try:
        for proc in procs:
            left = max(1.0, MESH_TIMEOUT_S - (time.perf_counter() - t0))
            outs.append(proc.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        outs.append(f"timed out after {MESH_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if len(outs) < len(procs) or any(p.returncode for p in procs):
        fail(f"phase 15, {what}: exit codes "
             f"{[p.returncode for p in procs]}: "
             + " | ".join(o[-3000:] for o in outs))
    return time.perf_counter() - t0


def mesh_phase(dev, card, tmp):
    """Phase 15: data parallelism and multi-device serving on the card.
    Returns ``{kernel: launches}`` over (a) and (b), every rank's."""
    from molann_tpu_torch.cli._common import _mesh_size
    from molann_tpu_torch.parallel.multihost import free_port

    t_phase = time.perf_counter()
    d = os.path.join(tmp, "mesh")
    os.makedirs(d)
    mesh_inputs(d, dev)
    with open(os.path.join(d, "sizes.json"), "w") as f:
        json.dump({"batch": BATCH, "ala_steps": 10, "pep_steps": 5,
                   "ckpt_every": 5}, f)
    t_ref = mesh_ranks([["ref", d]], "(a) NCCL, a world of one")
    port = str(free_port())
    t_two = mesh_ranks([["two", str(r), port, d] for r in (0, 1)],
                       "(b) two ranks over gloo on one card")

    def load(mode, rank):
        base = os.path.join(d, f"{mode}.rank{rank}")
        with open(base + ".json") as f, np.load(base + ".npz") as z:
            return json.load(f), dict(z)

    (jref, aref), (j0, a0), (j1, a1) = (load("ref", 0), load("two", 0),
                                        load("two", 1))
    if (jref["backend"], j0["backend"], j1["backend"]) != ("nccl", "gloo",
                                                           "gloo"):
        fail(f"phase 15: backends {jref['backend']}, {j0['backend']}")
    launched = dict.fromkeys(("forward", "cv_forces", "backward", "train",
                              "blocked_forward", "blocked_cv_forces",
                              "blocked_backward", "blocked_train"), 0)
    for who, js in (("ref", jref), ("rank 0", j0), ("rank 1", j1)):
        for case, want in MESH_LAUNCHES.items():
            if who == "ref" and case == "ala_resume":
                continue
            if js[case]["launches"] != want:
                fail(f"phase 15, {who}, {case}: launches "
                     f"{js[case]['launches']}, expected {want}")
            for k, v in want.items():
                launched[k] += v
    for case in (*MESH_TRAINERS, *MESH_SERVERS):
        if not jref[case]["same_bits_as_plain"]:
            fail(f"phase 15 (a), {case}: NCCL's world of one differs from "
                 "the call without a mesh")
    # (b): the ranks agree bit for bit after every step, and with one rank
    if sorted(a0) != sorted(a1):
        fail("phase 15 (b): the ranks wrote different cases")
    for k in a0:
        if not k.endswith(":step_seconds"):
            same_bits(a1[k], a0[k], f"phase 15 (b), rank 1 vs rank 0, {k}")
    worst = {}
    for case in MESH_TRAINERS:
        got, want = a0[f"{case}:losses"], aref[f"{case}:losses"]
        el = float(np.max(np.abs(got - want) / np.abs(want)))
        if not el <= LOSS_RTOL:
            fail(f"phase 15 (b), {case}: losses {got} vs one rank {want}")
        p, q = a0[f"{case}:params"], aref[f"{case}:params"]
        ew = float(np.abs(p - q).max())
        if not ew <= GRAD_RTOL * max(1.0, float(np.abs(q).max())):
            fail(f"phase 15 (b), {case}: weights {ew} from one rank's")
        worst[case] = (el, ew)
    # the decay read outside a model call: exact on the ranks, untouched in
    # a world of one, and a read past the wrapper raises on two ranks only
    same_bits(aref["ala_penalty:ranks"], aref["ala_penalty:plain"],
              "phase 15 (a), the decayed step in a world of one")
    extra = a0["ala_penalty:ranks"].astype(np.float64) - a0[
        "ala_penalty:plain"]
    decay = a0["ala_penalty:decay"].astype(np.float64)
    counted = 1.0 + float(extra @ decay / (decay @ decay))
    if not abs(counted - 1.0) < 1e-3:
        fail(f"phase 15 (b): the decay's gradient counted {counted} times")
    if jref["ala_penalty"]["bypass"]:
        fail(f"phase 15 (a): a world of one refused a read past the wrapper: "
             f"{jref['ala_penalty']['bypass']}")
    for who, js in (("rank 0", j0), ("rank 1", j1)):
        if "'ann_layers.layers.0.weight'" not in js["ala_penalty"]["bypass"]:
            fail(f"phase 15 (b), {who}: a read past the wrapper gave "
                 f"{js['ala_penalty']['bypass']!r}")
    same_bits(a0["ala_resume:losses"], a0["ala_fit:losses"][5:],
              "phase 15 (b), fit resumed from step 5, losses")
    same_bits(a0["ala_resume:params"], a0["ala_fit:params"][5:],
              "phase 15 (b), fit resumed from step 5, weights")
    want_ckpts = [f"ckpt_{s:010d}.{k}.npz" for s in (5, 10)
                  for k in ("model", "opt")]
    if j0["ckpts"] != want_ckpts:
        fail(f"phase 15 (b): checkpoints {j0['ckpts']}")
    for case, keys in MESH_SERVERS.items():
        for k in keys:
            ref = np.load(os.path.join(d, f"ref_{case}_{k}.npy"))
            got = np.load(os.path.join(d, f"two_{case}_{k}.npy"))
            if case == "ala_serve" and k == "grads":
                ref = np.negative(ref)  # written as forces, in flight
            same_bits(got, ref, f"phase 15 (b), {case} {k}: two ranks vs "
                                "one")
    rates = []
    for case in MESH_TRAINERS:  # steady steps: the first carries set-up
        one = float(np.median(aref[f"{case}:step_seconds"][1:]))
        two = float(np.median(np.maximum(a0[f"{case}:step_seconds"],
                                         a1[f"{case}:step_seconds"])[1:]))
        rates.append(f"{case} {one * 1e3:.4g} / {two * 1e3:.4g} ms a step "
                     f"(first {aref[f'{case}:step_seconds'][0]:.3g} / "
                     f"{a0[f'{case}:step_seconds'][0]:.3g} s)")
    for case in MESH_SERVERS:
        one, two = jref[case]["seconds"], max(j0[case]["seconds"],
                                              j1[case]["seconds"])
        rates.append(f"{case} {one:.4g} / {two:.4g} s")

    # (c) the commands at the card's count, and the container
    cards = torch.cuda.device_count()
    ala = os.path.join(d, "ala.npz")
    frames = os.path.join(d, "ala.npy")
    ranks = _mesh_size(types.SimpleNamespace(devices=2, device="cuda"))
    out, _, t_forces = run_cli(
        ["forces", ala, frames, "--out", os.path.join(d, "y.npy"),
         "--forces-out", os.path.join(d, "f.npy"), "--batch-size",
         str(BATCH), "--devices", "2"],
        counts(cv_forces=SERVE_FRAMES // BATCH) if ranks == 1 else counts())
    if ranks == 1 and "(1 devices)" not in out:  # ranks > 1 print apart
        fail(f"phase 15: the forces command printed {out!r}")
    same_bits(np.load(os.path.join(d, "f.npy")).reshape(SERVE_FRAMES, -1, 3),
              np.negative(np.load(os.path.join(d, "ref_ala_serve_grads.npy"))),
              "phase 15: forces --devices 2 vs evaluate_trajectory")
    out, _, t_train = run_cli(
        ["train", ala, frames, "--loss", "eigenfunction", "--steps", "20",
         "--batch-size", "4096", "--log-every", "0", "--devices", "2",
         "--out", os.path.join(d, "trained.npz")], counts())
    if ranks == 1 and "trained 20 steps" not in out:
        fail(f"phase 15: the train command printed {out!r}")
    served = mesh_serve_torch(tmp)
    print("data parallelism (phase 15, "
          f"{time.perf_counter() - t_phase:.1f} s): (a) NCCL, a world of "
          f"one: every case the bits of its call without a mesh ({t_ref:.1f}"
          f" s with its process); (b) two ranks on the card over gloo with "
          f"CUDA tensors ({t_two:.1f} s): the ranks bit-identical after every"
          " step; losses / weights from one rank's: "
          + ", ".join(f"{c} {e[0]:.3g} / {e[1]:.3g}" for c, e in worst.items())
          + "; served rows and forces bit-identical to one rank's; fit "
          f"resumed from step 5 bit-identical; the decay read outside a "
          f"call counted {counted:.6f} times on two ranks (once in JAX's "
          f"step), a read past the wrapper refused by both; launches every "
          f"rank exact "
          f"({json.dumps(MESH_LAUNCHES)}); host time one rank / two ranks "
          "(a step: the median after the first): " + ", ".join(rates)
          + f"; (c) {cards} card(s): forces and "
          f"train --devices 2 ran {ranks} rank(s) ({t_forces:.2f} s, "
          f"{t_train:.2f} s); serve_torch on {SERVE_FRAMES} alanine frames "
          "from .dcd, fused gradient artifact, bit-identical to phase 14: "
          + "; ".join(f"{k} in flight {np.mean([r for r, _ in v]):.6g} "
                      f"frames/s ({', '.join(f'{r:.6g}' for r, _ in v)}; "
                      f"{v[0][1]})" for k, v in sorted(served.items()))
          + f"; card: {card}")
    return launched


def mesh_serve_torch(tmp):
    """``serve_torch`` on phase 14's ``.dcd`` through its fused gradient
    artifact with 1 and 2 batches in flight, in turns (1, 2, 2, 1), each
    bit-identical to phase 14's outputs. Returns per count its runs'
    ``(frames/s, timing line)``."""
    from molann_tpu_torch.ops import _build

    serve_bin, ops_lib = _build.build_serve_torch(), _build.load_op_library()
    served = {}
    for k in ("1", "2", "2", "1"):
        res = os.path.join(tmp, f"mesh_out_{k}.npy")
        proc = subprocess.run(
            [serve_bin, os.path.join(tmp, "ala_forces.pt"),
             os.path.join(tmp, "ala.dcd"), res, "--ops", ops_lib,
             "--in-flight", k, "--verbose"], capture_output=True, text=True,
            timeout=600)
        if proc.returncode != 0:
            fail(f"serve_torch --in-flight {k} exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        same_bits(np.load(res), np.load(os.path.join(tmp, "out.npy")),
                  f"serve_torch --in-flight {k} vs phase 14, values")
        same_bits(np.load(res[:-4] + ".grad.npy"),
                  np.load(os.path.join(tmp, "out.grad.npy")),
                  f"serve_torch --in-flight {k} vs phase 14, gradients")
        line = serve_line(proc.stderr, "served")
        rate = float(re.search(r"\(([0-9.e+]+) frames/s", line).group(1))
        served.setdefault(k, []).append(
            (rate, serve_line(proc.stderr, "timing:")))
    return served


# the examples of phase 16 (molann_tpu_torch/examples/): the five long
# sampling examples run at a cut depth, every dynamics stage at most
# EXAMPLE_STEPS[name] steps (whole periods) and every training stage at most
# EXAMPLE_TRAIN steps; path_kinetics' string at EXAMPLE_STRING iterations.
# Those run through main are cut by ExampleStages, the others are called at
# that depth.
# The other five run as the CPU tests run them (serve_biased_md and
# train_autoencoder_cv at full size, the rest quick). The science of the
# long five is held on the CPU at quick size (tests/test_torch_port_
# examples_*.py): their host-bound loops cannot reach it in the budget.
EXAMPLE_STEPS = {"biased_dynamics": 100, "train_eigenfunction_cv": 100,
                 "train_timelagged_cv": 600, "adaptive_cv_loop": 100,
                 "path_kinetics": 200}
EXAMPLE_TRAIN = 20
EXAMPLE_STRING = 500
EXAMPLE_PROFILE_STEPS = 20   # the profiled run of each kind of stage
EXAMPLE_BUDGET_S = 150.0     # the phase fails past it
DYNAMICS = ("overdamped_langevin", "metadynamics_langevin",
            "steered_langevin", "empirical_committor")
TRAINING = ("fit", "fit_ensemble", "string_method")


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class ExampleStages:
    """The library calls of an example's modules, wrapped where the modules
    name them. Each call is timed between two synchronisations. A dynamics
    stage is cut to ``steps`` (whole periods) if given, for the examples
    that run through ``main``, and its outputs are checked:
    on the example's device, finite, one deposit a walker a period. The
    first stage of each kind is run again, alone, for its host waits in one
    period, and, if there are any, in two, which must be as many (no wait
    inside a period), and, for the kinds in ``profiled`` (every kind when
    None), its kernels a step and the card's busy share
    (``torch.profiler``). A training stage is cut to ``train`` steps if
    given."""

    def __init__(self, dev, steps=None, train=None, profiled=None):
        self.dev, self.steps, self.train = dev, steps, train
        self.profiled = profiled
        self.records, self._seen, self.profile_s = [], set(), 0.0

    def __call__(self, *modules):
        import contextlib

        @contextlib.contextmanager
        def patched():
            saved = []
            for mod in dict.fromkeys(modules):  # each module wrapped once
                for name in DYNAMICS + TRAINING:
                    fn = getattr(mod, name, None)
                    if fn is not None:
                        saved.append((mod, name, fn))
                        setattr(mod, name, self._wrap(name, fn))
            try:
                yield self
            finally:
                for mod, name, fn in saved:
                    setattr(mod, name, fn)

        return patched()

    def _timed(self, fn, *args, **kw):
        sync(self.dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(self.dev)
        return out, time.perf_counter() - t0

    def _wrap(self, name, fn):
        def stage(*args, **kw):
            if name in DYNAMICS:
                return self._dynamics(name, fn, args, kw)
            cut = {"fit": ("num_steps", self.train),
                   "fit_ensemble": ("num_steps", self.train),
                   "string_method": ("n_iterations", None)}[name]
            if cut[1] and kw.get(cut[0]):
                kw[cut[0]] = min(kw[cut[0]], cut[1])
            out, sec = self._timed(fn, *args, **kw)
            steps = kw.get(cut[0]) or (len(out.losses) if hasattr(
                out, "losses") else None)
            self.records.append({"stage": name, "s": sec, "steps": steps})
            return out

        return stage

    def _dynamics(self, name, fn, args, kw):
        period = kw.get("stride") or kw.get("thin") or 1
        if self.steps:
            kw["n_steps"] = max(period, min(kw["n_steps"], self.steps)
                                // period * period)
        n = kw["n_steps"]
        out, sec = self._timed(fn, *args, **kw)
        x0 = args[2] if name in ("metadynamics_langevin",
                                 "steered_langevin") else args[1]
        walkers = x0.shape[0] * kw.get("n_replicas", 1)
        # the committor estimate is NaN where no replica resolved
        checked = out[1:2] if name == "empirical_committor" else out[:2]
        for t in checked:
            if t.device.type != self.dev.type or not bool(
                    torch.isfinite(t).all()):
                fail(f"phase 16, {name}: an output off {self.dev} or not "
                     "finite")
        if name == "metadynamics_langevin":
            bias = out[2]
            if (bias.centers.shape[0] != n // period * walkers
                    or bias.centers.device.type != self.dev.type
                    or not bool((bias.weights > 0).all())):
                fail(f"phase 16, metadynamics: {bias.centers.shape[0]} "
                     f"deposits for {n // period} periods of {walkers} "
                     "walkers")
        rec = {"stage": name, "s": sec, "steps": n, "walkers": walkers,
               "steps_per_s": n / sec}
        if name not in self._seen and self.dev.type == "cuda":
            self._seen.add(name)
            t0 = time.perf_counter()
            rec.update(self._rerun(name, fn, args, kw, period))
            self.profile_s += time.perf_counter() - t0
        self.records.append(rec)
        return out

    def _rerun(self, name, fn, args, kw, period):
        def run(periods):
            k = dict(kw, n_steps=periods * period,
                     generator=torch.Generator(self.dev).manual_seed(7))
            return fn(*args, **k)

        one = host_syncs(lambda: run(1))
        two = host_syncs(lambda: run(2)) if one else 0
        if one != two:
            fail(f"phase 16: {fn.__name__} waits for the card inside a "
                 f"period ({one} host waits in one period, {two} in two)")
        if self.profiled is not None and name not in self.profiled:
            return {"host_waits_a_call": one}
        periods = max(1, EXAMPLE_PROFILE_STEPS // period)
        t0 = time.perf_counter()
        busy, kernels, _ = device_ms(lambda: run(periods))
        wall = 1e3 * (time.perf_counter() - t0)
        return {"kernels_per_step": kernels / (periods * period),
                "busy": busy / wall, "host_waits_a_call": one}


def example_line(name, depth, wall, stages, launched, out):
    """One JSON line of phase 16: the example's wall seconds (its stages'
    profiled reruns apart), its stages, the kernels K4 and K6 launched,
    and the scalars it returned."""
    line = {"phase": 16, "example": name, "depth": depth,
            "wall_s": wall - stages.profile_s,
            "profiling_s": stages.profile_s, "stages": stages.records,
            "k4_launches": launched["cv_forces"],
            "k6_launches": launched["blocked_forward"],
            "result": {k: v for k, v in out.items()
                       if isinstance(v, (bool, int, float, str))}}
    print(json.dumps(line))
    return line


WALKTHROUGH = os.path.join("molann_tpu_torch", "docs", "quickstart.md")
WALKTHROUGH_BUDGET_S = 60.0
# the one line that names the walkthrough's device
DEVICE_LINE = 'device = torch.device("cuda")'


def walkthrough_phase(dev, card):
    """Phase 17: every ```python block of the port's walkthrough, verbatim,
    in one namespace in a temporary directory, on the card. Returns
    ``{kernel: launches}`` over the blocks."""
    root = os.path.dirname(os.path.abspath(__file__))
    with open(os.path.join(root, WALKTHROUGH)) as f:
        blocks = re.findall(r"```python\n(.*?)```", f.read(), flags=re.DOTALL)
    if sum(b.count(DEVICE_LINE) for b in blocks) != 1:
        fail(f"phase 17: {WALKTHROUGH} must name its device once, as "
             f"{DEVICE_LINE!r}")
    from molann_tpu_torch.ops import fused as F

    ns, seconds = {"__name__": "walkthrough"}, []
    here = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i, block in enumerate(blocks):
                tb = time.perf_counter()
                try:
                    exec(compile(block, f"{WALKTHROUGH}[block {i}]", "exec"),
                         ns)
                    torch.cuda.synchronize()
                except Exception as e:  # noqa: BLE001 - named in the failure
                    fail(f"phase 17: block {i} of {WALKTHROUGH} raised "
                         f"{type(e).__name__}: {e}")
                seconds.append(time.perf_counter() - tb)
            wall = time.perf_counter() - t0
            launched = dict(F.KERNEL_LAUNCHES)
            written = sorted(os.listdir(tmp))
        finally:
            os.chdir(here)
    losses = ns["result"].losses
    if not losses[-1] < losses[0]:
        fail(f"phase 17: the walkthrough's fit did not learn: {losses}")
    if not {"model.npz", "model.pt"} <= set(written):
        fail(f"phase 17: the walkthrough wrote {written}")
    on_card = {k: ns[k].device.type for k in ("xs", "forces", "traj",
                                                "wrapped", "imgs")}
    on_card["model"] = next(ns["model"].parameters()).device.type
    if set(on_card.values()) != {"cuda"}:
        fail(f"phase 17: outputs off the card: {on_card}")
    if not all(bool(torch.isfinite(ns[k]).all()) for k in ("forces", "traj",
                                                          "imgs")):
        fail("phase 17: the walkthrough's forces, trajectory or string are "
             "not finite")
    # the walkthrough's blocks call the eager modules and no fused op (its
    # CV is an eager PreprocessingANN; section 5 is prose)
    if launched != counts():
        fail(f"phase 17: the walkthrough launched {launched}, none expected")
    if wall > WALKTHROUGH_BUDGET_S:
        fail(f"phase 17: the walkthrough took {wall:.1f} s, past its budget "
             f"of {WALKTHROUGH_BUDGET_S} s")
    print(f"walkthrough (phase 17, {WALKTHROUGH}): {len(blocks)} blocks "
          f"in {wall:.2f} s of a {WALKTHROUGH_BUDGET_S:.0f} s budget, each "
          f"block's s: {', '.join(f'{t:.2f}' for t in seconds)}; fit loss "
          f"{losses[0]:.6g} -> {losses[-1]:.6g}; metadynamics max cos(phi) "
          f"{ns['escaped']:.4f}; wrote {', '.join(written)}; every output on "
          f"the card; launches {json.dumps(launched)}; card: {card}")
    return launched


EDGE_VALIDATION_FRAMES = 2048  # scripts/tpu_validation.py:129-131, config 5
EDGE_VALIDATION_SIGMA = 0.02   # its noise, Angstrom
EDGE_RAGGED = 8191             # a ragged last tile of K1/K4 and block of K2/K3
EDGE_STEPS = 10
EDGE_BUDGET_S = 60.0           # the phase fails past it
EDGE_KERNELS = ("forward", "cv_forces", "backward", "train")
# what phase 18 launches a model: K4 on three batches, two layouts and two
# components; K1 twice under no_grad and once under autograd; K2 once; K3
# in two layouts with and without ref_x, then once a training step
EDGE_LAUNCHES = {"cv_forces": 12, "forward": 3, "backward": 1,
                 "train": 4 + EDGE_STEPS}


def edge_model_ops(spec, dims, kind):
    """A lower bound on the f32 operations a frame of K1 (``forward``), K4
    (``cv_forces``), K2 (``backward``) or K3 (``train``) does on a model:
    the head's multiply-adds, once for its forward, once more for the
    inputs' cotangents where gx is formed and once more for the weights'
    gradients (K2, K3); every feature's forward and, where gx is formed,
    its adjoint (:data:`OPS`). The alignment is not counted."""
    weights = sum(a * b for a, b in zip(dims, dims[1:]))
    grad = kind in ("cv_forces", "backward")
    passes = 1 + grad + (kind in ("backward", "train"))
    n_pairs = sum(p for _, p in spec.coord_slices)
    return (2 * weights * passes
            + spec.n_angles * (OPS["angle"] + grad * OPS["angle_bwd"])
            + spec.n_bonds * (OPS["bond"] + grad * OPS["bond_bwd"])
            + spec.n_dihedrals * (OPS["dihedral"]
                                  + grad * OPS["dihedral_bwd"])
            + n_pairs * (OPS["pair_head"] + OPS["pair_tail_bwd" if grad
                                                else "pair_tail"]))


def edge_models_phase(dev, card):
    """Phase 18: K1-K4 at the edge of the unrolled envelope, on
    ``chignolin_model()`` (``scripts/tpu_validation.py``'s config 5) and
    ``envelope_corner_model()``, weights from seeded generators. The drive,
    with every launch count set to 0 before it and held to
    :data:`EDGE_LAUNCHES` after it: K4 through ``fused_cv_forces`` on
    config 5's 2,048 frames (0.02 of noise), 8,191 frames (a ragged tile)
    and one 65,536-frame batch made on the card, in the ``[l, n, 3]`` and
    ``[3n, l]`` layouts, components None and 0; K1 through
    ``fused_model_forward`` on the batch and on the 8,191 packed; K2 under
    autograd on the 8,191 (gx, every weight and ``ref_x``); K3 through
    ``fused_train_grads`` (``train_ref`` False and True, both layouts), then
    ``make_fused_train_step`` for 10 Adam steps on the batch, labelled by a
    teacher. Each output against its float64 plain version (the batch's K4
    and K1 on 4,096 sampled rows) at phase 4's and phase 6's tolerances, a
    lower loss after the 10 steps; then a second launch of each kernel to
    the same bits. Then on the batch each kernel's CUDA-event time with its
    wrapper beside its plain version's (in turns) and its time alone
    (``torch.profiler``, :func:`traced`), its bound (the bytes of
    ``unrolled_probe.frame_bytes`` over 3.35 TB/s, or
    :func:`edge_model_ops` over 67 TFLOP/s), the warps a block and blocks
    an SM of K1 and K4 and the frames a block of K2 and K3. Fails past
    :data:`EDGE_BUDGET_S`. Returns ``{kernel: {model: its line}}``."""
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.probes.unrolled_probe import frame_bytes
    from molann_tpu_torch.systems import (
        chignolin_model,
        envelope_corner_model,
    )
    from molann_tpu_torch.train import (
        make_fused_train_step,
        masked_optimizer,
        trainable_mask,
    )

    t_phase = time.perf_counter()
    retakes = dict(TRACE_RETAKES)
    lib = F._library()
    out = {k: {} for k in EDGE_KERNELS}
    for seed, (name, build) in enumerate((
            ("chignolin", chignolin_model),
            ("envelope_corner", envelope_corner_model))):
        def seeded(s):
            return build(generator=torch.Generator().manual_seed(s),
                         device=dev)[0]

        model, u = build(generator=torch.Generator().manual_seed(seed),
                         device=dev)
        if F.model_select_mode(model) != "unrolled":
            fail(f"phase 18: {name} is not routed to the unrolled kernels")
        parts = F._extract_model(model)
        spec, align_idx, ref_x, params, act = parts
        n, d = u.atoms.n_atoms, params[-1][0].shape[0]
        dims = (spec.out_dim, *(w.shape[0] for w, _ in params))
        x_val = noisy_frames(u, EDGE_VALIDATION_FRAMES, 31,
                             EDGE_VALIDATION_SIGMA, dev)
        x_rag = noisy_frames(u, EDGE_RAGGED, 32, 0.05, dev)
        gen = torch.Generator(device=dev).manual_seed(33)
        pos = torch.as_tensor(u.atoms.positions, dtype=torch.float32,
                              device=dev)
        x_big = pos + 0.05 * torch.randn(BATCH, n, 3, generator=gen,
                                         device=dev)
        xt_big = x_big.reshape(BATCH, 3 * n).T.contiguous()
        gy = torch.randn(EDGE_RAGGED, d, generator=gen, device=dev)
        with torch.no_grad():
            labels = F.fused_model_forward(seeded(seed + 10), x_big)
        yt_big = labels.T.contiguous()
        batches = {"2048": x_val, "8191": x_rag, "65536": x_big}
        student = seeded(seed + 20)
        opt = masked_optimizer(functools.partial(torch.optim.Adam, lr=1e-3),
                               trainable_mask(student))(student)
        step = make_fused_train_step(transposed_input=True)
        torch.cuda.synchronize()

        # the drive
        reset_counts()
        k4 = {}
        for label, xs in batches.items():
            xts = xs.reshape(xs.shape[0], 3 * n).T.contiguous()
            for comp in (None, 0):
                k4[label, "[l, n, 3]", comp] = F.fused_cv_forces(
                    model, xs, component=comp)
                y, g = F.fused_cv_forces(model, xts, component=comp,
                                         transposed_input=True)
                k4[label, "[3n, l]", comp] = (y.T, g.T.reshape(-1, n, 3))
        with torch.no_grad():
            y1_big = F.fused_model_forward(model, x_big)
            y1_rag = F.fused_model_forward(
                model, x_rag.reshape(EDGE_RAGGED, 3 * n))
        ref_x.requires_grad_(True)
        xg = x_rag.clone().requires_grad_(True)
        y2 = F.fused_model_forward(model, xg)
        got2 = torch.autograd.grad(y2, [xg, ref_x, *flat(params)], gy)
        ref_x.requires_grad_(False)
        k3 = {}
        for train_ref in (False, True):
            k3[train_ref, "[l, n, 3]"] = F.fused_train_grads(
                model, x_rag, gy, train_ref=train_ref)
            k3[train_ref, "[3n, l]"] = F.fused_train_grads(
                model, x_rag.reshape(EDGE_RAGGED, 3 * n).T.contiguous(),
                gy.T.contiguous(), transposed_input=True, train_ref=train_ref)
        losses = []
        for _ in range(EDGE_STEPS):
            student, opt, loss = step(student, opt, (xt_big, yt_big))
            losses.append(loss)
        torch.cuda.synchronize()
        launched = dict(F.KERNEL_LAUNCHES)
        if launched != counts(**EDGE_LAUNCHES):
            fail(f"phase 18, {name}: launch counts {launched}")

        # against float64 plain versions
        p64 = f64(parts)
        errs = dict.fromkeys(EDGE_KERNELS, 0.0)
        rows = torch.as_tensor(np.sort(np.random.default_rng(34).choice(
            BATCH, SAMPLE_ROWS, replace=False)), device=dev)
        for label, xs in batches.items():
            sample = rows if label == "65536" else slice(None)
            for comp in (None, 0):
                y_r, g_r = F.cv_forces_plain(*p64, xs[sample].double(), comp)
                for layout in ("[l, n, 3]", "[3n, l]"):
                    y, g = k4[label, layout, comp]
                    what = f"phase 18, {name}, K4 on {label} {layout} " \
                           f"frames, component={comp}"
                    ev = float((y[sample] - y_r).abs().max())
                    if not ev <= VAL_TOL:
                        fail(f"{what}: values {ev}")
                    errs["cv_forces"] = max(errs["cv_forces"], ev, worst(
                        [g[sample]], [g_r], what))
        for y, xs in ((y1_big[rows], x_big[rows]), (y1_rag, x_rag),
                      (y2.detach(), x_rag)):
            with torch.no_grad():
                y_r = F.forward_plain(*p64, xs.double())
            e = float((y - y_r).abs().max())
            if not e <= VAL_TOL:
                fail(f"phase 18, {name}, K1 on {xs.shape[0]} frames: {e}")
            errs["forward"] = max(errs["forward"], e)
        gx_r, gp_r, gref_r = F.backward_plain(*p64, x_rag.double(),
                                              gy.double())
        errs["backward"] = worst(got2, [gx_r, gref_r, *flat(gp_r)],
                                 f"phase 18, {name}, K2")
        for (train_ref, layout), (loss, grads) in k3.items():
            loss_r, gp_r, gref_r = F.train_grads_plain(
                *p64, x_rag.double(), gy.double(), train_ref)
            what = f"phase 18, {name}, K3 {layout}, train_ref={train_ref}"
            el = abs(float(loss) - float(loss_r))
            if not el <= LOSS_RTOL * abs(float(loss_r)):
                fail(f"{what}: loss {float(loss)} vs {float(loss_r)}")
            errs["train"] = max(errs["train"], el, worst(
                list(grads.values()), [*flat(gp_r), gref_r], what))
        losses = [float(v) for v in losses]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            fail(f"phase 18, {name}: {EDGE_STEPS} steps did not lower the "
                 f"loss: {losses}")

        # a second launch of each gives the same bits
        y, g = F.fused_cv_forces(model, xt_big, transposed_input=True)
        same = (torch.equal(y.T, k4["65536", "[3n, l]", None][0])
                and torch.equal(g.T.reshape(-1, n, 3),
                                k4["65536", "[3n, l]", None][1]))
        with torch.no_grad():
            same &= torch.equal(F.fused_model_forward(model, x_big), y1_big)
        ref_x.requires_grad_(True)
        xg = x_rag.clone().requires_grad_(True)
        again = torch.autograd.grad(F.fused_model_forward(model, xg),
                                    [xg, ref_x, *flat(params)], gy)
        ref_x.requires_grad_(False)
        same &= all(torch.equal(a, b) for a, b in zip(again, got2))
        loss, grads = F.fused_train_grads(model, x_rag, gy, train_ref=True)
        loss_0, grads_0 = k3[True, "[l, n, 3]"]
        same &= torch.equal(loss, loss_0) and all(
            torch.equal(grads[k], grads_0[k]) for k in grads)
        if not same:
            fail(f"phase 18, {name}: two launches of a kernel differ")

        # times on the batch, bounds, grids and tiles
        gyb = torch.randn(BATCH, d, generator=gen, device=dev)
        xgb = x_big.clone().requires_grad_(True)
        yk = F.fused_model_forward(model, xgb)
        with torch.enable_grad():
            xp = x_big.clone().requires_grad_(True)
            pp = tuple((w.detach().requires_grad_(True),
                        b.detach().requires_grad_(True)) for w, b in params)
            yp = F.forward_plain(spec, align_idx, ref_x, pp, act, xp)

        def no_grad(fn):
            def call():
                with torch.no_grad():
                    return fn()
            return call

        calls = {
            "cv_forces": (lambda: F.fused_cv_forces(model, x_big),
                          lambda: F.cv_forces_plain(*parts, x_big),
                          r"fused_unrolled_kernel<(true|1)", (False, True, d)),
            "cv_forces [3n, l]": (
                lambda: F.fused_cv_forces(model, xt_big,
                                          transposed_input=True),
                lambda: F.cv_forces_plain(*parts, x_big),
                r"fused_unrolled_kernel<(true|1)", (True, True, d)),
            "forward": (no_grad(lambda: F.fused_model_forward(model, x_big)),
                        no_grad(lambda: F.forward_plain(*parts, x_big)),
                        r"fused_unrolled_kernel<(false|0)", (False, False, d)),
            "backward": (
                lambda: torch.autograd.grad(yk, [xgb, *flat(params)], gyb,
                                            retain_graph=True),
                lambda: torch.autograd.grad(yp, [xp, *flat(pp)], gyb,
                                            retain_graph=True),
                r"fused_grads_kernel<(false|0)", (False, True, d)),
            "train": (
                lambda: F.fused_train_grads(model, xt_big, yt_big,
                                            transposed_input=True),
                lambda: F.train_grads_plain(*parts, x_big, labels),
                r"fused_grads_kernel<(true|1)", (True, False, d)),
        }
        st = F._statics(spec, align_idx, act, params, dev)
        tiles = {"forward": st.grid(lib, "forward", dev),
                 "cv_forces": st.grid(lib, "cv_forces", dev),
                 "backward": st.frames(lib, "backward", True),
                 "train": st.frames(lib, "train", False)}
        line = {"phase": 18, "model": name, "atoms": n,
                "columns": spec.out_dim, "head": list(dims),
                "pairs": sum(p for _, p in spec.coord_slices),
                "frames_a_block_backward_without_gx": st.frames(
                    lib, "backward_nogx", True),
                "frames_a_block_train_with_ref": st.frames(lib, "train",
                                                           True),
                "loss": [losses[0], losses[-1]]}
        for label, (kernel_fn, plain_fn, pattern, fb) in calls.items():
            kind = label.split()[0]
            ms, plain = alternate(plain_fn, kernel_fn, 3, 20)
            alone, _ = profiled_ms(kernel_fn, pattern)
            b_ms, b_by = bound(BATCH * frame_bytes(F, model, *fb),
                               BATCH * edge_model_ops(spec, dims, kind))
            row = {"ms": ms, "plain_ms": plain, "alone_ms": alone,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "bytes_a_frame": frame_bytes(F, model, *fb)}
            if label != kind:
                out[kind][name]["[3n, l]"] = row
                continue
            if kind in ("forward", "cv_forces"):
                warps, per_sm, _ = tiles[kind]
                row.update(warps_a_block=warps, blocks_an_sm=per_sm)
            else:
                row["frames_a_block"] = tiles[kind]
            out[kind][name] = {"launches": launched[kind],
                               "max_abs_err": errs[kind], **row}
            line[kind] = out[kind][name]
        print(json.dumps({**line, "card": card}))
        del yk, yp, xgb, xp
    reset_counts()
    wall = time.perf_counter() - t_phase
    if wall > EDGE_BUDGET_S:
        fail(f"phase 18 took {wall:.1f} s of its {EDGE_BUDGET_S} s budget")
    print(f"edge of the unrolled envelope (phase 18): {wall:.2f} s of a "
          f"{EDGE_BUDGET_S:.0f} s budget; profiler retakes "
          + json.dumps({k: TRACE_RETAKES[k] - retakes[k]
                        for k in TRACE_RETAKES}) + f"; card: {card}")
    return out


def examples_phase(dev, card):
    """Phase 16: the ten port examples on ``dev``. Returns ``{kernel:
    launches}`` of K4 and K6 over the phase."""
    import importlib

    from molann_tpu_torch.io import load_artifact, load_model
    from molann_tpu_torch.ops import fused as F
    from molann_tpu_torch.sampling import ToyPeptidePotential
    from molann_tpu_torch.systems import alanine_universe
    from molann_tpu_torch.train import force_fn, packed_batch_iterator

    def ex(name):
        return importlib.import_module(f"molann_tpu_torch.examples.{name}")

    import gc

    gc.collect()  # the earlier phases' garbage, out of the loops' way
    t_phase = time.perf_counter()
    launched = {"cv_forces": 0, "blocked_forward": 0}
    lines = []
    on_card = dev.type == "cuda"

    def run(name, depth, fn, stages, *modules):
        reset_counts()
        with stages(ex(name), *modules):
            out, wall = stages._timed(fn)
        got = {k: F.KERNEL_LAUNCHES[k] for k in launched}
        for k in launched:
            launched[k] += got[k]
        lines.append(example_line(name, depth, wall, stages, got, out))
        return out, got

    # (a) serving from a .dcd through K4: one launch a batch of 1024
    mod = ex("serve_biased_md")
    out, got = run("serve_biased_md", "full", lambda: mod.main(device=dev),
                   ExampleStages(dev))
    n_batches = math.ceil(mod.N_FRAMES / mod.BATCH)
    if dict(F.KERNEL_LAUNCHES) != counts(
            cv_forces=n_batches if on_card else 0):
        fail(f"phase 16, serve_biased_md: launches {dict(F.KERNEL_LAUNCHES)}"
             f", expected {n_batches} of K4")
    if out["n_done"] != mod.N_FRAMES or out["launches"] != got["cv_forces"]:
        fail(f"phase 16, serve_biased_md: served {out['n_done']}")
    if out["cvs"].device.type != dev.type or out["forces"].device.type != \
            dev.type:
        fail("phase 16, serve_biased_md: outputs off the card")
    model = load_model(out["model_path"], device=dev)
    xb = next(iter(packed_batch_iterator(out["traj"], mod.BATCH,
                                         shuffle=False, epochs=1)))
    parts = F._extract_model(model)
    x3 = torch.as_tensor(xb, device=dev).reshape(mod.BATCH, -1, 3)
    y_ref, g_ref = F.cv_forces_plain(*parts, x3, component=0)
    ev = float((out["cvs"] - y_ref).abs().max())
    eg = float((-out["forces"].reshape(g_ref.shape) - g_ref).abs().max())
    if not (ev <= VAL_TOL and eg <= grad_tol(g_ref)):
        fail(f"phase 16, serve_biased_md: the first batch against K4's "
             f"plain version: values {ev}, gradients {eg}")
    serve_err = max(ev, eg)

    # (b) the autoencoder CV, its artifact and forces
    mod = ex("train_autoencoder_cv")
    out, _ = run("train_autoencoder_cv", "full", lambda: mod.main(device=dev),
                 ExampleStages(dev))
    if not out["losses"][-1] < 0.1 * out["losses"][0]:
        fail(f"phase 16, train_autoencoder_cv: losses {out['losses'][0]} "
             f"-> {out['losses'][-1]}")
    cv_model, x = out["cv_model"], out["x"]
    y, g = load_artifact(out["artifact"], device=dev)(x)
    with torch.no_grad():
        ev = float((y - cv_model(x)).abs().max())
    f = force_fn(cv_model, 0)(x) + force_fn(cv_model, 1)(x)
    eg = float((-g - f).abs().max())
    if not (ev <= VAL_TOL and eg <= grad_tol(f)) or g.device.type != \
            dev.type:
        fail(f"phase 16, train_autoencoder_cv: the artifact against the "
             f"model: values {ev}, gradients {eg} (force_fn summed)")

    # (c) the condensed phase through K6
    mod = ex("condensed_phase_cv")
    res, got = run("condensed_phase_cv", "quick",
                   lambda: mod.main(quick=True, device=dev),
                   ExampleStages(dev))
    if dict(F.KERNEL_LAUNCHES) != counts(
            blocked_forward=1 if on_card else 0):
        fail(f"phase 16, condensed_phase_cv: launches "
             f"{dict(F.KERNEL_LAUNCHES)}, expected one of K6")
    # (the JAX test's cv_gap > 3 cv_spread is not held but the held-out
    # accuracy in its place: see tests/test_torch_port_examples_serving.py::
    # test_condensed_phase_cv_outcome; the line above carries all three)
    if not (res["fused_mode"] == "blocked" and res["fused_rel_err"] < 1e-4
            and res["shell1_fluid"] < res["shell1_solid"] - 1.0
            and res["cv_accuracy"] > 0.8):
        fail(f"phase 16, condensed_phase_cv: {res}")

    # (d) the committor test and the committee, at quick size
    mod = ex("committor_cv")
    res, _ = run("committor_cv", "quick",
                 lambda: mod.main(quick=True, device=dev), ExampleStages(dev))
    if not (res["loss1"] < 0.1 * res["loss0"] and res["pred_q_a"] < 0.1
            and res["pred_q_b"] > 0.9 and abs(res["pred_q_mid"] - 0.5) < 0.05
            and res["resolved_mid"] > 0.6 and res["emp_q_a"] < 0.15
            and res["emp_q_b"] > 0.85 and 0.3 < res["emp_q_mid"] < 0.75):
        fail(f"phase 16, committor_cv: {res}")
    mod = ex("committee_uncertainty")
    res, _ = run("committee_uncertainty", "quick",
                 lambda: mod.main(quick=True, device=dev), ExampleStages(dev))
    if not (res["ratio"] > 3.0 and np.asarray(res["losses"])[-1].mean()
            < 0.2):
        fail(f"phase 16, committee_uncertainty: ratio {res['ratio']}")

    # (e) the five long sampling examples at their cut depth
    def cut(name, through_main=False):
        # the profiler's window on the stage each example is about, its
        # metadynamics where it has one (a window costs seconds of the
        # budget); an example run through main has its library calls cut
        main = ("overdamped_langevin" if name == "train_timelagged_cv"
                else "metadynamics_langevin")
        if not through_main:
            return ExampleStages(dev, profiled=(main,))
        return ExampleStages(dev, steps=EXAMPLE_STEPS[name],
                             train=EXAMPLE_TRAIN, profiled=(main,))

    def depth(name):
        return (f"cut: dynamics <= {EXAMPLE_STEPS[name]} steps, training "
                f"{EXAMPLE_TRAIN} steps"
                + (f", string {EXAMPLE_STRING} iterations"
                   if name == "path_kinetics" else ""))

    biased = ex("biased_dynamics")
    for name in ("biased_dynamics", "adaptive_cv_loop"):
        mod = ex(name)
        res, _ = run(name, depth(name),
                     lambda: mod.main(quick=True, device=dev),
                     cut(name, through_main=True), biased)
        if not all(np.isfinite(v) for v in res.values()
                   if isinstance(v, float) and v != float("inf")):
            fail(f"phase 16, {name}: {res}")

    mod = ex("train_eigenfunction_cv")

    def eigenfunctions():
        u = alanine_universe()
        pot = ToyPeptidePotential(u, barrier=mod.BARRIER)
        staged = mod.sample_both_basins(
            u, pot, n_steps=EXAMPLE_STEPS["train_eigenfunction_cv"],
            generator=torch.Generator(dev).manual_seed(0))
        return mod.learn_eigenfunctions(u, *staged, num_steps=EXAMPLE_TRAIN)

    name = "train_eigenfunction_cv"
    res, _ = run(name, depth(name), eigenfunctions, cut(name), biased)
    if not np.isfinite(res["eigenvalues"]).all():
        fail(f"phase 16, {name}: {res}")

    mod = ex("train_timelagged_cv")

    def timelagged():
        u = alanine_universe()
        pot = ToyPeptidePotential(u, barrier=mod.BARRIER)
        traj, cos_phi, hops = mod.sample_hopping(
            u, pot, n_steps=EXAMPLE_STEPS["train_timelagged_cv"],
            generator=torch.Generator(dev).manual_seed(0))
        return {"hops": hops, **mod.learn_cv(
            u, traj, cos_phi, num_steps=EXAMPLE_TRAIN, device=dev)}

    name = "train_timelagged_cv"
    res, _ = run(name, depth(name), timelagged, cut(name))
    if not np.isfinite([res["tica_ac"], res["vamp_ac"], res["vamp2"]]).all():
        fail(f"phase 16, {name}: {res}")

    # path_kinetics' stages on the card; its MSM, TPT and first passages
    # are host numpy, which a cut run gives too few transitions
    mod = ex("path_kinetics")

    def path_stages():
        from molann_tpu_torch.sampling import PathCV

        imgs, e = mod.find_path(n_iterations=EXAMPLE_STRING, device=dev)
        path = PathCV(imgs)
        steps = EXAMPLE_STEPS["path_kinetics"]
        x_u, x_b = mod.cold_runs(path, n_steps=steps, device=dev)
        s = mod.warm_run(path, n_steps=steps, device=dev)
        return {"barrier": float(e.max()), "s_frames": len(s),
                "cold_unbiased_max_x": float(x_u.max()),
                "cold_biased_max_x": float(x_b.max())}

    name = "path_kinetics"
    res, _ = run(name, depth(name), path_stages, cut(name))
    if not (abs(res["barrier"] - 1.0) < 0.01 and np.isfinite(
            [res["cold_unbiased_max_x"], res["cold_biased_max_x"]]).all()):
        fail(f"phase 16, {name}: {res}")

    seconds = time.perf_counter() - t_phase
    print(f"examples (phase 16, {seconds:.1f} s of a {EXAMPLE_BUDGET_S:.0f} s "
          f"budget): ten examples on {dev}; K4 launches {launched['cv_forces']}"
          f", K6 launches {launched['blocked_forward']}; serve_biased_md's "
          f"first batch against K4's plain version {serve_err:.3g}; "
          f"card: {card}")
    if on_card and seconds > EXAMPLE_BUDGET_S:
        fail(f"phase 16 took {seconds:.1f} s, past its budget of "
             f"{EXAMPLE_BUDGET_S:.0f} s")
    return launched, lines


PHASE_CHILD_TIMEOUT_S = 600


def phase_in_child(number):
    """Phase ``number`` run as ``chip_smoke.py --phase N`` in a child process
    (under :data:`PHASE_CHILD_TIMEOUT_S`), its output passed through; what
    the phase returned comes back on the child's last line. Phases 16 and
    18 run so: the ``torch.profiler`` traces of the earlier phases leave a
    process's launches slower (``python -m
    molann_tpu_torch.probes.edge_mm_probe residue``) and its later traces
    short of their closing spins (``PERF.md`` §6, PR 18), and their budgets
    measure their own work."""
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "--phase", str(number)],
        capture_output=True, text=True, timeout=PHASE_CHILD_TIMEOUT_S)
    sys.stdout.write(proc.stdout)
    sys.stderr.write(proc.stderr)
    if proc.returncode != 0:
        fail(f"phase {number} in its own process exited {proc.returncode}")
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    if last.get("phase") != number or not last.get("passed"):
        fail(f"phase {number} in its own process ended with {last}")
    return last["returned"]


def warm_up(dev):
    """What a full run's earlier phases leave warm in its process, done
    before phase 16 alone starts its clock: TorchScript's first scripted
    module and its first calls, and an eager training step (autograd,
    Adam) on the card."""
    lin = torch.nn.Linear(4, 2).to(dev)
    x = torch.randn(8, 4, device=dev)
    scripted = torch.jit.script(lin)
    for _ in range(3):
        scripted(x)
    opt = torch.optim.Adam(lin.parameters())
    lin(x).square().mean().backward()
    opt.step()
    torch.cuda.synchronize()


def options(argv):
    """``{"phase": None or 9, 16, 17 or 18, "repeat": n, "k9_readings": None or
    (rounds, path)}`` from the command line (see the module's docstring's
    end)."""
    opts = {"phase": None, "repeat": 1, "k9_readings": None}
    args = list(argv)
    while args:
        a = args.pop(0)
        if a == "--phase" and args and args[0] in ("9", "16", "17", "18"):
            opts["phase"] = int(args.pop(0))
        elif a == "--repeat" and args and args[0].isdigit():
            opts["repeat"] = int(args.pop(0))
        elif a == "--k9-readings" and len(args) >= 2 and args[0].isdigit():
            opts["k9_readings"] = (int(args.pop(0)), args.pop(0))
        else:
            fail(f"unknown arguments {argv}: use no argument, --phase "
                 f"9|16|17|18 "
                 f"[--repeat N] or --k9-readings ROUNDS OUT")
    return opts


def main():
    opts = options(sys.argv[1:])
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

    if opts["phase"] is not None:
        phase = {9: edge_phase, 16: examples_phase, 17: walkthrough_phase,
                 18: edge_models_phase}[opts["phase"]]
        if opts["phase"] == 16:
            warm_up(dev)
        for run in range(1, opts["repeat"] + 1):
            t0 = time.perf_counter()
            got = phase(dev, card)
            print(json.dumps({"phase": opts["phase"], "run": run,
                              "passed": True,
                              "s": time.perf_counter() - t0, "card": card,
                              "profiler_retakes": TRACE_RETAKES,
                              "returned": got[0] if opts["phase"] == 16
                              else got}))
        return

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
    for l in (CHECK_FRAMES, CHECK_FRAMES - 1):  # the second: a ragged tile
        xl = x[:l]
        y_ref = F.forward_plain(*parts, xl).detach()
        for xin in (xl, xl.reshape(l, 3 * n)):
            y = F.fused_model_forward(model, xin).detach()
            e = float((y - y_ref).abs().max())
            if not e <= VAL_TOL:
                fail(f"forward kernel vs plain on {tuple(xin.shape)}: {e}")
            max_err["forward"] = max(max_err["forward"], e)
        for comp in (None, 0):
            y_ref, g_ref = F.cv_forces_plain(*parts, xl, comp)
            y, g = F.fused_cv_forces(model, xl, component=comp)
            yt, gt = F.fused_cv_forces(model, x_t[:, :l].contiguous(),
                                       component=comp, transposed_input=True)
            for name, yy, gg in (("[l, n, 3]", y, g),
                                 ("[3n, l]", yt.T, gt.T.reshape(-1, n, 3))):
                ev = float((yy - y_ref).abs().max())
                eg = float((gg - g_ref).abs().max())
                if not (ev <= VAL_TOL and eg <= grad_tol(g_ref)):
                    fail(f"cv+forces kernel vs plain, {name}, {l} frames, "
                         f"component={comp}: values {ev}, gradients {eg}")
                max_err["cv_forces"] = max(max_err["cv_forces"], ev, eg)
    torch.cuda.synchronize()
    print(f"kernels vs plain on {CHECK_FRAMES} and {CHECK_FRAMES - 1} frames: "
          f"max abs err forward {max_err['forward']:.3g}, cv_forces "
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

    # 5b. the bench op as bench.py runs it, on frames made on the card
    bench_op_phase(F, model, parts, u, dev, card)

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

    from molann_tpu_torch.probes import unrolled_probe

    steps = unrolled_probe.phase_table(dev)
    print("K4 and K1 by step (probes/unrolled_probe.py phases: a clock read "
          "in every warp before each step, each step's share of the warps' "
          f"cycles times the kernel's time with the reads, ms; one {BATCH}-"
          f"frame batch), with resources and warps an SM: "
          f"{json.dumps(steps)}; card: {card}")

    # (f) the heads PR 6 added, and a wide head under "auto"
    head_phase(dev)

    with tempfile.TemporaryDirectory() as tmp:
        # 7. the blocked serving path
        blocked_kernels, blocked_models = blocked_phase(dev, card, model, x,
                                                        tmp)
        # 8. the blocked training path
        blocked_kernels += blocked_train_phase(dev, card, model, x,
                                               blocked_models, tmp)
    if opts["k9_readings"] is not None:
        k9_readings(*opts["k9_readings"], card)
    # 9. the edge-product probe
    for run in range(1, opts["repeat"] + 1):
        t0 = time.perf_counter()
        edge_kernel = edge_phase(dev, card)
        if opts["repeat"] > 1:
            print(json.dumps({"phase": 9, "run": run, "passed": True,
                              "s": time.perf_counter() - t0, "card": card}))
    if opts["k9_readings"] is not None:
        return
    # 10. coordination features in the unrolled kernels
    coordination_phase(dev)
    # 11. the CV-learning objectives through the train command
    objectives_phase(dev, card)
    # 12. serving from trajectory files through the commands
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches = files_phase(dev, card, tmp)
    # 13. the enhanced-sampling loop through the commands
    with tempfile.TemporaryDirectory() as tmp:
        sample_launches = sampling_phase(dev, card, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        # 14. the engine artifact: K1/K4/K6/K8 as torch custom ops
        engine = engine_phase(dev, card, tmp)
        # 15. data parallelism and multi-device serving
        mesh_launches = mesh_phase(dev, card, tmp)
    # 16. the ten workflow examples, in a process of their own
    example_launches = phase_in_child(16)
    # 17. the walkthrough
    walkthrough_launches = walkthrough_phase(dev, card)
    # 18. K1-K4 at the edge of the unrolled envelope, in a process of its own
    edge_models = phase_in_child(18)
    print(json.dumps({"profiler_retakes": TRACE_RETAKES,
                      "off_spins_traced_over_timed": TRACE_RATIOS,
                      "card": card}))

    def alanine_bound(kind):
        # as timed above: K1, K4 and K2 on [l, n, 3], K3 on [3n, l]
        n_bytes = unrolled_probe.frame_bytes(
            F, model, kind == "train", kind in ("cv_forces", "backward"), 3)
        b_ms, b_by = bound(BATCH * n_bytes, BATCH * ALANINE_OPS[kind])
        return {"bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    src = "molann_tpu_torch/csrc/fused_unrolled.cu"
    src_train = "molann_tpu_torch/csrc/fused_train.cu"
    kernels = [
        {"name": "cv_forces", "route": "cuda", "source": src,
         "replaces": "molann_tpu/ops/fused.py:1116",
         "launches": launches["cv_forces"],
         "cli_launches": cli_launches["cv_forces"],
         "mesh_launches": mesh_launches["cv_forces"],
         "examples_launches": example_launches["cv_forces"],
         "max_abs_err": max_err["cv_forces"], "ms": ms_k4,
         "plain_ms": ms_p4, "alone_ms": split["cv_forces"][0],
         **alanine_bound("cv_forces"), **engine["cv_forces"]},
        {"name": "forward", "route": "cuda", "source": src,
         "replaces": "molann_tpu/ops/fused.py:578",
         "launches": launches["forward"],
         "cli_launches": cli_launches["forward"],
         "sample_launches": sample_launches["forward"],
         "mesh_launches": mesh_launches["forward"],
         "max_abs_err": max_err["forward"], "ms": ms_k1,
         "plain_ms": ms_p1, "alone_ms": split["forward"][0],
         **alanine_bound("forward"), **engine["forward"]},
        {"name": "backward", "route": "cuda", "source": src_train,
         "replaces": "molann_tpu/ops/fused.py:586",
         "launches": fit_launches["backward"],
         "sample_launches": sample_launches["backward"],
         "mesh_launches": mesh_launches["backward"],
         "max_abs_err": max_err["backward"], "ms": ms_k2,
         "plain_ms": ms_p2, "alone_ms": split["backward"][0],
         **alanine_bound("backward")},
        {"name": "train", "route": "cuda", "source": src_train,
         "replaces": "molann_tpu/ops/fused.py:900",
         "launches": fused_launches["train"],
         "mesh_launches": mesh_launches["train"],
         "max_abs_err": max_err["train"], "ms": ms_k3,
         "plain_ms": ms_p3, "alone_ms": split["train"][0],
         **alanine_bound("train")},
        *({**k, **({"cli_launches": cli_launches[k["name"]]}
                   if k["name"] in cli_launches else {}),
           **({"sample_launches": sample_launches[k["name"]]}
              if k["name"] in sample_launches else {}),
           **({"mesh_launches": mesh_launches[k["name"]]}
              if k["name"] in mesh_launches else {}),
           **({"examples_launches": example_launches[k["name"]]}
              if k["name"] in example_launches else {}),
           **engine.get(k["name"], {})}
          for k in blocked_kernels),
        edge_kernel,
    ]
    for k in kernels:  # phase 17: what the walkthrough's blocks launched
        k["walkthrough_launches"] = walkthrough_launches[k["name"]]
        if k["name"] in edge_models:  # phase 18: K1-K4 on the edge models
            k["edge_models"] = edge_models[k["name"]]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.stdout.flush()
