"""Fused align+feature+MLP ops: CUDA kernels and their plain versions.

The entry points, with the JAX signatures. ``mode="auto"`` picks the
formulation by system size (:func:`select_mode`): the unrolled family
below for systems of at most 64 atoms, 96 columns and 96 coordination
pairs, the blocked family of :mod:`.fused_blocked` (kernels K5 to K8) for
everything larger.

Port of the unrolled family of ``molann_tpu/ops/fused.py``:

- :func:`fused_model_forward` — values, differentiable with respect to x,
  the MLP parameters and ``ref_x``; on a CUDA tensor it launches the CUDA
  kernel that replaces the Pallas ``_fwd_kernel`` (K1), and its backward
  launches the one that replaces ``_bwd_kernel`` (K2);
- :func:`fused_cv_forces` — values and coordinate gradients in one pass
  (the biased-MD serving op); on a CUDA tensor it launches the CUDA kernel
  that replaces ``_cv_forces_kernel`` (K4);
- :func:`fused_train_grads` — the MSE loss and its parameter gradients in
  one pass (the training op); on a CUDA tensor it launches the CUDA kernel
  that replaces ``_train_kernel`` (K3).

The kernels live in ``molann_tpu_torch/csrc/`` (K1 and K4 in
``fused_unrolled.cu``, K2 and K3 in ``fused_train.cu``) and are built by
``nvcc`` at first use (:mod:`._build`). Each has a plain PyTorch version
beside it here (:func:`forward_plain`, :func:`backward_plain`,
:func:`train_grads_plain`, :func:`cv_forces_plain`): a wrapper takes the
plain version only when its input lies on the CPU. On a CUDA tensor it
launches the kernel or raises; it never falls back. ``KERNEL_LAUNCHES``
counts the launches of each kernel.

The wrappers keep the JAX signatures. ``tile``, ``bwd_tile``,
``interpret`` and ``remat`` are accepted and change nothing: they set the
TPU kernels' VMEM tiling, and the CUDA kernels mask the ragged last block
by frame index instead of padding. ``precision`` is resolved and
otherwise ignored, as in the unrolled TPU kernels, which have no matmuls.
"""

from __future__ import annotations

import ctypes
import numbers

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ..parallel.data_parallel import ShardedModel
from ..spec import CompiledFeatures
from .alignment import kabsch_covariance, rotation_qcp
from .features import (
    angle_features,
    bond_features,
    coordination_features,
    dihedral_features,
)

__all__ = [
    "fused_apply",
    "fused_model_forward",
    "fused_cv_forces",
    "fused_train_grads",
    "forward_plain",
    "backward_plain",
    "train_grads_plain",
    "cv_forces_plain",
    "select_mode",
    "model_select_mode",
    "model_chunk_matrix",
    "active_atom_indices",
    "resolve_precision",
    "qcp_rotation",
    "artifact_tables",
    "KERNEL_LAUNCHES",
]

# Envelope of the unrolled family (molann_tpu/ops/fused.py:72-74) ...
UNROLLED_MAX_ATOMS = 64
UNROLLED_MAX_COLS = 96
UNROLLED_MAX_COORD_PAIRS = 96
# ... and the unrolled CUDA kernels' caps on the MLP head
# (csrc/frame_math.cuh); a head past them goes to the blocked kernels
KERNEL_MAX_WIDTH = 64
KERNEL_MAX_LAYERS = 4
# The activations of both kernel families, every name
# ``molann_tpu.io.serialize`` writes (``MOLANN_ACT_*`` in frame_math.cuh).
KERNEL_ACTIVATIONS = {"identity": 0, "tanh": 1, "relu": 2, "sigmoid": 3,
                      "gelu": 4, "elu": 5, "celu": 6, "softplus": 7,
                      "swish": 8}
# Floats of one coordination feature's parameters (csrc/frame_math.cuh).
COORD_FLOATS = 20

# Launches of each CUDA kernel, counted by the wrappers where they launch.
KERNEL_LAUNCHES = {"forward": 0, "cv_forces": 0, "backward": 0, "train": 0,
                   "blocked_forward": 0, "blocked_cv_forces": 0,
                   "blocked_backward": 0, "blocked_train": 0, "edge_mm": 0}


def select_mode(spec, n_atoms: int) -> str:
    """``"unrolled"`` for systems inside the unrolled envelope, else
    ``"blocked"`` (same rule as ``molann_tpu.ops.fused.select_mode``)."""
    n_pairs = sum(np_ for _, np_ in spec.coord_slices)
    if (spec.out_dim <= UNROLLED_MAX_COLS and n_atoms <= UNROLLED_MAX_ATOMS
            and n_pairs <= UNROLLED_MAX_COORD_PAIRS):
        return "unrolled"
    return "blocked"


def head_fits_unrolled(params) -> bool:
    """Whether an MLP head is inside the unrolled kernels' caps: at most
    ``KERNEL_MAX_LAYERS`` Linear layers of width ``KERNEL_MAX_WIDTH``."""
    return len(params) <= KERNEL_MAX_LAYERS and all(
        w.shape[0] <= KERNEL_MAX_WIDTH for w, _ in params)


def model_select_mode(model) -> str:
    """Which fused formulation a model gets under ``mode="auto"``:
    :func:`select_mode` of its system size, and ``"blocked"`` for a small
    system whose head is wider or deeper than the unrolled kernels take."""
    spec, _, _, params, _ = _extract_model(model)
    return _auto_mode(spec, params)


def _auto_mode(spec, params):
    mode = select_mode(spec, spec.n_input_atoms)
    return mode if head_fits_unrolled(params) else "blocked"


def model_chunk_matrix(model):
    """The pair operand of a model's coordination features as an int32
    numpy array, or None when no feature has more than 512 pairs (see
    :func:`.fused_blocked.chunk_matrix`). Move it to the device once and
    pass it to every call, so a large pair table is one device buffer::

        c = torch.as_tensor(model_chunk_matrix(model), device="cuda")
        y, g = fused_cv_forces(model, x, c_mat=c)
    """
    from .fused_blocked import chunk_matrix

    spec, align_idx = _extract_model(model)[:2]
    return chunk_matrix(spec, align_idx)


def active_atom_indices(model):
    """0-based input-group indices of the atoms any feature (or the align
    subset) references: the rows of a ``compact_grads=True`` gradient from
    :func:`fused_cv_forces`. All other atoms have exactly-zero gradients.
    ``None`` means every atom is active (the gradient is full-width)."""
    from .fused_blocked import blocked_layout

    spec, align_idx = _extract_model(model)[:2]
    lay = blocked_layout(spec, align_idx)
    return None if lay.active_idx is None else lay.active_idx.copy()


def resolve_precision(precision: str, *, training: bool) -> str:
    """``"auto"`` → ``"tf32"`` on training paths, ``"exact"`` on serving
    paths; explicit names pass through (``molann_tpu/ops/fused.py:831``)."""
    if precision == "auto":
        return "tf32" if training else "exact"
    if precision not in ("exact", "tf32", "bf16"):
        raise ValueError(
            f"unknown precision {precision!r}: "
            "choose 'auto', 'exact', 'tf32', or 'bf16'")
    return precision


def _extract_model(model):
    """``(spec, align_idx, ref_x, params, activation)`` of a model; params
    are ``(W [d_out, d_in], b [d_out])`` per Linear, activation a name."""
    from ..models.ann import (
        FeatureLayer,
        Identity,
        MolANN,
        PreprocessingANN,
        SequentialNN,
    )

    head = None
    if isinstance(model, MolANN):
        pp, head = model.preprocessing_layer, model.ann_layers
    elif isinstance(model, (PreprocessingANN, FeatureLayer)):
        pp = model
    else:
        raise TypeError(f"cannot run {type(model).__name__} via the fused path")
    if isinstance(pp, FeatureLayer):
        flayer, align_layer = pp, None
    else:
        flayer, align_layer = pp.feature_layer, pp.align_layer
        if isinstance(align_layer, Identity):
            align_layer = None
    if align_layer is not None:
        align_idx = tuple(align_layer._local_align_atom_indices)
        ref_x = align_layer.ref_x
    else:
        align_idx, ref_x = None, None
    params, activation = (), "tanh"
    if head is not None:
        if not isinstance(head, SequentialNN):
            raise TypeError("fused path requires a SequentialNN head")
        params = tuple((lin.weight, lin.bias) for lin in head.layers)
        activation = head.activation
    return flayer.spec, align_idx, ref_x, params, activation


def _resolve_mode(spec, params, mode, c_mat):
    """``"unrolled"`` or ``"blocked"`` for a call's ``mode``
    (:func:`model_select_mode` under ``"auto"``); ``c_mat`` is refused
    outside the blocked formulation."""
    if mode == "auto":
        mode = _auto_mode(spec, params)
    if mode == "blocked":
        return mode
    if mode != "unrolled":
        raise ValueError(f"unknown mode {mode!r}: choose 'auto', 'unrolled' "
                         "or 'blocked'")
    if c_mat is not None:
        raise ValueError("c_mat applies to the blocked formulation only "
                         "(mode='blocked'; auto selected 'unrolled' for this "
                         "system)")
    return mode


def _check_envelope(spec, params, activation):
    """What the CUDA kernels compute, checked for every input device so that
    a model behaves the same on the CPU and on the card."""
    n_pairs = sum(npairs for _, npairs in spec.coord_slices)
    if n_pairs > UNROLLED_MAX_COORD_PAIRS:
        raise ValueError(
            f"{n_pairs} coordination pairs are outside the unrolled kernels' "
            f"envelope ({UNROLLED_MAX_COORD_PAIRS} pairs): use mode='blocked'")
    if activation not in KERNEL_ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; the CUDA "
                         f"kernels take {sorted(KERNEL_ACTIVATIONS)}")
    if spec.n_input_atoms > UNROLLED_MAX_ATOMS or spec.out_dim > UNROLLED_MAX_COLS:
        raise ValueError(
            f"{spec.n_input_atoms} atoms / {spec.out_dim} feature columns are "
            f"outside the unrolled kernels' envelope ({UNROLLED_MAX_ATOMS} "
            f"atoms, {UNROLLED_MAX_COLS} columns)")
    if not head_fits_unrolled(params):
        raise ValueError(
            f"the unrolled CUDA kernels take at most {KERNEL_MAX_LAYERS} "
            f"Linear layers of width <= {KERNEL_MAX_WIDTH}; got "
            f"{[tuple(w.shape) for w, _ in params]}: use mode='blocked'")


def _out_dim(spec, params):
    return params[-1][0].shape[0] if params else spec.out_dim


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels (mirror _forward_tiles,
# molann_tpu/ops/fused.py:525-548)
# ---------------------------------------------------------------------------


def forward_plain(spec: CompiledFeatures, align_idx, ref_x, params, activation,
                  x):
    """The plain version of the forward kernel: ``x [l, n, 3] → [l, d_out]``.

    Only the atoms that feed position features are Kabsch-aligned (by QCP);
    the other features are rigid-motion invariant and read ``x``."""
    from ..models.ann import ACTIVATIONS

    l = x.shape[0]
    parts = []
    if spec.n_angles:
        parts.append(angle_features(x, spec.angle_idx, spec.use_angle_value))
    if spec.n_bonds:
        parts.append(bond_features(x, spec.bond_idx))
    if spec.n_dihedrals:
        d = dihedral_features(x, spec.dihedral_idx, spec.use_angle_value)
        parts.append(d.reshape(l, -1))
    if spec.n_coordinations:
        parts.append(coordination_features(
            x, spec.coord_pairs, spec.coord_slices, spec.coord_params,
            spec.coord_boxes or None, spec.coord_dmax or None))
    if spec.n_position_atoms:
        pos = x[:, torch.as_tensor(spec.position_idx, dtype=torch.long,
                                   device=x.device)]
        if align_idx is not None:
            sub = x[:, torch.as_tensor(align_idx, dtype=torch.long,
                                       device=x.device)]
            c = sub.mean(dim=1, keepdim=True)
            R = rotation_qcp(kabsch_covariance(sub - c, ref_x.to(x.dtype)))
            pos = (pos - c) @ R
        parts.append(pos.reshape(l, -1))
    rows = torch.cat(parts, dim=1)
    if spec.perm is not None:
        rows = rows[:, torch.as_tensor(spec.perm, dtype=torch.long,
                                       device=x.device)]
    act = ACTIVATIONS[activation]
    for i, (w, b) in enumerate(params):
        rows = rows @ w.T + b
        if i < len(params) - 1:
            rows = act(rows)
    return rows


def _plain_grads(spec, align_idx, ref_x, params, activation, x, objective,
                 want_x, want_ref):
    """Autograd of ``objective(forward_plain(...))`` with respect to x (if
    ``want_x``), the parameters and ``ref_x`` (if ``want_ref``). Returns
    ``(value, gx or None, gparams, g_ref)``: ``gparams`` holds ``(gW
    [d_out, d_in], gb [d_out])`` per layer; ``g_ref`` is None without
    alignment and zeros unless ``want_ref``."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(want_x)
        rr = None
        if align_idx is not None:
            rr = ref_x.detach().to(x.dtype).requires_grad_(want_ref)
        pp = tuple((w.detach().requires_grad_(True),
                    b.detach().requires_grad_(True)) for w, b in params)
        value = objective(forward_plain(spec, align_idx, rr, pp, activation,
                                        xx))
        leaves = [t for wb in pp for t in wb]
        if want_x:
            leaves.append(xx)
        if rr is not None and want_ref:
            leaves.append(rr)
        grads = list(torch.autograd.grad(value, leaves, allow_unused=True))
    grads = [torch.zeros_like(t) if g is None else g
             for g, t in zip(grads, leaves)]
    gparams = tuple(zip(grads[0:2 * len(pp):2], grads[1:2 * len(pp):2]))
    rest = grads[2 * len(pp):]
    gx = rest.pop(0) if want_x else None
    g_ref = None
    if rr is not None:
        g_ref = rest.pop(0) if want_ref else torch.zeros_like(rr)
    return value.detach(), gx, gparams, g_ref


def backward_plain(spec, align_idx, ref_x, params, activation, x, gy):
    """The plain version of the backward kernel: autograd of
    :func:`forward_plain` given the cotangent ``gy [l, d_out]``. Returns
    ``(gx [l, n, 3], gparams, g_ref)``, summed over the frames;
    ``gparams`` holds ``(gW [d_out, d_in], gb [d_out])`` per layer and
    ``g_ref`` is None without alignment."""
    _, gx, gparams, g_ref = _plain_grads(
        spec, align_idx, ref_x, params, activation, x,
        lambda y: (y * gy.to(y.dtype)).sum(), True, True)
    return gx, gparams, g_ref


def train_grads_plain(spec, align_idx, ref_x, params, activation, x,
                      y_target, train_ref=False):
    """The plain version of the train kernel: ``loss = mean((forward_plain(x)
    - y_target)**2)`` over ``x [l, n, 3]`` and ``y_target [l, d_out]``, and
    autograd of it with respect to the parameters, and ``ref_x`` when
    ``train_ref``. Returns ``(loss, gparams, g_ref)`` as
    :func:`backward_plain` does (``g_ref`` zeros unless ``train_ref``)."""
    loss, _, gparams, g_ref = _plain_grads(
        spec, align_idx, ref_x, params, activation, x,
        lambda y: ((y - y_target.to(y.dtype)) ** 2).mean(), False, train_ref)
    return loss, gparams, g_ref


def cv_forces_plain(spec, align_idx, ref_x, params, activation, x,
                    component=None):
    """The plain version of the cv+forces kernel: the plain forward and
    ``torch.autograd.grad`` of ``sum(y)`` (or of ``y[:, component]``) with
    respect to ``x [l, n, 3]``. Returns ``(y, gx)``, both detached."""
    with torch.enable_grad():
        xx = x.detach().requires_grad_(True)
        y = forward_plain(spec, align_idx, ref_x, params, activation, xx)
        obj = y if component is None else y[:, component]
        (g,) = torch.autograd.grad(obj.sum(), xx)
    return y.detach(), g


# ---------------------------------------------------------------------------
# Kernel arguments and launches
# ---------------------------------------------------------------------------


class ModelArgs(ctypes.Structure):
    """Mirror of ``struct ModelArgs`` in ``csrc/frame_math.cuh``."""

    _fields_ = [
        ("n_atoms", ctypes.c_int),
        ("n_angles", ctypes.c_int),
        ("n_bonds", ctypes.c_int),
        ("n_dihedrals", ctypes.c_int),
        ("n_pos", ctypes.c_int),
        ("n_align", ctypes.c_int),
        ("n_coord", ctypes.c_int),
        ("use_angle_value", ctypes.c_int),
        ("n_feat", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("activation", ctypes.c_int),
        ("dims", ctypes.c_int * (KERNEL_MAX_LAYERS + 1)),
        ("angle_idx", ctypes.c_void_p),
        ("bond_idx", ctypes.c_void_p),
        ("dihedral_idx", ctypes.c_void_p),
        ("pos_idx", ctypes.c_void_p),
        ("align_idx", ctypes.c_void_p),
        ("col_of", ctypes.c_void_p),
        ("coord_start", ctypes.c_void_p),
        ("coord_pairs", ctypes.c_void_p),
        ("coord_par", ctypes.c_void_p),
        ("ref_x", ctypes.c_void_p),
        ("w", ctypes.c_void_p * KERNEL_MAX_LAYERS),
        ("b", ctypes.c_void_p * KERNEL_MAX_LAYERS),
        ("n_slots", ctypes.c_int),
        ("slot_col", ctypes.c_void_p),
        ("col_slot", ctypes.c_void_p),
    ]


class UnrIO(ctypes.Structure):
    """Mirror of ``struct UnrIO`` in ``csrc/frame_math.cuh``."""

    _fields_ = [
        ("x", ctypes.c_void_p),
        ("y", ctypes.c_void_p),
        ("gx", ctypes.c_void_p),
        ("aux", ctypes.c_void_p),
        ("partials", ctypes.c_void_p),
        ("l", ctypes.c_longlong),
        ("in_t", ctypes.c_int),
        ("out_t", ctypes.c_int),
        ("component", ctypes.c_int),
        ("want_ref", ctypes.c_int),
        ("inv_count", ctypes.c_float),
        ("frames", ctypes.c_int),
        ("pitch", ctypes.c_int),
    ]


_TABLES = ("angle_idx", "bond_idx", "dihedral_idx", "pos_idx", "align_idx",
           "col_of", "coord_start", "coord_pairs")
# The kernels that take the slot form of the tables (K1, K4).
_SLOT_KERNELS = ("forward", "cv_forces")
# The tables that number atoms, renumbered by slot for those kernels.
_ATOM_TABLES = ("angle_idx", "bond_idx", "dihedral_idx", "pos_idx",
                "align_idx", "coord_pairs")


def coord_parameters(spec):
    """The coordination features' parameters as the kernels read them:
    float32 ``[n_coord, COORD_FLOATS]`` holding ``r0, nn, mm``, then
    ``has_dmax, d_max, s(d_max), 1 / (1 - s(d_max))``, then ``has_box``,
    the reciprocal box diagonal and the box's nine entries (offsets
    ``CP_*`` in ``csrc/frame_math.cuh``)."""
    n_coord = spec.n_coordinations
    boxes = spec.coord_boxes or (None,) * n_coord
    dmaxs = spec.coord_dmax or (None,) * n_coord
    par = np.zeros((n_coord, COORD_FLOATS), dtype=np.float32)
    for k, ((r0, nn, mm), box, dmax) in enumerate(
            zip(spec.coord_params, boxes, dmaxs)):
        par[k, 0:3] = (r0, nn, mm)
        if dmax is not None:
            y = float(dmax) / float(r0)
            s_dmax = (1.0 - y**nn) / (1.0 - y**mm)
            par[k, 3:7] = (1.0, dmax, s_dmax, 1.0 / (1.0 - s_dmax))
        if box is not None:
            par[k, 7] = 1.0
            par[k, 8:11] = [1.0 / box[i][i] for i in range(3)]
            par[k, 11:20] = np.asarray(box, dtype=np.float64).reshape(9)
    return par


def _index_tables(spec, align_idx):
    """The model's int32 index tables, atom form then slot form, as one
    flat list: ``(flat, offsets, n_slots)`` with ``offsets[form, name]``
    the element offset of each table (``form`` ``"atoms"`` or
    ``"slots"``; the slot form adds ``slot_col`` and ``col_slot``)."""
    col_of = list(range(spec.out_dim))
    for k, row in enumerate(spec.perm or ()):
        col_of[row] = k  # column k holds type-grouped row perm[k]
    starts = [0]
    for _, npairs in spec.coord_slices:
        starts.append(starts[-1] + npairs)
    tables = {
        "angle_idx": [i for t in spec.angle_idx for i in t],
        "bond_idx": [i for t in spec.bond_idx for i in t],
        "dihedral_idx": [i for t in spec.dihedral_idx for i in t],
        "pos_idx": list(spec.position_idx),
        "align_idx": list(align_idx or ()),
        "col_of": col_of,
        "coord_start": starts,
        "coord_pairs": [i for p in spec.coord_pairs for i in p],
    }
    n = spec.n_input_atoms
    slot_atom = sorted({i for name in _ATOM_TABLES for i in tables[name]})
    slot_of = {a: k for k, a in enumerate(slot_atom)}
    slotted = {name: ([slot_of[i] for i in tables[name]]
                      if name in _ATOM_TABLES else tables[name])
               for name in _TABLES}
    slotted["slot_col"] = [3 * a + c for a in slot_atom for c in range(3)]
    slotted["col_slot"] = [3 * slot_of[a] + c if a in slot_of else -1
                           for a in range(n) for c in range(3)]
    flat, offsets = [], {}
    for form, tabs in (("atoms", tables), ("slots", slotted)):
        for name, values in tabs.items():
            offsets[form, name] = len(flat)
            flat.extend(values)
    return flat, offsets, len(slot_atom)


def _sizes(spec, n_align, activation, dims):
    """``(field, value)`` of the sizes a :class:`ModelArgs` holds, but for
    ``dims`` and ``n_slots``."""
    return (("n_atoms", spec.n_input_atoms), ("n_angles", spec.n_angles),
            ("n_bonds", spec.n_bonds), ("n_dihedrals", spec.n_dihedrals),
            ("n_pos", spec.n_position_atoms), ("n_align", n_align),
            ("n_coord", spec.n_coordinations),
            ("use_angle_value", int(spec.use_angle_value)),
            ("n_feat", spec.out_dim), ("n_layers", len(dims) - 1),
            ("activation", KERNEL_ACTIVATIONS[activation]))


class _Statics:
    """What every kernel call of one model on one device shares, built
    once: the index tables and coordination parameters on the device, a
    :class:`ModelArgs` holding them and the model's sizes (the weight and
    ``ref_x`` pointers are filled per call, as the values change every
    optimizer step), each kernel's frames a block and K1's and K4's grids.
    K1 and K4 take a second :class:`ModelArgs` (``slot_args``) whose tables
    number only the atoms some feature or the alignment reads, by slot,
    with the tables between slot columns and input columns; the other
    kernels take ``args``, in atom numbers, and each refuses the other
    form."""

    def __init__(self, spec, align_idx, activation, dims, device):
        self.spec = spec  # keeps id(spec), the cache key, in use
        self.n_align = len(align_idx) if align_idx is not None else 0
        self.width = 1 + 3 * self.n_align + sum(
            o * (i + 1) for i, o in zip(dims, dims[1:]))
        self.d_out = dims[-1]
        self.tiles = {}
        self.grids = {}
        flat, offsets, n_slots = _index_tables(spec, align_idx)
        ints = torch.tensor(flat + [0], dtype=torch.int32, device=device)
        par = torch.from_numpy(np.concatenate(
            [coord_parameters(spec).reshape(-1), np.zeros(1, np.float32)])
        ).to(device)
        self.keep = (ints, par)
        a = self.args = ModelArgs()
        for name, value in _sizes(spec, self.n_align, activation, dims):
            setattr(a, name, value)
        for i, d in enumerate(dims):
            a.dims[i] = d
        a.coord_par = par.data_ptr()
        self.slot_args = ModelArgs.from_buffer_copy(a)
        self.slot_args.n_slots = n_slots
        base = ints.data_ptr()
        for (form, name), off in offsets.items():
            args = a if form == "atoms" else self.slot_args
            setattr(args, name, base + 4 * off)

    def frames(self, lib, kind, ref=False):
        """Frames a block of kernel ``kind`` (``backward``,
        ``backward_nogx``, ``train``; ``ref``: with the ``ref_x`` gradient)
        takes, asked of the library once."""
        t = self.tiles.get((kind, ref))
        if t is None:
            t = lib.molann_grads_frames(ctypes.addressof(self.args),
                                        int(kind == "train"),
                                        int(kind == "backward"), int(ref))
            if t <= 0:
                raise RuntimeError(f"no tile of the {kind} kernel fits this "
                                   f"model's state in shared memory ({t})")
            self.tiles[kind, ref] = t
        return t

    def grid(self, lib, kind, device):
        """``(warps a block, blocks an SM, SMs)`` of K1 (``forward``) or K4
        (``cv_forces``) on ``device``, asked of the library once (which
        also sets the kernel's shared memory limit there)."""
        g = self.grids.get(kind)
        if g is None:
            got = (ctypes.c_int * 3)()
            rc = lib.molann_fused_grid(ctypes.addressof(self.slot_args),
                                       int(kind == "cv_forces"),
                                       device.index, got)
            if rc != 0:
                raise RuntimeError(
                    f"no grid of the {kind} kernel for this model: a warp's "
                    "state does not fit a block's shared memory" if rc == 9
                    else f"{kind} kernel grid query failed: cudaError {rc}")
            g = self.grids[kind] = tuple(got)
        return g

    def model_args(self, kernel, ref_x, params, device):
        """``(ModelArgs, keepalive)`` of one call of ``kernel``: a copy of
        the static part in the form that kernel takes (slots for
        ``forward`` and ``cv_forces``, atoms for the others) with the
        pointers of ``ref_x`` and of each ``W``, ``b``; tensors that are not
        float32 and contiguous are converted into ``keepalive``."""
        a = ModelArgs.from_buffer_copy(
            self.slot_args if kernel in _SLOT_KERNELS else self.args)
        keep = []
        if self.n_align:
            a.ref_x = _f32_pointer(ref_x, device, keep)
        for i, (w, b) in enumerate(params):
            a.w[i] = _f32_pointer(w, device, keep)
            a.b[i] = _f32_pointer(b, device, keep)
        return a, keep


def _f32_pointer(t, device, keep):
    if t.device != device:
        raise ValueError(f"model tensors are on {t.device}, input on {device}: "
                         "move the model with model.to(device)")
    if t.dtype != torch.float32 or not t.is_contiguous():
        t = t.detach().to(torch.float32).contiguous()
        keep.append(t)
    return t.data_ptr()


_STATICS = {}
_STATICS_MAX = 64


def _statics(spec, align_idx, activation, params, device):
    """The :class:`_Statics` of a model on ``device``, built on first use
    and kept (at most ``_STATICS_MAX``, the oldest dropped first)."""
    dims = (spec.out_dim, *(w.shape[0] for w, _ in params))
    key = (id(spec), align_idx, activation, dims, device)
    st = _STATICS.get(key)
    if st is None:
        if len(_STATICS) >= _STATICS_MAX:
            del _STATICS[next(iter(_STATICS))]
        st = _STATICS[key] = _Statics(spec, align_idx, activation, dims,
                                      device)
    return st


def model_args(spec, align_idx, ref_x, params, activation, device, kernel):
    """``(ModelArgs, keepalive)`` for ``kernel`` (``forward``,
    ``cv_forces``, ``backward`` or ``train``) on ``device``: pointers into
    the cached index tables, in the form that kernel takes, and to the
    model's own ``ref_x`` and weights."""
    device = torch.device(device)
    st = _statics(spec, align_idx, activation, params, device)
    args, keep = st.model_args(kernel, ref_x, params, device)
    return args, (st, keep)


# The int meta-data of an engine artifact of K1/K4, in the order
# csrc/torch_ops_launch.cpp reads it (UnrMeta there): the format, the sizes
# of ModelArgs, the output width, the element offset of each slot-form table
# in the int32 tensor and of each float table in the float32 tensor (-1:
# absent).
UNROLLED_META = (
    "format", "n_atoms", "n_angles", "n_bonds", "n_dihedrals", "n_pos",
    "n_align", "n_coord", "use_angle_value", "n_feat", "n_layers",
    "activation", *(f"dim{i}" for i in range(KERNEL_MAX_LAYERS + 1)),
    "n_slots", "d_out", *(f"{t}_off" for t in (*_TABLES, "slot_col",
                                                 "col_slot")),
    "coord_par_off", "ref_x_off",
    *(f"w{i}_off" for i in range(KERNEL_MAX_LAYERS)),
    *(f"b{i}_off" for i in range(KERNEL_MAX_LAYERS)))
UNROLLED_FORMAT = 1


def _aligned(pieces, to=4):
    """numpy pieces laid end to end, each starting at a multiple of ``to``
    elements: ``(flat array, offsets)``."""
    out, offs, o = [], [], 0
    for p in pieces:
        pad = -o % to
        if pad:
            out.append(np.zeros(pad, p.dtype))
            o += pad
        offs.append(o)
        out.append(p)
        o += p.size
    return np.concatenate(out + [np.zeros(1, pieces[0].dtype)]), offs


def artifact_tables(model):
    """What an engine artifact carries to run ``model`` through the unrolled
    kernels K1 (values) and K4 (values and coordinate gradients) as torch
    custom ops (:mod:`molann_tpu_torch.io.export`): ``{"ints", "floats",
    "meta"}``, host tensors and a list of ints.

    ``ints`` holds the int32 index tables of :class:`_Statics`, the atom
    form then the slot form; ``floats`` the coordination parameters
    (:func:`coord_parameters`), ``ref_x`` and each layer's ``W [d_out,
    d_in]`` and ``b``, every piece 16-byte aligned; ``meta`` the sizes and
    offsets, named by :data:`UNROLLED_META`. The ops rebuild
    :class:`ModelArgs` from them on every call, in the slot form K1 and K4
    take, so an artifact's kernel reads the tables and weights the
    Python route's launch reads."""
    spec, align_idx, ref_x, params, activation = _extract_model(model)
    _check_envelope(spec, params, activation)
    dims = (spec.out_dim, *(int(w.shape[0]) for w, _ in params))
    n_align = len(align_idx) if align_idx is not None else 0
    flat, offsets, n_slots = _index_tables(spec, align_idx)

    def host(t):
        return t.detach().to("cpu", torch.float32).contiguous().numpy()

    pieces = [coord_parameters(spec).reshape(-1)]
    if n_align:
        pieces.append(host(ref_x).reshape(-1))
    for w, b in params:
        pieces += [host(w).reshape(-1), host(b).reshape(-1)]
    floats, offs = _aligned(pieces)
    offs = iter(offs)
    coord_off = next(offs)
    ref_off = next(offs) if n_align else -1
    w_offs, b_offs = [-1] * KERNEL_MAX_LAYERS, [-1] * KERNEL_MAX_LAYERS
    for i in range(len(params)):
        w_offs[i], b_offs[i] = next(offs), next(offs)
    meta = [UNROLLED_FORMAT,
            *(v for _, v in _sizes(spec, n_align, activation, dims)),
            *dims, *([0] * (KERNEL_MAX_LAYERS + 1 - len(dims))),
            n_slots, dims[-1],
            *(offsets["slots", t] for t in (*_TABLES, "slot_col",
                                             "col_slot")),
            coord_off, ref_off, *w_offs, *b_offs]
    assert len(meta) == len(UNROLLED_META)
    return {"ints": torch.tensor(flat + [0], dtype=torch.int32),
            "floats": torch.from_numpy(floats), "meta": meta}


def _check_cuda_input(x):
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32 frames, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous frames; call "
                         ".contiguous() first")


_LIB = None


def _library():
    """The built kernel library, after checking once that it was compiled
    with the envelope and the struct layouts this module assumes."""
    global _LIB
    if _LIB is None:
        from ._build import load_library

        lib = load_library()
        caps = (ctypes.c_int * 6)()
        lib.molann_caps(caps)
        want = [UNROLLED_MAX_ATOMS, UNROLLED_MAX_COLS, KERNEL_MAX_WIDTH,
                KERNEL_MAX_LAYERS, ctypes.sizeof(ModelArgs),
                ctypes.sizeof(UnrIO)]
        if list(caps) != want:
            raise RuntimeError(f"kernel library caps {list(caps)} do not "
                               f"match ops/fused.py {want}")
        _LIB = lib
    return _LIB


def _launch(kind, spec, align_idx, ref_x, params, activation, xm, l, in_t,
            out_t, component=None):
    """Allocate the outputs, launch K1 (``forward``) or K4 (``cv_forces``)
    on the current stream and count it. xm is packed ``[l, 3n]`` (in_t=0)
    or ``[3n, l]`` (in_t=1)."""
    lib = _library()
    dev = xm.device
    st = _statics(spec, align_idx, activation, params, dev)
    n3 = 3 * spec.n_input_atoms
    y = torch.empty((st.d_out, l) if out_t else (l, st.d_out),
                    dtype=torch.float32, device=dev)
    forces = kind == "cv_forces"
    gx = None
    if forces:
        gx = torch.empty((n3, l) if out_t else (l, n3), dtype=torch.float32,
                         device=dev)
    if l == 0:
        return y, gx
    warps, per_sm, sms = st.grid(lib, kind, dev)
    args, keep = st.model_args(kind, ref_x, params, dev)
    io = UnrIO(x=xm.data_ptr(), y=y.data_ptr(),
               gx=gx.data_ptr() if forces else None, l=l, in_t=in_t,
               out_t=out_t, component=-1 if component is None else component)
    rc = lib.molann_fused_forward(
        ctypes.addressof(args), ctypes.addressof(io), int(forces), warps,
        per_sm * sms, dev.index, torch.cuda.current_stream(dev).cuda_stream)
    del keep  # the caching allocator orders reuse on this stream
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES[kind] += 1
    return y, gx


def _grad_width(align_idx, params):
    """Entries of the kernels' flat gradient vector ``[ref_x | W0 | b0 | W1
    | b1 ...]`` (``model_grad_size`` in ``csrc/frame_math.cuh``)."""
    n_ref = 3 * len(align_idx) if align_idx is not None else 0
    return n_ref + sum(w.numel() + b.numel() for w, b in params)


def _launch_grads(kind, spec, align_idx, ref_x, params, activation, xm, l,
                  aux, *, in_t=0, want_gx=False, want_ref=False,
                  inv_count=0.0):
    """Launch the backward (``aux`` = gy) or train (``aux`` = y_target)
    kernel and the reduction of its rows on the current stream and count
    it. Returns ``(out, gx)``: ``out [1 + G]`` holds the loss (0 for the
    backward) and the flat gradients summed over the frames; ``gx [l, 3n]``
    or None."""
    lib = _library()
    dev = xm.device
    st = _statics(spec, align_idx, activation, params, dev)
    width = st.width
    gx = (torch.empty((l, 3 * spec.n_input_atoms), dtype=torch.float32,
                      device=dev) if want_gx else None)
    if l == 0:
        return torch.zeros(width, dtype=torch.float32, device=dev), gx
    frames = st.frames(lib, kind if kind == "train" or want_gx
                       else "backward_nogx", want_ref)
    # out first, then the kernel's rows of partials, in one allocation
    buf = torch.empty((1 + -(-l // frames)) * width, dtype=torch.float32,
                      device=dev)
    args, keep = st.model_args(kind, ref_x, params, dev)
    io = UnrIO(x=xm.data_ptr(), gx=gx.data_ptr() if want_gx else None,
               aux=aux.data_ptr(), partials=buf.data_ptr() + 4 * width, l=l,
               in_t=in_t, want_ref=int(want_ref), inv_count=inv_count,
               frames=frames, pitch=frames + 1)
    rc = lib.molann_fused_grads(
        ctypes.addressof(args), ctypes.addressof(io), int(kind == "train"),
        buf.data_ptr(), dev.index, torch.cuda.current_stream(dev).cuda_stream)
    del keep  # the caching allocator orders reuse on this stream
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES[kind] += 1
    return buf[:width], gx


def _unpack_grads(g, align_idx, ref_x, params):
    """The flat gradient vector → ``(gparams, g_ref)`` shaped like
    ``params`` and ``ref_x`` (``g_ref`` None without alignment)."""
    o, g_ref = 0, None
    if align_idx is not None:
        o = 3 * len(align_idx)
        g_ref = g[:o].view(ref_x.shape)
    gparams = []
    for w, b in params:
        gw = g[o:o + w.numel()].view(w.shape)
        o += w.numel()
        gparams.append((gw, g[o:o + b.numel()].view(b.shape)))
        o += b.numel()
    return tuple(gparams), g_ref


class _FusedApply(torch.autograd.Function):
    """The forward kernel with the backward kernel as its VJP: the port of
    the ``fused_apply`` custom VJP (``molann_tpu/ops/fused.py:743-782``).
    Inputs are the packed frames ``[l, 3n]``, ``ref_x`` (or None) and each
    ``W_i``, ``b_i`` on its own, so that autograd reaches the
    ``nn.Parameter``s; outputs nobody asked for are not computed."""

    @staticmethod
    def forward(ctx, statics, xm, ref_x, *flat):
        spec, align_idx, activation = statics
        params = tuple(zip(flat[0::2], flat[1::2]))
        y, _ = _launch("forward", spec, align_idx, ref_x, params, activation,
                       xm, xm.shape[0], 0, 0)
        ctx.statics = statics
        ctx.save_for_backward(xm, ref_x, *flat)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, gy):
        spec, align_idx, activation = ctx.statics
        xm, ref_x, *flat = ctx.saved_tensors
        params = tuple(zip(flat[0::2], flat[1::2]))
        gy = gy.contiguous()
        _check_cuda_input(gy)
        want_ref = align_idx is not None and ctx.needs_input_grad[2]
        out, gx = _launch_grads("backward", spec, align_idx, ref_x, params,
                                activation, xm, xm.shape[0], gy,
                                want_gx=ctx.needs_input_grad[1],
                                want_ref=want_ref)
        gparams, g_ref = _unpack_grads(out[1:], align_idx, ref_x, params)
        return (None, gx, g_ref if want_ref else None,
                *(g for wb in gparams for g in wb))


def _as_packed(x, n_atoms):
    """``[l, n, 3]`` or packed ``[l, 3n]`` → ``([l, 3n], packed)``."""
    if x.ndim == 3:
        if x.shape[1:] != (n_atoms, 3):
            raise ValueError(f"expected frames [l, {n_atoms}, 3], got "
                             f"{tuple(x.shape)}")
        return x.reshape(x.shape[0], 3 * n_atoms), False
    if x.ndim != 2 or x.shape[1] != 3 * n_atoms:
        raise ValueError(f"expected frames [l, {n_atoms}, 3] or "
                         f"[l, {3 * n_atoms}], got {tuple(x.shape)}")
    return x, True


def check_tile_args(tile=None, interpret=False):
    """Check the TPU kernels' ``tile`` (None, a positive int, or a tuple of
    them such as ``(tile, bwd_tile)``) and ``interpret`` (a bool), which the
    port's entry points take for the JAX signatures and which change
    nothing: the CUDA kernels choose their own tile, and interpret mode is
    the plain version a CPU tensor runs."""
    tiles = tile if isinstance(tile, (tuple, list)) else (tile,)
    for t in tiles:
        if t is not None and (isinstance(t, bool)
                              or not isinstance(t, numbers.Integral)
                              or t <= 0):
            raise ValueError(f"tile must be None or a positive int, got "
                             f"{tile!r}")
    if not isinstance(interpret, bool):
        raise ValueError(f"interpret must be a bool, got {interpret!r}")


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def fused_model_forward(model, x, *, tile=None, bwd_tile=None,
                        interpret=False, mode="auto", precision="exact",
                        c_mat=None):
    """``model(x)`` through the fused forward kernel: ``x [l, n, 3]`` or
    packed ``[l, 3n]`` → ``[l, d_out]``, differentiable with respect to x,
    the MLP parameters and ``ref_x``.

    On a CUDA tensor this launches the CUDA forward kernel (K1); autograd
    then runs the backward kernel (K2), which computes only the gradients
    asked for. Under ``torch.no_grad()`` only K1 runs. On a CPU tensor it
    runs :func:`forward_plain`, which autograd differentiates.

    In the blocked formulation (``mode="blocked"``, or ``"auto"`` for a
    large system) ``x`` may also be ``[3n, l]`` or ``[3, n, l]``, and
    ``c_mat`` may carry the pair operand of :func:`model_chunk_matrix`. On
    a CUDA tensor the blocked forward kernel (K6) runs, and autograd then
    runs the blocked backward kernel (K7) in the same way
    (:func:`.fused_blocked.blocked_apply`).

    A :class:`~molann_tpu_torch.parallel.data_parallel.ShardedModel` (the
    model a data-parallel training step hands its loss) runs this rank's
    rows of ``x`` (frames on the leading dimension) and returns every
    rank's rows."""
    if isinstance(model, ShardedModel):
        return model.map_rows(fused_model_forward, x, tile=tile,
                              bwd_tile=bwd_tile, interpret=interpret,
                              mode=mode, precision=precision, c_mat=c_mat)
    resolve_precision(precision, training=False)
    spec, align_idx, ref_x, params, activation = _extract_model(model)
    if _resolve_mode(spec, params, mode, c_mat) == "blocked":
        from .fused_blocked import blocked_apply

        return blocked_apply(spec, align_idx, activation, (tile, bwd_tile),
                             interpret, precision, params, ref_x, x, c_mat)
    return fused_apply(spec, align_idx, activation, (tile, bwd_tile),
                       interpret, params, ref_x, x)


def fused_apply(spec, align_idx, activation, tiles, interpret, params, ref_x,
                x):
    """The unrolled forward with its backward as the VJP, on a model's
    parts: ``x [l, n, 3]`` or packed ``[l, 3n]`` → ``[l, d_out]``, the
    reference's ``fused_apply`` (``molann_tpu/ops/fused.py:744``) with its
    positional order.

    ``spec``: the :class:`~molann_tpu_torch.spec.CompiledFeatures`;
    ``align_idx``: local align-atom indices or None; ``activation``: a name
    in :data:`~molann_tpu_torch.models.ann.ACTIVATIONS`; ``tiles`` and
    ``interpret`` are accepted and change nothing; ``params``: ``(W
    [d_out, d_in], b [d_out] or [d_out, 1])`` per layer (torch's weight
    layout, the reference's transposed one); ``ref_x``: the centred
    reference ``[n_align, 3]``, or None (an empty array is taken as None)
    without alignment.

    On a CUDA tensor the forward kernel (K1) runs and autograd runs the
    backward kernel (K2); on a CPU tensor :func:`forward_plain` runs."""
    check_tile_args(tiles, interpret)
    if ref_x is not None and ref_x.numel() == 0:
        ref_x = None
    params = tuple((w, b if b.ndim == 1 else b.reshape(-1)) for w, b in params)
    _check_envelope(spec, params, activation)
    _check_device(x)
    n = spec.n_input_atoms
    xm, _ = _as_packed(x, n)
    l = xm.shape[0]
    if x.device.type == "cpu":
        return forward_plain(spec, align_idx, ref_x, params, activation,
                             xm.reshape(l, n, 3))
    _check_cuda_input(x)
    return _FusedApply.apply((spec, align_idx, activation), xm, ref_x,
                             *(t for wb in params for t in wb))


def qcp_rotation(H):
    """Horn/QCP optimal rotation from per-frame covariances, in the
    reference's nested form (``molann_tpu/ops/fused.py:192``): ``H`` a 3x3
    nested list of same-shaped tensors, one covariance entry per frame;
    returns the 3x3 nested list ``R`` with ``aligned_i = Σ_j v_j R[j][i]``.
    The same rotation as :func:`~.alignment.rotation_qcp` (12 Newton steps,
    then one differentiable step, the adjugate's largest column)."""
    Ht = torch.stack([torch.stack(list(row), dim=-1) for row in H], dim=-2)
    R = rotation_qcp(Ht)
    return [[R[..., j, i] for i in range(3)] for j in range(3)]


def fused_cv_forces(model, x, *, component=None, tile=None,
                    transposed_input=False, transposed_outputs=False,
                    remat=False, interpret=False, mode="auto",
                    precision="exact", compact_grads=False, c_mat=None):
    """The serving op for biased MD: CV values AND their coordinate
    gradients in one kernel.

    component: output column to differentiate (None = sum of all; negative
    values wrap as ``component % d_out``). x: ``[l, n, 3]``, packed
    ``[l, 3n]``, or with ``transposed_input`` ``[3n, l]`` (which implies
    transposed outputs). Returns ``(y [l, d_out], g)`` with ``g`` shaped
    like ``x``, or with ``transposed_outputs`` ``(y [d_out, l],
    g [3n, l])``. Forces are ``-g``.

    On a CUDA tensor this launches the CUDA kernel (K4); on a CPU tensor it
    runs :func:`cv_forces_plain`.

    In the blocked formulation (``mode="blocked"``, or ``"auto"`` for a
    large system) the blocked cv+forces kernel (K8) runs instead
    (:func:`.fused_blocked.blocked_cv_forces`): ``x`` may also be
    component-major ``[3, n, l]`` (then ``y`` is ``[d_out, l]`` and ``g``
    ``[3, n, l]``), ``compact_grads=True`` returns the gradient on the
    active atoms only as ``[3, n_active, l]`` (row k = atom
    ``active_atom_indices(model)[k]``), and ``c_mat`` may carry the pair
    operand of :func:`model_chunk_matrix`."""
    resolve_precision(precision, training=False)
    check_tile_args(tile, interpret)
    spec, align_idx, ref_x, params, activation = _extract_model(model)
    if _resolve_mode(spec, params, mode, c_mat) == "blocked":
        from .fused_blocked import blocked_cv_forces

        out_layout = "t" if (transposed_input or transposed_outputs) else None
        return blocked_cv_forces(
            spec, align_idx, activation, params, ref_x, x,
            component=component, tile=tile, interpret=interpret,
            out_layout=out_layout, precision=precision,
            compact_grads=compact_grads, c_mat=c_mat)
    if compact_grads:
        raise ValueError("compact_grads requires the blocked formulation "
                         "(mode='blocked'; auto selected 'unrolled' for this "
                         "system)")
    _check_envelope(spec, params, activation)
    _check_device(x)
    n = spec.n_input_atoms
    d_out = _out_dim(spec, params)
    if component is not None:
        component = component % d_out
    if transposed_input:
        if x.ndim != 2 or x.shape[0] != 3 * n:
            raise ValueError(f"transposed frames must be [{3 * n}, l], got "
                             f"{tuple(x.shape)}")
        xm, packed, l = x, True, x.shape[1]
        transposed_outputs = True
    else:
        xm, packed = _as_packed(x, n)
        l = xm.shape[0]

    if x.device.type == "cpu":
        x3 = (xm.T if transposed_input else xm).reshape(l, n, 3)
        y, g = cv_forces_plain(spec, align_idx, ref_x, params, activation, x3,
                               component)
        if transposed_outputs:
            return y.T.contiguous(), g.reshape(l, 3 * n).T.contiguous()
        return y, (g.reshape(l, 3 * n) if packed else g)

    _check_cuda_input(x)
    y, gx = _launch("cv_forces", spec, align_idx, ref_x, params, activation,
                    xm, l, int(transposed_input), int(transposed_outputs),
                    component)
    if not transposed_outputs and not packed:
        gx = gx.reshape(l, n, 3)
    return y, gx


def _grads_dict(model, params, gparams, ref_x, g_ref):
    """Gradients keyed like :func:`~molann_tpu_torch.models.ann.named_tensors`
    (parameters, then the ``ref_x`` buffer); zeros for any other tensor,
    as ``_grads_like`` (``molann_tpu/ops/fused.py:971-993``)."""
    from ..models.ann import named_tensors

    by_id = {id(ref_x): g_ref} if ref_x is not None else {}
    for (w, b), (gw, gb) in zip(params, gparams):
        by_id[id(w)], by_id[id(b)] = gw, gb
    return {name: by_id[id(t)] if id(t) in by_id else torch.zeros_like(t)
            for name, t in named_tensors(model)}


def fused_train_grads(model, x, y_target, *, tile=None, interpret=False,
                      transposed_input=False, mode="auto",
                      precision="auto", train_ref=False, c_mat=None):
    """The MSE loss AND its parameter gradients in one fused kernel, with
    no coordinate gradients computed or written.

    x: ``[l, n, 3]``, packed ``[l, 3n]`` or, with ``transposed_input``,
    ``[3n, l]``; y_target: ``[l, d_out]`` (``[d_out, l]`` transposed).
    Returns ``(loss, grads)``: ``loss = mean((model(x) - y_target)**2)`` as
    a 0-d tensor, and ``grads`` a dict keyed by the names of the model's
    parameters and of its ``ref_x`` buffer, weights in torch's ``[d_out,
    d_in]`` layout. ``train_ref=False`` treats ``ref_x`` as the frozen
    buffer it is and gives zeros for it; ``train_ref=True`` computes its
    gradient too.

    On a CUDA tensor this launches the CUDA train kernel (K3); on a CPU
    tensor it runs :func:`train_grads_plain`. ``precision`` is resolved
    with ``training=True`` and otherwise ignored.

    In the blocked formulation (``mode="blocked"``, or ``"auto"`` for a
    large system) the blocked train kernel (K5) runs instead
    (:func:`.fused_blocked.blocked_train_grads`): ``x`` may be in any
    layout it takes (``[3, n, l]`` too, the layout told from the shape),
    ``y_target`` ``[l, d_out]`` or ``[d_out, l]``, and ``c_mat`` may carry
    the pair operand of :func:`model_chunk_matrix`."""
    precision = resolve_precision(precision, training=True)
    check_tile_args(tile, interpret)
    spec, align_idx, ref_x, params, activation = _extract_model(model)
    if _resolve_mode(spec, params, mode, c_mat) == "blocked":
        from .fused_blocked import blocked_train_grads

        loss, gparams, g_ref = blocked_train_grads(
            spec, align_idx, activation, params, ref_x, x, y_target,
            tile=tile, interpret=interpret, precision=precision,
            train_ref=train_ref, c_mat=c_mat)
        return loss, _grads_dict(model, params, gparams, ref_x, g_ref)
    _check_envelope(spec, params, activation)
    _check_device(x)
    n = spec.n_input_atoms
    d_out = _out_dim(spec, params)
    if transposed_input:
        if x.ndim != 2 or x.shape[0] != 3 * n:
            raise ValueError(f"transposed frames must be [{3 * n}, l], got "
                             f"{tuple(x.shape)}")
        xm, l = x, x.shape[1]
        y_shape = (d_out, l)
    else:
        xm, _ = _as_packed(x, n)
        l = xm.shape[0]
        y_shape = (l, d_out)
    if tuple(y_target.shape) != y_shape:
        raise ValueError(f"y_target must be {list(y_shape)}, got "
                         f"{list(y_target.shape)}")
    if l == 0:
        raise ValueError("fused_train_grads needs at least one frame")
    if y_target.device != x.device:
        raise ValueError(f"y_target is on {y_target.device}, x on {x.device}")

    if x.device.type == "cpu":
        x3 = (xm.T if transposed_input else xm).reshape(l, n, 3)
        yt = y_target.T if transposed_input else y_target
        loss, gparams, g_ref = train_grads_plain(
            spec, align_idx, ref_x, params, activation, x3, yt, train_ref)
    else:
        _check_cuda_input(x)
        _check_cuda_input(y_target)
        out, _ = _launch_grads(
            "train", spec, align_idx, ref_x, params, activation, xm, l,
            y_target, in_t=int(transposed_input),
            want_ref=train_ref and align_idx is not None,
            inv_count=1.0 / (float(l) * float(d_out)))
        loss = out[0]
        gparams, g_ref = _unpack_grads(out[1:], align_idx, ref_x, params)
    return loss, _grads_dict(model, params, gparams, ref_x, g_ref)
