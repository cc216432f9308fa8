"""Fused align+feature+MLP serving ops: CUDA kernels and their plain versions.

Port of the unrolled family of ``molann_tpu/ops/fused.py``:

- :func:`fused_model_forward` — values only; on a CUDA tensor it launches
  the CUDA kernel that replaces the Pallas ``_fwd_kernel`` (K1);
- :func:`fused_cv_forces` — values and coordinate gradients in one pass
  (the biased-MD serving op); on a CUDA tensor it launches the CUDA kernel
  that replaces ``_cv_forces_kernel`` (K4).

Both kernels live in ``molann_tpu_torch/csrc/`` and are built by ``nvcc``
at first use (:mod:`._build`). Each has a plain PyTorch version beside it
here (:func:`forward_plain`, :func:`cv_forces_plain`): a wrapper takes the
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
import functools

import torch

from ..spec import CompiledFeatures
from .alignment import kabsch_covariance, rotation_qcp
from .features import (
    angle_features,
    bond_features,
    coordination_features,
    dihedral_features,
)

__all__ = [
    "fused_model_forward",
    "fused_cv_forces",
    "forward_plain",
    "cv_forces_plain",
    "select_mode",
    "resolve_precision",
    "KERNEL_LAUNCHES",
]

# Envelope of the unrolled family (molann_tpu/ops/fused.py:72-74) ...
UNROLLED_MAX_ATOMS = 64
UNROLLED_MAX_COLS = 96
UNROLLED_MAX_COORD_PAIRS = 96
# ... and the CUDA kernels' own caps on the MLP head (csrc/frame_math.cuh)
KERNEL_MAX_WIDTH = 64
KERNEL_MAX_LAYERS = 4
KERNEL_ACTIVATIONS = {"identity": 0, "tanh": 1, "relu": 2, "sigmoid": 3}

# Launches of each CUDA kernel, counted by the wrappers where they launch.
KERNEL_LAUNCHES = {"forward": 0, "cv_forces": 0}

_BLOCKED_TODO = ("the blocked formulation (mode='blocked') is not ported to "
                 "molann_tpu_torch yet (ROADMAP.md, queue 1: kernels "
                 "K5-K8)")
_COORD_TODO = ("coordination features are not in the CUDA unrolled kernels "
               "yet (ROADMAP.md, queue 1: coordination in K1/K4); the "
               "eager model computes them")


def select_mode(spec, n_atoms: int) -> str:
    """``"unrolled"`` for systems inside the unrolled envelope, else
    ``"blocked"`` (same rule as ``molann_tpu.ops.fused.select_mode``)."""
    n_pairs = sum(np_ for _, np_ in spec.coord_slices)
    if (spec.out_dim <= UNROLLED_MAX_COLS and n_atoms <= UNROLLED_MAX_ATOMS
            and n_pairs <= UNROLLED_MAX_COORD_PAIRS):
        return "unrolled"
    return "blocked"


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


def _resolve_mode(spec, mode):
    if mode == "auto":
        mode = select_mode(spec, spec.n_input_atoms)
    if mode == "blocked":
        raise NotImplementedError(_BLOCKED_TODO)
    if mode != "unrolled":
        raise ValueError(f"unknown mode {mode!r}: choose 'auto', 'unrolled' "
                         "or 'blocked'")


def _check_envelope(spec, params, activation):
    """What the CUDA kernels compute, checked for every input device so that
    a model behaves the same on the CPU and on the card."""
    if spec.coord_slices:
        raise NotImplementedError(_COORD_TODO)
    if activation not in KERNEL_ACTIVATIONS:
        raise NotImplementedError(
            f"activation {activation!r} is not in the CUDA kernels "
            f"(they take {sorted(KERNEL_ACTIVATIONS)})")
    if spec.n_input_atoms > UNROLLED_MAX_ATOMS or spec.out_dim > UNROLLED_MAX_COLS:
        raise ValueError(
            f"{spec.n_input_atoms} atoms / {spec.out_dim} feature columns are "
            f"outside the unrolled kernels' envelope ({UNROLLED_MAX_ATOMS} "
            f"atoms, {UNROLLED_MAX_COLS} columns)")
    if len(params) > KERNEL_MAX_LAYERS or any(
            w.shape[0] > KERNEL_MAX_WIDTH for w, _ in params):
        raise ValueError(
            f"the CUDA kernels take at most {KERNEL_MAX_LAYERS} Linear layers "
            f"of width <= {KERNEL_MAX_WIDTH}; got "
            f"{[tuple(w.shape) for w, _ in params]}")


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
        ("use_angle_value", ctypes.c_int),
        ("n_feat", ctypes.c_int),
        ("has_perm", ctypes.c_int),
        ("n_layers", ctypes.c_int),
        ("activation", ctypes.c_int),
        ("dims", ctypes.c_int * (KERNEL_MAX_LAYERS + 1)),
        ("angle_idx", ctypes.c_void_p),
        ("bond_idx", ctypes.c_void_p),
        ("dihedral_idx", ctypes.c_void_p),
        ("pos_idx", ctypes.c_void_p),
        ("align_idx", ctypes.c_void_p),
        ("perm", ctypes.c_void_p),
        ("ref_x", ctypes.c_void_p),
        ("params", ctypes.c_void_p),
    ]


_TABLES = ("angle_idx", "bond_idx", "dihedral_idx", "pos_idx", "align_idx",
           "perm")


@functools.lru_cache(maxsize=64)
def _index_tables(spec, align_idx, device):
    """The spec's index tables as ONE int32 tensor on ``device`` plus the
    element offset of each table (static per model, so cached)."""
    tables = {
        "angle_idx": [i for t in spec.angle_idx for i in t],
        "bond_idx": [i for t in spec.bond_idx for i in t],
        "dihedral_idx": [i for t in spec.dihedral_idx for i in t],
        "pos_idx": list(spec.position_idx),
        "align_idx": list(align_idx or ()),
        "perm": list(spec.perm or ()),
    }
    flat, offsets = [], {}
    for name in _TABLES:
        offsets[name] = len(flat)
        flat.extend(tables[name])
    buf = torch.tensor(flat + [0], dtype=torch.int32, device=device)
    return buf, offsets


def model_args(spec, align_idx, ref_x, params, activation, device):
    """``(ModelArgs, keepalive)`` for the kernels on ``device``: pointers
    into an int32 table tensor and a float32 tensor
    ``[ref_x | W0 | b0 | W1 | b1 ...]`` that ``keepalive`` holds."""
    device = torch.device(device)
    idx, offsets = _index_tables(spec, align_idx, device)
    with torch.no_grad():
        pieces = [torch.zeros(1, dtype=torch.float32, device=device)]
        if align_idx is not None:
            pieces.append(ref_x.reshape(-1))
        for w, b in params:
            pieces.extend((w.reshape(-1), b.reshape(-1)))
        for p in pieces:
            if p.device != device:
                raise ValueError(
                    f"model tensors are on {p.device}, input on {device}: "
                    "move the model with model.to(device)")
        floats = torch.cat([p.to(torch.float32) for p in pieces])
    a = ModelArgs()
    a.n_atoms = spec.n_input_atoms
    a.n_angles, a.n_bonds = spec.n_angles, spec.n_bonds
    a.n_dihedrals, a.n_pos = spec.n_dihedrals, spec.n_position_atoms
    a.n_align = len(align_idx) if align_idx is not None else 0
    a.use_angle_value = int(spec.use_angle_value)
    a.n_feat = spec.out_dim
    a.has_perm = int(spec.perm is not None)
    a.n_layers = len(params)
    a.activation = KERNEL_ACTIVATIONS[activation]
    a.dims[0] = spec.out_dim
    for i, (w, _) in enumerate(params):
        a.dims[i + 1] = w.shape[0]
    base = idx.data_ptr()
    for name in _TABLES:
        setattr(a, name, base + 4 * offsets[name])
    fbase = floats.data_ptr() + 4  # past the leading pad element
    a.ref_x = fbase
    a.params = fbase + 4 * (3 * a.n_align)
    return a, (idx, floats)


def _check_cuda_input(x):
    if x.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32 frames, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("the CUDA kernels take contiguous frames; call "
                         ".contiguous() first")


def _library():
    """The built kernel library, after checking that it was compiled with
    the envelope and the ``ModelArgs`` layout this module assumes."""
    from ._build import load_library

    lib = load_library()
    caps = (ctypes.c_int * 5)()
    lib.molann_caps(caps)
    want = [UNROLLED_MAX_ATOMS, UNROLLED_MAX_COLS, KERNEL_MAX_WIDTH,
            KERNEL_MAX_LAYERS, ctypes.sizeof(ModelArgs)]
    if list(caps) != want:
        raise RuntimeError(f"kernel library caps {list(caps)} do not match "
                           f"ops/fused.py {want}")
    return lib


def _launch(kind, spec, align_idx, ref_x, params, activation, xm, l, in_t,
            out_t, component=None):
    """Allocate the outputs, launch one kernel on the current stream and
    count it. xm is packed ``[l, 3n]`` (in_t=0) or ``[3n, l]`` (in_t=1)."""
    lib = _library()
    dev = xm.device
    n3 = 3 * spec.n_input_atoms
    d_out = _out_dim(spec, params)
    y = torch.empty((d_out, l) if out_t else (l, d_out), dtype=torch.float32,
                    device=dev)
    gx = None
    if kind == "cv_forces":
        gx = torch.empty((n3, l) if out_t else (l, n3), dtype=torch.float32,
                         device=dev)
    if l == 0:
        return y, gx
    args, keep = model_args(spec, align_idx, ref_x, params, activation, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if kind == "cv_forces":
        rc = lib.molann_fused_cv_forces(
            ctypes.addressof(args), xm.data_ptr(), y.data_ptr(), gx.data_ptr(),
            l, in_t, out_t, -1 if component is None else component, dev.index,
            stream)
    else:
        rc = lib.molann_fused_forward(ctypes.addressof(args), xm.data_ptr(),
                                      y.data_ptr(), l, in_t, out_t, dev.index,
                                      stream)
    del keep  # the caching allocator orders reuse on this stream
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} kernel launch failed: cudaError {rc}")
    KERNEL_LAUNCHES[kind] += 1
    return y, gx


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


def _check_device(x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def fused_model_forward(model, x, *, tile=None, bwd_tile=None,
                        interpret=False, mode="auto", precision="exact",
                        c_mat=None):
    """``model(x)`` through the fused forward kernel: ``x [l, n, 3]`` or
    packed ``[l, 3n]`` → ``[l, d_out]``.

    On a CUDA tensor this launches the CUDA kernel (K1). Its result has no
    autograd graph: the backward kernel (K2) is not ported yet, so a
    ``x`` that requires grad raises; use :func:`fused_cv_forces` for
    coordinate gradients. On a CPU tensor it runs :func:`forward_plain`."""
    resolve_precision(precision, training=False)
    spec, align_idx, ref_x, params, activation = _extract_model(model)
    _resolve_mode(spec, mode)
    if c_mat is not None:
        raise ValueError("c_mat applies to the blocked formulation only "
                         "(mode='blocked'; auto selected 'unrolled' for this "
                         "system)")
    _check_envelope(spec, params, activation)
    _check_device(x)
    n = spec.n_input_atoms
    xm, _ = _as_packed(x, n)
    l = xm.shape[0]
    if x.device.type == "cpu":
        return forward_plain(spec, align_idx, ref_x, params, activation,
                             xm.reshape(l, n, 3))
    if x.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            "the CUDA forward kernel has no backward yet (ROADMAP.md, "
            "queue 1: kernel K2); use fused_cv_forces for coordinate "
            "gradients")
    _check_cuda_input(x)
    y, _ = _launch("forward", spec, align_idx, ref_x, params, activation, xm,
                   l, 0, 0)
    return y


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
    runs :func:`cv_forces_plain`."""
    resolve_precision(precision, training=False)
    spec, align_idx, ref_x, params, activation = _extract_model(model)
    _resolve_mode(spec, mode)
    if compact_grads:
        raise ValueError("compact_grads requires the blocked formulation "
                         "(mode='blocked'; auto selected 'unrolled' for this "
                         "system)")
    if c_mat is not None:
        raise ValueError("c_mat applies to the blocked formulation only "
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
