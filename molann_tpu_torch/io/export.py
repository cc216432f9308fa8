"""Engine artifacts: TorchScript archives an MD engine loads from C++.

The port of ``molann_tpu/io/export.py``. The reference's downstream MD and
enhanced-sampling engines load a ``.pt`` with LibTorch, no Python needed
(reference README.rst:51). :func:`export_artifact` writes such an archive
from a port model: it takes frames ``x [l, n_atoms, 3]`` float32 for any
``l`` (or the fixed ``batch_size``) and returns the CVs ``[l, d]``, or
``(cvs, ∂Σcvs/∂x)`` with ``with_gradient``, the biasing-force evaluation.
``csrc/serve_torch.cpp`` serves one from C++ (``build_serve_torch``), and
:func:`load_artifact` loads one in Python.

Two forms, as in the JAX package:

- ``fused=False`` carries the model as TorchScript: a scriptable copy of
  the port's eager math (alignment by the model's method, every feature,
  the MLP; the eager modules themselves do not script), held to the eager
  model by the tests. The gradient is ``torch.autograd.grad`` inside the
  scripted forward, so such an artifact runs with gradient mode on (not
  under ``torch.no_grad`` or ``InferenceMode``).
- ``fused=True`` carries the model's tables as buffers
  (``ops.fused.artifact_tables`` or ``ops.fused_blocked.artifact_tables``)
  and calls the hand-written CUDA kernels as torch custom ops: K1
  (``torch.ops.molann_tpu_torch.unrolled_forward``) and K4
  (``unrolled_cv_forces``) where ``model_select_mode`` says
  ``"unrolled"``, K6 (``blocked_forward``) and K8 (``blocked_cv_forces``)
  otherwise. The pair operand of a model with coordination features is one
  buffer of the artifact (``c_mat``). Exporting needs only the ops'
  schemas (``ops._build.load_op_library(cuda=False)``, built by g++ against
  PyTorch), so it works on a machine without a card; the launch geometry
  is chosen on the card the artifact runs on, each call. The ops have no
  CPU implementation: on CPU tensors the call raises. An engine loads the
  op library (``load_op_library()``'s path) before the archive.

Three names of the JAX module are replaced by design: ``raw_mlir`` (bare
StableHLO for a PJRT runtime), ``export_bundle``/``read_bundle`` (several
fixed-batch modules, because a bare PJRT runtime cannot refine a
polymorphic batch; a TorchScript artifact takes any batch) and the
bundle's ``c_mat`` section (a buffer of the artifact here).
"""

import io
import json
import zipfile
from typing import List, Tuple

import torch
from torch import nn

from .._device import resolve_device

__all__ = ["export_artifact", "load_artifact"]

# The archive's record of what it is, read by load_artifact before loading.
INFO_FILE = "molann_artifact.json"
# the rotation solvers of ops.alignment, as the scripted alignment numbers
# them
_METHODS = {"qcp": 0, "svd": 1, "eigh": 2}


# ---------------------------------------------------------------------------
# The eager model as TorchScript (ops/alignment.py, ops/features.py and
# models/ann.py, written for the script compiler)
# ---------------------------------------------------------------------------


def _det3(a, b, c, d, e, f, g, h, i):
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _minor(M: torch.Tensor, i: int, j: int) -> torch.Tensor:
    """Determinant of ``M [..., 4, 4]`` without row i and column j."""
    r: List[int] = []
    c: List[int] = []
    for k in range(4):
        if k != i:
            r.append(k)
        if k != j:
            c.append(k)
    return _det3(M[..., r[0], c[0]], M[..., r[0], c[1]], M[..., r[0], c[2]],
                 M[..., r[1], c[0]], M[..., r[1], c[1]], M[..., r[1], c[2]],
                 M[..., r[2], c[0]], M[..., r[2], c[1]], M[..., r[2], c[2]])


def _quaternion_matrix(H: torch.Tensor) -> torch.Tensor:
    Sxx, Sxy, Sxz = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
    Syx, Syy, Syz = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
    Szx, Szy, Szz = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
    k00 = Sxx + Syy + Szz
    k01 = Syz - Szy
    k02 = Szx - Sxz
    k03 = Sxy - Syx
    k11 = Sxx - Syy - Szz
    k12 = Sxy + Syx
    k13 = Szx + Sxz
    k22 = -Sxx + Syy - Szz
    k23 = Syz + Szy
    k33 = -Sxx - Syy + Szz
    return torch.stack([
        torch.stack([k00, k01, k02, k03], dim=-1),
        torch.stack([k01, k11, k12, k13], dim=-1),
        torch.stack([k02, k12, k22, k23], dim=-1),
        torch.stack([k03, k13, k23, k33], dim=-1),
    ], dim=-2)


def _quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    col0 = torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
                       dim=-1)
    col1 = torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
                       dim=-1)
    col2 = torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
                       dim=-1)
    return torch.stack([col0, col1, col2], dim=-1)


def _newton_step(lam, c2, c1, c0):
    p = ((lam * lam + c2) * lam + c1) * lam + c0
    dp = (4.0 * lam * lam + 2.0 * c2) * lam + c1
    return lam - p / torch.where(torch.abs(dp) < 1e-30,
                                 torch.full_like(dp, 1e-30), dp)


def _rotation_qcp(H: torch.Tensor) -> torch.Tensor:
    """``ops.alignment.rotation_qcp``: 12 Newton steps without gradient,
    one with, the adjugate's largest column."""
    K = _quaternion_matrix(H)
    frob2 = torch.sum(H * H, dim=(-1, -2))
    c2 = -2.0 * frob2
    c1 = -8.0 * _det3(H[..., 0, 0], H[..., 0, 1], H[..., 0, 2],
                      H[..., 1, 0], H[..., 1, 1], H[..., 1, 2],
                      H[..., 2, 0], H[..., 2, 1], H[..., 2, 2])
    K2 = K @ K
    p2 = torch.diagonal(K2, dim1=-2, dim2=-1).sum(-1)
    p4 = torch.sum(K2 * K2, dim=(-1, -2))
    c0 = p2 * p2 / 8.0 - p4 / 4.0
    with torch.no_grad():
        lam = torch.sqrt(3.0 * frob2)
        for _ in range(12):
            lam = _newton_step(lam, c2, c1, c0)
    lam = _newton_step(lam, c2, c1, c0)
    M = K - lam[..., None, None] * torch.eye(4, dtype=K.dtype,
                                             device=K.device)
    rows: List[torch.Tensor] = []
    for i in range(4):
        row: List[torch.Tensor] = []
        for j in range(4):
            # adj[i][j] = cofactor[j][i]
            sign = -1.0 if (i + j) % 2 == 1 else 1.0
            row.append(sign * _minor(M, j, i))
        rows.append(torch.stack(row, dim=-1))
    adj = torch.stack(rows, dim=-2)
    norms2 = torch.sum(adj * adj, dim=-2)
    best = torch.argmax(norms2, dim=-1)
    q = torch.gather(adj, -1, best[..., None, None].expand(
        adj.size(0), 4, 1))[..., 0]
    q = q / torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True))
    return _quaternion_to_rotation(q)


def _rotation_svd(H: torch.Tensor) -> torch.Tensor:
    u, _, vh = torch.linalg.svd(H)
    sign = torch.sign(torch.linalg.det(u @ vh)).detach()
    d = torch.stack([torch.ones_like(sign), torch.ones_like(sign), sign],
                    dim=-1)
    return (u * d[..., None, :]) @ vh


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [l, n, 3], idx [m, k] -> [l, m, k, 3]."""
    return x.index_select(1, idx.reshape(-1)).reshape(
        x.size(0), idx.size(0), idx.size(1), 3)


def _ipow(t: torch.Tensor, k: int) -> torch.Tensor:
    acc = torch.ones_like(t)
    sq = t
    while k > 0:
        if (k & 1) == 1:
            acc = acc * sq
        k = k >> 1
        if k > 0:
            sq = sq * sq
    return acc


def _geometric_sum(t: torch.Tensor, k: int) -> torch.Tensor:
    acc = t * 0.0 + 1.0
    for _ in range(k - 1):
        acc = 1.0 + t * acc
    return acc


def _switching(r: torch.Tensor, r0: float, nn_: int, mm: int,
               d_max: float) -> torch.Tensor:
    """``ops.features.switching_function`` (``d_max < 0``: none)."""
    t = r / r0
    if mm == 2 * nn_:
        raw = 1.0 / (1.0 + _ipow(t, nn_))
    else:
        raw = _geometric_sum(t, nn_) / _geometric_sum(t, mm)
    if d_max < 0:
        return raw
    y = d_max / r0
    s_dmax = (1.0 - y ** nn_) / (1.0 - y ** mm)
    stretch = 1.0 / (1.0 - s_dmax)
    return torch.where(r < d_max, (raw - s_dmax) * stretch,
                       torch.zeros_like(r))


def _activate(x: torch.Tensor, code: int) -> torch.Tensor:
    # ops.fused.KERNEL_ACTIVATIONS' codes, models.ann.ACTIVATIONS' math
    if code == 1:
        return torch.tanh(x)
    if code == 2:
        return torch.relu(x)
    if code == 3:
        return torch.sigmoid(x)
    if code == 4:
        return torch.nn.functional.gelu(x, approximate="tanh")
    if code == 5:
        return torch.nn.functional.elu(x)
    if code == 6:
        return torch.nn.functional.celu(x)
    if code == 7:
        return torch.nn.functional.softplus(x)
    if code == 8:
        return torch.nn.functional.silu(x)
    return x


def _long(rows, width):
    return torch.tensor([int(i) for row in rows for i in row],
                        dtype=torch.long).reshape(-1, width)


class _ScriptedModel(nn.Module):
    """A port model's eager forward as TorchScript: alignment of every atom
    by the model's method (``AlignmentLayer``), the compiled features in
    type-grouped blocks and their permutation
    (``ops.features.apply_compiled_features``), then the MLP
    (``SequentialNN``)."""

    coord_start: List[int]
    coord_n: List[int]
    coord_r0: List[float]
    coord_nn: List[int]
    coord_mm: List[int]
    coord_dmax: List[float]
    coord_box: List[List[float]]

    def __init__(self, model):
        super().__init__()
        from ..models.ann import Identity, MolANN, PreprocessingANN
        from ..ops.fused import KERNEL_ACTIVATIONS, _extract_model

        spec, _, _, params, activation = _extract_model(model)
        align = None
        if isinstance(model, MolANN):
            align = model.preprocessing_layer.align_layer
        elif isinstance(model, PreprocessingANN):
            align = model.align_layer
        if isinstance(align, Identity):
            align = None
        self.n_atoms = spec.n_input_atoms
        self.has_align = align is not None
        self.method = _METHODS[align.method] if align is not None else 0
        self.register_buffer("align_idx", torch.tensor(
            align._local_align_atom_indices if align is not None else [],
            dtype=torch.long))
        self.register_buffer("ref_x", (
            align.ref_x.detach().to("cpu", torch.float32).clone()
            if align is not None else torch.zeros(0, 3)))
        self.use_angle_value = spec.use_angle_value
        self.register_buffer("angle_idx", _long(spec.angle_idx, 3))
        self.register_buffer("bond_idx", _long(spec.bond_idx, 2))
        self.register_buffer("dihedral_idx", _long(spec.dihedral_idx, 4))
        self.register_buffer("position_idx", torch.tensor(
            list(spec.position_idx), dtype=torch.long))
        self.has_perm = spec.perm is not None
        self.register_buffer("perm", torch.tensor(
            list(spec.perm or ()), dtype=torch.long))
        self.register_buffer("coord_pairs", _long(spec.coord_pairs, 2))
        n_coord = spec.n_coordinations
        boxes = spec.coord_boxes or (None,) * n_coord
        dmaxs = spec.coord_dmax or (None,) * n_coord
        self.coord_start = [int(s) for s, _ in spec.coord_slices]
        self.coord_n = [int(n) for _, n in spec.coord_slices]
        self.coord_r0 = [float(p[0]) for p in spec.coord_params]
        self.coord_nn = [int(p[1]) for p in spec.coord_params]
        self.coord_mm = [int(p[2]) for p in spec.coord_params]
        self.coord_dmax = [-1.0 if v is None else float(v)
                                        for v in dmaxs]
        self.coord_box = [
            [] if b is None else [float(v) for row in b for v in row]
            for b in boxes]
        self.layers = nn.ModuleList()
        for w, b in params:
            lin = nn.Linear(w.shape[1], w.shape[0])
            with torch.no_grad():
                lin.weight.copy_(w.detach().cpu())
                lin.bias.copy_(b.detach().cpu())
            self.layers.append(lin)
        self.activation = KERNEL_ACTIVATIONS[activation]

    def _align(self, x: torch.Tensor) -> torch.Tensor:
        sub = x.index_select(1, self.align_idx)
        c = torch.mean(sub, dim=1, keepdim=True)
        H = torch.einsum("lni,nj->lij", [sub - c, self.ref_x.to(x.dtype)])
        if self.method == 1:
            R = _rotation_svd(H)
        elif self.method == 2:
            _, v = torch.linalg.eigh(_quaternion_matrix(H))
            R = _quaternion_to_rotation(v[..., :, -1])
        else:
            R = _rotation_qcp(H)
        return (x - c) @ R

    def _coordination(self, x: torch.Tensor) -> torch.Tensor:
        outs: List[torch.Tensor] = []
        for k in range(len(self.coord_n)):
            s0 = self.coord_start[k]
            g = _gather(x, self.coord_pairs[s0:s0 + self.coord_n[k]])
            d = g[:, :, 1, :] - g[:, :, 0, :]
            box = self.coord_box[k]
            if len(box) > 0:
                # ops.features.min_image_components, lower-triangular box
                comps = [d[..., 0], d[..., 1], d[..., 2]]
                for i in [2, 1, 0]:
                    shift = torch.round(comps[i] * (1.0 / box[3 * i + i]))
                    for j in range(3):
                        if box[3 * i + j] != 0.0:
                            comps[j] = comps[j] - shift * box[3 * i + j]
                d = torch.stack(comps, dim=-1)
            outs.append(torch.sum(_switching(
                _norm(d), self.coord_r0[k], self.coord_nn[k],
                self.coord_mm[k], self.coord_dmax[k]), dim=1))
        return torch.stack(outs, dim=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.has_align:
            x = self._align(x)
        l = x.size(0)
        parts: List[torch.Tensor] = []
        if self.angle_idx.size(0) > 0:
            g = _gather(x, self.angle_idx)
            r21 = g[:, :, 0, :] - g[:, :, 1, :]
            r23 = g[:, :, 2, :] - g[:, :, 1, :]
            cos_angle = torch.sum(r21 * r23, dim=-1) / (_norm(r21)
                                                        * _norm(r23))
            parts.append(torch.acos(cos_angle) if self.use_angle_value
                         else cos_angle)
        if self.bond_idx.size(0) > 0:
            g = _gather(x, self.bond_idx)
            parts.append(_norm(g[:, :, 1, :] - g[:, :, 0, :]))
        if self.dihedral_idx.size(0) > 0:
            g = _gather(x, self.dihedral_idx)
            r12 = g[:, :, 1, :] - g[:, :, 0, :]
            r23 = g[:, :, 2, :] - g[:, :, 1, :]
            r34 = g[:, :, 3, :] - g[:, :, 2, :]
            n1 = torch.linalg.cross(r12, r23)
            n2 = torch.linalg.cross(r23, r34)
            cos_phi = torch.sum(n1 * n2, dim=-1)
            sin_phi = torch.sum(n1 * r34, dim=-1) * _norm(r23)
            if self.use_angle_value:
                parts.append(torch.atan2(sin_phi, cos_phi))
            else:
                radius = torch.sqrt(cos_phi * cos_phi + sin_phi * sin_phi)
                parts.append(torch.stack(
                    [cos_phi / radius, sin_phi / radius], dim=-1).reshape(
                        l, -1))
        if len(self.coord_n) > 0:
            parts.append(self._coordination(x))
        if self.position_idx.size(0) > 0:
            parts.append(x.index_select(1, self.position_idx).reshape(l, -1))
        y = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
        if self.has_perm:
            y = y.index_select(1, self.perm)
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            y = lin(y)
            if i < n - 1:
                y = _activate(y, self.activation)
        return y


# ---------------------------------------------------------------------------
# The artifacts' forwards
# ---------------------------------------------------------------------------


def _check_frames(x: torch.Tensor, n_atoms: int, batch_size: int):
    if x.dim() != 3 or x.size(1) != n_atoms or x.size(2) != 3:
        raise ValueError("the artifact takes frames [l, n_atoms, 3]")
    if batch_size > 0 and x.size(0) != batch_size:
        raise ValueError("the artifact takes a fixed batch of frames "
                         "(its batch_size)")


class _Artifact(nn.Module):
    def __init__(self, n_atoms, batch_size):
        super().__init__()
        self.n_atoms = int(n_atoms)
        self.batch_size = int(batch_size or 0)


class _Eager(_Artifact):
    def __init__(self, model, n_atoms, batch_size):
        super().__init__(n_atoms, batch_size)
        self.model = _ScriptedModel(model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_frames(x, self.n_atoms, self.batch_size)
        return self.model(x)


class _EagerGrad(_Eager):
    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_frames(x, self.n_atoms, self.batch_size)
        xg = x.detach().requires_grad_(True)
        y = self.model(xg)
        g = torch.autograd.grad([y.sum()], [xg])[0]
        assert g is not None
        return y.detach(), g


class _Fused(_Artifact):
    meta: List[int]

    def __init__(self, tables, n_atoms, batch_size):
        super().__init__(n_atoms, batch_size)
        self.register_buffer("ints", tables["ints"])
        self.register_buffer("floats", tables["floats"])
        self.register_buffer("pairs", tables.get(
            "pairs", torch.zeros(0, dtype=torch.int32)))
        self.meta = [int(v) for v in tables["meta"]]


class _UnrolledForward(_Fused):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_frames(x, self.n_atoms, self.batch_size)
        return torch.ops.molann_tpu_torch.unrolled_forward(
            x.contiguous(), self.ints, self.floats, self.meta)


class _UnrolledCvForces(_Fused):
    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_frames(x, self.n_atoms, self.batch_size)
        return torch.ops.molann_tpu_torch.unrolled_cv_forces(
            x.contiguous(), self.ints, self.floats, self.meta)


class _BlockedForward(_Fused):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _check_frames(x, self.n_atoms, self.batch_size)
        return torch.ops.molann_tpu_torch.blocked_forward(
            x.contiguous(), self.ints, self.floats, self.pairs, self.meta)


class _BlockedCvForces(_Fused):
    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _check_frames(x, self.n_atoms, self.batch_size)
        return torch.ops.molann_tpu_torch.blocked_cv_forces(
            x.contiguous(), self.ints, self.floats, self.pairs, self.meta)


def export_artifact(model, n_atoms, path=None, *, with_gradient=False,
                    batch_size=None, fused=False, tile=None, c_mat="auto"):
    """Serialize ``model``'s forward as a TorchScript engine artifact.

    :param model: a MolANN, PreprocessingANN or FeatureLayer of the port
    :param n_atoms: input atom count (the artifact's input is ``[l,
        n_atoms, 3]`` float32)
    :param path: optional file path; when given, the bytes are written there
    :param with_gradient: also return ``∂(Σ out)/∂x`` (force evaluation):
        the artifact then yields ``(out, grad)``
    :param batch_size: fix the frame-batch size, checked on every call;
        default any batch
    :param fused: call the hand-written CUDA kernels as torch custom ops
        (K1/K4 for the unrolled formulation, K6/K8 for the blocked one,
        ``model_select_mode``); CUDA-only artifact: on CPU tensors the call
        raises. Exporting needs no card.
    :param tile: accepted for the JAX signature and checked; the CUDA
        kernels choose their own tile on the card they run on
    :param c_mat: the pair operand of a blocked model's coordination
        features: ``"auto"`` (default) or ``None`` carry the model's own
        (``model_chunk_matrix``) as one buffer of the artifact; an explicit
        int32 array is checked and carried instead. Ignored without
        ``fused``.
    :returns: the serialized bytes
    """
    from ..models.ann import model_dims
    from ..ops.fused import check_tile_args, model_select_mode

    check_tile_args(tile)
    n, d_out = model_dims(model)
    if int(n_atoms) != n:
        raise ValueError(f"the model takes {n} atoms, not n_atoms={n_atoms}")
    if batch_size is not None and int(batch_size) <= 0:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    mode = None
    if fused:
        from ..ops import fused_blocked
        from ..ops._build import load_op_library
        from ..ops.fused import artifact_tables

        load_op_library(cuda=False)  # the schemas, for the script compiler
        mode = model_select_mode(model)
        if mode == "unrolled":
            tables = artifact_tables(model)
            cls = _UnrolledCvForces if with_gradient else _UnrolledForward
        else:
            tables = fused_blocked.artifact_tables(model, c_mat)
            cls = _BlockedCvForces if with_gradient else _BlockedForward
        module = cls(tables, n, batch_size)
    else:
        module = (_EagerGrad if with_gradient else _Eager)(model, n,
                                                            batch_size)
    info = {"format": 1, "fused": bool(fused), "mode": mode,
            "with_gradient": bool(with_gradient), "n_atoms": n,
            "d_out": int(d_out), "batch_size": int(batch_size or 0)}
    buf = io.BytesIO()
    torch.jit.save(torch.jit.script(module), buf,
                   _extra_files={INFO_FILE: json.dumps(info)})
    blob = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(blob)
    return blob


def artifact_info(blob):
    """The record an artifact carries (``fused``, ``mode``,
    ``with_gradient``, ``n_atoms``, ``d_out``, ``batch_size``), read from
    the archive without loading it; None for a TorchScript archive that
    :func:`export_artifact` did not write."""
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        for name in z.namelist():
            if name.endswith("/extra/" + INFO_FILE):
                return json.loads(z.read(name))
    return None


def load_artifact(path_or_bytes, device=None):
    """Load an artifact as a callable ``fn(x)`` on ``device`` (the card
    when ``None``, an error without one; ``"cpu"`` the host). A fused
    artifact's op library is loaded first: its CUDA implementations on the
    card (built at first use), its schemas alone on the host, where calling
    the artifact raises."""
    device = resolve_device(device)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            blob = fh.read()
    info = artifact_info(blob) or {}
    if info.get("fused"):
        from ..ops._build import load_op_library

        load_op_library(cuda=device.type == "cuda")
    return torch.jit.load(io.BytesIO(blob), map_location=device)
