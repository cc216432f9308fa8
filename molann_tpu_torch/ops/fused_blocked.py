"""The blocked fused formulation for large systems: CUDA kernels, their
host-side layout compiler and their plain versions.

Port of ``molann_tpu/ops/fused_blocked.py``:

- :func:`blocked_apply` — values, differentiable with respect to x, the
  MLP parameters and ``ref_x``; on a CUDA tensor it launches the CUDA
  kernel that replaces the Pallas ``_blk_fwd_kernel`` (K6), and its
  backward launches the one that replaces ``_blk_bwd_kernel`` (K7);
- :func:`blocked_cv_forces` — values and coordinate gradients in one pass;
  on a CUDA tensor it launches the CUDA kernel that replaces
  ``_blk_cv_forces_kernel`` (K8);
- :func:`blocked_train_grads` — the MSE loss and its parameter gradients in
  one pass; on a CUDA tensor it launches the CUDA kernel that replaces
  ``_blk_train_kernel`` (K5).

The kernels live in ``csrc/fused_blocked.cu`` (K6, K8) and
``csrc/fused_blocked_grads.cu`` (K7, K5) over the per-block steps of
``csrc/blocked_math.cuh``. Beside them are the plain PyTorch versions
:func:`blocked_forward_plain`, :func:`blocked_backward_plain`,
:func:`blocked_cv_forces_plain` and :func:`blocked_train_grads_plain`, which
a wrapper takes only for a CPU tensor.

What the JAX module does with matrices, this one does with index tables. A
:class:`BlockedLayout` keeps the names a reader of the JAX module looks for
(``active_idx``, ``n_active``, ``coord_resident``, ``coord_npairs``,
``has_align``, ``n_align``, ``out_dim``) and holds int32 tables in place of
``D``, ``C`` and ``CW``: the atoms of every feature, each feature's final
column, the bonds, angles and dihedrals in batches in which no two share an
atom (their adjoints are added into per-atom accumulators batch by batch),
per atom its position and alignment entries, and for the coordination
features per atom its pair partners. That last part, the *pair operand*, is
what ``c_mat`` is in the port (:func:`chunk_matrix`): one int32 device
tensor ``[partner rows | owned ends | partners]`` that may hold millions of
pairs.

The kernels choose their own tile (:func:`choose_frames`): the ``tile``
that the fused ops and ``evaluate_trajectory`` accept for the JAX signature
sets the TPU kernels' VMEM tiling and changes nothing here. ``precision``
is validated and otherwise ignored, on the training paths too: it selects
the passes of the TPU's edge matmul, which a direct f32 gather does not
have, and f32 is inside every mode's error budget (docs/design.md:296-300).
``probes/edge_mm_probe.py`` measures the tensor-core forms of that product
against the gather.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..spec import CompiledFeatures
from . import fused as _F

__all__ = [
    "BlockedLayout",
    "blocked_layout",
    "chunk_matrix",
    "artifact_tables",
    "blocked_apply",
    "blocked_cv_forces",
    "blocked_train_grads",
    "blocked_forward_plain",
    "blocked_backward_plain",
    "blocked_cv_forces_plain",
    "blocked_train_grads_plain",
    "gradient_jump_slack",
]

# Coordination features with more pairs than this are "streamed" in the JAX
# package (molann_tpu/ops/fused_blocked.py:171); here it only decides
# whether a model has a pair operand the caller may pass as ``c_mat``.
COORD_RESIDENT_MAX = 512
# Mirrors of csrc/blocked_math.cuh, checked against the built library.
BLK_COORD_FLOATS = _F.COORD_FLOATS
BLK_THREADS = 256
BLK_THREADS_WIDE = 512  # MOLANN_BLK_THREADS_WIDE
BLK_GRAD_BLOCKS = 528
# Where a backward or train block's running sums live (BLK_SUMS_*), and the
# floats of a thread's rectangle of a large layer's weight gradient.
SUMS_SHARED, SUMS_ROW, SUMS_RECT = 0, 1, 2
RECT_FLOATS = 24
# Shared memory a block may use (227 KB), and a quarter and a half of an
# SM's, at which four and two blocks are resident and hide each other's
# barriers.
_SMEM_MAX = 232448
_SMEM_QUARTER = 56 * 1024
_SMEM_HALF = 113 * 1024
# Blocks a launch should have before its tile grows: about one per SM.
_MIN_BLOCKS = 128
# Floats of one [frames, pairs, 3] intermediate of the plain versions.
_PLAIN_SLICE_FLOATS = 1 << 25


class BlockedLayout:
    """Static plan of the blocked kernels for one compiled spec.

    Attributes kept from the JAX ``BlockedLayout``: ``n_atoms``,
    ``active_idx`` (sorted input-atom indices any feature or the align
    subset references, or None when compaction is off), ``n_active``,
    ``coord_npairs``, ``coord_resident``, ``chunked``, ``has_align``,
    ``n_align``, ``out_dim``. ``tables`` holds the small int32 index tables
    by name and ``coord_par`` the per-feature float parameters; the pair
    operand is built on demand by :meth:`pair_operand` and the batches of
    bonds, angles and dihedrals by :meth:`feature_batches`. Every atom index in
    a table is a staged index: a position in ``active_idx`` when compaction
    is on, the input-atom index otherwise.
    """

    def __init__(self, spec: CompiledFeatures, align_idx):
        n = spec.n_input_atoms
        self.spec = spec
        self.n_atoms = n
        self.out_dim = spec.out_dim
        self.use_angle_value = spec.use_angle_value
        # alignment only matters for position features
        self.has_align = align_idx is not None and spec.n_position_atoms > 0
        self.align_idx = tuple(align_idx) if self.has_align else ()
        self.n_align = len(self.align_idx)
        n_coord = spec.n_coordinations
        self.coord_npairs = tuple(npairs for _, npairs in spec.coord_slices)
        self.coord_resident = tuple(npairs <= COORD_RESIDENT_MAX
                                    for npairs in self.coord_npairs)
        self.chunked = not all(self.coord_resident)
        self._pairs = np.asarray(spec.coord_pairs, dtype=np.int64).reshape(-1, 2)

        # active-atom compaction engages when 4 * n_active <= n
        used = set(int(a) for row in spec.angle_idx for a in row)
        used.update(int(a) for row in spec.bond_idx for a in row)
        used.update(int(a) for row in spec.dihedral_idx for a in row)
        used.update(int(a) for a in np.unique(self._pairs))
        used.update(int(a) for a in spec.position_idx)
        used.update(int(a) for a in self.align_idx)
        active = np.asarray(sorted(used), dtype=np.int64)
        if active.size and 4 * active.size <= n:
            self.active_idx = active
            self.n_active = int(active.size)
            staged = np.full(n, -1, dtype=np.int64)
            staged[active] = np.arange(active.size)
        else:
            self.active_idx = None
            self.n_active = n
            staged = np.arange(n, dtype=np.int64)
        self._staged = staged

        def remap(rows, width):
            return staged[np.asarray(rows, dtype=np.int64).reshape(-1, width)]

        angle = remap(spec.angle_idx, 3)
        bond = remap(spec.bond_idx, 2)
        dihedral = remap(spec.dihedral_idx, 4)
        pos = staged[np.asarray(spec.position_idx, dtype=np.int64)]
        align = staged[np.asarray(self.align_idx, dtype=np.int64)]

        # first FINAL column of every item; spec.perm maps final column c to
        # row perm[c] of [angles | bonds | dihedrals | coords | positions]
        d = spec.out_dim
        perm = (np.arange(d) if spec.perm is None
                else np.asarray(spec.perm, dtype=np.int64))
        final_of_row = np.empty(d, dtype=np.int64)
        final_of_row[perm] = np.arange(d)
        w = 1 if spec.use_angle_value else 2
        na, nb, nd = spec.n_angles, spec.n_bonds, spec.n_dihedrals
        rows = np.concatenate([
            np.arange(na), na + np.arange(nb), na + nb + w * np.arange(nd),
            na + nb + w * nd + np.arange(n_coord),
            na + nb + w * nd + n_coord + 3 * np.arange(len(pos))])
        item_col = final_of_row[rows.astype(np.int64)]

        # per staged atom, its (kind, item) entries of the gather: position
        # features, then align atoms. Bonds, angles and dihedrals reach their
        # atoms through the batches.
        entries = [[] for _ in range(self.n_active)]
        for item, a in enumerate(pos):
            entries[a].append(3 << 28 | item)
        for item, a in enumerate(align):
            entries[a].append(4 << 28 | item)
        if max(len(angle), len(bond), len(dihedral), len(pos), 1) >= 1 << 28:
            raise ValueError("too many features of one type for the blocked "
                             "kernels' tables (limit 2^28)")
        self._scattered = [
            (kind, item, tuple(int(a) for a in row))
            for kind, table in enumerate((angle, bond, dihedral))
            for item, row in enumerate(table)]
        self._batches: dict = {}
        atom_ptr = np.zeros(self.n_active + 1, dtype=np.int64)
        atom_ptr[1:] = np.cumsum([len(e) for e in entries])
        atom_ent = np.asarray([v for e in entries for v in e], dtype=np.int64)

        out_map = staged if self.active_idx is not None else np.zeros(0)
        self.coord_range = self._coord_ranges()
        self.tables = {
            "active_idx": (self.active_idx if self.active_idx is not None
                           else np.zeros(0)),
            "out_map": out_map,
            "angle_idx": angle, "bond_idx": bond, "dihedral_idx": dihedral,
            "pos_idx": pos, "align_idx": align, "item_col": item_col,
            "atom_ptr": atom_ptr, "atom_ent": atom_ent,
            "coord_range": np.asarray(self.coord_range).reshape(-1),
        }
        self.tables = {k: np.ascontiguousarray(v, dtype=np.int32).reshape(-1)
                       for k, v in self.tables.items()}

        self.coord_par = _F.coord_parameters(spec).reshape(-1)
        self._on_device: dict = {}  # device tensors, built once per device

    def _coord_ranges(self):
        """Per coordination feature ``(s0, n)`` when its pairs are all
        pairs of the staged atoms ``s0..s0+n-1`` (each once, none with
        itself), else ``(0, 0)``. The kernels walk such a feature's partners
        by position on the circle of those atoms, with no partner table:
        atom ``s0 + i`` owns the pairs with the next ``(n - 1) // 2`` atoms
        (and, for even ``n`` and ``i < n / 2``, with the one opposite)."""
        out, start = [], 0
        for npairs in self.coord_npairs:
            p = self._staged[self._pairs[start:start + npairs]]
            start += npairs
            lo, hi = p.min(axis=1), p.max(axis=1)
            s0, n = (int(lo.min()), int(hi.max()) - int(lo.min()) + 1) \
                if npairs else (0, 0)
            if (n >= 2 and npairs == n * (n - 1) // 2 and (lo < hi).all()
                    and np.unique((lo - s0) * n + (hi - s0)).size == npairs):
                out.append((s0, n))
            else:
                out.append((0, 0))
        return tuple(out)

    @property
    def n_pairs(self):
        return int(self._pairs.shape[0])

    @property
    def pair_operand_size(self):
        """Entries of the pair operand: ``[partner rows n_coord·(n_active+1)
        | owned ends n_coord·n_active | partners 2P]``."""
        return 2 * self.n_pairs + len(self.coord_npairs) * (
            2 * self.n_active + 1)

    def pair_operand(self):
        """The int32 pair operand of the coordination features (numpy,
        1-D), in staged indices: per feature and atom the row of its pair
        partners (a CSR into the partners), per feature and atom where in
        that row the partners of the pairs the atom *owns* end, then the
        partners, each row's owned ones first. Every pair has one owner, so
        a walk over the owned partners of every atom meets each pair once;
        a pair ``(i, j)`` belongs to its smaller atom when ``i + j`` is
        even and to its larger otherwise, which shares an all-pairs
        feature's pairs evenly among its atoms."""
        pairs = self._staged[self._pairs]
        ptrs, mids, nbrs, base = [], [], [], 0
        start = 0
        for npairs in self.coord_npairs:
            p = pairs[start:start + npairs]
            start += npairs
            lo, hi = p.min(axis=1), p.max(axis=1)
            owner = np.where((lo + hi) % 2 == 0, lo, hi)
            other = lo + hi - owner
            ends = np.concatenate([owner, other])
            partners = np.concatenate([other, owner])
            order = np.argsort(ends, kind="stable")  # owned first, pair order
            ptr = np.zeros(self.n_active + 1, dtype=np.int64)
            ptr[1:] = np.cumsum(np.bincount(ends, minlength=self.n_active))
            ptrs.append(base + ptr)
            mids.append(base + ptr[:-1]
                        + np.bincount(owner, minlength=self.n_active))
            nbrs.append(partners[order])
            base += 2 * npairs
        parts = [*ptrs, *mids, *nbrs]
        out = np.concatenate(parts) if parts else np.zeros(0)
        if out.size and out.max() >= 2**31:
            raise ValueError("pair operand exceeds int32 indexing")
        return np.ascontiguousarray(out, dtype=np.int32)

    def feature_batches(self, group):
        """``(batch_ptr, batch_ent)``, int32: the bonds, angles and
        dihedrals (``kind << 28 | item``) cut into batches of at most
        ``group`` features of which no two share an atom, so that a thread
        per feature can add its adjoint into per-atom accumulators without
        a race; the kernels put a barrier between batches. Greedy in table
        order (angles, bonds, dihedrals): a feature joins the first batch
        that has room and none of its atoms; within a batch the entries go
        by kind, so that the threads of a warp run one kind of adjoint."""
        if group not in self._batches:
            batches, open_ = [], []  # open_: indices of batches with room
            for kind, item, atoms in self._scattered:
                for b in open_:
                    ents, used = batches[b]
                    if used.isdisjoint(atoms):
                        break
                else:
                    b = len(batches)
                    batches.append(([], set()))
                    open_.append(b)
                    ents, used = batches[b]
                ents.append(kind << 28 | item)
                used.update(atoms)
                if len(ents) >= group:
                    open_.remove(b)
            ptr = np.zeros(len(batches) + 1, dtype=np.int32)
            ptr[1:] = np.cumsum([len(e) for e, _ in batches])
            # a batch's entries by kind, so that a warp runs one adjoint
            ent = np.asarray([v for e, _ in batches
                              for v in sorted(e, key=lambda v: v >> 28)],
                             dtype=np.int32)
            self._batches[group] = (ptr, ent)
        return self._batches[group]

    def device_batches(self, group, device):
        """:meth:`feature_batches` as one tensor ``[ptr | ent | 0]`` on
        ``device`` and the number of batches."""
        key = ("batches", group, torch.device(device))
        if key not in self._on_device:
            ptr, ent = self.feature_batches(group)
            self._on_device[key] = (torch.from_numpy(np.concatenate(
                [ptr, ent, np.zeros(1, np.int32)])).to(device), len(ptr) - 1)
        return self._on_device[key]

    def device_tables(self, device):
        """The small int32 tables as ONE tensor on ``device`` with the
        element offset of each, and the coordination parameters."""
        key = ("tables", torch.device(device))
        if key not in self._on_device:
            flat, offsets = [], {}
            o = 0
            for name in _INT_TABLES:
                offsets[name] = o
                flat.append(self.tables[name])
                o += self.tables[name].size
            ints = torch.from_numpy(np.concatenate(
                [*flat, np.zeros(1, np.int32)])).to(device)
            par = torch.from_numpy(np.concatenate(
                [self.coord_par, np.zeros(1, np.float32)])).to(device)
            self._on_device[key] = (ints, offsets, par)
        return self._on_device[key]

    def device_head(self, dims, device):
        """The head table of the kernels (``BlockedArgs.head``) for the
        widths ``dims`` (``[n_feat, d_1, ..., d_out]``): per layer ``d_in,
        d_out``, its weights' offset in the parameter block, its output's
        first row among the layers' outputs, its weight gradient's offset in
        ``[loss | ref_x | W0 | b0 ...]``, then three zeros. An int32 tensor
        on ``device`` and the numpy array the host's sizing functions read,
        built once per head and device: the kernels take a head of any
        depth."""
        key = ("head", tuple(dims), torch.device(device))
        if key not in self._on_device:
            rows, w_off, h_row, g_off = [], 0, 0, 1 + 3 * self.n_align
            for d_in, d_o in zip(dims[:-1], dims[1:]):
                rows.append((d_in, d_o, w_off, h_row, g_off, 0, 0, 0))
                w_off += -(-d_o * d_in // 4) * 4 + -(-d_o // 4) * 4
                h_row += d_o
                g_off += d_o * (d_in + 1)
            host = np.ascontiguousarray(
                np.asarray(rows, dtype=np.int32).reshape(-1)
                if rows else np.zeros(8, np.int32))
            self._on_device[key] = (torch.from_numpy(host).to(device), host)
        return self._on_device[key]

    def device_pair_operand(self, device):
        """:meth:`pair_operand` as a tensor on ``device``."""
        key = ("pairs", torch.device(device))
        if key not in self._on_device:
            self._on_device[key] = torch.from_numpy(
                self.pair_operand()).to(device)
        return self._on_device[key]


_INT_TABLES = ("active_idx", "out_map", "angle_idx", "bond_idx",
               "dihedral_idx", "pos_idx", "align_idx", "item_col", "atom_ptr",
               "atom_ent", "coord_range")
# The one cache of this module: layouts by spec identity; a layout holds its
# own device tensors, so dropping it frees them.
_LAYOUTS: dict = {}


def blocked_layout(spec: CompiledFeatures, align_idx) -> BlockedLayout:
    """The cached layout of ``(spec, align_idx)``. Keyed by the spec's
    identity: hashing a spec walks its whole pair table, which for a
    condensed-phase model would cost more per call than the kernel's
    launch."""
    key = (id(spec), align_idx)
    hit = _LAYOUTS.get(key)
    if hit is not None and hit[0] is spec:
        return hit[1]
    lay = BlockedLayout(spec, align_idx)
    if len(_LAYOUTS) >= 64:
        _LAYOUTS.pop(next(iter(_LAYOUTS)))
    _LAYOUTS[key] = (spec, lay)  # holds the spec, so its id stays its own
    return lay


def chunk_matrix(spec, align_idx):
    """The pair operand of a spec's coordination features as an int32 numpy
    array, or ``None`` when no feature has more than 512 pairs (the JAX
    package's rule for having a chunk matrix). Move it to the device once
    and pass it as ``c_mat=`` so that a large pair table is one device
    buffer for every call."""
    lay = blocked_layout(spec, align_idx)
    if not lay.chunked:
        return None
    return lay.pair_operand()


# ---------------------------------------------------------------------------
# Plain PyTorch versions of the kernels
# ---------------------------------------------------------------------------


def _frame_slice(spec):
    """Frames per slice of the plain versions, so that the coordination
    part never holds more than ``_PLAIN_SLICE_FLOATS`` floats per
    ``[frames, pairs, 3]`` intermediate."""
    return max(1, _PLAIN_SLICE_FLOATS // max(1, 3 * len(spec.coord_pairs)))


def blocked_forward_plain(spec, align_idx, ref_x, params, activation, x):
    """The plain version of the blocked forward kernel: ``x [l, n, 3] → [l,
    d_out]`` through the port's eager layers (:func:`.fused.forward_plain`),
    a slice of frames at a time."""
    step = _frame_slice(spec)
    if x.shape[0] <= step:
        return _F.forward_plain(spec, align_idx, ref_x, params, activation, x)
    return torch.cat([
        _F.forward_plain(spec, align_idx, ref_x, params, activation,
                         x[s:s + step])
        for s in range(0, x.shape[0], step)])


def blocked_cv_forces_plain(spec, align_idx, ref_x, params, activation, x,
                            component=None):
    """The plain version of the blocked cv+forces kernel: the plain forward
    and ``torch.autograd.grad`` of ``sum(y)`` (or of ``y[:, component]``)
    with respect to ``x [l, n, 3]``, a slice of frames at a time. Returns
    ``(y, gx)``, both detached."""
    step = _frame_slice(spec)
    outs = [_F.cv_forces_plain(spec, align_idx, ref_x, params, activation,
                               x[s:s + step], component)
            for s in range(0, max(x.shape[0], 1), step)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([y for y, _ in outs]), torch.cat([g for _, g in outs])


def _sum_grads(total, part):
    """Add one slice's ``(gparams, g_ref)`` to the running total."""
    if total is None:
        return part
    gparams = tuple((gw + hw, gb + hb)
                    for (gw, gb), (hw, hb) in zip(total[0], part[0]))
    g_ref = None if total[1] is None else total[1] + part[1]
    return gparams, g_ref


def blocked_backward_plain(spec, align_idx, ref_x, params, activation, x,
                           gy):
    """The plain version of the blocked backward kernel: autograd of
    :func:`blocked_forward_plain` given the cotangent ``gy [l, d_out]``, a
    slice of frames at a time. Returns ``(gx [l, n, 3], gparams, g_ref)``
    as :func:`.fused.backward_plain` does, summed over the frames."""
    step = _frame_slice(spec)
    gxs, total = [], None
    for s in range(0, max(x.shape[0], 1), step):
        gx, gparams, g_ref = _F.backward_plain(
            spec, align_idx, ref_x, params, activation, x[s:s + step],
            gy[s:s + step])
        gxs.append(gx)
        total = _sum_grads(total, (gparams, g_ref))
    return (gxs[0] if len(gxs) == 1 else torch.cat(gxs)), *total


def blocked_train_grads_plain(spec, align_idx, ref_x, params, activation, x,
                              y_target, train_ref=False):
    """The plain version of the blocked train kernel: ``loss = mean((
    blocked_forward_plain(x) - y_target)**2)`` over ``x [l, n, 3]`` and
    ``y_target [l, d_out]`` and autograd of it with respect to the
    parameters (and ``ref_x`` when ``train_ref``), a slice of frames at a
    time. Returns ``(loss, gparams, g_ref)`` as
    :func:`.fused.train_grads_plain` does."""
    step = _frame_slice(spec)
    inv_count = 1.0 / float(y_target.numel())
    loss, total = None, None
    for s in range(0, x.shape[0], step):
        yt = y_target[s:s + step]
        part, _, gparams, g_ref = _F._plain_grads(
            spec, align_idx, ref_x, params, activation, x[s:s + step],
            lambda y, yt=yt: ((y - yt.to(y.dtype)) ** 2).sum() * inv_count,
            False, train_ref)
        loss = part if loss is None else loss + part
        total = _sum_grads(total, (gparams, g_ref))
    return loss, *total


def gradient_jump_slack(spec, params, x, tol=4e-6):
    """``[l, n]``: how far the gradient on each atom of ``x [l, n, 3]`` may
    rightly differ between two evaluations that place a pair on different
    sides of a threshold it sits within ``tol`` of.

    A coordination feature's gradient is not continuous in two places. At
    ``d_max`` the stretched switching function is continuous and its
    derivative is not: a pair counted inside adds ``|s'(d_max)|`` to the
    gradient of its two atoms, a pair counted outside adds nothing. Where a
    displacement sits at half a box length the minimum image flips its
    sign, and with it the sign of the pair's term. float32 and float64 may
    take different sides there, so a comparison between them allows, on
    the two atoms of such a pair and nowhere else, the jump the pair can
    make: its ``|s'(r)|`` (twice that for a flip) times a bound on
    ``|d objective / d feature|``, the largest entry of
    ``|W_L| ··· |W_1|`` summed over the outputs (every activation the
    kernels take has a slope of at most 1). Every other atom gets 0."""
    from .features import switching_function

    l, n = x.shape[:2]
    slack = x.new_zeros((l, n))
    if not spec.coord_slices:
        return slack
    slope = 1.0
    if params:
        chain = None
        for w, _ in params:
            a = w.detach().abs().to(x.dtype)
            chain = a if chain is None else a @ chain
        slope = float(chain.sum(dim=0).max())
    pairs = torch.as_tensor(np.asarray(spec.coord_pairs, dtype=np.int64)
                            .reshape(-1, 2), device=x.device)
    n_coord = len(spec.coord_slices)
    boxes = spec.coord_boxes or (None,) * n_coord
    dmaxs = spec.coord_dmax or (None,) * n_coord
    step = _frame_slice(spec)
    for s0 in range(0, l, step):
        xs = x[s0:s0 + step].detach()
        for (start, npairs), (r0, nn, mm), box, dmax in zip(
                spec.coord_slices, spec.coord_params, boxes, dmaxs):
            p = pairs[start:start + npairs]
            d = [xs[:, p[:, 1], i] - xs[:, p[:, 0], i] for i in range(3)]
            flip = torch.zeros_like(d[0], dtype=torch.bool)
            if box is not None:
                for i in (2, 1, 0):
                    frac = d[i] / box[i][i]
                    flip |= ((frac - torch.floor(frac) - 0.5).abs()
                             * box[i][i] < tol)
                    shift = torch.round(frac)
                    for j in range(3):
                        if box[i][j] != 0.0:
                            d[j] = d[j] - shift * box[i][j]
            with torch.enable_grad():
                r = torch.sqrt(d[0] * d[0] + d[1] * d[1]
                               + d[2] * d[2]).requires_grad_(True)
                (ds,) = torch.autograd.grad(
                    switching_function(r, r0, nn, mm).sum(), r)
            r, ds = r.detach(), ds.abs()
            if dmax is None:
                jump = 2.0 * ds * flip
            else:
                y = float(dmax) / float(r0)
                s_dmax = (1.0 - y**nn) / (1.0 - y**mm)
                edge = (r - dmax).abs() < tol
                jump = ds / (1.0 - s_dmax) * (
                    edge.to(ds.dtype) + 2.0 * (flip & (r < dmax + tol)))
            for end in (0, 1):
                slack[s0:s0 + step].index_add_(1, p[:, end], jump)
    return slope * slack


# ---------------------------------------------------------------------------
# Layouts of x, y and gx
# ---------------------------------------------------------------------------


def _classify(x, n):
    """``(tag, l)`` of an input in any layout ``_to_cmajor`` of the JAX
    module takes: ``"lnd"`` ``[l, n, 3]``, ``"packed"`` ``[l, 3n]``,
    ``"t"`` ``[3n, l]`` or ``"cmajor"`` ``[3, n, l]`` (a 3-d array is
    component-major only when it is ``[3, n, l]`` with ``l != 3``)."""
    shape = tuple(x.shape)
    if x.ndim == 3:
        if shape[0] == 3 and shape[1] == n and shape[2] != 3:
            return "cmajor", shape[2]
        if shape[1:] == (n, 3):
            return "lnd", shape[0]
    elif x.ndim == 2:
        if shape[1] == 3 * n:
            return "packed", shape[0]
        if shape[0] == 3 * n:
            return "t", shape[1]
    raise ValueError(f"expected frames [l, {n}, 3], [l, {3 * n}], "
                     f"[{3 * n}, l] or [3, {n}, l], got {shape}")


def _strides(tag, n, l):
    """Strides in floats of (frame, atom, component) for a layout tag."""
    return {"lnd": (3 * n, 3, 1), "packed": (3 * n, 3, 1),
            "t": (1, 3 * l, l), "cmajor": (1, l, n * l)}[tag]


def _as_lnd(x, tag, n, l):
    """Any layout as ``[l, n, 3]`` (a view where the layout allows)."""
    if tag == "lnd":
        return x
    if tag == "packed":
        return x.reshape(l, n, 3)
    if tag == "t":
        return x.reshape(n, 3, l).permute(2, 0, 1)
    return x.permute(2, 1, 0)


def _g_shape(tag, n, l):
    return {"lnd": (l, n, 3), "packed": (l, 3 * n), "t": (3 * n, l),
            "cmajor": (3, n, l)}[tag]


def _from_lnd(g, tag, n, l):
    """``[l, n, 3]`` into the layout ``tag``, contiguous."""
    if tag == "lnd":
        return g.contiguous()
    if tag == "packed":
        return g.reshape(l, 3 * n).contiguous()
    if tag == "t":
        return g.permute(1, 2, 0).reshape(3 * n, l).contiguous()
    return g.permute(2, 1, 0).contiguous()


def _resolve_out_layout(out_layout, tag):
    if out_layout is None:
        return {"lnd": "standard", "packed": "standard", "t": "t",
                "cmajor": "cmajor"}[tag]
    if out_layout not in ("standard", "t", "cmajor"):
        raise ValueError(f"unknown out_layout {out_layout!r}: choose None, "
                         "'standard', 't' or 'cmajor'")
    return out_layout


# ---------------------------------------------------------------------------
# Kernel arguments and launches
# ---------------------------------------------------------------------------

class BlockedArgs(ctypes.Structure):
    """Mirror of ``struct BlockedArgs`` in ``csrc/blocked_math.cuh``."""

    _fields_ = [
        ("n_act", ctypes.c_int), ("n_out", ctypes.c_int),
        ("n_angles", ctypes.c_int), ("n_bonds", ctypes.c_int),
        ("n_dihedrals", ctypes.c_int), ("n_coord", ctypes.c_int),
        ("n_pos", ctypes.c_int), ("n_align", ctypes.c_int),
        ("use_angle_value", ctypes.c_int), ("n_feat", ctypes.c_int),
        ("n_layers", ctypes.c_int), ("activation", ctypes.c_int),
        ("frames", ctypes.c_int), ("pitch", ctypes.c_int),
        ("n_batches", ctypes.c_int),
        *((name, ctypes.c_void_p) for name in _INT_TABLES),
        ("batch_ptr", ctypes.c_void_p), ("batch_ent", ctypes.c_void_p),
        ("head", ctypes.c_void_p), ("head_host", ctypes.c_void_p),
        ("nbr_ptr", ctypes.c_void_p), ("nbr_mid", ctypes.c_void_p),
        ("nbr", ctypes.c_void_p), ("coord_par", ctypes.c_void_p),
        ("ref_x", ctypes.c_void_p), ("params", ctypes.c_void_p),
    ]


class BlockedIO(ctypes.Structure):
    """Mirror of ``struct BlockedIO`` in ``csrc/blocked_math.cuh``."""

    _fields_ = [
        ("x", ctypes.c_void_p), ("y", ctypes.c_void_p),
        ("gx", ctypes.c_void_p), ("l", ctypes.c_longlong),
        ("x_sf", ctypes.c_longlong), ("x_sa", ctypes.c_longlong),
        ("x_sc", ctypes.c_longlong),
        ("y_sf", ctypes.c_longlong), ("y_sj", ctypes.c_longlong),
        ("g_sf", ctypes.c_longlong), ("g_sa", ctypes.c_longlong),
        ("g_sc", ctypes.c_longlong),
        ("component", ctypes.c_int), ("want_ref", ctypes.c_int),
        ("gy", ctypes.c_void_p),
        ("gy_sf", ctypes.c_longlong), ("gy_sj", ctypes.c_longlong),
        ("y_target", ctypes.c_void_p),
        ("t_sf", ctypes.c_longlong), ("t_sj", ctypes.c_longlong),
        ("inv_count", ctypes.c_float), ("acc_global", ctypes.c_int),
        ("partials", ctypes.c_void_p),
    ]


def resolve_c_mat(lay, c_mat, device):
    """The pair operand the kernels walk, on ``device``: the caller's
    ``c_mat`` after checking it, else one built and cached per layout and
    device (None for a layout without coordination features). A ``c_mat``
    given to a model that has no pair operand of its own (no coordination
    feature over 512 pairs), or of the wrong size or type, raises."""
    if not lay.chunked:
        if c_mat is not None:
            raise ValueError("c_mat given but this model has no chunked "
                             "coordination features")
    elif c_mat is not None:
        if isinstance(c_mat, np.ndarray):
            c_mat = torch.from_numpy(c_mat)
        want = (lay.pair_operand_size,)
        if (not torch.is_tensor(c_mat) or tuple(c_mat.shape) != want
                or c_mat.dtype != torch.int32):
            got = (f"{c_mat.dtype} {tuple(c_mat.shape)}"
                   if torch.is_tensor(c_mat) else type(c_mat).__name__)
            raise ValueError(f"c_mat must be int32 {want} (use "
                             f"model_chunk_matrix(model)); got {got}")
        return c_mat.to(device).contiguous()
    if not lay.coord_npairs or torch.device(device).type == "cpu":
        return None  # the plain versions read the spec
    return lay.device_pair_operand(device)


def check_blocked_envelope(params, activation):
    """What the blocked CUDA kernels compute, checked for every input
    device so that a model behaves the same on the CPU and on the card."""
    if activation not in _F.KERNEL_ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}; the CUDA "
                         f"kernels take {sorted(_F.KERNEL_ACTIVATIONS)}")


def param_block(lay, ref_x, params, device):
    """The blocked kernels' float parameters on ``device``: a leading pad of
    4 zeros, then ``ref_x`` (where the layout aligns) and per layer ``W``
    transposed ``[d_in, d_out]`` and ``b``, every piece padded to a
    multiple of 4 floats so that the kernels may load a row of four weights
    in one 16-byte access (the leading pad keeps the pointer valid for a
    model without any); one zeros and one cat."""
    with torch.no_grad():
        zeros = torch.zeros(4, dtype=torch.float32, device=device)
        pieces = [zeros]
        tensors = [ref_x.reshape(-1)] if lay.has_align else []
        for w, b in params:
            tensors.extend((w.T.reshape(-1), b.reshape(-1)))
        for p in tensors:
            if p.device != device:
                raise ValueError(
                    f"model tensors are on {p.device}, input on {device}: "
                    "move the model with model.to(device)")
            pieces.append(p.to(torch.float32))
            if p.numel() % 4:
                pieces.append(zeros[:-p.numel() % 4])
        return torch.cat(pieces)


def _sizes(lay, params, activation, compact_out=False):
    """``(field, value)`` of the sizes a :class:`BlockedArgs` holds, but
    for the tile's."""
    spec = lay.spec
    return (("n_act", lay.n_active),
            ("n_out", lay.n_active if compact_out else lay.n_atoms),
            ("n_angles", spec.n_angles), ("n_bonds", spec.n_bonds),
            ("n_dihedrals", spec.n_dihedrals),
            ("n_coord", spec.n_coordinations),
            ("n_pos", spec.n_position_atoms), ("n_align", lay.n_align),
            ("use_angle_value", int(spec.use_angle_value)),
            ("n_feat", spec.out_dim), ("n_layers", len(params)),
            ("activation", _F.KERNEL_ACTIVATIONS[activation]))


def blocked_args(lay, ref_x, params, activation, pair_op, device, *,
                 compact_out=False):
    """``(BlockedArgs, keepalive)`` for the kernels on ``device``; the
    tile (frames, pitch and the feature batches) is left for
    :func:`set_tile`."""
    device = torch.device(device)
    ints, offsets, par = lay.device_tables(device)
    spec = lay.spec
    floats = param_block(lay, ref_x, params, device)
    a = BlockedArgs()
    for name, value in _sizes(lay, params, activation, compact_out):
        setattr(a, name, value)
    head_dev, head_host = lay.device_head(
        (spec.out_dim, *(int(w.shape[0]) for w, _ in params)), device)
    a.head, a.head_host = head_dev.data_ptr(), head_host.ctypes.data
    base = ints.data_ptr()
    for name in _INT_TABLES:
        setattr(a, name, base + 4 * offsets[name])
    if lay.active_idx is None:
        a.active_idx = None
    if lay.active_idx is None or compact_out:
        a.out_map = None
    if pair_op is not None:
        p0 = pair_op.data_ptr()
        n_ptr = len(lay.coord_npairs) * (lay.n_active + 1)
        a.nbr_ptr = p0
        a.nbr_mid = p0 + 4 * n_ptr
        a.nbr = p0 + 4 * (2 * n_ptr - len(lay.coord_npairs))
    a.coord_par = par.data_ptr()
    fbase = floats.data_ptr() + 16  # past the leading pad
    a.ref_x = fbase
    a.params = fbase + 4 * (-(-3 * lay.n_align // 4) * 4)
    if floats.data_ptr() % 16:
        raise RuntimeError("the parameter block is not 16-byte aligned")
    return a, (ints, par, floats, pair_op, head_dev, head_host)


def set_tile(args, lay, frames, device, threads):
    """Give ``args`` its tile: ``frames`` frames a block and the batches of
    bonds, angles and dihedrals for the ``threads // frames`` features a
    block's threads take at a time. Returns what must stay alive."""
    args.frames, args.pitch = frames, frames | 1
    buf, n_batches = lay.device_batches(max(1, threads // frames), device)
    args.n_batches = n_batches
    args.batch_ptr = buf.data_ptr()
    args.batch_ent = buf.data_ptr() + 4 * (n_batches + 1)
    return buf


def blocked_io(x, x_strides, l, y, y_strides, gx, g_strides, component):
    """A call's :class:`BlockedIO`: pointers, frame count, strides in
    floats, and the component (None = the sum of the outputs)."""
    io = BlockedIO()
    io.x, io.l = x.data_ptr(), l
    io.y = y.data_ptr() if y is not None else None
    io.gx = gx.data_ptr() if gx is not None else None
    io.x_sf, io.x_sa, io.x_sc = x_strides
    io.y_sf, io.y_sj = y_strides
    io.g_sf, io.g_sa, io.g_sc = g_strides
    io.component = -1 if component is None else component
    return io


def blocked_grads_io(kind, x, x_strides, l, aux, aux_strides, gx, g_strides,
                     want_ref, inv_count, acc_global, partials):
    """The :class:`BlockedIO` of a backward (``aux`` = gy) or train
    (``aux`` = y_target) call."""
    io = blocked_io(x, x_strides, l, None, (0, 0), gx, g_strides, None)
    if kind == "blocked_train":
        io.y_target = aux.data_ptr()
        io.t_sf, io.t_sj = aux_strides
    else:
        io.gy = aux.data_ptr()
        io.gy_sf, io.gy_sj = aux_strides
    io.want_ref, io.inv_count = int(want_ref), inv_count
    io.acc_global, io.partials = int(acc_global), partials.data_ptr()
    return io


def _library():
    """The built kernel library, after checking that it was compiled with
    the caps and struct layouts this module assumes."""
    lib = _F._library()
    caps = (ctypes.c_int * 5)()
    lib.molann_blocked_caps(caps)
    want = [BLK_COORD_FLOATS, BLK_THREADS,
            ctypes.sizeof(BlockedArgs), ctypes.sizeof(BlockedIO),
            BLK_GRAD_BLOCKS]
    if list(caps) != want:
        raise RuntimeError(f"kernel library caps {list(caps)} do not match "
                           f"ops/fused_blocked.py {want}")
    return lib


# The batches of bonds, angles and dihedrals a blocked launch may ask for:
# max(1, threads // frames) over a block's threads and every tile.
BATCH_GROUPS = tuple(sorted({max(1, t // f)
                             for t in (BLK_THREADS, BLK_THREADS_WIDE)
                             for f in (32, 16, 8, 4, 2, 1)}))
# The int meta-data of an engine artifact of K6/K8, in the order
# csrc/torch_ops_launch.cpp reads it (BlkMeta there): the format, the sizes
# of BlockedArgs, the input's atoms and the output width, whether the layout
# compacts atoms, walks pairs heavily (pair_heavy) and has a pair operand,
# the operand's length, the element offset of each int32 table, of the head
# table and of each group's batches (with their count) in the int32 tensor,
# and of the coordination parameters, ref_x and the parameters in the
# float32 tensor; then the head table itself, for the host's sizing.
BLOCKED_META = (
    "format", "n_act", "n_out", "n_angles", "n_bonds", "n_dihedrals",
    "n_coord", "n_pos", "n_align", "use_angle_value", "n_feat", "n_layers",
    "activation", "n_atoms", "d_out", "has_active", "pair_heavy",
    "has_pairs", "n_pair_operand", *(f"{t}_off" for t in _INT_TABLES),
    "head_off", *(f"{k}{g}" for g in BATCH_GROUPS
                  for k in ("batches_off_", "n_batches_")),
    "coord_par_off", "ref_x_off", "params_off")
BLOCKED_FORMAT = 1


def artifact_tables(model, c_mat="auto"):
    """What an engine artifact carries to run ``model`` through the blocked
    kernels K6 (values) and K8 (values and coordinate gradients) as torch
    custom ops (:mod:`molann_tpu_torch.io.export`): ``{"ints", "floats",
    "pairs", "meta"}``, host tensors and a list of ints.

    ``ints`` holds the layout's int32 tables (:meth:`BlockedLayout.
    device_tables`), the head table (:meth:`BlockedLayout.device_head`) and
    the batches of bonds, angles and dihedrals for every group a tile may
    ask for (:data:`BATCH_GROUPS`), each piece 32-byte aligned; ``floats``
    the coordination parameters and :func:`param_block`; ``pairs`` the pair
    operand (:meth:`BlockedLayout.pair_operand`, or ``c_mat`` checked as
    :func:`resolve_c_mat` checks it; empty without coordination features);
    ``meta`` the sizes and offsets named by :data:`BLOCKED_META`, then the
    head table. The ops choose the tile as :func:`choose_frames` and
    :func:`set_tile` do and rebuild :class:`BlockedArgs` on every call, so
    an artifact's kernel reads what the Python route's launch reads."""
    spec, align_idx, ref_x, params, activation = _F._extract_model(model)
    check_blocked_envelope(params, activation)
    lay = blocked_layout(spec, align_idx)
    cpu = torch.device("cpu")
    if isinstance(c_mat, str) and c_mat == "auto" or c_mat is None:
        pairs = (lay.pair_operand() if lay.coord_npairs
                 else np.zeros(0, np.int32))
    else:
        pairs = resolve_c_mat(lay, c_mat, cpu).numpy()
    ints, offsets, par = lay.device_tables(cpu)
    dims = (spec.out_dim, *(int(w.shape[0]) for w, _ in params))
    head = lay.device_head(dims, cpu)[1]
    pieces = [ints.numpy()[:-1], head]
    batches = [lay.feature_batches(g) for g in BATCH_GROUPS]
    pieces += [np.concatenate(pb) for pb in batches]
    flat_ints, offs = _F._aligned(pieces, 8)
    floats = param_block(lay, None if ref_x is None else ref_x.detach().cpu(),
                         tuple((w.detach().cpu(), b.detach().cpu())
                               for w, b in params), cpu).numpy()
    flat_floats, (coord_off, params_off) = _F._aligned(
        [par.numpy()[:-1], floats])
    meta = [BLOCKED_FORMAT, *(v for _, v in _sizes(lay, params, activation)),
            lay.n_atoms, dims[-1], int(lay.active_idx is not None),
            int(pair_heavy(lay)), int(pairs.size > 0), lay.pair_operand_size,
            *(offsets[t] for t in _INT_TABLES), offs[1],
            *(v for (ptr, _), o in zip(batches, offs[2:])
              for v in (o, len(ptr) - 1)),
            coord_off, params_off + 4,
            params_off + 4 + -(-3 * lay.n_align // 4) * 4]
    assert len(meta) == len(BLOCKED_META)
    return {"ints": torch.from_numpy(flat_ints),
            "floats": torch.from_numpy(flat_floats),
            "pairs": torch.from_numpy(np.ascontiguousarray(pairs, np.int32)),
            "meta": meta + [int(v) for v in head]}


def choose_frames(smem_bytes, l=None, backward=False, pairs=False):
    """Frames per block (a power of two) given ``smem_bytes(frames) ->
    bytes``: 32, 16 or 8 while four blocks fit on an SM, else the most that
    fit in one block's 227 KB; halved while a batch of ``l`` frames would
    leave most SMs without a block, so that a small batch spreads its atoms
    and features over more threads. ``backward``: the kernels that form a
    gradient (cv+forces, backward, train) keep per-atom accumulators, the
    pair gradients or a block's running sums beside the tile; where four
    blocks do not fit they take 32, 16 or 8 frames with two blocks on an SM
    before one block's 227 KB. ``pairs``: a model whose time is its pair
    walk (:func:`pair_heavy`) takes the largest of 32, 16 or 8 frames that
    leaves two blocks on an SM first: the walk's threads are (atom, frame)
    either way, and a larger tile spreads a tile's barriers and its serial
    sum over the atoms over more frames (the 125-atom contact model's train
    kernel: 2.35 ms per 65,536 frames at 32 frames against 2.58 at 16, its
    backward kernel 4.71 at 16 against 5.09 at 8, H100 80GB HBM3 at 700 W).
    (The tile sets the order of the sums: a frame's low bits may differ
    between batch sizes, never between two calls on the same batch.) Raises
    when one frame does not fit."""
    frames = None
    shares = ((_SMEM_QUARTER, _SMEM_HALF) if backward else (_SMEM_QUARTER,))
    for share in ((_SMEM_HALF,) + shares) if pairs else shares:
        for cand in (32, 16, 8):
            if frames is None and smem_bytes(cand) <= share:
                frames = cand
    if frames is None:
        for cand in (32, 16, 8, 4, 2, 1):
            if smem_bytes(cand) <= _SMEM_MAX:
                frames = cand
                break
    if frames is not None:
        while l is not None and frames > 1 and l < frames * _MIN_BLOCKS:
            frames //= 2
        return frames
    raise ValueError(
        f"one frame of this system needs {smem_bytes(1)} bytes of shared "
        f"memory in the blocked CUDA kernels, past the {_SMEM_MAX} a block "
        "has: too many active atoms or feature columns")


def pair_heavy(lay):
    """Whether the blocked kernels' time on this layout is its pair walk:
    more than eight pairs a staged atom."""
    return lay.n_pairs > 8 * lay.n_active


def _launch(kind, lay, ref_x, params, activation, x, tag, l, y, y_strides,
            gx, g_strides, component, pair_op, compact_out):
    """Launch one blocked kernel on the current stream and count it."""
    lib = _library()
    dev = x.device
    args, keep = blocked_args(lay, ref_x, params, activation, pair_op, dev,
                              compact_out=compact_out)
    forces = int(kind == "blocked_cv_forces")

    def smem_bytes(frames):
        args.frames, args.pitch = frames, frames | 1
        return lib.molann_blocked_smem_bytes(ctypes.addressof(args), forces)

    frames = choose_frames(smem_bytes, l, backward=bool(forces),
                           pairs=pair_heavy(lay))
    args.frames, args.pitch = frames, frames | 1
    keep += (set_tile(args, lay, frames, dev, lib.molann_blocked_threads(
        ctypes.addressof(args), forces)),)
    io = blocked_io(x, _strides(tag, lay.n_atoms, l), l, y, y_strides, gx,
                    g_strides, component)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = (lib.molann_blocked_cv_forces if forces
          else lib.molann_blocked_forward)
    rc = fn(ctypes.addressof(args), ctypes.addressof(io), dev.index, stream)
    del keep  # the caching allocator orders reuse on this stream
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} kernel launch failed: cudaError {rc}")
    _F.KERNEL_LAUNCHES[kind] += 1


def _launch_grads(kind, lay, ref_x, params, activation, x, tag, l, aux,
                  aux_strides, gx, g_strides, want_ref, inv_count, pair_op):
    """Launch the backward (``aux`` = gy) or train (``aux`` = y_target)
    kernel and its column-wise reduction on the current stream and count
    it. Returns ``out [1 + G]``: the loss (0 for the backward) and the flat
    gradients ``[ref_x | W0 | b0 ...]`` summed over the frames."""
    lib = _library()
    dev = x.device
    args, keep = blocked_args(lay, ref_x, params, activation, pair_op, dev)
    width = 1 + _F._grad_width(lay.align_idx if lay.has_align else None,
                               params)
    with_gx = 2 | int(gx is not None)  # molann_blocked_smem_bytes' kind

    def smem_bytes(frames, sums=None):
        args.frames, args.pitch = frames, frames | 1
        return lib.molann_blocked_smem_bytes(
            ctypes.addressof(args),
            with_gx | 4 * (acc_global if sums is None else sums))

    # where a block's running sums live (BLK_SUMS_* in blocked_math.cuh):
    # sums that would take more than half a block's shared memory stay in
    # the block's row of partials in device memory
    acc_global = SUMS_ROW if 4 * width > _SMEM_MAX // 2 else SUMS_SHARED
    frames = choose_frames(smem_bytes, l, backward=True,
                           pairs=pair_heavy(lay))
    if acc_global == SUMS_SHARED and smem_bytes(frames) > _SMEM_HALF:
        # one block on an SM: two, if they fit with the largest layer's
        # weight gradient in device memory
        fewer = choose_frames(lambda f: smem_bytes(f, SUMS_RECT), l,
                              backward=True)
        if smem_bytes(fewer, SUMS_RECT) <= _SMEM_HALF:
            acc_global, frames = SUMS_RECT, fewer
    args.frames, args.pitch = frames, frames | 1
    threads = lib.molann_blocked_threads(ctypes.addressof(args),
                                         with_gx | 4 * acc_global)
    keep += (set_tile(args, lay, frames, dev, threads),)
    rows = lib.molann_blocked_partial_rows(ctypes.addressof(args), l)
    partials = torch.empty(
        rows * (width + (RECT_FLOATS * threads
                         if acc_global == SUMS_RECT else 0)),
        dtype=torch.float32, device=dev)
    out = torch.empty(width, dtype=torch.float32, device=dev)
    io = blocked_grads_io(kind, x, _strides(tag, lay.n_atoms, l), l, aux,
                          aux_strides, gx, g_strides, want_ref, inv_count,
                          acc_global, partials)
    stream = torch.cuda.current_stream(dev).cuda_stream
    fn = (lib.molann_blocked_train if kind == "blocked_train"
          else lib.molann_blocked_backward)
    rc = fn(ctypes.addressof(args), ctypes.addressof(io), out.data_ptr(),
            dev.index, stream)
    del keep, partials  # the caching allocator orders reuse on this stream
    if rc != 0:
        raise RuntimeError(f"CUDA {kind} kernel launch failed: cudaError {rc}")
    _F.KERNEL_LAUNCHES[kind] += 1
    return out


def _prepare(spec, align_idx, params, activation, x, precision, c_mat,
             training=False):
    _F.resolve_precision(precision, training=training)
    check_blocked_envelope(params, activation)
    _F._check_device(x)
    lay = blocked_layout(spec, align_idx)
    tag, l = _classify(x, lay.n_atoms)
    pair_op = resolve_c_mat(lay, c_mat, x.device)
    if x.device.type == "cuda":
        _F._check_cuda_input(x)
    return lay, tag, l, pair_op


class _BlockedApply(torch.autograd.Function):
    """The blocked forward kernel with the blocked backward kernel as its
    VJP: the port of the ``blocked_apply`` custom VJP
    (``molann_tpu/ops/fused_blocked.py:1756-1797``). Inputs are the frames
    in their own layout, ``ref_x`` (or None) and each ``W_i``, ``b_i`` on
    its own, so that autograd reaches the ``nn.Parameter``s; gradients
    nobody asked for are not computed. The pair operand rides in
    ``statics`` and gets no gradient."""

    @staticmethod
    def forward(ctx, statics, x, ref_x, *flat):
        lay, activation, tag, l, pair_op = statics
        params = tuple(zip(flat[0::2], flat[1::2]))
        ctx.statics = statics
        ctx.save_for_backward(x, ref_x, *flat)
        return _kernel_forward(lay, ref_x, params, activation, x, tag, l,
                               pair_op)

    @staticmethod
    @_F.once_differentiable
    def backward(ctx, gy):
        lay, activation, tag, l, pair_op = ctx.statics
        x, ref_x, *flat = ctx.saved_tensors
        params = tuple(zip(flat[0::2], flat[1::2]))
        want_ref = lay.has_align and ctx.needs_input_grad[2]
        gx, gparams, g_ref = _kernel_backward(
            lay, ref_x, params, activation, x, tag, l, gy,
            ctx.needs_input_grad[1], want_ref, pair_op)
        if ctx.needs_input_grad[2] and not want_ref:
            g_ref = torch.zeros_like(ref_x)  # alignment that no feature reads
        return (None, gx, g_ref if ctx.needs_input_grad[2] else None,
                *(g for wb in gparams for g in wb))


def blocked_apply(spec, align_idx, activation, tiles, interpret, precision,
                  params, ref_x, x, c_mat=None):
    """The blocked fused forward: ``x`` in any layout :func:`_classify`
    takes ``→ [l, d_out]`` (final feature order when there is no MLP),
    differentiable with respect to x, the MLP parameters and ``ref_x``
    (``c_mat`` is a constant). The arguments come in the reference's
    positional order (``molann_tpu/ops/fused_blocked.py:1757``); ``tiles``
    (the TPU kernels' tile sizes, None or a tuple) and ``interpret`` (a
    bool) are checked and change nothing.

    On a CUDA tensor this launches the blocked forward kernel (K6);
    autograd then runs the blocked backward kernel (K7), which computes
    only the gradients asked for: gx (shaped like ``x``) only when ``x``
    requires grad, the ``ref_x`` gradient only when ``ref_x`` does. Under
    ``torch.no_grad()`` only K6 runs. On a CPU tensor it runs
    :func:`blocked_forward_plain`, which autograd differentiates."""
    _F.check_tile_args(tiles, interpret)
    lay, tag, l, pair_op = _prepare(spec, align_idx, params, activation, x,
                                    precision, c_mat)
    n = lay.n_atoms
    if x.device.type == "cpu":
        return blocked_forward_plain(spec, align_idx, ref_x, params,
                                     activation, _as_lnd(x, tag, n, l))
    return _BlockedApply.apply((lay, activation, tag, l, pair_op), x, ref_x,
                               *(t for wb in params for t in wb))


def _kernel_forward(lay, ref_x, params, activation, x, tag, l, pair_op):
    """Allocate ``y [l, d_out]`` and launch the forward kernel."""
    d_out = _F._out_dim(lay.spec, params)
    y = torch.empty((l, d_out), dtype=torch.float32, device=x.device)
    if l:
        _launch("blocked_forward", lay, ref_x, params, activation, x, tag, l,
                y, (d_out, 1), None, (0, 0, 0), None, pair_op, False)
    return y


def _kernel_backward(lay, ref_x, params, activation, x, tag, l, gy, want_gx,
                     want_ref, pair_op):
    """Allocate gx in the layout of ``x`` (when wanted) and launch the
    backward kernel. Returns ``(gx or None, gparams, g_ref or None)``."""
    n = lay.n_atoms
    d_out = _F._out_dim(lay.spec, params)
    gy = gy.to(torch.float32).contiguous()
    gx = None
    if want_gx:
        gx = (torch.empty if l else torch.zeros)(
            _g_shape(tag, n, l), dtype=torch.float32, device=x.device)
    align = lay.align_idx if lay.has_align else None
    if l == 0:
        out = torch.zeros(1 + _F._grad_width(align, params),
                          dtype=torch.float32, device=x.device)
    else:
        out = _launch_grads("blocked_backward", lay, ref_x, params,
                            activation, x, tag, l, gy, (d_out, 1), gx,
                            _strides(tag, n, l) if want_gx else (0, 0, 0),
                            want_ref, 0.0, pair_op)
    gparams, g_ref = _F._unpack_grads(out[1:], align, ref_x, params)
    return gx, gparams, g_ref if want_ref else None


def blocked_train_grads(spec, align_idx, activation, params, ref_x, x,
                        y_target, *, tile=None, interpret=False,
                        precision="exact", train_ref=False, c_mat=None):
    """The blocked single-kernel MSE training gradients: ``x`` in any layout
    :func:`_classify` takes, ``y_target`` ``[l, d_out]`` or ``[d_out, l]``.
    Returns ``(loss, gparams, g_ref)``: ``loss = mean((model(x) -
    y_target)**2)`` as a 0-d tensor, ``gparams`` as ``(gW [d_out, d_in], gb
    [d_out])`` per layer, ``g_ref`` shaped like ``ref_x`` (zeros unless
    ``train_ref``; None for a model without alignment). Needs an MLP head:
    a bare feature layer has nothing to train. ``c_mat`` is the pair
    operand of :func:`chunk_matrix`.

    On a CUDA tensor this launches the blocked train kernel (K5): no
    coordinate gradient, no feature adjoints and, with
    ``train_ref=False``, no QCP backward either. On a CPU tensor it runs
    :func:`blocked_train_grads_plain`. ``tile`` and ``interpret`` are
    accepted for the JAX signature and change nothing. ``precision`` is
    validated (``"auto"`` means ``"tf32"`` on a training path) and the
    kernel computes in f32 for every name, which is inside each mode's
    error budget (docs/design.md:296-300)."""
    if not params:
        raise ValueError("blocked_train_grads requires an MLP head")
    lay, tag, l, pair_op = _prepare(spec, align_idx, params, activation, x,
                                    precision, c_mat, training=True)
    n = lay.n_atoms
    d_out = _F._out_dim(spec, params)
    if tuple(y_target.shape) == (l, d_out):
        t_strides, yt = (d_out, 1), y_target
    elif tuple(y_target.shape) == (d_out, l):
        t_strides, yt = (1, l), y_target.T
    else:
        raise ValueError(f"y_target must be [{l}, {d_out}] or [{d_out}, "
                         f"{l}], got {list(y_target.shape)}")
    if l == 0:
        raise ValueError("blocked_train_grads needs at least one frame")
    if y_target.device != x.device:
        raise ValueError(f"y_target is on {y_target.device}, x on {x.device}")
    train_ref = bool(train_ref) and lay.has_align

    if x.device.type == "cpu":
        loss, gparams, g_ref = blocked_train_grads_plain(
            spec, align_idx, ref_x, params, activation,
            _as_lnd(x, tag, n, l), yt, train_ref)
    else:
        _F._check_cuda_input(y_target)
        loss, gparams, g_ref = _kernel_train(
            lay, ref_x, params, activation, x, tag, l, y_target, t_strides,
            train_ref, pair_op)
    if g_ref is None and ref_x is not None:
        g_ref = torch.zeros_like(ref_x)  # alignment that no feature reads
    return loss, gparams, g_ref


def _kernel_train(lay, ref_x, params, activation, x, tag, l, y_target,
                  t_strides, train_ref, pair_op):
    """Launch the train kernel on ``y_target`` with strides ``t_strides``
    of (frame, column). Returns ``(loss, gparams, g_ref or None)``."""
    d_out = _F._out_dim(lay.spec, params)
    out = _launch_grads("blocked_train", lay, ref_x, params, activation, x,
                        tag, l, y_target, t_strides, None, (0, 0, 0),
                        train_ref, 1.0 / (float(l) * float(d_out)), pair_op)
    gparams, g_ref = _F._unpack_grads(
        out[1:], lay.align_idx if lay.has_align else None, ref_x, params)
    return out[0], gparams, g_ref


def blocked_cv_forces(spec, align_idx, activation, params, ref_x, x, *,
                      component=None, tile=None, interpret=False,
                      out_layout=None, precision="exact",
                      compact_grads=False, c_mat=None):
    """CV values and their coordinate gradients in one kernel, blocked
    formulation.

    ``x``: ``[l, n, 3]``, ``[l, 3n]``, ``[3n, l]`` or ``[3, n, l]``.
    ``out_layout``: ``None`` follows the input (``(y [l, d], g`` shaped
    like ``x)`` for the frame-major inputs, ``(y [d, l], g [3n, l])`` for
    ``[3n, l]``, ``(y [d, l], g [3, n, l])`` for ``[3, n, l]``), or force
    ``"standard"``, ``"t"`` or ``"cmajor"``. ``component``: the output
    column to differentiate (None = their sum; negative values wrap).
    ``compact_grads``: the gradient on the active atoms only, ``[3,
    n_active, l]`` (row k = atom ``layout.active_idx[k]``; every atom when
    compaction is off); inactive atoms have exactly-zero gradients.
    ``c_mat``: the pair operand of :func:`chunk_matrix` on the device.

    On a CUDA tensor this launches the blocked cv+forces kernel (K8), which
    reads and writes every layout in place; on a CPU tensor it runs
    :func:`blocked_cv_forces_plain`. ``tile`` and ``interpret`` are
    accepted for the JAX signature, checked, and change nothing."""
    _F.check_tile_args(tile, interpret)
    lay, tag, l, pair_op = _prepare(spec, align_idx, params, activation, x,
                                    precision, c_mat)
    n = lay.n_atoms
    out_layout = _resolve_out_layout(out_layout, tag)
    d_out = _F._out_dim(spec, params)
    if component is not None:
        component = component % d_out
    y_t, g_tag, g_n = _output_plan(lay, tag, out_layout, compact_grads)

    if x.device.type == "cpu":
        y, g = blocked_cv_forces_plain(spec, align_idx, ref_x, params,
                                       activation, _as_lnd(x, tag, n, l),
                                       component)
        if compact_grads and lay.active_idx is not None:
            g = g[:, torch.from_numpy(lay.active_idx)]
        return ((y.T.contiguous() if y_t else y),
                _from_lnd(g, g_tag, g_n, l))

    return _kernel_cv_forces(lay, ref_x, params, activation, x, tag, l,
                             out_layout, component, compact_grads, pair_op)


def _output_plan(lay, tag, out_layout, compact_grads):
    """``(y is [d, l], layout tag of g, atoms in g)`` for a resolved
    ``out_layout``."""
    y_t = out_layout in ("t", "cmajor")
    if compact_grads:
        return y_t, "cmajor", lay.n_active
    if out_layout == "standard":
        return y_t, (tag if tag in ("lnd", "packed") else "lnd"), lay.n_atoms
    return y_t, out_layout, lay.n_atoms


def _kernel_cv_forces(lay, ref_x, params, activation, x, tag, l, out_layout,
                      component, compact_grads, pair_op):
    """Allocate ``y`` and ``gx`` in their final layouts and launch the
    cv+forces kernel, which writes them in place."""
    d_out = _F._out_dim(lay.spec, params)
    y_t, g_tag, g_n = _output_plan(lay, tag, out_layout, compact_grads)
    y = torch.empty((d_out, l) if y_t else (l, d_out), dtype=torch.float32,
                    device=x.device)
    gx = torch.empty(_g_shape(g_tag, g_n, l), dtype=torch.float32,
                     device=x.device)
    if l:
        _launch("blocked_cv_forces", lay, ref_x, params, activation, x, tag,
                l, y, (1, l) if y_t else (d_out, 1), gx,
                _strides(g_tag, g_n, l), component, pair_op, compact_grads)
    return y, gx
