"""Periodic-boundary utilities: wrap, minimum image, and making molecules
whole.

The port of ``molann_tpu/pbc.py``. Wrapped trajectories (GROMACS XTC/TRR,
CHARMM DCD, Amber NetCDF) come out of the codecs with per-frame box
matrices; these functions repair them before feature extraction:

- :func:`minimum_image` / :func:`wrap`: the triclinic lattice reductions,
  as torch functions on tensors;
- :func:`guess_bonds` / :func:`bond_tree_levels`: covalent bonds from the
  topology's reference coordinates and their BFS spanning forest (numpy,
  carried over);
- :func:`make_whole`: every atom at the minimum image of its bond-tree
  parent, one batched update per tree depth (``trjconv -pbc whole``);
- :func:`unwrap_time`: each frame moved to the image nearest the previous,
  already unwrapped frame (``trjconv -pbc nojump``), a loop over frames in
  the reference's order of operations;
- :func:`dcd_cell_to_box` / :func:`box_to_dcd_cell`: CHARMM unit-cell
  records to and from box matrices (numpy, carried over).

The torch functions compute on the device of the tensor they are given;
for numpy or list inputs, on ``device`` (``None`` means the card, and an
error where there is none, as the port's other entry points).

Box convention: GROMACS row matrices, ``box[i]`` the i-th lattice vector,
lower-triangular, the layout the XTC/TRR codecs return. The row-by-row
reduction is GROMACS's nearest-image scheme: exact for orthorhombic cells
and for any displacement shorter than half the inscribed-sphere diameter of
a reduced triclinic cell.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device

__all__ = [
    "wrap",
    "minimum_image",
    "unwrap_time",
    "guess_bonds",
    "bond_tree_levels",
    "make_whole",
    "dcd_cell_to_box",
    "box_to_dcd_cell",
]

# Covalent radii (Angstrom), Cordero et al., Dalton Trans. 2008 — the
# standard table (same source MDAnalysis uses for bond guessing).
_COVALENT_RADII = {
    "H": 0.31, "HE": 0.28, "LI": 1.28, "BE": 0.96, "B": 0.84, "C": 0.76,
    "N": 0.71, "O": 0.66, "F": 0.57, "NE": 0.58, "NA": 1.66, "MG": 1.41,
    "AL": 1.21, "SI": 1.11, "P": 1.07, "S": 1.05, "CL": 1.02, "AR": 1.06,
    "K": 2.03, "CA": 1.76, "MN": 1.39, "FE": 1.32, "CO": 1.26, "NI": 1.24,
    "CU": 1.32, "ZN": 1.22, "BR": 1.20, "I": 1.39,
}


def _device_of(device, *args):
    """The device of the first tensor among ``args``, else ``device``
    resolved by the port's rule."""
    for a in args:
        if isinstance(a, torch.Tensor):
            return a.device
    return resolve_device(device)


def _as_f32(a, dev):
    if not isinstance(a, torch.Tensor):
        a = np.array(a, np.float32)  # a writable copy: torch takes those
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def _check_box_arg(box, dev):
    box = _as_f32(box, dev)
    if box.shape[-2:] != (3, 3):
        raise ValueError(f"box must be [..., 3, 3], got {tuple(box.shape)}")
    return box


def _rows_diag(x, box):
    """The lattice rows and diagonal of ``box``, shaped to broadcast over
    ``x [..., 3]`` (``[l, ..., 3]`` for per-frame boxes)."""
    if box.ndim == 3:  # per-frame boxes: broadcast over mid axes of x
        mid = x.ndim - 2
        if mid < 0 or x.shape[0] != box.shape[0]:
            raise ValueError(
                f"per-frame boxes {tuple(box.shape)} need x [l, ..., 3], "
                f"got {tuple(x.shape)}")
        bshape = (box.shape[0],) + (1,) * mid + (3,)
        rows = [box[:, i].reshape(bshape) for i in range(3)]
        diag = [box[:, i, i].reshape(bshape[:-1]) for i in range(3)]
    else:
        rows = [box[i] for i in range(3)]
        diag = [box[i, i] for i in range(3)]
    return rows, diag


def minimum_image(dx, box, *, device=None):
    """Nearest-image displacement(s) under a (possibly triclinic) box.

    dx: ``[..., 3]`` displacement vectors. box: ``[3, 3]`` lattice
    row-matrix, or ``[l, 3, 3]`` with ``dx = [l, ..., 3]`` for per-frame
    boxes. Returns the reduced displacements, a float32 tensor shaped as
    ``dx``.

    Example:
        >>> import torch
        >>> box = torch.diag(torch.tensor([10.0, 10.0, 10.0]))
        >>> minimum_image(torch.tensor([9.0, 0.2, -9.5]), box).tolist()
        [-1.0, 0.20000000298023224, 0.5]
    """
    dev = _device_of(device, dx, box)
    dx = _as_f32(dx, dev)
    box = _check_box_arg(box, dev)
    rows, diag = _rows_diag(dx, box)
    # row-by-row reduction, c then b then a: each row only has components
    # on its own and earlier axes (lower-triangular), so later axes are
    # finalized first; torch.round, like jnp.round, rounds half to even
    for i in (2, 1, 0):
        shift = torch.round(dx[..., i] / diag[i])
        dx = dx - shift[..., None] * rows[i]
    return dx


def wrap(x, box, *, device=None):
    """Wrap coordinates into the primary cell.

    x: ``[..., 3]``; box: ``[3, 3]`` or ``[l, 3, 3]`` (with
    ``x = [l, ..., 3]``), lower-triangular. Row-by-row floor reduction into
    the GROMACS brick cell (every Cartesian component lands in
    ``[0, box[i][i])``), with the lattice shifts as exact float32 multiples
    and no matrix product.

    Example:
        >>> import torch
        >>> box = torch.diag(torch.tensor([4.0, 5.0, 6.0]))
        >>> wrap(torch.tensor([-1.0, 5.5, 17.0]), box).tolist()
        [3.0, 0.5, 5.0]
    """
    dev = _device_of(device, x, box)
    x = _as_f32(x, dev)
    box = _check_box_arg(box, dev)
    rows, diag = _rows_diag(x, box)
    for i in (2, 1, 0):
        shift = torch.floor(x[..., i] / diag[i])
        x = x - shift[..., None] * rows[i]
    return x


def unwrap_time(frames, box, *, device=None):
    """Temporal continuity unwrap (``trjconv -pbc nojump``).

    Each frame's atoms are moved to the periodic image nearest their own
    position in the previous (already unwrapped) frame: frame t becomes
    ``prev + minimum_image(x_t - prev)``, in that order, one frame after
    another as the reference's ``lax.scan`` does. Frame 0 is kept as it
    is. Valid while no atom moves more than half a box between frames.

    frames: ``[l, n, 3]``; box: ``[3, 3]`` or ``[l, 3, 3]``. Returns
    ``[l, n, 3]`` float32.
    """
    dev = _device_of(device, frames, box)
    frames = _as_f32(frames, dev)
    if frames.ndim != 3:
        raise ValueError(f"frames must be [l, n, 3], got "
                         f"{tuple(frames.shape)}")
    box = _check_box_arg(box, dev)
    boxes = (box.expand(frames.shape[0], 3, 3) if box.ndim == 2 else box)
    if boxes.shape[0] != frames.shape[0]:
        raise ValueError(
            f"{boxes.shape[0]} boxes for {frames.shape[0]} frames")
    out = torch.empty_like(frames)
    if frames.shape[0] == 0:
        return out
    prev = out[0] = frames[0]
    for t in range(1, frames.shape[0]):
        prev = prev + minimum_image(frames[t] - prev, boxes[t])
        out[t] = prev
    return out


def _radii_for(universe):
    from .topology import guess_atom_type

    radii = []
    for atom in universe.atoms:
        t = getattr(atom, "type", "") or guess_atom_type(
            getattr(atom, "name", ""))
        radii.append(_COVALENT_RADII.get(str(t).upper(), 0.0))
    return np.asarray(radii, np.float64)


def guess_bonds(universe, *, tolerance=0.45):
    """Covalent bonds from the topology's reference coordinates.

    Two atoms are bonded when their reference distance is below
    ``r_cov(i) + r_cov(j) + tolerance`` (Angstrom; Cordero covalent
    radii). The PDB's coordinates must be whole. Unknown elements get
    radius 0 and only bond within ``tolerance``. Returns ``[n_bonds, 2]``
    0-based int64 pairs (i < j), lexicographic.

    Example (alanine dipeptide has 21 covalent bonds):
        >>> from molann_tpu_torch.systems import alanine_universe
        >>> len(guess_bonds(alanine_universe()))
        21
    """
    pos = np.asarray(universe.atoms.positions, np.float64)
    radii = _radii_for(universe)
    d = np.linalg.norm(pos[:, None] - pos[None, :], axis=-1)
    cut = radii[:, None] + radii[None, :] + float(tolerance)
    adj = (d < cut) & (d > 1e-3)
    i, j = np.nonzero(np.triu(adj, 1))
    return np.stack([i, j], axis=1).astype(np.int64)


def bond_tree_levels(n_atoms, bonds):
    """BFS spanning forest of the bond graph as depth levels.

    Returns a list of ``(children [k], parents [k])`` int64 arrays: level
    ``d`` holds every atom first reached at BFS depth ``d+1`` together with
    the atom it was reached from. Applying levels in order visits each atom
    after its parent, the schedule :func:`make_whole` follows. Isolated
    atoms appear in no level and are left where they are.
    """
    bonds = np.asarray(bonds, np.int64).reshape(-1, 2)
    if bonds.size and (bonds.min() < 0 or bonds.max() >= n_atoms):
        raise ValueError(f"bond indices outside [0, {n_atoms})")
    neigh = [[] for _ in range(n_atoms)]
    for a, b in bonds:
        neigh[int(a)].append(int(b))
        neigh[int(b)].append(int(a))
    seen = np.zeros(n_atoms, bool)
    levels = []
    for root in range(n_atoms):
        if seen[root]:
            continue
        seen[root] = True
        frontier = [root]
        depth = 0
        while frontier:
            nxt, parents = [], []
            for p in frontier:
                for c in neigh[p]:
                    if not seen[c]:
                        seen[c] = True
                        nxt.append(c)
                        parents.append(p)
            if nxt:
                if len(levels) <= depth:
                    levels.append(([], []))
                levels[depth][0].extend(nxt)
                levels[depth][1].extend(parents)
            frontier = nxt
            depth += 1
    return [(np.asarray(c, np.int64), np.asarray(p, np.int64))
            for c, p in levels]


def make_whole(frames, box, *, bonds=None, universe=None, levels=None,
               device=None):
    """Reassemble molecules broken across the periodic boundary
    (``trjconv -pbc whole``).

    Every atom is placed at the minimum image relative to its parent in a
    BFS spanning tree of the bond graph, one batched minimum-image update
    per tree depth. Connectivity comes as ``bonds [nb, 2]``, a ``universe``
    (bonds guessed by :func:`guess_bonds`) or precomputed ``levels``
    (:func:`bond_tree_levels`, the cheapest when called repeatedly).

    frames: ``[l, n, 3]`` or ``[n, 3]``; box: ``[3, 3]`` or ``[l, 3, 3]``.
    Returns the repaired coordinates, a float32 tensor of the same shape.
    """
    dev = _device_of(device, frames, box)
    x = _as_f32(frames, dev)
    single = x.ndim == 2
    if single:
        x = x[None]
    if x.ndim != 3:
        raise ValueError(f"frames must be [l, n, 3], got {tuple(x.shape)}")
    if levels is None:
        if bonds is None:
            if universe is None:
                raise ValueError(
                    "make_whole needs bonds=, universe=, or levels=")
            bonds = guess_bonds(universe)
        levels = bond_tree_levels(x.shape[1], bonds)
    box = _check_box_arg(box, dev)
    x = x.clone()
    for children, parents in levels:
        c = torch.as_tensor(children, device=dev)
        p = torch.as_tensor(parents, device=dev)
        dx = minimum_image(x[:, c] - x[:, p], box)
        x[:, c] = x[:, p] + dx
    return x[0] if single else x


def dcd_cell_to_box(cell):
    """CHARMM DCD unit-cell records -> GROMACS-style lower-triangular
    box matrices.

    cell: ``[l, 6]`` (or ``[6]``) records as stored in DCD frames:
    ``(A, gamma', B, beta', alpha', C)`` where the angle slots hold
    either cosines (CHARMM >= c24, values in [-1, 1]) or degrees —
    auto-detected per record, like MDAnalysis. Returns ``[l, 3, 3]``
    (or ``[3, 3]``) float32 box matrices.
    """
    cell = np.asarray(cell, np.float64)
    single = cell.ndim == 1
    cells = cell[None] if single else cell
    if cells.ndim != 2 or cells.shape[1] != 6:
        raise ValueError(f"cell must be [l, 6], got {cell.shape}")
    a, g_, b, b_, a_, c = (cells[:, i] for i in range(6))
    angles = np.stack([a_, b_, g_], axis=1)  # alpha, beta, gamma
    is_cos = (np.abs(angles) <= 1.0).all(axis=1)
    rad = np.where(is_cos[:, None], np.arccos(np.clip(angles, -1, 1)),
                   np.deg2rad(angles))
    ca, cb, cg = np.cos(rad[:, 0]), np.cos(rad[:, 1]), np.cos(rad[:, 2])
    sg = np.sin(rad[:, 2])
    out = np.zeros((cells.shape[0], 3, 3))
    out[:, 0, 0] = a
    out[:, 1, 0] = b * cg
    out[:, 1, 1] = b * sg
    out[:, 2, 0] = c * cb
    cy = (ca - cb * cg) / np.where(sg == 0, 1.0, sg)
    out[:, 2, 1] = c * cy
    out[:, 2, 2] = c * np.sqrt(np.maximum(1.0 - cb**2 - cy**2, 0.0))
    out = out.astype(np.float32)
    return out[0] if single else out


def box_to_dcd_cell(box):
    """GROMACS-style lower-triangular box matrices -> CHARMM DCD
    unit-cell records (inverse of :func:`dcd_cell_to_box`).

    box: ``[l, 3, 3]`` (or ``[3, 3]``) lower-triangular matrices.
    Returns ``[l, 6]`` (or ``[6]``) float64 records in the on-disk
    order ``(A, gamma', B, beta', alpha', C)`` with the angle slots
    holding cosines (the CHARMM >= c24 convention
    :func:`dcd_cell_to_box` auto-detects).
    """
    box = np.asarray(box, np.float64)
    single = box.ndim == 2
    boxes = box[None] if single else box
    if boxes.ndim != 3 or boxes.shape[1:] != (3, 3):
        raise ValueError(f"box must be [l, 3, 3], got {box.shape}")
    a = np.linalg.norm(boxes[:, 0], axis=1)
    b = np.linalg.norm(boxes[:, 1], axis=1)
    c = np.linalg.norm(boxes[:, 2], axis=1)

    def safe(v):  # a zero box gives cos = 0, the "no cell" record
        return np.where(v == 0, 1.0, v)

    cg = np.einsum("li,li->l", boxes[:, 0], boxes[:, 1]) / safe(a * b)
    cb = np.einsum("li,li->l", boxes[:, 0], boxes[:, 2]) / safe(a * c)
    ca = np.einsum("li,li->l", boxes[:, 1], boxes[:, 2]) / safe(b * c)
    out = np.stack([a, cg, b, cb, ca, c], axis=1)
    return out[0] if single else out
