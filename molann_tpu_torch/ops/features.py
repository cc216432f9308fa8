"""Molecular feature math in PyTorch (the port of ``molann_tpu/ops/features.py``).

Same formulas and quirks as the JAX package (reference molann/ann.py:288-356):

- bond (type 1):      ``‖x[a1] - x[a0]‖₂``
- angle (type 0):     ``cosθ = (r21·r23)/(‖r21‖‖r23‖)`` with
  ``r21 = x[a0]-x[a1]``, ``r23 = x[a2]-x[a1]``; ``use_angle_value=True`` →
  ``acos``, deliberately UNclamped (``|cos| > 1`` from roundoff gives NaN).
- dihedral (type 2):  ``n1 = r12×r23``, ``n2 = r23×r34``, ``cos̃ = n1·n2``,
  ``siñ = (n1·r34)‖r23‖``, ``ρ = √(cos̃²+siñ²)``; ``use_angle_value=True`` →
  ``atan2(siñ, cos̃)``, else ``[cos̃/ρ, siñ/ρ]`` in that column order (NaN at
  a degenerate dihedral, where ``ρ = 0``).
- position (type 3):  row-major gather → ``[l, 3n]`` (x,y,z per atom).
- coordination (type 4): PLUMED rational switching sums (an extension).

Every function takes the whole batch ``x [l, n, 3]`` and a static index
table and runs one vectorised gather + math chain per feature type. An
index table may be given as a long tensor on ``x``'s device
(:func:`_spec_tables`), which is then used as it is: a table given as a
tuple is copied to the device at every call, and on the card such a copy
makes the host wait.
"""

from __future__ import annotations

import torch

from ..spec import CompiledFeatures

__all__ = [
    "bond_features",
    "angle_features",
    "dihedral_features",
    "position_features",
    "switching_function",
    "coordination_features",
    "apply_compiled_features",
]


def _gather(x, idx_2d):
    """x: [l, n, 3]; idx_2d: static [m, k] → [l, m, k, 3]."""
    idx = torch.as_tensor(idx_2d, dtype=torch.long, device=x.device)
    return x[:, idx, :]


def _norm(v):
    # sqrt(v·v), as jnp.linalg.norm: its gradient at v = 0 is NaN there too
    return torch.sqrt(torch.sum(v * v, dim=-1))


def bond_features(x, bond_idx):
    """[l, n, 3] × static [nb, 2] → [l, nb] bond lengths."""
    g = _gather(x, bond_idx)
    return _norm(g[:, :, 1, :] - g[:, :, 0, :])


def angle_features(x, angle_idx, use_angle_value: bool):
    """[l, n, 3] × static [na, 3] → [l, na] cosθ or θ (unclamped acos)."""
    g = _gather(x, angle_idx)
    r21 = g[:, :, 0, :] - g[:, :, 1, :]
    r23 = g[:, :, 2, :] - g[:, :, 1, :]
    cos_angle = torch.sum(r21 * r23, dim=-1) / (_norm(r21) * _norm(r23))
    if use_angle_value:
        return torch.acos(cos_angle)
    return cos_angle


def dihedral_features(x, dihedral_idx, use_angle_value: bool):
    """[l, n, 3] × static [nd, 4] → [l, nd] φ or [l, nd, 2] [cosφ, sinφ]."""
    g = _gather(x, dihedral_idx)
    r12 = g[:, :, 1, :] - g[:, :, 0, :]
    r23 = g[:, :, 2, :] - g[:, :, 1, :]
    r34 = g[:, :, 3, :] - g[:, :, 2, :]
    n1 = torch.linalg.cross(r12, r23)
    n2 = torch.linalg.cross(r23, r34)
    cos_phi = torch.sum(n1 * n2, dim=-1)
    sin_phi = torch.sum(n1 * r34, dim=-1) * _norm(r23)
    if use_angle_value:
        return torch.atan2(sin_phi, cos_phi)
    radius = torch.sqrt(cos_phi * cos_phi + sin_phi * sin_phi)
    return torch.stack([cos_phi / radius, sin_phi / radius], dim=-1)


def position_features(x, position_idx):
    """[l, n, 3] × static flat [m] → [l, 3m] row-major (x,y,z per atom)."""
    idx = torch.as_tensor(position_idx, dtype=torch.long, device=x.device)
    return x[:, idx, :].reshape(x.shape[0], 3 * len(position_idx))


def geometric_sum(t, k):
    """``1 + t + ... + t^(k-1)`` by Horner (k-1 multiply-adds)."""
    acc = t * 0.0 + 1.0
    for _ in range(int(k) - 1):
        acc = 1.0 + t * acc
    return acc


def _ipow(t, k):
    """``t**k`` for a static positive int exponent by repeated squaring
    (exact at ``t == 0``, unlike ``exp(k log t)``)."""
    k = int(k)
    if k < 1:
        raise ValueError(f"_ipow requires a positive exponent, got {k}")
    acc = None
    sq = t
    while k:
        if k & 1:
            acc = sq if acc is None else acc * sq
        k >>= 1
        if k:
            sq = sq * sq
    return acc


def switching_function(r, r0, nn, mm, d_max=None):
    """PLUMED rational switching ``(1-(r/r0)^nn)/(1-(r/r0)^mm)``.

    ``mm == 2*nn`` uses the identical ``1/(1+(r/r0)^nn)``; other exponents
    use the well-conditioned geometric-sum quotient
    ``(sum_{k<nn} t^k) / (sum_{k<mm} t^k)``. ``d_max`` applies PLUMED's
    stretch-and-truncate: ``(s(r) - s(d_max)) / (1 - s(d_max))`` below
    ``d_max`` and exactly 0 beyond (see ``molann_tpu/ops/features.py``).
    """
    nn, mm = int(nn), int(mm)
    if nn < 1 or mm < 1:
        raise ValueError(
            f"switching_function exponents must be positive ints, got "
            f"nn={nn}, mm={mm}")
    t = r / r0

    def raw(tt):
        if mm == 2 * nn:
            return 1.0 / (1.0 + _ipow(tt, nn))
        return geometric_sum(tt, nn) / geometric_sum(tt, mm)

    if d_max is None:
        return raw(t)
    d_max = float(d_max)
    if d_max <= r0:
        raise ValueError(f"d_max must exceed r0, got d_max={d_max}, "
                         f"r0={r0}")
    y = d_max / float(r0)
    s_dmax = (1.0 - y**nn) / (1.0 - y**mm)
    stretch = 1.0 / (1.0 - s_dmax)
    return torch.where(r < d_max, (raw(t) - s_dmax) * stretch,
                       torch.zeros_like(r))


def min_image_components(d, box):
    """Minimum image of displacements given as a 3-sequence of same-shape
    tensors under a static lower-triangular box (tuple of tuples)."""
    d = list(d)
    for i in (2, 1, 0):
        shift = torch.round(d[i] * (1.0 / box[i][i]))
        for j in range(3):
            if box[i][j] != 0.0:
                d[j] = d[j] - shift * box[i][j]
    return tuple(d)


def coordination_features(x, coord_pairs, coord_slices, coord_params,
                          coord_boxes=None, coord_dmax=None):
    """[l, n, 3] × static pair table → [l, nc] switching-function contact
    counts, one column per coordination feature (minimum image where a
    feature carries a box, exact truncation where it carries ``d_max``)."""
    outs = []
    pairs = torch.as_tensor(coord_pairs, dtype=torch.long,
                            device=x.device).reshape(-1, 2)
    if coord_boxes is None:
        coord_boxes = (None,) * len(coord_slices)
    if coord_dmax is None:
        coord_dmax = (None,) * len(coord_slices)
    for (start, npairs), (r0, nn, mm), box, dmax in zip(
        coord_slices, coord_params, coord_boxes, coord_dmax
    ):
        g = _gather(x, pairs[start:start + npairs])
        d = g[:, :, 1, :] - g[:, :, 0, :]
        if box is not None:
            d = torch.stack(
                min_image_components(tuple(d[..., i] for i in range(3)), box),
                dim=-1)
        outs.append(torch.sum(switching_function(_norm(d), r0, nn, mm, dmax),
                              dim=1))
    return torch.stack(outs, dim=1)


_TABLES = ("angle_idx", "bond_idx", "dihedral_idx", "position_idx",
           "coord_pairs", "perm")


def _spec_tables(spec: CompiledFeatures, device):
    """A compiled spec's index tables as long tensors on ``device``, keyed
    by field name (those the spec has), for :func:`_apply_compiled` to
    gather with and no copy."""
    return {name: torch.as_tensor(getattr(spec, name), dtype=torch.long,
                                  device=device)
            for name in _TABLES if getattr(spec, name)}


def apply_compiled_features(spec: CompiledFeatures, x):
    """Evaluate all features of a compiled spec: ``[l, n, 3] → [l, d]``
    (type-grouped blocks, then the static column permutation)."""
    return _apply_compiled(spec, x, {name: getattr(spec, name)
                                     for name in _TABLES})


def _apply_compiled(spec: CompiledFeatures, x, t):
    """:func:`apply_compiled_features` with the index tables ``t`` by field
    name: the spec's tuples, or :func:`_spec_tables` on ``x``'s device."""
    l = x.shape[0]
    parts = []
    if spec.n_angles:
        parts.append(angle_features(x, t["angle_idx"], spec.use_angle_value))
    if spec.n_bonds:
        parts.append(bond_features(x, t["bond_idx"]))
    if spec.n_dihedrals:
        d = dihedral_features(x, t["dihedral_idx"], spec.use_angle_value)
        if not spec.use_angle_value:
            d = d.reshape(l, 2 * spec.n_dihedrals)
        parts.append(d)
    if spec.n_coordinations:
        parts.append(coordination_features(
            x, t["coord_pairs"], spec.coord_slices, spec.coord_params,
            spec.coord_boxes or None, spec.coord_dmax or None))
    if spec.n_position_atoms:
        parts.append(position_features(x, t["position_idx"]))
    if not parts:
        return x.new_zeros((l, 0))
    feats = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    if spec.perm is not None:
        feats = feats[:, torch.as_tensor(t["perm"], dtype=torch.long,
                                         device=x.device)]
    return feats
