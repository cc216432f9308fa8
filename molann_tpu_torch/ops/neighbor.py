"""Cutoff-culled coordination pairs via a host-side cell list.

Carried over from ``molann_tpu/ops/neighbor.py`` (numpy only), with
:func:`cull_model` rebuilt for the port's ``nn.Module`` models.

The all-pairs coordination table (:func:`molann_tpu_torch.spec.
coordination_pair_list`) is exact but O(N²): 15,500 pairs on the 125-atom
LJ fluid. The switching function ``s(r) = (1-(r/r0)^nn)/(1-(r/r0)^mm)``
decays like ``(r/r0)^(nn-mm)``, so pairs beyond a cutoff ``r_cut`` with
``s(r_cut) = tol`` contribute at most ``tol`` each; culling them bounds the
per-feature error by ``n_culled × tol`` (default ``tol = 1e-6``). A feature
with ``d_max`` is culled at ``d_max`` exactly: its culled pairs contribute
0.

Culling happens on the host against a reference frame with a Verlet skin:
every pair within ``r_cut + skin`` at the reference positions is kept, and
the kernels see a fixed pair table. As long as no atom moves more than
``skin/2`` from the reference frame, every culled pair is still beyond
``r_cut`` and the bound holds for every frame (:func:`max_displacement` is
the monitor; rebuild when it exceeds ``skin/2``).

Pair construction is an O(N) cell list (orthorhombic boxes and open
boundaries; triclinic cells fall back to an O(N²) distance filter, with
the same result).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

__all__ = [
    "switching_cutoff",
    "neighbor_pairs",
    "cull_spec",
    "cull_model",
    "max_displacement",
    "CullReport",
]


def switching_cutoff(r0, nn=6, mm=12, tol=1e-6, r_max_factor=1e3):
    """Smallest ``r_cut`` with ``s(r) <= tol`` for all ``r >= r_cut``,
    where ``s(r) = (1-(r/r0)^nn)/(1-(r/r0)^mm)`` (the PLUMED RATIONAL
    switching function used by coordination features). ``s`` is
    monotonically decreasing for ``r > 0`` with ``s(r0) = nn/mm`` (the
    removable singularity), decaying like ``(r/r0)^(nn-mm)``; solved by
    bisection to float64 precision."""
    r0 = float(r0)
    if r0 <= 0:
        raise ValueError("r0 must be positive")
    if not 0 < tol < 1:
        raise ValueError("tol must be in (0, 1)")

    def s(y):  # y = r / r0, y != 1
        return (1.0 - y**nn) / (1.0 - y**mm)

    lo, hi = 1.0 + 1e-9, float(r_max_factor)
    if s(hi) > tol:
        raise ValueError(f"switching never reaches tol={tol} below "
                         f"{r_max_factor}*r0")
    if s(lo) <= tol:  # already below at r0 (huge nn/mm ratio)
        return r0 * lo
    for _ in range(200):
        mid = 0.5 * (lo + hi)
        if s(mid) > tol:
            lo = mid
        else:
            hi = mid
    return r0 * hi


def _min_image(d, box):
    """Minimum-image displacement rows ``[m, 3]`` under a lower-
    triangular box (rows = lattice vectors), host-side numpy."""
    b = np.asarray(box, dtype=np.float64)
    for k in (2, 1, 0):  # GROMACS order: subtract c, then b, then a
        d -= np.round(d[:, k:k + 1] / b[k, k]) * b[k]
    return d


def neighbor_pairs(positions, a, b=(), r_cut=None, box=None):
    """Culled coordination pair list: the subset of
    :func:`~molann_tpu_torch.spec.coordination_pair_list`'s pairs whose
    (minimum-image) distance at ``positions`` is ``<= r_cut``.

    positions: ``[n, 3]`` reference coordinates of the INPUT group
    (pairs hold local indices into it, like the spec).
    a, b: local index lists — ``A x B`` pairs when ``b`` is non-empty,
    unordered within-``A`` pairs otherwise, exactly the all-pairs
    semantics. box: None, or a (lower-triangular) ``[3, 3]`` cell.

    Orthorhombic/open systems bin into a cell grid (O(N) build); a
    triclinic box or a grid too coarse to wrap cleanly falls back to
    the O(N²) distance filter (identical result — the grid is only a
    build-time accelerator). Returns pairs ordered by (position-in-a,
    position-in-partner-list): deterministic and orientation-identical
    to the all-pairs table, so a culled spec is bit-compatible with the
    kernels."""
    pos = np.asarray(positions, dtype=np.float64)
    a = [int(i) for i in a]
    b = [int(j) for j in b]
    if r_cut is None:
        raise ValueError("r_cut is required")
    r_cut = float(r_cut)

    diag_box = None
    if box is not None:
        bm = np.asarray(box, dtype=np.float64).reshape(3, 3)
        off = bm - np.diag(np.diag(bm))
        if not off.any():
            diag_box = np.diag(bm).copy()

    cand: set[tuple[int, int]] | None = None
    targets = b if b else a
    if (box is None or diag_box is not None):
        cand = _grid_candidates(pos, a, targets, r_cut, diag_box)
        # cand is None when the grid cannot wrap cleanly (tiny box)

    def dist_ok(i_arr, j_arr):
        d = pos[j_arr] - pos[i_arr]
        if box is not None:
            d = _min_image(d, box)
        return (d * d).sum(axis=1) <= r_cut * r_cut

    out = []
    if b:
        for i in a:
            js = [j for j in b if cand is None or (i, j) in cand]
            if not js:
                continue
            keep = dist_ok(np.full(len(js), i), np.asarray(js))
            out.extend((i, j) for j, k in zip(js, keep) if k)
    else:
        for pi in range(len(a)):
            i = a[pi]
            js = [a[pj] for pj in range(pi + 1, len(a))
                  if cand is None or (i, a[pj]) in cand
                  or (a[pj], i) in cand]
            if not js:
                continue
            keep = dist_ok(np.full(len(js), i), np.asarray(js))
            out.extend((i, j) for j, k in zip(js, keep) if k)
    return out


def _grid_candidates(pos, a, targets, r_cut, diag_box):
    """Candidate pair set from cell binning, or None when binning cannot
    apply (periodic box with fewer than 3 cells along an axis — the
    27-stencil would wrap onto itself and duplicate work; the caller
    falls back to the exact filter)."""
    if diag_box is not None:
        lengths = diag_box
        n_cells = np.floor(lengths / r_cut).astype(int)
        if (n_cells < 3).any():
            return None
        frac = (pos % lengths) / lengths
        cell_of = np.floor(frac * n_cells).astype(int) % n_cells
        wrap = True
    else:
        lo = pos.min(axis=0) - 1e-9
        span = np.maximum(pos.max(axis=0) - lo, 1e-9)
        n_cells = np.maximum(np.floor(span / r_cut).astype(int), 1)
        cell_of = np.minimum(
            np.floor((pos - lo) / span * n_cells).astype(int),
            n_cells - 1,
        )
        wrap = False

    buckets: dict[tuple[int, int, int], list[int]] = {}
    for j in targets:
        buckets.setdefault(tuple(cell_of[j]), []).append(j)

    cand = set()
    offsets = [(di, dj, dk) for di in (-1, 0, 1) for dj in (-1, 0, 1)
               for dk in (-1, 0, 1)]
    for i in a:
        ci = cell_of[i]
        for off in offsets:
            c = ci + off
            if wrap:
                c = c % n_cells
            elif ((c < 0) | (c >= n_cells)).any():
                continue
            for j in buckets.get(tuple(c), ()):
                cand.add((i, j))
    return cand


@dataclass(frozen=True)
class CullReport:
    """Per-coordination-feature culling diagnostics. ``exact[k]`` is
    True when the feature carries a ``d_max`` truncation — culled pairs
    contribute EXACTLY 0 there, so its error bound is 0 (not
    ``n_culled × tol``)."""

    n_pairs_before: tuple
    n_pairs_after: tuple
    r_cut: tuple          # culling radius per feature (without skin)
    skin: float
    tol: float
    exact: tuple = ()

    @property
    def error_bound(self):
        """Per-feature worst-case contact-count error while every atom
        stays within ``skin/2`` of the reference frame:
        ``n_culled × tol`` (0 for d_max-truncated features)."""
        exact = self.exact or (False,) * len(self.n_pairs_before)
        return tuple(0.0 if ex else (nb - na) * self.tol
                     for nb, na, ex in
                     zip(self.n_pairs_before, self.n_pairs_after, exact))

    def __str__(self):
        exact = self.exact or (False,) * len(self.n_pairs_before)
        feats = ", ".join(
            f"{nb}->{na} (rc={rc:.3g}{', exact' if ex else ''})"
            for nb, na, rc, ex in
            zip(self.n_pairs_before, self.n_pairs_after, self.r_cut,
                exact))
        return (f"CullReport[{feats}; skin={self.skin:g}, tol={self.tol:g},"
                f" bound={tuple(f'{e:.2g}' for e in self.error_bound)}]")


def cull_spec(spec, ref_positions, *, tol=1e-6, skin=1.0):
    """Rebuild a :class:`~molann_tpu_torch.spec.CompiledFeatures` with every
    coordination feature's pair table culled to ``r_cut(tol) + skin``
    at ``ref_positions`` (``[n_input_atoms, 3]``). Non-coordination
    features and output geometry are untouched. Returns
    ``(new_spec, CullReport)``.

    The result is a drop-in spec: same out_dim/columns, strictly fewer
    pairs — valid (within the report's error bound) while
    ``max_displacement(ref_positions, x) <= skin/2``."""
    if not spec.coord_slices:
        return spec, CullReport((), (), (), float(skin), float(tol), ())
    pos = np.asarray(ref_positions, dtype=np.float64)
    if pos.shape != (spec.n_input_atoms, 3):
        raise ValueError(
            f"ref_positions must be [{spec.n_input_atoms}, 3], got "
            f"{pos.shape}")
    pairs = np.asarray(spec.coord_pairs, dtype=np.int64).reshape(-1, 2)
    boxes = spec.coord_boxes or (None,) * len(spec.coord_slices)
    dmaxes = (getattr(spec, "coord_dmax", None)
              or (None,) * len(spec.coord_slices))

    new_pairs, new_slices = [], []
    before, after, rcs, exact = [], [], [], []
    for (start, npairs), (r0, nn, mm), box, dmax in zip(
            spec.coord_slices, spec.coord_params, boxes, dmaxes):
        if dmax is not None:
            # stretched-truncated switching is exactly 0 past d_max:
            # culling at d_max is exact, tol plays no role
            rc = float(dmax)
            exact.append(True)
        else:
            rc = switching_cutoff(r0, nn, mm, tol)
            exact.append(False)
        rcs.append(rc)
        sub = pairs[start:start + npairs]
        d = pos[sub[:, 1]] - pos[sub[:, 0]]
        if box is not None:
            d = _min_image(d, box)
        keep = (d * d).sum(axis=1) <= (rc + skin) ** 2
        kept = [tuple(int(v) for v in p) for p in sub[keep]]
        before.append(int(npairs))
        after.append(len(kept))
        new_slices.append((len(new_pairs), len(kept)))
        new_pairs.extend(kept)
    report = CullReport(tuple(before), tuple(after), tuple(rcs),
                        float(skin), float(tol), tuple(exact))
    return (
        replace(spec, coord_pairs=tuple(new_pairs),
                coord_slices=tuple(new_slices)),
        report,
    )


def max_displacement(ref_positions, x, box=None):
    """``max_i |x_i - ref_i|`` over a frame or batch ``[..., n, 3]`` —
    the rebuild monitor: a culled spec stays within its error bound
    while this is ``<= skin/2``. With a box, displacements are
    minimum-imaged first (atoms wrapping across the boundary are not
    real motion)."""
    x = np.asarray(x, dtype=np.float64)
    ref = np.asarray(ref_positions, dtype=np.float64)
    d = (x - ref).reshape(-1, 3)
    if box is not None:
        d = _min_image(d, box)
    return float(np.sqrt((d * d).sum(axis=1)).max())


def cull_model(model, ref_positions, *, tol=1e-6, skin=1.0):
    """A copy of a model (:class:`~molann_tpu_torch.models.ann.MolANN`,
    ``PreprocessingANN`` or ``FeatureLayer``) whose feature layer holds the
    culled spec of :func:`cull_spec`. Returns ``(new_model, CullReport)``.

    The new model is a deep copy (on the same device) with the culled spec
    in the place of its ``FeatureLayer._spec``; the caller's model is left
    as it is. The serving ops key their caches on the spec's identity, so
    the culled model gets its own kernel tables and blocked layout."""
    import copy

    from ..models.ann import FeatureLayer, MolANN, PreprocessingANN

    if isinstance(model, MolANN):
        fl = model.preprocessing_layer.feature_layer
    elif isinstance(model, PreprocessingANN):
        fl = model.feature_layer
    elif isinstance(model, FeatureLayer):
        fl = model
    else:
        raise TypeError(f"cannot cull {type(model).__name__}")
    spec, report = cull_spec(fl.spec, ref_positions, tol=tol, skin=skin)
    new = copy.deepcopy(model)
    if isinstance(new, MolANN):
        new.preprocessing_layer.feature_layer._spec = spec
    elif isinstance(new, PreprocessingANN):
        new.feature_layer._spec = spec
    else:
        new._spec = spec
    return new, report
