"""Feature-spec compiler: feature lists → static index arrays.

Carried over unchanged from ``molann_tpu/spec.py`` (pure Python): the port
compiles exactly the same :class:`CompiledFeatures` record, and the CUDA
kernels take its index tables as int32 device tensors.

The single most important architectural fact about the reference (SURVEY.md
§1): all shapes and gather indices are resolved at construction time into
Python ints. The TPU-native design makes that an explicit compile step —
a list of :class:`~molann_tpu_torch.feature.Feature` over an input atom group
compiles into a :class:`CompiledFeatures` record of *static* per-type index
tuples plus an output-column permutation. The forward pass is then a pure
function of ``(spec, x)`` with every gather index a trace-time constant,
which lets XLA unroll/fuse everything and lets the Pallas kernel bake the
indices in as immediates.

Output column order matches the reference exactly: features appear in
feature-list order (reference molann/ann.py:473), a dihedral with
``use_angle_value=False`` contributes ``[cos, sin]`` in that order
(molann/ann.py:351), and a position feature contributes row-major
``x,y,z``-interleaved coordinates (molann/ann.py:354). Internally features
are computed grouped by type (one vectorized gather+math per type instead of
the reference's per-feature Python loop — SURVEY.md §3.2 hot loop #1), then
a static column permutation restores feature-list order.
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CompiledFeatures", "resolve_local_indices", "compile_features",
           "coordination_pair_list"]


def coordination_pair_list(a, b):
    """The pair table of one coordination feature over local atom
    indices: ``A x B`` pairs when ``b`` is non-empty, otherwise all
    unordered pairs within ``A``. The single source of pair semantics —
    the per-FeatureMap eager path and the compiled-spec/fused path must
    agree exactly (the parity tests rely on it)."""
    if b:
        return [(i, j) for i in a for j in b]
    return [(a[i], a[j]) for i in range(len(a))
            for j in range(i + 1, len(a))]


def resolve_local_indices(atom_indices_0based, input_atom_indices):
    """Map global 0-based atom indices to positions within the input group.

    Uses first-occurrence semantics (``list.index``) and raises the same
    ValueError message as the reference (molann/ann.py:258-263).
    """
    input_list = [int(i) for i in input_atom_indices]
    try:
        return [input_list.index(int(idx)) for idx in atom_indices_0based]
    except ValueError:
        raise ValueError("Atoms used in feature must be among the input")


@dataclass(frozen=True)
class CompiledFeatures:
    """Static (hashable) compiled form of a feature list.

    All index fields are local indices into the input atom group. The
    intermediate, type-grouped layout is ``[angles | bonds |
    dihedrals(1 or 2 cols each) | coordinations | positions(3 per atom)]``
    and ``perm`` maps it back to feature-list column order (``None`` when the
    orders coincide).
    """

    n_input_atoms: int
    use_angle_value: bool
    out_dim: int
    angle_idx: tuple = ()      # ((a0, a1, a2), ...) — central atom second
    bond_idx: tuple = ()       # ((a0, a1), ...)
    dihedral_idx: tuple = ()   # ((a0, a1, a2, a3), ...)
    position_idx: tuple = ()   # flat (a, a, ...) over all position features
    perm: tuple | None = None  # output permutation or None (identity)
    feature_dims: tuple = ()   # per-feature output dims, feature-list order
    coord_pairs: tuple = ()    # ((i, j), ...) flat over coordination feats
    coord_slices: tuple = ()   # per coordination feature (start, n_pairs)
    coord_params: tuple = ()   # per coordination feature (r0, nn, mm)
    coord_boxes: tuple = ()    # per coordination feature: None or a static
    #                            lower-triangular 3x3 (tuple-of-tuples) for
    #                            minimum-image pair distances
    coord_dmax: tuple = ()     # per coordination feature: None, or the
    #                            stretch-truncation distance d_max (pairs
    #                            beyond it contribute exactly 0 — the
    #                            exact-culling radius for ops.neighbor)

    @property
    def n_angles(self):
        return len(self.angle_idx)

    @property
    def n_bonds(self):
        return len(self.bond_idx)

    @property
    def n_dihedrals(self):
        return len(self.dihedral_idx)

    @property
    def n_position_atoms(self):
        return len(self.position_idx)

    @property
    def n_coordinations(self):
        return len(self.coord_slices)


def _feature_dim(type_id: int, n_atoms: int, use_angle_value: bool) -> int:
    """Output dim of one feature (reference molann/ann.py:265-286;
    coordination is an extension, one scalar count per feature)."""
    if type_id in (0, 1, 4):  # angle, bond, coordination
        return 1
    if type_id == 2:  # dihedral
        return 1 if use_angle_value else 2
    return 3 * n_atoms  # position


def compile_features(feature_list, input_atom_indices, use_angle_value=False):
    """Compile features over an input group into a :class:`CompiledFeatures`.

    feature_list: sequence of :class:`~molann_tpu_torch.feature.Feature` (or any
    object with ``get_type_id()`` and ``get_atom_indices()`` → 1-based).
    input_atom_indices: global 0-based indices of the input atom group.
    """
    input_list = [int(i) for i in input_atom_indices]

    angle_idx, bond_idx, dihedral_idx, position_idx = [], [], [], []
    coord_pairs, coord_slices, coord_params, coord_boxes = [], [], [], []
    coord_dmax = []
    feature_dims = []
    # Per-feature (type_id, start) into the per-type intermediate blocks.
    placements = []

    for f in feature_list:
        type_id = f.get_type_id()
        local = resolve_local_indices(
            [int(i) - 1 for i in f.get_atom_indices()], input_list
        )
        dim = _feature_dim(type_id, len(local), use_angle_value)
        feature_dims.append(dim)
        if type_id == 0:
            placements.append((0, len(angle_idx) * 1, dim))
            angle_idx.append(tuple(local))
        elif type_id == 1:
            placements.append((1, len(bond_idx) * 1, dim))
            bond_idx.append(tuple(local))
        elif type_id == 2:
            width = 1 if use_angle_value else 2
            placements.append((2, len(dihedral_idx) * width, dim))
            dihedral_idx.append(tuple(local))
        elif type_id == 4:
            n_a, r0, nn, mm = f.get_coordination_params()
            a, b = local[:n_a], local[n_a:]
            pairs = coordination_pair_list(a, b)
            placements.append((4, len(coord_slices) * 1, dim))
            coord_slices.append((len(coord_pairs), len(pairs)))
            coord_pairs.extend(pairs)
            coord_params.append((float(r0), int(nn), int(mm)))
            coord_boxes.append(getattr(f, "pbc_box", None))
            dm = getattr(f, "d_max", None)
            coord_dmax.append(None if dm is None else float(dm))
        else:
            placements.append((3, len(position_idx) * 3, dim))
            position_idx.extend(local)

    na = len(angle_idx)
    nb = len(bond_idx)
    nd = len(dihedral_idx)
    nc = len(coord_slices)
    d_width = 1 if use_angle_value else 2
    block_offsets = {
        0: 0,
        1: na,
        2: na + nb,
        4: na + nb + nd * d_width,
        3: na + nb + nd * d_width + nc,
    }
    out_dim = na + nb + nd * d_width + nc + 3 * len(position_idx)

    perm = []
    for (type_id, start, dim) in placements:
        base = block_offsets[type_id] + start
        perm.extend(range(base, base + dim))
    perm_t = tuple(perm)
    if perm_t == tuple(range(out_dim)):
        perm_t = None

    return CompiledFeatures(
        n_input_atoms=len(input_list),
        use_angle_value=bool(use_angle_value),
        out_dim=out_dim,
        angle_idx=tuple(angle_idx),
        bond_idx=tuple(bond_idx),
        dihedral_idx=tuple(dihedral_idx),
        position_idx=tuple(position_idx),
        perm=perm_t,
        feature_dims=tuple(feature_dims),
        coord_pairs=tuple(coord_pairs),
        coord_slices=tuple(coord_slices),
        coord_params=tuple(coord_params),
        coord_boxes=tuple(coord_boxes),
        coord_dmax=tuple(coord_dmax),
    )
