"""Built-in alanine-dipeptide system for the port.

The 22-atom ACE-ALA-NME structure (vacuum, idealised geometry) and the
flagship model built on it — the port of the alanine part of
``molann_tpu/systems.py`` (:65-105, :278-296). The synthetic peptide and
Lennard-Jones fluid systems are still to be ported (ROADMAP.md).
"""

from __future__ import annotations

from .ann import (
    AlignmentLayer,
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
)
from .feature import Feature
from .topology import Universe

__all__ = [
    "ALANINE_ATOMS",
    "alanine_universe",
    "alanine_pdb_text",
    "alanine_histogram_features",
    "alanine_model",
]

# (name, resname, resid, x, y, z)
ALANINE_ATOMS = [
    ("1HH3", "ACE", 1, 2.000, 1.000, -0.000),
    ("CH3", "ACE", 1, 2.000, 2.090, 0.000),
    ("2HH3", "ACE", 1, 1.486, 2.454, 0.890),
    ("3HH3", "ACE", 1, 1.486, 2.454, -0.890),
    ("C", "ACE", 1, 3.427, 2.641, -0.000),
    ("O", "ACE", 1, 4.391, 1.877, -0.000),
    ("N", "ALA", 2, 3.555, 3.970, -0.000),
    ("H", "ALA", 2, 2.733, 4.556, -0.000),
    ("CA", "ALA", 2, 4.853, 4.614, -0.000),
    ("HA", "ALA", 2, 5.408, 4.316, 0.890),
    ("CB", "ALA", 2, 5.661, 4.221, -1.232),
    ("1HB", "ALA", 2, 5.123, 4.521, -2.131),
    ("2HB", "ALA", 2, 6.630, 4.719, -1.206),
    ("3HB", "ALA", 2, 5.809, 3.141, -1.241),
    ("C", "ALA", 2, 4.713, 6.129, 0.000),
    ("O", "ALA", 2, 3.601, 6.653, 0.000),
    ("N", "NME", 3, 5.846, 6.835, 0.000),
    ("H", "NME", 3, 6.737, 6.359, -0.000),
    ("CH3", "NME", 3, 5.846, 8.284, 0.000),
    ("1HH3", "NME", 3, 4.819, 8.648, 0.000),
    ("2HH3", "NME", 3, 6.360, 8.648, 0.890),
    ("3HH3", "NME", 3, 6.360, 8.648, -0.890),
]


def alanine_universe() -> Universe:
    """Universe for the embedded alanine-dipeptide structure."""
    return Universe.from_arrays(
        [[a[3], a[4], a[5]] for a in ALANINE_ATOMS],
        names=[a[0] for a in ALANINE_ATOMS],
        resnames=[a[1] for a in ALANINE_ATOMS],
        resids=[a[2] for a in ALANINE_ATOMS],
    )


def alanine_pdb_text() -> str:
    """The structure rendered as standard PDB ATOM records."""
    lines = ["REMARK  alanine dipeptide (vacuum)"]
    for i, (name, resname, resid, x, y, z) in enumerate(ALANINE_ATOMS, start=1):
        name_field = name if len(name) == 4 else f" {name:<3s}"
        lines.append(
            f"ATOM  {i:5d} {name_field:<4s} {resname:<3s}  {resid:4d}    "
            f"{x:8.3f}{y:8.3f}{z:8.3f}"
        )
    lines.extend(["TER", "END"])
    return "\n".join(lines) + "\n"


def _ordered_group(u: Universe, nums):
    ag = None
    for n in nums:
        s = u.select_atoms(f"bynum {n}")
        ag = s if ag is None else ag + s
    return ag


def alanine_histogram_features(u: Universe):
    """The six standard observables (φ/ψ dihedrals, two bonds, two angles)."""
    return [
        Feature("d1", "dihedral", _ordered_group(u, (5, 7, 9, 15))),
        Feature("d2", "dihedral", _ordered_group(u, (7, 9, 15, 17))),
        Feature("b1", "bond", u.select_atoms("bynum 2 5")),
        Feature("b2", "bond", u.select_atoms("bynum 5 6")),
        Feature("a1", "angle", _ordered_group(u, (20, 19, 21))),
        Feature("a2", "angle", _ordered_group(u, (16, 15, 17))),
    ]


def alanine_model(hidden_dims=(5, 3), method="qcp", use_angle_value=False,
                  include_position=True, *, generator=None, activation="tanh",
                  device="cpu"):
    """The flagship serving model: AlignmentLayer('bynum 1 2 5') →
    FeatureLayer(position over resid 2 + the six histogram observables,
    38 columns) → MLP ``38 → 5 → 3``. Weights are drawn from
    ``generator`` (seeded with 0 when omitted). Returns ``(model,
    universe)``."""
    u = alanine_universe()
    align = AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms,
                           method=method, device=device)
    feats = list(alanine_histogram_features(u))
    if include_position:
        feats.insert(0, Feature("p1", "position", u.select_atoms("resid 2")))
    flayer = FeatureLayer(feats, u.atoms, use_angle_value)
    pp = PreprocessingANN(align, flayer)
    nn = create_sequential_nn([pp.output_dimension(), *hidden_dims],
                              activation, generator=generator, device=device)
    return MolANN(pp, nn), u
