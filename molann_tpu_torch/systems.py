"""Built-in systems of the port (``molann_tpu/systems.py``).

- the 22-atom ACE-ALA-NME alanine dipeptide (vacuum, idealised geometry)
  and the flagship model on it (:65-105, :278-296);
- a synthetic poly-alanine-like peptide of ``5 * n_residues`` atoms with
  its backbone feature set and model (:108-184), the scaling system of the
  blocked kernels;
- a periodic Lennard-Jones-like fluid with two all-pairs coordination
  shells and its model (:187-275), the condensed-phase system;
- two peptide models at the edge of the unrolled kernels' envelope:
  ``scripts/tpu_validation.py``'s config 5 (:func:`chignolin_model`) and
  the largest model both packages still serve unrolled
  (:func:`envelope_corner_model`).

The functions that return a model are entry points: they put the model on the card unless
``device="cpu"`` is passed, and raise where no CUDA device is present.
Weights come from an explicit ``torch.Generator`` (seeded with 0 when
omitted).
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
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
    "synthetic_peptide",
    "peptide_backbone_features",
    "peptide_model",
    "chignolin_model",
    "envelope_corner_model",
    "lj_fluid",
    "lj_fluid_model",
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
                  device=None):
    """The flagship serving model: AlignmentLayer('bynum 1 2 5') →
    FeatureLayer(position over resid 2 + the six histogram observables,
    38 columns) → MLP ``38 → 5 → 3``. Weights are drawn from
    ``generator`` (seeded with 0 when omitted). The model is built on
    ``device``: the card when ``None`` (an error without one), the host for
    ``"cpu"``. Returns ``(model, universe)``."""
    device = resolve_device(device)
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


def synthetic_peptide(n_residues: int = 10, seed: int = 0) -> Universe:
    """A synthetic poly-alanine-like chain with ``5*n_residues`` atoms
    (N, CA, C, O, CB per residue) in an idealised helical geometry, the
    same coordinates as ``molann_tpu.systems.synthetic_peptide``."""
    rng = np.random.default_rng(seed)
    offsets = {
        "N": (-0.7, -0.6, -0.4),
        "CA": (0.0, 0.0, 0.0),
        "C": (0.9, 0.5, 0.4),
        "O": (1.1, 1.6, 0.3),
        "CB": (-0.5, 0.8, 0.8),
    }
    names, resids, resnames, coords = [], [], [], []
    # crude helix: backbone advances along z, rotates in xy
    for r in range(n_residues):
        theta = 1.745 * r  # ~100 degrees per residue
        cx, cy, cz = 2.3 * np.cos(theta), 2.3 * np.sin(theta), 1.5 * r
        for name, (dx, dy, dz) in offsets.items():
            jitter = 0.05 * rng.normal(size=3)
            coords.append((cx + dx + jitter[0], cy + dy + jitter[1],
                           cz + dz + jitter[2]))
            names.append(name)
            resids.append(r + 1)
            resnames.append("ALA")
    return Universe.from_arrays(coords, names=names, resids=resids,
                                resnames=resnames)


def peptide_backbone_features(u: Universe):
    """Backbone φ/ψ dihedrals, CA-CA pseudo-bonds and N-CA-C angles of a
    :func:`synthetic_peptide` universe (about 4 features per residue)."""
    def sel(name, resid):
        return u.select_atoms(f"name {name} and resid {resid}")

    feats = []
    resids = sorted(set(int(r) for r in u.atoms.resids))
    for r in resids:
        if r > min(resids):
            feats.append(Feature(
                f"phi{r}", "dihedral",
                sel("C", r - 1) + sel("N", r) + sel("CA", r) + sel("C", r)))
            feats.append(Feature(f"dCA{r}", "bond",
                                 sel("CA", r - 1) + sel("CA", r)))
        if r < max(resids):
            feats.append(Feature(
                f"psi{r}", "dihedral",
                sel("N", r) + sel("CA", r) + sel("C", r) + sel("N", r + 1)))
        feats.append(Feature(f"ang{r}", "angle",
                             sel("N", r) + sel("CA", r) + sel("C", r)))
    return feats


def peptide_model(n_residues: int = 10, hidden_dims=(32, 2), method="qcp", *,
                  generator=None, activation="tanh", device=None):
    """The scaling model: synthetic peptide, alignment on the CA trace, the
    full backbone feature set → MLP. At 60 residues: 300 atoms, 355 feature
    columns, MLP ``355 → 32 → 2``. It has no position feature, so the fused
    kernels run no alignment. Returns ``(model, universe)``, the model on
    ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    u = synthetic_peptide(n_residues)
    align = AlignmentLayer(u.select_atoms("name CA"), u.atoms, method=method,
                           device=device)
    flayer = FeatureLayer(peptide_backbone_features(u), u.atoms)
    pp = PreprocessingANN(align, flayer)
    nn = create_sequential_nn([pp.output_dimension(), *hidden_dims],
                              activation, generator=generator, device=device)
    return MolANN(pp, nn), u


def chignolin_model(*, generator=None, activation="tanh", device=None):
    """``scripts/tpu_validation.py``'s config 5 (:119-128): a 10-residue
    :func:`synthetic_peptide` (50 atoms) aligned on its CA atoms, a CA
    position feature plus :func:`peptide_backbone_features` (85 columns),
    MLP ``85 → 32 → 2``. Inside the unrolled envelope. Returns ``(model,
    universe)``, the model on ``device`` (the card when ``None``)."""
    device = resolve_device(device)
    u = synthetic_peptide(10)
    ca = u.select_atoms("name CA")
    feats = [Feature("pos", "position", ca), *peptide_backbone_features(u)]
    pp = PreprocessingANN(AlignmentLayer(ca, u.atoms, device=device),
                          FeatureLayer(feats, u.atoms))
    nn = create_sequential_nn([pp.output_dimension(), 32, 2], activation,
                              generator=generator, device=device)
    return MolANN(pp, nn), u


def envelope_corner_model(*, generator=None, activation="tanh", device=None):
    """The largest model the unrolled kernels take in both packages: a
    12-residue :func:`synthetic_peptide` (60 atoms) aligned on its 12 CA
    atoms; their positions (36 columns), the backbone φ/ψ dihedrals and
    CA-CA bonds (55) and one coordination number (``r0=6``) over the CA
    atoms and the N atoms of residues 1 and 2 (91 pairs, 1 column): 92
    columns; MLP ``92 → 64 → 64 → 64 → 2``, four layers of the kernels'
    widest. Returns ``(model, universe)``, the model on ``device`` (the card
    when ``None``)."""
    device = resolve_device(device)
    u = synthetic_peptide(12)
    ca = u.select_atoms("name CA")
    feats = [Feature("pos", "position", ca),
             *(f for f in peptide_backbone_features(u)
               if f.type_name != "angle"),
             Feature("contacts", "coordination",
                     u.select_atoms("name CA or (name N and resid 1 2)"),
                     r0=6.0)]
    pp = PreprocessingANN(AlignmentLayer(ca, u.atoms, device=device),
                          FeatureLayer(feats, u.atoms))
    nn = create_sequential_nn([pp.output_dimension(), 64, 64, 64, 2],
                              activation, generator=generator, device=device)
    return MolANN(pp, nn), u

def lj_fluid(n_per_side: int = 5, spacing: float = 1.7, jitter: float = 0.05,
             seed: int = 0):
    """A periodic Lennard-Jones-like fluid: ``n_per_side**3`` atoms on a
    jittered cubic lattice in a cubic box of side ``n_per_side * spacing``.
    Returns ``(universe, box)`` with ``box`` the ``[3]`` float array of
    orthorhombic box lengths, to pass as a coordination feature's
    ``pbc_box``."""
    rng = np.random.default_rng(seed)
    n = int(n_per_side)
    grid = np.stack(np.meshgrid(*(np.arange(n),) * 3, indexing="ij"),
                    axis=-1).reshape(-1, 3).astype(np.float64)
    coords = (grid + 0.5) * spacing + jitter * spacing * rng.normal(
        size=grid.shape)
    n_atoms = n**3
    u = Universe.from_arrays(coords, names=["AR"] * n_atoms,
                             resnames=["AR"] * n_atoms,
                             resids=list(range(1, n_atoms + 1)))
    return u, np.full((3,), n * spacing, dtype=np.float64)


def lj_fluid_model(n_per_side: int = 5, spacing: float = 1.7,
                   hidden_dims=(8, 1), seed: int = 0, d_max=True, *,
                   generator=None, activation="tanh", device=None):
    """The condensed-phase model: two all-pairs coordination shells (first
    and second neighbour distance, minimum image under the periodic box)
    over an :func:`lj_fluid` → MLP. At the default size: 125 atoms and
    2 × 7,750 switching-function pairs, MLP ``2 → 8 → 1``.

    ``d_max=True`` gives the shells stretch-truncation distances of 2.0 and
    2.8 spacings, ``False`` keeps the untruncated tails, a 2-tuple sets
    explicit distances. All-pairs contact counts are in the hundreds and
    would saturate a tanh MLP, so the features are standardised over a
    jittered-lattice sample and the ``(x − μ)/σ`` affine is folded into the
    first Linear: the model stays a plain :class:`MolANN`. Returns
    ``(model, universe, box)``, the model on ``device`` (the card when
    ``None``)."""
    device = resolve_device(device)
    u, box = lj_fluid(n_per_side, spacing, seed=seed)
    if d_max is True:
        d_max = (2.0 * spacing, 2.8 * spacing)
    elif d_max is False or d_max is None:
        d_max = (None, None)
    feats = [
        Feature("shell1", "coordination", u.atoms, r0=1.35 * spacing,
                pbc_box=box, d_max=d_max[0]),
        Feature("shell2", "coordination", u.atoms, r0=2.2 * spacing,
                nn=4, mm=8, pbc_box=box, d_max=d_max[1]),
    ]
    pp = PreprocessingANN(None, FeatureLayer(feats, u.atoms))
    nn = create_sequential_nn([pp.output_dimension(), *hidden_dims],
                              activation, generator=generator, device=device)
    rng = np.random.default_rng(seed + 1)
    xs = (u.atoms.positions[None]
          + 0.15 * spacing * rng.normal(size=(16,) + u.atoms.positions.shape)
          ).astype(np.float32)
    with torch.no_grad():
        f = pp(torch.from_numpy(xs)).numpy()
        mu, sigma = f.mean(axis=0), f.std(axis=0) + 1e-3
        first = nn.layers[0]
        w0 = first.weight.cpu()  # [d_out, d_in]
        scale = torch.as_tensor(sigma, dtype=w0.dtype)
        shift = torch.as_tensor(mu / sigma, dtype=w0.dtype)
        first.bias.copy_((first.bias.cpu() - w0 @ shift).to(device))
        first.weight.copy_((w0 / scale[None, :]).to(device))
    return MolANN(pp, nn), u, box
