"""Topology front-end: minimal PDB reader + MDAnalysis-compatible atom groups.

Carried over from ``molann_tpu/topology.py`` (numpy only) so that the
PyTorch port imports no JAX; the minimum-image helper it borrowed from
``ops/neighbor.py`` lives here as ``_min_image``.

The reference library (zwpku/molann) depends on MDAnalysis only through a
tiny duck-typed surface: ``Universe(pdb)``, ``universe.select_atoms(sel)``,
``AtomGroup.ix`` (0-based indices, numpy), ``AtomGroup.positions`` (float32
``[n, 3]``), ``len(ag)``, iteration over atoms, and order-preserving ``+``
concatenation (reference: molann/feature.py:84,101,123 and
molann/ann.py:131-135,255-258).  MDAnalysis is not installed in this
environment, so this module provides a standalone implementation of exactly
that surface, plus the subset of the MDAnalysis selection language the
reference exercises (``bynum``, ``index``, ``resid``, ``name``, ``type``,
``resname``, ``all``, ``and``/``or``/``not``, parentheses, numeric ranges)
and the geometric/expansion/property keywords (``around``, ``sphzone``,
``sphlayer``, ``point``, ``byres``, ``same ... as``, ``prop`` on
x/y/z/mass) — periodic under the universe's box like MDAnalysis'
``periodic=True`` default. Out of scope (fails loudly): bonded
connectivity (``bonded``, fragments), ``segid``/chain keywords,
``cyzone``/``cylayer``, and ``prop`` on charge (no charges in PDB
topologies here).

If real MDAnalysis objects are passed to the rest of the library they work
unchanged — everything downstream is duck-typed on ``.ix`` / ``.positions`` /
``len`` / iteration, never on these classes.

Semantics intentionally mirrored from MDAnalysis:

- ``select_atoms`` returns atoms in index-sorted order with duplicates
  removed (so ``bynum 5 2`` comes back as atoms 2,5 — the reason the
  reference's feature files use one selector per atom when order matters,
  see reference test/feature.txt:9).
- ``ag1 + ag2`` concatenates preserving order and keeping duplicates
  (duplicate rejection happens later in ``Feature``,
  reference molann/feature.py:84-85).
"""

from __future__ import annotations

import re

import numpy as np

__all__ = [
    "Atom",
    "AtomGroup",
    "FrozenAtomGroup",
    "Universe",
    "SelectionError",
    "guess_atom_mass",
    "guess_atom_type",
]


class SelectionError(ValueError):
    """Raised for selection strings outside the supported subset."""


# Elements that keep two letters when guessed from an atom name.  Small
# curated table (same spirit as MDAnalysis' guessers); everything else falls
# back to the first alphabetic character of the digit-stripped name.
_TWO_LETTER_ELEMENTS = {
    "CL", "BR", "NA", "MG", "FE", "ZN", "CA2", "MN", "CU", "CO", "NI",
    "SE", "SI", "LI", "AL", "RB", "CS", "SR", "BA", "HE", "NE", "AR",
    "KR", "XE", "CD", "HG", "PB", "PT", "AU", "AG",
}


# Standard atomic masses (u), CIAAW 2021 abridged values — the same table
# MDAnalysis' mass guesser draws from for organic/biomolecular systems.
# Unknown types get 0.0, matching MDAnalysis' behavior for unguessable
# atoms (callers that need real masses, e.g. the BAOAB integrator, must
# validate positivity themselves).
_MASSES = {
    "H": 1.008, "D": 2.014, "He": 4.0026, "Li": 6.94, "Be": 9.0122,
    "B": 10.81, "C": 12.011, "N": 14.007, "O": 15.999, "F": 18.998,
    "Ne": 20.180, "Na": 22.990, "Mg": 24.305, "Al": 26.982, "Si": 28.085,
    "P": 30.974, "S": 32.06, "Cl": 35.45, "Ar": 39.95, "K": 39.098,
    "Ca": 40.078, "Mn": 54.938, "Fe": 55.845, "Co": 58.933, "Ni": 58.693,
    "Cu": 63.546, "Zn": 65.38, "Se": 78.971, "Br": 79.904, "Kr": 83.798,
    "Rb": 85.468, "Sr": 87.62, "Ag": 107.87, "Cd": 112.41, "I": 126.90,
    "Xe": 131.29, "Cs": 132.91, "Ba": 137.33, "Pt": 195.08, "Au": 196.97,
    "Hg": 200.59, "Pb": 207.2,
}


def guess_atom_mass(atom_type: str) -> float:
    """Standard atomic mass (u) for an element-like type string; 0.0 if
    unknown (MDAnalysis-compatible fallback)."""
    t = atom_type.strip()
    return _MASSES.get(t.capitalize() if len(t) > 1 else t.upper(), 0.0)


def guess_atom_type(name: str) -> str:
    """Guess an element-like atom type from a PDB atom name.

    Mirrors the common-case behavior of MDAnalysis' type guesser for
    organic systems: leading digits are dropped (``1HH3`` -> H), trailing
    digits are dropped (``CH3`` -> C via ``CH`` -> first letter), and a
    small two-letter-element table is consulted.
    """
    stripped = name.strip()
    stripped = stripped.lstrip("0123456789")
    if not stripped:
        return ""
    if stripped[0] in "Hh":
        return "H"
    no_digits = stripped.rstrip("0123456789")
    upper = (no_digits or stripped).upper()
    if upper in _TWO_LETTER_ELEMENTS:
        return upper.capitalize() if len(upper) > 1 else upper
    return upper[0]


class Atom:
    """One atom of a :class:`Universe`. Hashable, identity = (universe, ix)."""

    __slots__ = ("universe", "ix")

    def __init__(self, universe: "Universe", ix: int):
        self.universe = universe
        self.ix = int(ix)

    @property
    def name(self) -> str:
        return self.universe._names[self.ix]

    @property
    def type(self) -> str:
        return self.universe._types[self.ix]

    @property
    def resid(self) -> int:
        return int(self.universe._resids[self.ix])

    @property
    def resname(self) -> str:
        return self.universe._resnames[self.ix]

    @property
    def position(self) -> np.ndarray:
        return self.universe._positions[self.ix]

    @property
    def mass(self) -> float:
        return guess_atom_mass(self.type)

    def __eq__(self, other):
        return (
            isinstance(other, Atom)
            and other.universe is self.universe
            and other.ix == self.ix
        )

    def __hash__(self):
        return hash((id(self.universe), self.ix))

    def __repr__(self):
        return f"<Atom {self.ix + 1}: {self.name} of resid {self.resid}>"


class AtomGroup:
    """Ordered collection of atoms of one universe (duplicates allowed).

    Implements the duck-typed surface the feature/ANN layers require:
    ``.ix`` (0-based numpy int array), ``.positions`` (float32 ``[n, 3]``),
    ``len``, iteration, indexing, and order-preserving ``+``.
    """

    def __init__(self, universe: "Universe", indices):
        self.universe = universe
        self._ix = np.asarray(indices, dtype=np.int64).reshape(-1)
        n = len(universe._names)
        if self._ix.size and (self._ix.min() < 0 or self._ix.max() >= n):
            raise IndexError("atom index out of range for universe")

    @property
    def ix(self) -> np.ndarray:
        """0-based atom indices (numpy array), MDAnalysis-compatible."""
        return self._ix.copy()

    @property
    def positions(self) -> np.ndarray:
        """float32 ``[n, 3]`` coordinates, MDAnalysis-compatible."""
        return self.universe._positions[self._ix].astype(np.float32)

    @property
    def names(self) -> np.ndarray:
        return np.array([self.universe._names[i] for i in self._ix])

    @property
    def types(self) -> np.ndarray:
        return np.array([self.universe._types[i] for i in self._ix])

    @property
    def resids(self) -> np.ndarray:
        return np.array([self.universe._resids[i] for i in self._ix])

    @property
    def resnames(self) -> np.ndarray:
        return np.array([self.universe._resnames[i] for i in self._ix])

    @property
    def masses(self) -> np.ndarray:
        """Standard atomic masses (u) guessed from atom types,
        MDAnalysis-compatible (unknown types -> 0.0)."""
        return np.array(
            [guess_atom_mass(self.universe._types[i]) for i in self._ix],
            dtype=np.float64,
        )

    @property
    def n_atoms(self) -> int:
        return len(self._ix)

    @property
    def atoms(self) -> "AtomGroup":
        return self

    def select_atoms(self, selection: str) -> "AtomGroup":
        """Select within this group (result index-sorted, deduplicated)."""
        mask = _evaluate_selection(selection, self.universe)
        member = np.zeros_like(mask)
        member[self._ix] = True
        return AtomGroup(self.universe, np.nonzero(mask & member)[0])

    def __len__(self):
        return len(self._ix)

    def __iter__(self):
        for i in self._ix:
            yield Atom(self.universe, int(i))

    def __getitem__(self, item):
        if isinstance(item, (int, np.integer)):
            return Atom(self.universe, int(self._ix[item]))
        return AtomGroup(self.universe, self._ix[item])

    def __add__(self, other: "AtomGroup") -> "AtomGroup":
        if other.universe is not self.universe:
            raise ValueError("cannot concatenate groups from different universes")
        return AtomGroup(self.universe, np.concatenate([self._ix, other.ix]))

    def __eq__(self, other):
        return (
            isinstance(other, AtomGroup)
            and other.universe is self.universe
            and np.array_equal(other._ix, self._ix)
        )

    def __hash__(self):
        return hash((id(self.universe), self._ix.tobytes()))

    def __repr__(self):
        return f"<AtomGroup with {len(self)} atoms>"


class FrozenAtomGroup:
    """Standalone atom group: indices (+ optional positions), no universe.

    Used when models are reloaded from checkpoints without any topology
    front-end (mirroring the reference's TorchScript artifacts, which embed
    index lists and need no MDAnalysis at load time). Implements the same
    duck-typed surface as :class:`AtomGroup`.
    """

    __slots__ = ("_ix", "_positions")

    def __init__(self, indices, positions=None):
        self._ix = np.asarray(indices, dtype=np.int64).reshape(-1)
        self._positions = (
            None
            if positions is None
            else np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        )

    @property
    def ix(self):
        return self._ix.copy()

    @property
    def positions(self):
        if self._positions is None:
            raise AttributeError("this FrozenAtomGroup carries no positions")
        return self._positions.copy()

    def __len__(self):
        return len(self._ix)

    def __iter__(self):
        # yields hashable (group-less) atom handles; identity by index
        for i in self._ix:
            yield ("frozen-atom", int(i))

    def __add__(self, other):
        pos = None
        if self._positions is not None and getattr(other, "_positions", None) is not None:
            pos = np.concatenate([self._positions, other._positions])
        return FrozenAtomGroup(
            np.concatenate([self._ix, np.asarray(other.ix)]), pos
        )

    def __repr__(self):
        return f"<FrozenAtomGroup with {len(self)} atoms>"


class Universe:
    """Minimal MDAnalysis-compatible universe built from a coordinate
    file — dispatched on extension like MDAnalysis:

    - ``.pdb`` (default): ATOM/HETATM records (fixed PDB columns with a
      whitespace-split fallback); covers the reference's fixture
      (reference test/alanine-dipeptide-vacuum.pdb) and standard PDBs.
      A CRYST1 record, when present, populates :attr:`box`.
    - ``.gro``: GROMACS coordinate files (fixed columns, nanometres —
      converted to the Angstroms every other front-end uses, matching
      MDAnalysis); the trailing box line populates :attr:`box`.
    - ``.xyz``: plain XYZ (element x y z, Angstroms).

    Can also be built directly from arrays via :meth:`from_arrays`.
    """

    def __init__(self, pdb_filename: str | None = None):
        self._names: list[str] = []
        self._types: list[str] = []
        self._resids: list[int] = []
        self._resnames: list[str] = []
        self._positions = np.zeros((0, 3), dtype=np.float32)
        self._box = None
        if pdb_filename is not None:
            low = str(pdb_filename).lower()
            if low.endswith(".gro"):
                self._load_gro(pdb_filename)
            elif low.endswith(".xyz"):
                self._load_xyz(pdb_filename)
            else:
                self._load_pdb(pdb_filename)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_arrays(cls, positions, names=None, resids=None, resnames=None,
                    types=None) -> "Universe":
        u = cls(None)
        pos = np.asarray(positions, dtype=np.float32).reshape(-1, 3)
        n = pos.shape[0]
        u._positions = pos
        u._names = list(names) if names is not None else [f"X{i+1}" for i in range(n)]
        u._resids = [int(r) for r in resids] if resids is not None else [1] * n
        u._resnames = list(resnames) if resnames is not None else ["UNK"] * n
        if types is not None:
            u._types = list(types)
        else:
            u._types = [guess_atom_type(nm) for nm in u._names]
        return u

    def _load_pdb(self, filename: str) -> None:
        names, resids, resnames, coords, elements = [], [], [], [], []
        with open(filename, "r") as fh:
            for line in fh:
                rec = line[:6].strip()
                if rec == "CRYST1":
                    try:
                        a, b, c = (float(line[6:15]), float(line[15:24]),
                                   float(line[24:33]))
                        al, be, ga = (float(line[33:40]), float(line[40:47]),
                                      float(line[47:54]))
                    except (ValueError, IndexError):
                        continue
                    # the common "no cell" placeholder: unit cube, 90/90/90
                    if not (a <= 1.0 and b <= 1.0 and c <= 1.0):
                        from .pbc import dcd_cell_to_box

                        self._box = dcd_cell_to_box(
                            np.asarray([a, ga, b, be, al, c]))
                    continue
                if rec not in ("ATOM", "HETATM"):
                    continue
                try:
                    name = line[12:16].strip()
                    resname = line[17:20].strip()
                    resid = int(line[22:26])
                    x = float(line[30:38])
                    y = float(line[38:46])
                    z = float(line[46:54])
                    element = line[76:78].strip() if len(line) >= 78 else ""
                except (ValueError, IndexError):
                    # Fallback for non-standard column layouts.
                    parts = line.split()
                    name, resname = parts[2], parts[3]
                    resid = int(parts[4])
                    x, y, z = (float(v) for v in parts[5:8])
                    element = ""
                names.append(name)
                resnames.append(resname)
                resids.append(resid)
                coords.append((x, y, z))
                elements.append(element)
        self._names = names
        self._resnames = resnames
        self._resids = resids
        self._positions = np.asarray(coords, dtype=np.float32)
        self._types = [
            el.capitalize() if el else guess_atom_type(nm)
            for el, nm in zip(elements, names)
        ]

    def _load_gro(self, filename: str) -> None:
        """GROMACS .gro: title line, atom count, fixed-column atom lines
        (``%5d%-5s%5s%5d`` + free-format nm coordinates, velocities
        ignored), trailing box line. Coordinates and box are converted
        nm -> Angstrom (x10), matching MDAnalysis."""
        with open(filename, "r") as fh:
            lines = fh.read().splitlines()
        if len(lines) < 2:
            raise ValueError(f"{filename}: not a .gro file (too short)")
        try:
            n = int(lines[1].strip())
        except ValueError:
            raise ValueError(
                f"{filename}: bad .gro atom count {lines[1]!r}")
        if n < 0 or len(lines) < 2 + n:
            raise ValueError(
                f"{filename}: .gro promises {n} atoms, has "
                f"{max(0, len(lines) - 3)} atom lines")
        names, resids, resnames, coords = [], [], [], []
        for line in lines[2 : 2 + n]:
            try:
                resids.append(int(line[0:5]))
                resnames.append(line[5:10].strip())
                names.append(line[10:15].strip())
                vals = line[20:].split()
                x, y, z = (float(v) for v in vals[:3])
            except (ValueError, IndexError):
                raise ValueError(f"{filename}: malformed .gro line {line!r}")
            coords.append((x, y, z))
        self._names = names
        self._resnames = resnames
        self._resids = resids
        self._positions = 10.0 * np.asarray(coords, dtype=np.float32)
        self._types = [guess_atom_type(nm) for nm in names]
        if len(lines) > 2 + n:
            try:
                vals = [float(v) for v in lines[2 + n].split()]
            except ValueError:
                # Trailing non-numeric line (comment/garbage) — per the
                # lenient .gro convention treat it as "no box" rather
                # than surfacing a raw float() ValueError.
                vals = []
            if len(vals) >= 3 and any(vals):
                box = np.zeros((3, 3), dtype=np.float64)
                box[0, 0], box[1, 1], box[2, 2] = vals[0], vals[1], vals[2]
                if len(vals) >= 9:  # v1y v1z v2x v2z v3x v3y
                    (box[0, 1], box[0, 2], box[1, 0],
                     box[1, 2], box[2, 0], box[2, 1]) = vals[3:9]
                self._box = (10.0 * box).astype(np.float32)

    def _load_xyz(self, filename: str) -> None:
        """Plain XYZ: atom count, comment, ``element x y z`` lines
        (Angstroms). Only the first frame of a multi-frame file is read
        (a topology needs one geometry; trajectories belong in the
        binary codecs)."""
        with open(filename, "r") as fh:
            lines = fh.read().splitlines()
        if not lines:
            raise ValueError(f"{filename}: empty .xyz file")
        try:
            n = int(lines[0].split()[0])
        except (ValueError, IndexError):
            raise ValueError(f"{filename}: bad .xyz atom count "
                             f"{lines[0]!r}")
        if n < 0 or len(lines) < 2 + n:
            raise ValueError(f"{filename}: .xyz promises {n} atoms, has "
                             f"{max(0, len(lines) - 2)} atom lines")
        names, coords = [], []
        for line in lines[2 : 2 + n]:
            parts = line.split()
            try:
                x, y, z = (float(v) for v in parts[1:4])
            except (ValueError, IndexError):
                raise ValueError(f"{filename}: malformed .xyz line {line!r}")
            names.append(parts[0])
            coords.append((x, y, z))
        self._names = names
        self._resnames = ["UNK"] * n
        self._resids = [1] * n
        self._positions = np.asarray(coords, dtype=np.float32)
        self._types = [guess_atom_type(nm) for nm in names]

    # -- MDAnalysis-compatible API ----------------------------------------

    @property
    def box(self):
        """``[3, 3] float32`` unit-cell matrix in Angstroms (GROMACS
        lower-triangular convention, directly usable with
        :mod:`molann_tpu_torch.pbc`), or None when the file carried no cell —
        from a .gro box line or a PDB CRYST1 record."""
        return self._box

    @property
    def atoms(self) -> AtomGroup:
        return AtomGroup(self, np.arange(len(self._names)))

    @property
    def n_atoms(self) -> int:
        return len(self._names)

    def select_atoms(self, selection: str) -> AtomGroup:
        """Evaluate a selection string; result is index-sorted, deduplicated
        (MDAnalysis semantics — see module docstring)."""
        mask = _evaluate_selection(selection, self)
        return AtomGroup(self, np.nonzero(mask)[0])


# ---------------------------------------------------------------------------
# Selection language (subset of MDAnalysis' grammar)
# ---------------------------------------------------------------------------

_KEYWORDS = {
    "and", "or", "not", "all", "bynum", "index", "resid", "name", "type",
    "resname", "protein", "backbone", "heavy", "hydrogen",
    # geometric / expansion / property keywords (MDAnalysis User Guide,
    # "Atom selection language": Geometric, Similarity-and-connectivity,
    # and Index sections)
    "around", "sphzone", "sphlayer", "point", "prop", "byres", "same",
    "as", "abs",
}

# Standard residue names recognized by the `protein` keyword (the common
# MDAnalysis set: amino acids + caps + common variants).
_PROTEIN_RESNAMES = {
    "ALA", "ARG", "ASN", "ASP", "CYS", "GLN", "GLU", "GLY", "HIS", "ILE",
    "LEU", "LYS", "MET", "PHE", "PRO", "SER", "THR", "TRP", "TYR", "VAL",
    "ACE", "NME", "NMA", "HID", "HIE", "HIP", "HSD", "HSE", "HSP", "CYX",
    "ASH", "GLH", "LYN", "MSE",
}

_BACKBONE_NAMES = {"N", "CA", "C", "O", "OXT"}

_TOKEN_RE = re.compile(r"\(|\)|[^\s()]+")


def _tokenize(selection: str) -> list[str]:
    return _TOKEN_RE.findall(selection)


def _min_image(d, box):
    """Minimum-image displacement rows ``[m, 3]`` under a lower-
    triangular box (rows = lattice vectors), host-side numpy (the same
    reduction as ``molann_tpu/ops/neighbor.py:_min_image``)."""
    b = np.asarray(box, dtype=np.float64)
    for k in (2, 1, 0):  # GROMACS order: subtract c, then b, then a
        d -= np.round(d[:, k:k + 1] / b[k, k]) * b[k]
    return d


def _min_image_dist2(pos, ref, box):
    """Squared distances ``[n, m]`` between every atom and every
    reference point, minimum-imaged when the universe has a box
    (MDAnalysis distance selections default to ``periodic=True``)."""
    d = pos[:, None, :] - ref[None, :, :]  # [n, m, 3]
    if box is not None:
        n, m, _ = d.shape
        d = _min_image(d.reshape(n * m, 3), box).reshape(n, m, 3)
    return (d * d).sum(-1)


class _Parser:
    """Recursive-descent parser producing a boolean mask over all atoms.

    Grammar:
        expr     := and_expr ('or' and_expr)*
        and_expr := not_expr ('and' not_expr)*
        not_expr := 'not' not_expr | '(' expr ')' | primary
        primary  := 'all' | ('bynum'|'index'|'resid') range+ |
                    ('name'|'type'|'resname') value+ |
                    'around' NUM expr | 'sphzone' NUM expr |
                    'sphlayer' NUM NUM expr | 'point' NUM NUM NUM NUM |
                    'byres' expr | 'same' ATTR 'as' expr |
                    'prop' ['abs'] ('x'|'y'|'z'|'mass') OP NUM
        range    := INT | INT:INT | INT-INT        (bynum is 1-based,
                                                    index is 0-based)

    The unary keywords (around/sphzone/sphlayer/byres/same) take the
    ENTIRE expression to their right as operand — MDAnalysis gives them
    the lowest precedence (core/selection.py: precedence 1, below
    and/or at 3), so ``around 3.5 protein and name O`` means
    ``around 3.5 (protein and name O)``; parenthesize to bound the
    operand, exactly as the MDAnalysis User Guide recommends.
    """

    def __init__(self, tokens: list[str], universe: Universe):
        self.tokens = tokens
        self.pos = 0
        self.u = universe

    def peek(self):
        return self.tokens[self.pos] if self.pos < len(self.tokens) else None

    def next(self):
        tok = self.peek()
        if tok is None:
            raise SelectionError("unexpected end of selection string")
        self.pos += 1
        return tok

    def parse(self) -> np.ndarray:
        mask = self.expr()
        if self.peek() is not None:
            raise SelectionError(f"unexpected token {self.peek()!r}")
        return mask

    def expr(self) -> np.ndarray:
        mask = self.and_expr()
        while self.peek() == "or":
            self.next()
            mask = mask | self.and_expr()
        return mask

    def and_expr(self) -> np.ndarray:
        mask = self.not_expr()
        while self.peek() == "and":
            self.next()
            mask = mask & self.not_expr()
        return mask

    def not_expr(self) -> np.ndarray:
        tok = self.peek()
        if tok == "not":
            self.next()
            return ~self.not_expr()
        if tok == "(":
            self.next()
            mask = self.expr()
            if self.next() != ")":
                raise SelectionError("missing closing parenthesis")
            return mask
        return self.primary()

    def primary(self) -> np.ndarray:
        tok = self.next()
        n = self.u.n_atoms
        if tok == "all":
            return np.ones(n, dtype=bool)
        if tok == "protein":
            res = np.asarray(self.u._resnames)
            return np.isin(res, sorted(_PROTEIN_RESNAMES))
        if tok == "backbone":
            res = np.asarray(self.u._resnames)
            names = np.asarray(self.u._names)
            return np.isin(res, sorted(_PROTEIN_RESNAMES)) & np.isin(
                names, sorted(_BACKBONE_NAMES)
            )
        if tok == "hydrogen":
            return np.asarray(self.u._types) == "H"
        if tok == "heavy":
            return np.asarray(self.u._types) != "H"
        if tok in ("bynum", "index", "resid"):
            values = self._collect_ranges(tok)
            if tok == "bynum":
                field = np.arange(1, n + 1)
            elif tok == "index":
                field = np.arange(n)
            else:
                field = np.asarray(self.u._resids)
            mask = np.zeros(n, dtype=bool)
            for lo, hi in values:
                mask |= (field >= lo) & (field <= hi)
            return mask
        if tok in ("name", "type", "resname"):
            values = self._collect_values(tok)
            attr = {"name": "_names", "type": "_types", "resname": "_resnames"}
            field = np.asarray(getattr(self.u, attr[tok]))
            mask = np.zeros(n, dtype=bool)
            for v in values:
                if "*" in v or "?" in v:
                    pat = re.compile(re.escape(v).replace(r"\*", ".*").replace(r"\?", "."))
                    mask |= np.array([bool(pat.fullmatch(f)) for f in field])
                else:
                    mask |= field == v
            return mask
        if tok == "around":
            # 'around R sel: atoms within R of sel, EXCLUDING sel itself'
            # (User Guide, Geometric); periodic when the universe has a
            # box, matching the periodic=True default
            r = self._number("around")
            sel = self.expr()
            if not sel.any():
                return np.zeros(n, dtype=bool)
            pos = self.u._positions.astype(np.float64)
            d2 = _min_image_dist2(pos, pos[sel], self.u.box)
            return (d2.min(axis=1) <= r * r) & ~sel
        if tok == "sphzone":
            # 'sphzone R sel: atoms within a sphere of radius R centered
            # in the center of geometry of sel' (User Guide, Geometric)
            r = self._number("sphzone")
            return self._cog_shell("sphzone", 0.0, r)
        if tok == "sphlayer":
            # 'sphlayer r1 r2 sel: atoms within a spherical layer of
            # inner radius r1 and outer radius r2 centered in the COG of
            # sel' (User Guide, Geometric)
            r1 = self._number("sphlayer")
            r2 = self._number("sphlayer")
            return self._cog_shell("sphlayer", r1, r2)
        if tok == "point":
            # 'point x y z R: atoms within R of the point (x, y, z)'
            # (User Guide, Geometric)
            vals = [self._number("point") for _ in range(4)]
            x, y, z, r = vals
            pos = self.u._positions.astype(np.float64)
            d2 = _min_image_dist2(
                pos, np.asarray([[x, y, z]], dtype=np.float64), self.u.box
            )[:, 0]
            return d2 <= r * r
        if tok == "byres":
            # 'byres sel: all atoms in the same (numbered) residue as
            # any atom of sel' (User Guide, Similarity and connectivity)
            sel = self.expr()
            res = np.asarray(self.u._resids)
            return np.isin(res, np.unique(res[sel]))
        if tok == "same":
            # 'same SUBKEYWORD as sel: atoms sharing the property with
            # any atom of sel' (User Guide, Similarity and connectivity)
            attr_tok = self.next()
            fields = {
                "resid": np.asarray(self.u._resids),
                "resname": np.asarray(self.u._resnames),
                "name": np.asarray(self.u._names),
                "type": np.asarray(self.u._types),
                "mass": np.asarray(
                    [guess_atom_mass(t) for t in self.u._types]),
            }
            if attr_tok not in fields:
                raise SelectionError(
                    f"'same' supports {sorted(fields)}, got {attr_tok!r}")
            if self.next() != "as":
                raise SelectionError("'same' expects: same ATTR as SEL")
            sel = self.expr()
            field = fields[attr_tok]
            return np.isin(field, np.unique(field[sel]))
        if tok == "prop":
            # 'prop [abs] PROPERTY OPERATOR VALUE' (User Guide,
            # Selections based on atom properties); x/y/z/mass here
            t = self.next()
            use_abs = t == "abs"
            if use_abs:
                t = self.next()
            if t in ("x", "y", "z"):
                vals = self.u._positions[:, "xyz".index(t)].astype(
                    np.float64)
            elif t == "mass":
                vals = np.asarray(
                    [guess_atom_mass(tt) for tt in self.u._types])
            else:
                raise SelectionError(
                    f"'prop' supports x/y/z/mass, got {t!r}")
            if use_abs:
                vals = np.abs(vals)
            op = self.next()
            ops = {
                "<": np.less, "<=": np.less_equal, ">": np.greater,
                ">=": np.greater_equal, "==": np.equal,
                "!=": np.not_equal,
            }
            if op not in ops:
                raise SelectionError(
                    f"'prop' expects one of {sorted(ops)}, got {op!r}")
            val = self._number("prop")
            return ops[op](vals, val)
        raise SelectionError(
            f"unsupported selection keyword {tok!r}; supported subset: "
            f"{sorted(_KEYWORDS)}"
        )

    def _number(self, kw: str) -> float:
        tok = self.next()
        try:
            return float(tok)
        except ValueError:
            raise SelectionError(f"'{kw}' expects a number, got {tok!r}")

    def _cog_shell(self, kw: str, r1: float, r2: float) -> np.ndarray:
        """Spherical shell [r1, r2] around the center of geometry of the
        operand selection (sphzone/sphlayer)."""
        sel = self.expr()
        if not sel.any():
            raise SelectionError(f"'{kw}' reference selection is empty")
        pos = self.u._positions.astype(np.float64)
        cog = pos[sel].mean(axis=0)
        d2 = _min_image_dist2(pos, cog[None, :], self.u.box)[:, 0]
        return (d2 >= r1 * r1) & (d2 <= r2 * r2)

    def _collect_ranges(self, kw: str) -> list[tuple[int, int]]:
        out = []
        range_re = re.compile(r"^(-?\d+)(?:[:\-](-?\d+))?$")
        while True:
            tok = self.peek()
            if tok is None or tok in _KEYWORDS or tok in "()":
                break
            m = range_re.match(tok)
            if not m:
                break
            self.next()
            lo = int(m.group(1))
            hi = int(m.group(2)) if m.group(2) is not None else lo
            out.append((lo, hi))
        if not out:
            raise SelectionError(f"'{kw}' needs at least one number/range")
        return out

    def _collect_values(self, kw: str) -> list[str]:
        out = []
        while True:
            tok = self.peek()
            if tok is None or tok in _KEYWORDS or tok in "()":
                break
            out.append(self.next())
        if not out:
            raise SelectionError(f"'{kw}' needs at least one value")
        return out


def _evaluate_selection(selection: str, universe: Universe) -> np.ndarray:
    tokens = _tokenize(selection.strip())
    if not tokens:
        raise SelectionError("empty selection string")
    return _Parser(tokens, universe).parse()
