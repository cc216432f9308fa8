"""Molecular feature specs and the feature-file config front-end.

Carried over from ``molann_tpu/feature.py`` for the PyTorch port; the only
change is that pandas is imported inside the two ``get_feature_info``
methods, so importing the port needs neither pandas nor JAX.

API-compatible rebuild of the reference's L1 layer (zwpku/molann
``molann/feature.py``): an immutable :class:`Feature` describing one
geometric observable over an atom group, and :class:`FeatureFileReader`
parsing ``[Section] ... [End]`` text configs into feature lists.

Behavioral contract mirrored from the reference (with file:line citations
into the reference repository, zwpku/molann):

- ``Feature`` validates its type (NotImplementedError, feature.py:81-82),
  rejects duplicate atoms (IndexError, feature.py:84-85), and asserts atom
  counts 3/2/4/any for angle/bond/dihedral/position (feature.py:87-97);
  type ids are angle=0, bond=1, dihedral=2, position=3.
- ``get_atom_indices`` returns **1-based** indices (feature.py:118-123).
- ``get_feature_info`` returns a single-row pandas DataFrame with the exact
  reference column names (feature.py:132-137).
- ``FeatureFileReader.read`` reproduces the reference grammar byte-for-byte
  (feature.py:224-265): blank/'#' lines skipped; a ``[X]`` header strips all
  surrounding brackets; only the FIRST matching section is read (break at
  ``[End]``); feature lines are ``name, type, selector[, selector...]`` with
  selectors passed verbatim (not stripped) to ``select_atoms`` and
  concatenated with order-preserving ``+``; a stray non-``[End]`` header
  inside a section raises ValueError from tuple unpacking exactly like the
  reference does.

Atom groups are duck-typed: anything exposing ``.ix`` (0-based numpy ints),
``.positions``, ``len`` and iteration works — our :class:`~.topology.AtomGroup`
or a real MDAnalysis one.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Feature", "FeatureFileReader", "FEATURE_TYPE_IDS"]

FEATURE_TYPE_IDS = {
    "angle": 0, "bond": 1, "dihedral": 2, "position": 3,
    # Extension beyond the reference (which stops at position=3): smooth
    # switching-function contact counts, the workhorse CV of the
    # enhanced-sampling literature (PLUMED COORDINATION).
    "coordination": 4,
}
_REQUIRED_ATOM_COUNTS = {"angle": 3, "bond": 2, "dihedral": 4}


class Feature:
    """Immutable spec of one molecular observable over an atom group.

    :param str name: feature's name
    :param str feature_type: one of ``'angle'``, ``'bond'``, ``'dihedral'``,
        ``'position'``
    :param atom_group: atoms defining the feature, in order (duck-typed;
        our AtomGroup or MDAnalysis')

    Raises ``NotImplementedError`` for unknown types, ``IndexError`` for
    repeated atoms, ``AssertionError`` for wrong atom counts — matching the
    reference's exception classes (reference molann/feature.py:79-97).

    Example (runnable; executed by tests/test_docs.py):

    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> f = Feature("b1", "bond", u.select_atoms("bynum 2 5"))
    >>> f.get_type_id()
    1
    >>> f.get_atom_indices().tolist()   # 1-based, like the reference
    [2, 5]
    >>> f
    Feature(name='b1', type='bond', atoms(1-based)=[2, 5])

    Coordination numbers (an extension beyond the reference's four types)
    sum the rational switching function ``(1-(r/r0)^nn)/(1-(r/r0)^mm)``
    over group-A x group-B pairs (or all pairs within A):

    >>> c = Feature("c1", "coordination", u.select_atoms("bynum 2 5"),
    ...             group_b=u.select_atoms("bynum 15 17"), r0=3.0)
    >>> c.get_type_id(), c.get_coordination_params()
    (4, (2, 3.0, 6, 12))
    """

    def __init__(self, name, feature_type, atom_group, *, group_b=None,
                 r0=None, nn=None, mm=None, pbc_box=None, d_max=None):
        if feature_type not in FEATURE_TYPE_IDS:
            raise NotImplementedError(f"feature {feature_type} not implemented!")

        if feature_type != "coordination":
            if (group_b is not None or r0 is not None or nn is not None
                    or mm is not None or pbc_box is not None
                    or d_max is not None):
                raise ValueError(
                    "group_b/r0/nn/mm/pbc_box/d_max are coordination-"
                    "feature parameters"
                )
        else:
            # coordination: sum over pairs (group A x group B, or all
            # pairs within A) of the rational switching function
            # (1-(r/r0)^nn)/(1-(r/r0)^mm); mm defaults to 2*nn (PLUMED),
            # nn to 6.
            if r0 is None or not float(r0) > 0:
                raise ValueError(
                    f"coordination needs a cutoff r0 > 0, got {r0!r}"
                )
            nn = 6 if nn is None else int(nn)
            mm = 2 * nn if mm is None else int(mm)
            if nn < 1 or mm <= nn:
                raise ValueError(
                    f"switching exponents need mm > nn >= 1, got "
                    f"nn={nn}, mm={mm}"
                )
            if len(atom_group) < 1:
                raise ValueError(
                    "coordination group A is empty (selection matched "
                    "no atoms?)"
                )
            self._group_a_size = len(atom_group)
            if group_b is not None:
                if len(group_b) < 1:
                    raise ValueError("coordination group_b is empty")
                atom_group = atom_group + group_b
            elif len(atom_group) < 2:
                raise ValueError(
                    "self-coordination needs at least 2 atoms"
                )
            self.r0 = float(r0)
            self.nn = nn
            self.mm = mm
            self.pbc_box = _check_pbc_box(pbc_box)
            # optional PLUMED-style stretch-truncation distance: the
            # switching function is rescaled to hit exactly 0 at d_max
            # (ops.features.switching_function), making the feature
            # finite-ranged — the exact-culling radius for
            # ops.neighbor's cell-list pair construction.
            if d_max is not None and not float(d_max) > self.r0:
                raise ValueError(
                    f"d_max must exceed r0, got d_max={d_max!r}, "
                    f"r0={self.r0}")
            self.d_max = None if d_max is None else float(d_max)

        if len(set(atom_group)) < len(atom_group):
            raise IndexError("atom group contains repeated elements!")

        required = _REQUIRED_ATOM_COUNTS.get(feature_type)
        if required is not None:
            assert len(atom_group) == required, (
                f"{required} atoms are needed to define a {feature_type} "
                f"feature, {len(atom_group)} provided"
            )

        self.name = name
        self.type_name = feature_type
        self.atom_group = atom_group
        self.type_id = FEATURE_TYPE_IDS[feature_type]

    def get_name(self):
        """Return :attr:`name`."""
        return self.name

    def get_type(self):
        """Return :attr:`type_name`."""
        return self.type_name

    def get_atom_indices(self):
        """Return **1-based** atom indices as a numpy int array
        (reference molann/feature.py:118-123)."""
        return np.asarray(self.atom_group.ix) + 1

    def get_type_id(self):
        """Return :attr:`type_id` (angle=0, bond=1, dihedral=2, position=3,
        coordination=4)."""
        return self.type_id

    def get_coordination_params(self):
        """``(group_a_size, r0, nn, mm)`` of a coordination feature: the
        first ``group_a_size`` atoms of the group are A, the rest B
        (empty B = all pairs within A). Raises for other types."""
        if self.type_name != "coordination":
            raise ValueError(
                f"{self.type_name!r} features carry no coordination params"
            )
        return self._group_a_size, self.r0, self.nn, self.mm

    def get_feature_info(self):
        """Return a one-row :class:`pandas.DataFrame` describing the feature
        (same columns as reference molann/feature.py:132-137). pandas is
        imported here, not at module import."""
        import pandas as pd

        return pd.DataFrame(
            {
                "name": self.name,
                "type": self.type_name,
                "type_id": self.type_id,
                "atom indices (1-based)": [self.get_atom_indices()],
            }
        )

    # Value-based equality/hash so that models embedding Features as static
    # pytree metadata get stable jit-cache keys across reconstructions.
    def _key(self):
        extra = ()
        if self.type_name == "coordination":
            extra = (self._group_a_size, self.r0, self.nn, self.mm,
                     self.pbc_box)
        return (self.name, self.type_name,
                tuple(int(i) for i in self.atom_group.ix), extra)

    def __eq__(self, other):
        return isinstance(other, Feature) and other._key() == self._key()

    def __hash__(self):
        return hash(self._key())

    def __repr__(self):
        extra = ""
        if self.type_name == "coordination":
            extra = (f", groups={self._group_a_size}+"
                     f"{len(self.atom_group) - self._group_a_size}, "
                     f"r0={self.r0:g}, nn={self.nn}, mm={self.mm}")
            if self.pbc_box is not None:
                extra += (", box=("
                          + ", ".join(f"{self.pbc_box[i][i]:g}"
                                      for i in range(3)) + ")")
        return (
            f"Feature(name={self.name!r}, type={self.type_name!r}, "
            f"atoms(1-based)={self.get_atom_indices().tolist()}{extra})"
        )


def _check_pbc_box(pbc_box):
    """Validate a coordination feature's static box: None, 3 orthorhombic
    lengths, or a [3, 3] lower-triangular lattice matrix (GROMACS row
    convention). Returns a hashable tuple-of-tuples (or None)."""
    if pbc_box is None:
        return None
    b = np.asarray(pbc_box, dtype=np.float64)
    if b.shape == (3,):
        b = np.diag(b)
    if b.shape != (3, 3):
        raise ValueError(
            f"pbc_box must be 3 lengths or a [3, 3] matrix, got "
            f"{np.shape(pbc_box)}"
        )
    if (np.diag(b) <= 0).any():
        raise ValueError("pbc_box diagonal must be positive")
    if np.abs(np.triu(b, 1)).max() > 0:
        raise ValueError(
            "pbc_box must be lower-triangular (GROMACS row convention)"
        )
    return tuple(tuple(float(v) for v in row) for row in b)


def _parse_coordination_params(type_token):
    """``coordination[r0=3.0 n=6 m=12]`` -> Feature kwargs (r0 required;
    n/m optional). The bare token ``coordination`` is rejected — there is
    no meaningful default cutoff."""
    if type_token == "coordination":
        raise ValueError(
            "coordination features in a file need parameters: "
            "coordination[r0=<cutoff> n=<int> m=<int>]"
        )
    if not (type_token.startswith("coordination[")
            and type_token.endswith("]")):
        raise NotImplementedError(f"feature {type_token} not implemented!")
    kw = {}
    names = {"r0": "r0", "n": "nn", "m": "mm", "box": "pbc_box",
             "dmax": "d_max"}
    body = type_token[len("coordination["):-1]
    for tok in body.split():
        if "=" not in tok:
            raise ValueError(f"bad coordination parameter {tok!r} "
                             "(want key=value)")
        key, val = tok.split("=", 1)
        if key not in names:
            raise ValueError(f"unknown coordination parameter {key!r} "
                             "(r0, n, m, box, dmax)")
        if key == "box":
            # orthorhombic lengths, colon-separated (commas split the
            # feature line): box=8:8:8
            try:
                kw["pbc_box"] = [float(v) for v in val.split(":")]
            except ValueError:
                raise ValueError(f"bad box lengths {val!r} "
                                 "(want box=lx:ly:lz)")
        elif key in ("r0", "dmax"):
            kw[names[key]] = float(val)
        else:
            kw[names[key]] = int(val)
    if "r0" not in kw:
        raise ValueError("coordination parameters must include r0=")
    return kw


class FeatureFileReader:
    """Build a list of :class:`Feature` from one section of a feature file.

    :param str feature_file: path to the text config
    :param str section_name: section to read (case sensitive)
    :param universe: universe used to resolve selection strings (duck-typed:
        needs ``select_atoms``)

    The file grammar is the reference's (molann/feature.py:147-195): sections
    are delimited by ``[section_name]`` / ``[End]`` lines; feature lines are
    comma-separated ``name, type, selector[, selector...]``; ``#`` starts a
    comment line; atom groups are built by ``+``-concatenating one selection
    per selector field, preserving selector order.

    Example (runnable; executed by tests/test_docs.py):

    >>> import os, tempfile
    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> path = os.path.join(tempfile.mkdtemp(), "features.txt")
    >>> _ = open(path, "w").write(
    ...     "[Output]\\n"
    ...     "b1, bond, bynum 2 5\\n"
    ...     "d1, dihedral, bynum 5, bynum 7, bynum 9, bynum 15\\n"
    ...     "[End]\\n")
    >>> reader = FeatureFileReader(path, "Output", u)
    >>> feats = reader.read()
    >>> [f.get_name() for f in feats]
    ['b1', 'd1']
    >>> reader.get_num_of_features()
    2
    """

    def __init__(self, feature_file, section_name, universe):
        self.feature_file = feature_file
        self.section_name = section_name
        self.u = universe
        self.feature_list: list[Feature] = []

    def read(self):
        """Parse the file; return the list of features from the first
        matching section (reference molann/feature.py:224-265)."""
        self.feature_list = []
        in_section = False

        with open(self.feature_file, "r") as fh:
            for line in fh:
                line = line.strip()

                if not line or line.startswith("#"):
                    continue

                if line.startswith("["):
                    if line.strip("[]") == self.section_name:
                        in_section = True
                        continue
                    if in_section and line.strip("[]") == "End":
                        break

                if in_section:
                    # Mirrors the reference exactly: a stray header line in a
                    # section has <2 comma fields and raises ValueError here.
                    feature_name, feature_type, *selector_list = line.split(",")
                    ftype = feature_type.strip()
                    if ftype.startswith("coordination"):
                        # extension grammar (no reference counterpart):
                        #   name, coordination[r0=3.0 n=6 m=12], selA[, selB...]
                        # first selector = group A; the rest combine into
                        # group B (none = all pairs within A)
                        params = _parse_coordination_params(ftype)
                        if not selector_list:
                            raise ValueError(
                                f"coordination feature {feature_name.strip()!r}"
                                " needs at least one selector"
                            )
                        ag_a = self.u.select_atoms(selector_list[0])
                        ag_b = None
                        for selector in selector_list[1:]:
                            sel = self.u.select_atoms(selector)
                            ag_b = sel if ag_b is None else ag_b + sel
                        self.feature_list.append(
                            Feature(feature_name.strip(), "coordination",
                                    ag_a, group_b=ag_b, **params)
                        )
                        continue
                    ag = None
                    for selector in selector_list:
                        sel = self.u.select_atoms(selector)
                        ag = sel if ag is None else ag + sel
                    self.feature_list.append(
                        Feature(feature_name.strip(), ftype, ag)
                    )

        return self.feature_list

    def get_feature_list(self):
        """Return the feature list built by :meth:`read`."""
        return self.feature_list

    def get_num_of_features(self):
        """Return the number of features read."""
        return len(self.feature_list)

    def get_feature_info(self):
        """Return a :class:`pandas.DataFrame` with one row per feature
        (reference molann/feature.py:281-290)."""
        import pandas as pd

        df = pd.DataFrame()
        for f in self.feature_list:
            df = pd.concat([df, f.get_feature_info()], ignore_index=True)
        return df
