"""A differentiable toy internal-coordinate force field for demos/tests
(the port of ``molann_tpu/sampling/potentials.py``).

Built at construction time (host numpy) from a Universe's geometry:

- **bonds**: every atom pair closer than ``bond_cutoff`` gets a harmonic
  restraint to its reference length;
- **1-3 pairs**: second-neighbor distances restrained (encodes angles
  without ``acos`` edge cases);
- **torsions**: every bonded path ``i-j-k-l`` restrained to its reference
  ``(cos, sin)`` — EXCEPT torsions sharing the free torsion's central
  bond, which must rotate with it;
- **the free torsion** gets a double well
  ``barrier/2 * (1 - cos 2(phi - phi_ref))``: minima at the reference
  angle and at ``phi_ref + pi``, barrier height ``barrier`` in between.

Every term is a function of internal coordinates (the port's feature math,
:mod:`molann_tpu_torch.ops.features`), so the potential is rigid-motion
invariant and differentiable by autograd. The index tables and reference
values are put on a device once, at the first energy evaluated there.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.features import bond_features, dihedral_features
from .langevin import _DeviceTables, _tensor

__all__ = ["ToyPeptidePotential", "LennardJonesPotential"]


def _bond_graph(pos: np.ndarray, cutoff: float):
    """Adjacency from a distance cutoff (Å); fixture geometries have all
    covalent pairs < 1.8 and all non-bonded pairs well above."""
    n = len(pos)
    d = np.linalg.norm(pos[:, None, :] - pos[None, :, :], axis=-1)
    adj = [[] for _ in range(n)]
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            if d[i, j] < cutoff:
                adj[i].append(j)
                adj[j].append(i)
                pairs.append((i, j))
    return adj, pairs, d


class LennardJonesPotential:
    """Periodic all-pairs Lennard-Jones fluid, ``energy(x: [l, n, 3]) ->
    [l]`` — the condensed-phase stand-in MD engine (pairs with
    :func:`molann_tpu_torch.systems.lj_fluid`).

    ``4 eps ((sigma/r)^12 - (sigma/r)^6)`` over all atom pairs with
    minimum-image distances under a static orthorhombic box, truncated
    and energy-shifted at ``cutoff`` (default: half the shortest box
    side).

    :param n_atoms: number of atoms (pair table built at construction)
    :param box: ``[3]`` orthorhombic box lengths
    :param sigma: LJ length scale; a cubic lattice of spacing ``a`` sits
        near the minimum when ``sigma ≈ a / 2**(1/6)``
    """

    def __init__(self, n_atoms, box, *, epsilon=1.0, sigma=1.0,
                 cutoff=None):
        n = int(n_atoms)
        self.pair_idx = np.asarray(
            [(i, j) for i in range(n) for j in range(i + 1, n)],
            dtype=np.int32,
        ).reshape(-1, 2)
        box = np.asarray(box, dtype=np.float64)
        if box.shape != (3,) or (box <= 0).any():
            raise ValueError(
                f"box must be 3 positive orthorhombic lengths, got {box!r}"
            )
        self.box = tuple(float(b) for b in box)
        self.epsilon = float(epsilon)
        self.sigma = float(sigma)
        rc = float(cutoff) if cutoff is not None else 0.5 * float(box.min())
        if not 0.0 < rc <= 0.5 * float(box.min()):
            raise ValueError(
                f"cutoff {rc} must be in (0, half the shortest box side] "
                f"(minimum image sees one periodic copy per pair)"
            )
        self.cutoff = rc
        s6 = (self.sigma / rc) ** 6
        self._shift = 4.0 * self.epsilon * (s6 * s6 - s6)
        self._tables = _DeviceTables(
            i0=self.pair_idx[:, 0].astype(np.int64),
            i1=self.pair_idx[:, 1].astype(np.int64),
            box=np.asarray(self.box, np.float32))

    def energy(self, x):
        """Total energy, ``[l, n, 3] -> [l]``."""
        x = _tensor(x)
        t = self._tables.on(x.device)
        d = x[:, t["i1"], :] - x[:, t["i0"], :]
        L = t["box"]
        d = d - torch.round(d / L) * L
        r2 = torch.sum(d * d, dim=-1)
        inside = r2 < self.cutoff * self.cutoff
        # keep r2 strictly positive for the r -> 0 pole: autograd of where
        # still differentiates the untaken branch
        safe_r2 = torch.clamp(r2, min=1e-12)
        inv6 = (self.sigma * self.sigma / safe_r2) ** 3
        e = 4.0 * self.epsilon * (inv6 * inv6 - inv6) - self._shift
        return torch.sum(torch.where(inside, e, torch.zeros_like(e)), dim=-1)

    __call__ = energy


class ToyPeptidePotential:
    """``energy(x: [l, n, 3]) -> [l]`` toy force field with one free
    torsion in a double well.

    :param universe: topology (duck-typed ``.atoms.positions``)
    :param free_torsion: 0-based atom quadruple whose dihedral is left
        free in a double well (default: the alanine phi backbone
        dihedral, atoms 5-7-9-15 1-based)
    :param barrier: double-well barrier height (energy units; ``kT`` in
        the integrator is in the same units)
    """

    def __init__(self, universe, free_torsion=(4, 6, 8, 14), *,
                 bond_cutoff=1.8, k_bond=200.0, k_13=50.0, k_torsion=5.0,
                 barrier=6.0):
        pos = np.asarray(universe.atoms.positions, dtype=np.float32)
        adj, bonds, dist = _bond_graph(pos, bond_cutoff)
        free = tuple(int(a) for a in free_torsion)
        axis = frozenset(free[1:3])

        pairs_13 = set()
        for j in range(len(pos)):
            nb = adj[j]
            for a in range(len(nb)):
                for b in range(a + 1, len(nb)):
                    pairs_13.add((min(nb[a], nb[b]), max(nb[a], nb[b])))
        pairs_13 -= set(bonds)

        torsions = []
        for (j, k) in bonds:
            for jk in ((j, k), (k, j)):
                jj, kk = jk
                if frozenset(jk) == axis:
                    continue  # rotates with the free torsion: leave free
                for i in adj[jj]:
                    if i == kk:
                        continue
                    for l in adj[kk]:
                        if l == jj or l == i:
                            continue
                        t = (i, jj, kk, l)
                        if t[::-1] not in torsions:
                            torsions.append(t)

        self.free_torsion = np.asarray([free], dtype=np.int32)
        self.bond_idx = np.asarray(bonds, dtype=np.int32)
        self.pair13_idx = np.asarray(sorted(pairs_13), dtype=np.int32)
        self.torsion_idx = np.asarray(torsions, dtype=np.int32)
        self.k_bond = float(k_bond)
        self.k_13 = float(k_13)
        self.k_torsion = float(k_torsion)
        self.barrier = float(barrier)

        def np_dist(idx):
            return np.linalg.norm(
                pos[idx[:, 1]] - pos[idx[:, 0]], axis=-1
            ).astype(np.float32)

        def np_dihedral(idx):
            r12 = pos[idx[:, 1]] - pos[idx[:, 0]]
            r23 = pos[idx[:, 2]] - pos[idx[:, 1]]
            r34 = pos[idx[:, 3]] - pos[idx[:, 2]]
            n1 = np.cross(r12, r23)
            n2 = np.cross(r23, r34)
            cos_phi = np.sum(n1 * n2, axis=-1)
            sin_phi = np.sum(n1 * r34, axis=-1) * np.linalg.norm(
                r23, axis=-1
            )
            return cos_phi, sin_phi

        self.bond_ref = torch.as_tensor(np_dist(self.bond_idx))
        self.pair13_ref = torch.as_tensor(np_dist(self.pair13_idx))
        tc, ts = np_dihedral(self.torsion_idx)
        rho = np.sqrt(tc * tc + ts * ts)
        self.torsion_ref = torch.as_tensor(
            np.stack([tc / rho, ts / rho], axis=-1).astype(np.float32)
        )
        fc, fs = np_dihedral(self.free_torsion)
        self.phi_ref = float(np.arctan2(fs[0], fc[0]))
        self._tables = _DeviceTables(
            free=self.free_torsion.astype(np.int64),
            bond=self.bond_idx.astype(np.int64),
            pair13=self.pair13_idx.astype(np.int64),
            torsion=self.torsion_idx.astype(np.int64),
            bond_ref=self.bond_ref.numpy(),
            pair13_ref=self.pair13_ref.numpy(),
            torsion_ref=self.torsion_ref.numpy())

    def phi(self, x):
        """The free torsion's angle, ``[l, n, 3] -> [l]`` (radians)."""
        x = _tensor(x)
        t = self._tables.on(x.device)
        return dihedral_features(x, t["free"], True)[:, 0]

    def energy(self, x):
        """Total energy, ``[l, n, 3] -> [l]``."""
        x = _tensor(x)
        t = self._tables.on(x.device)
        eb = torch.sum((bond_features(x, t["bond"]) - t["bond_ref"]) ** 2,
                       dim=-1)
        e13 = torch.sum(
            (bond_features(x, t["pair13"]) - t["pair13_ref"]) ** 2, dim=-1)
        et = torch.sum(
            (dihedral_features(x, t["torsion"], False) - t["torsion_ref"])
            ** 2, dim=(-1, -2))
        phi = dihedral_features(x, t["free"], True)[:, 0]
        edw = 0.5 * self.barrier * (1.0 - torch.cos(2.0 * (phi - self.phi_ref)))
        return (
            self.k_bond * eb + self.k_13 * e13 + self.k_torsion * et + edw
        )

    __call__ = energy
