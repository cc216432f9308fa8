"""Periodic-cell helpers the port's topology front-end needs.

Only :func:`dcd_cell_to_box` is carried over from ``molann_tpu/pbc.py``
(numpy only): the PDB reader turns a ``CRYST1`` record into a box matrix
with it. Wrapping and making molecules whole are still to be ported
(ROADMAP.md, queue 2).
"""

from __future__ import annotations

import numpy as np

__all__ = ["dcd_cell_to_box"]


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
