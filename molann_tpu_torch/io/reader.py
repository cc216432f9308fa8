"""Trajectory reading for the port's serving path.

Port of ``molann_tpu/io/reader.py:62-156`` for the inputs the serving path
takes today: an in-memory array and a ``.npy`` file (memory-mapped, so
opening is cheap at any size). DCD, TRR, XTC and Amber NetCDF readers and
the native loader are still to be ported (ROADMAP.md, queue 2, item 4);
asking for them raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

__all__ = ["open_frame_reader"]

_NOT_PORTED = (".dcd", ".trr", ".xtc", ".nc", ".ncdf")


def _frames_3d(arr, what):
    if arr.ndim == 2 and arr.shape[1] % 3 == 0:  # packed [l, 3n]
        arr = arr.reshape(arr.shape[0], -1, 3)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"{what} has shape {np.shape(arr)}; expected "
                         "[n_frames, n_atoms, 3] or packed [n_frames, 3n]")
    return arr


def open_frame_reader(traj):
    """-> ``(read, n_frames, n_atoms)`` with
    ``read(start, count) -> [count, n_atoms, 3] float32`` numpy.

    ``traj``: an in-memory ``[l, n, 3]`` (or packed ``[l, 3n]``) array, or
    a path to a ``.npy`` file (memory-mapped; each read copies its frames
    out of the map).
    """
    if isinstance(traj, np.ndarray) or hasattr(traj, "shape"):
        arr = _frames_3d(np.asarray(traj, dtype=np.float32), "trajectory")
        return (lambda s, c: arr[s:s + c]), arr.shape[0], arr.shape[1]
    low = str(traj).lower()
    if low.endswith(_NOT_PORTED):
        raise NotImplementedError(
            f"reading {traj} is not ported to molann_tpu_torch yet "
            "(ROADMAP.md, queue 2: trajectory IO); convert it to .npy")
    frames = _frames_3d(np.load(traj, mmap_mode="r"), f"trajectory {traj}")
    # np.array copies out of the read-only map: torch takes writable arrays
    return ((lambda s, c: np.array(frames[s:s + c], np.float32)),
            frames.shape[0], frames.shape[1])
