"""Trajectory reading: one dispatch for every supported input.

The port of ``molann_tpu/io/reader.py``, with the same formats and the same
backend rules: an in-memory array, or a path to ``.npy``, ``.dcd``,
``.trr``, ``.xtc`` or Amber ``.nc`` / ``.ncdf``. ``backend="auto"`` prefers
the native loader (:mod:`.native_loader`, built with ``g++`` at first use)
and falls back to the numpy decoders; ``"native"`` raises if the loader
cannot open the file; ``"numpy"`` takes the numpy decoders only. The
fallback concerns the host's reader, never a kernel or the device.
"""

from __future__ import annotations

import weakref

import numpy as np

__all__ = ["open_frame_reader", "read_traj_boxes"]


def read_traj_boxes(traj):
    """Per-frame box matrices of a trajectory path without decoding any
    coordinates: ``-> [n_frames, 3, 3] float32 or None`` (None for formats
    and files that carry no cell: ``.npy``, cell-less DCD, box-less TRR,
    cell-less Amber ``.nc``; an all-zero XTC or NetCDF box counts as
    none)."""
    low = str(traj).lower()
    if low.endswith(".xtc"):
        from .xdr import scan_xtc_boxes

        boxes = scan_xtc_boxes(traj)
        return None if not boxes.size or not boxes.any() else boxes
    if low.endswith(".trr"):
        from .xdr import scan_trr_boxes

        return scan_trr_boxes(traj)
    if low.endswith(".nc") or low.endswith(".ncdf"):
        from .netcdf import scan_netcdf_boxes

        boxes = scan_netcdf_boxes(traj)
        if boxes is None or not boxes.size or not boxes.any():
            return None
        return boxes
    if low.endswith(".dcd"):
        from .dcd import scan_dcd_cells

        cells = scan_dcd_cells(traj)
        if cells is None or not len(cells):
            return None
        from ..pbc import dcd_cell_to_box

        return dcd_cell_to_box(cells)
    return None


def _with_close(read, closer=None):
    """Attach a ``close`` attribute to a read callable (a no-op where the
    source holds no file or map)."""
    read.close = closer if closer is not None else (lambda: None)
    return read


def _frames_3d(arr, what):
    if arr.ndim == 2 and arr.shape[1] % 3 == 0:  # packed [l, 3n]
        arr = arr.reshape(arr.shape[0], -1, 3)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"{what} has shape {np.shape(arr)}; expected "
                         "[n_frames, n_atoms, 3] or packed [n_frames, 3n]")
    return arr


def open_frame_reader(traj, *, backend="auto"):
    """-> ``(read, n_frames, n_atoms)`` with
    ``read(start, count) -> [count, n_atoms, 3] float32`` numpy (writable:
    each read copies its frames out of the file or map).

    Every returned ``read`` has a ``read.close()`` that releases the file
    or map the reader holds (a no-op for an in-memory array); a
    ``weakref.finalize`` closes NetCDF readers at collection regardless.

    ``traj``: an in-memory ``[l, n, 3]`` (or packed ``[l, 3n]``) array, or a
    path to ``.npy`` / ``.dcd`` / ``.trr`` / ``.xtc`` / ``.nc`` / ``.ncdf``.
    ``.npy`` and ``.nc`` files are memory-mapped by the numpy readers, so
    opening is cheap at any size; the DCD, TRR and XTC numpy decoders read
    the whole file at open. ``backend``: ``"auto"`` (the native loader, else
    the numpy decoders), ``"native"`` (the native loader or an error) or
    ``"numpy"``. An in-memory array never reaches a loader.
    """
    if backend not in ("auto", "native", "numpy"):
        raise ValueError(f"backend must be auto/native/numpy, "
                         f"got {backend!r}")
    if isinstance(traj, np.ndarray) or hasattr(traj, "shape"):
        arr = _frames_3d(np.asarray(traj, dtype=np.float32), "trajectory")
        return (_with_close(lambda s, c: arr[s:s + c]), arr.shape[0],
                arr.shape[1])

    if backend in ("auto", "native"):
        try:
            from .native_loader import NativeTrajLoader

            ldr = NativeTrajLoader(traj)
        except (OSError, RuntimeError):
            if backend == "native":
                raise
        else:
            n_atoms = ldr.n_atoms

            def read(s, c):
                return ldr.read_range(s, c).reshape(c, n_atoms, 3)

            return _with_close(read, ldr.close), ldr.n_frames, n_atoms

    low = str(traj).lower()
    if low.endswith(".nc") or low.endswith(".ncdf"):
        from .netcdf import NetCDFReader

        r = NetCDFReader(traj)  # mmap-backed: lazy random access

        def read(s, c, _r=r):
            return np.array(_r.read(s, c), np.float32)

        weakref.finalize(read, r.close)
        return _with_close(read, r.close), r.n_frames, r.n_atoms
    if low.endswith(".dcd"):
        from .dcd import read_dcd

        frames = read_dcd(traj)[0]
    elif low.endswith(".trr"):
        from .xdr import read_trr

        frames = read_trr(traj)[0]
    elif low.endswith(".xtc"):
        from .xdr import read_xtc

        frames = read_xtc(traj)[0]
    else:
        frames = _frames_3d(np.load(traj, mmap_mode="r"),
                            f"trajectory {traj}")
    # np.array copies out of a read-only map: torch takes writable arrays
    return (_with_close(lambda s, c: np.array(frames[s:s + c], np.float32)),
            frames.shape[0], frames.shape[1])
