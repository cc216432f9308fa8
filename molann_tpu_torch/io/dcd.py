"""Pure-Python DCD support: a writer (for conversion/tests) and a reader
(fallback oracle for the native loader).

Carried over from ``molann_tpu/io/dcd.py`` (numpy and ``struct`` only;
importing the JAX package would import JAX): the writer writes the same
bytes, default title included, and the reader reads the same arrays.

DCD is the CHARMM/NAMD/X-PLOR binary trajectory format: Fortran
sequential-access records (``[int32 len][payload][int32 len]``), a 84-byte
``CORD`` control record, a title record, a NATOM record, then per frame an
optional unit-cell record (6 doubles, CHARMM) and X/Y/Z coordinate planes
of NATOM float32 each. The native loader (csrc/traj_loader.cpp) mmaps
and gathers these at C speed; this module is the slow-but-dependency-free
counterpart. Fixed-atom (NAMNF != 0) and big-endian files are rejected,
matching the native reader.

The reference has no trajectory IO at all (its forward takes an in-memory
tensor); DCD support exists because MD users' trajectories arrive in it.
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["write_dcd", "read_dcd", "DCDWriter"]


def _rec(payload: bytes) -> bytes:
    n = struct.pack("<i", len(payload))
    return n + payload + n


class DCDWriter:
    """Incremental DCD writer: frames are appended chunk by chunk (bounded
    memory for ``python -m molann_tpu_torch convert``). The header's frame count (NSET/
    NSTEP) is back-patched on :meth:`close` with the number of frames
    actually appended, so callers need not know the total upfront.
    ``has_cell`` fixes whether per-frame unit-cell records are written
    (the CHARMM flag lives in the header, so it cannot vary per chunk)."""

    def __init__(self, path, *, title="written by molann_tpu",
                 has_cell=False):
        self._fh = open(path, "wb")
        self._has_cell = has_cell
        self._n_atoms = None
        self._n_frames = 0
        icntrl = [0] * 20
        icntrl[1] = 1                 # ISTART
        icntrl[2] = 1                 # NSAVC
        icntrl[10] = 1 if has_cell else 0  # unit-cell flag
        icntrl[19] = 24               # CHARMM version
        header = b"CORD" + struct.pack("<20i", *icntrl)
        assert len(header) == 84
        tpad = title.encode()[:80].ljust(80)
        self._fh.write(_rec(header))
        self._fh.write(_rec(struct.pack("<i", 1) + tpad))

    def append(self, frames, cell=None):
        """Append ``[k, n_atoms, 3]`` frames (atom count must match the
        first chunk); ``cell``: ``[k, 6]`` doubles, required iff the
        writer was opened with ``has_cell=True``."""
        arr = np.ascontiguousarray(frames, dtype=np.float32)
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(
                f"expected [n_frames, n_atoms, 3], got {arr.shape}")
        k, n_atoms = arr.shape[0], arr.shape[1]
        if (cell is not None) != self._has_cell:
            raise ValueError(
                "cell must be given exactly when the writer has "
                f"has_cell={self._has_cell}")
        if cell is not None:
            cell = np.ascontiguousarray(cell, dtype=np.float64)
            if cell.shape != (k, 6):
                raise ValueError(f"cell must be [{k}, 6], got {cell.shape}")
        if self._n_atoms is None:
            self._n_atoms = n_atoms
            self._fh.write(_rec(struct.pack("<i", n_atoms)))
        elif n_atoms != self._n_atoms:
            raise ValueError(
                f"atom count changed mid-file ({self._n_atoms} -> {n_atoms})"
            )
        fh = self._fh
        for f in range(k):
            if cell is not None:
                fh.write(_rec(cell[f].tobytes()))
            for c in range(3):
                fh.write(_rec(np.ascontiguousarray(arr[f, :, c]).tobytes()))
        self._n_frames += k

    def close(self):
        if self._fh is None:
            return
        if self._n_atoms is None:
            # zero chunks appended: the mandatory NATOM record was never
            # written — emit it (0 atoms) so the file stays structurally
            # valid for readers
            self._fh.write(_rec(struct.pack("<i", 0)))
        # back-patch NSET (icntrl[0]) and NSTEP (icntrl[3]); both sit
        # inside the first record: 4 (reclen) + 4 (CORD) + i*4
        self._fh.seek(4 + 4 + 0 * 4)
        self._fh.write(struct.pack("<i", self._n_frames))
        self._fh.seek(4 + 4 + 3 * 4)
        self._fh.write(struct.pack("<i", self._n_frames))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_dcd(path, frames, *, title="written by molann_tpu", cell=None):
    """Write ``[n_frames, n_atoms, 3]`` float32 frames as a CHARMM DCD.

    cell: optional ``[n_frames, 6]`` unit-cell doubles (CHARMM convention);
    when given the CHARMM unit-cell flag is set and one cell record is
    written per frame.
    """
    with DCDWriter(path, title=title, has_cell=cell is not None) as w:
        w.append(frames, cell=cell)
    return path


def scan_dcd_cells(path):
    """Per-frame unit-cell records of a DCD without decoding coordinates:
    ``-> [n_frames, 6] float64 or None`` (None when the file has no cell
    flag). Seek walk over the fixed-size records — see
    :func:`molann_tpu_torch.io.xdr.scan_xtc_boxes` for the rationale."""
    with open(path, "rb") as fh:
        def rec_skip(read_payload=False):
            head = fh.read(4)
            if not head:
                return None
            (n,) = struct.unpack("<i", head)
            payload = fh.read(n) if read_payload else fh.seek(n, 1)
            tail = fh.read(4)
            if len(tail) < 4 or struct.unpack("<i", tail)[0] != n:
                raise ValueError("corrupt DCD record")
            return payload if read_payload else n

        header = rec_skip(read_payload=True)
        if header is None or header[:4] != b"CORD":
            raise ValueError("not a coordinate DCD")
        icntrl = struct.unpack("<20i", header[4:84])
        if icntrl[19] == 0 or icntrl[10] == 0:
            return None
        rec_skip()  # title
        rec_skip()  # natoms
        cells = []
        while True:
            c = rec_skip(read_payload=True)
            if c is None:
                break
            cells.append(np.frombuffer(c, dtype="<f8"))
            for _ in range(3):  # x/y/z planes
                if rec_skip() is None:
                    raise ValueError("truncated DCD frame")
        return np.asarray(cells)


def read_dcd(path):
    """Read a (little-endian, no-fixed-atoms) DCD: returns
    ``(frames [n_frames, n_atoms, 3] float32, cell or None)``."""
    with open(path, "rb") as fh:
        data = fh.read()

    def rec(off):
        (n,) = struct.unpack_from("<i", data, off)
        payload = data[off + 4 : off + 4 + n]
        (n2,) = struct.unpack_from("<i", data, off + 4 + n)
        if n2 != n:
            raise ValueError(f"corrupt record at offset {off}")
        return payload, off + 8 + n

    header, off = rec(0)
    if header[:4] != b"CORD":
        raise ValueError("not a coordinate DCD")
    icntrl = struct.unpack("<20i", header[4:84])
    if icntrl[8] != 0:
        raise ValueError("fixed-atom DCD files are not supported")
    has_cell = icntrl[19] != 0 and icntrl[10] != 0
    _, off = rec(off)  # title
    natoms_rec, off = rec(off)
    (n_atoms,) = struct.unpack("<i", natoms_rec)

    frames, cells = [], []
    while off + 8 <= len(data):
        try:
            if has_cell:
                c, off = rec(off)
                cells.append(np.frombuffer(c, dtype="<f8"))
            planes = []
            for _ in range(3):
                p, off = rec(off)
                planes.append(np.frombuffer(p, dtype="<f4"))
            frames.append(np.stack(planes, axis=1))
        except (ValueError, struct.error):
            break
    if frames:
        out = np.asarray(frames, dtype=np.float32)
    else:
        out = np.zeros((0, n_atoms, 3), np.float32)
    return out, (np.asarray(cells) if has_cell else None)
