"""Amber NetCDF trajectory codec (NetCDF-3 classic, pure Python).

Carried over from ``molann_tpu/io/netcdf.py`` (numpy, ``struct`` and
``mmap`` only): the writer writes the same bytes, its ``program`` and
default ``title`` attributes included, and the reader reads the same
arrays.

Implements exactly the subset of the NetCDF classic file format (CDF-1
and CDF-2 / 64-bit-offset variants) that the AMBER trajectory
convention uses: big-endian header with dimension/attribute/variable
lists, fixed variables stored once, record variables interleaved along
the unlimited ``frame`` dimension. The reference library has no
trajectory IO at all (SURVEY.md §2.3 — its forward takes an in-memory
tensor); this codec exists because AMBER users' frames arrive as
``.nc`` files.

Unlike the XTC/TRR codecs (validated against committed spec-walk byte
fixtures), this one has an independent in-environment oracle: scipy's
``scipy.io.netcdf_file`` is a separate NetCDF-3 implementation, and
the JAX package's tests/test_netcdf.py cross-check both directions (our writer -> scipy
reader, scipy writer -> our reader), so reader and writer cannot share
a correlated misreading of the format.

Conventions followed (AMBER trajectory convention 1.0):
  dimensions  frame (unlimited), spatial=3, atom=n
              [+ cell_spatial=3, cell_angular=3, label=5 when boxed]
  variables   time [frame] float32 ps; coordinates [frame, atom,
              spatial] float32 Angstrom; cell_lengths [frame,
              cell_spatial] float64 Angstrom; cell_angles [frame,
              cell_angular] float64 degree
A ``scale_factor`` attribute on ``coordinates``/``cell_lengths`` is
applied on read (MDAnalysis semantics).
"""

from __future__ import annotations

import mmap
import struct

import numpy as np

__all__ = [
    "NetCDFReader",
    "NetCDFWriter",
    "read_netcdf",
    "scan_netcdf_boxes",
    "write_netcdf",
]

_ABSENT = (0, 0)
_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C

# nc_type -> (numpy dtype, size in bytes)
_NC_TYPES = {
    1: ("b", 1),    # NC_BYTE
    2: ("S1", 1),   # NC_CHAR
    3: (">i2", 2),  # NC_SHORT
    4: (">i4", 4),  # NC_INT
    5: (">f4", 4),  # NC_FLOAT
    6: (">f8", 8),  # NC_DOUBLE
}

_STREAMING = 0xFFFFFFFF  # numrecs sentinel: "count records from file size"


def _pad4(n: int) -> int:
    return (n + 3) & ~3


# ---------------------------------------------------------------------------
# Header parsing
# ---------------------------------------------------------------------------


class _Var:
    __slots__ = ("name", "dimids", "attrs", "nc_type", "begin", "is_record",
                 "shape", "_per_rec")

    def __init__(self, name, dimids, attrs, nc_type, begin):
        self.name = name
        self.dimids = dimids
        self.attrs = attrs
        self.nc_type = nc_type
        self.begin = begin
        self.is_record = False
        self.shape = ()


class _HeaderParser:
    """Walks the big-endian classic-format header of ``buf``."""

    def __init__(self, buf):
        self.buf = buf
        self.off = 0

    def _take(self, n):
        if self.off + n > len(self.buf):
            raise ValueError("truncated NetCDF header")
        out = self.buf[self.off : self.off + n]
        self.off += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def u4(self) -> int:
        return struct.unpack(">I", self._take(4))[0]

    def i8(self) -> int:
        return struct.unpack(">q", self._take(8))[0]

    def name(self) -> str:
        n = self.i4()
        if n < 0 or n > 1 << 20:
            raise ValueError(f"corrupt NetCDF name length {n}")
        raw = self._take(_pad4(n))[:n]
        return raw.decode("utf-8", errors="replace")

    def tagged_count(self, expect_tag) -> int:
        tag, count = self.i4(), self.i4()
        if (tag, count) == _ABSENT:
            return 0
        if tag != expect_tag or count < 0:
            raise ValueError(f"corrupt NetCDF list tag {tag}/{count}")
        return count

    def attrs(self) -> dict:
        out = {}
        for _ in range(self.tagged_count(_NC_ATTRIBUTE)):
            nm = self.name()
            nc_type = self.i4()
            nelems = self.i4()
            if nc_type not in _NC_TYPES or nelems < 0:
                raise ValueError(f"corrupt NetCDF attribute {nm!r}")
            dt, sz = _NC_TYPES[nc_type]
            raw = self._take(_pad4(nelems * sz))[: nelems * sz]
            if nc_type == 2:
                out[nm] = raw.decode("utf-8", errors="replace")
            else:
                vals = np.frombuffer(raw, dtype=dt)
                out[nm] = vals[0] if nelems == 1 else vals
        return out


def _parse_header(buf):
    """-> (version, numrecs, dims [(name, size)], gattrs, vars
    {name: _Var}, header_end) — sizes/begins validated but record
    geometry (shapes, recsize) is resolved by the caller."""
    if len(buf) < 8 or buf[:3] != b"CDF":
        raise ValueError("not a NetCDF classic file (bad magic)")
    version = buf[3]
    if version not in (1, 2):
        raise ValueError(
            f"unsupported NetCDF variant {version} (only classic CDF-1/"
            "CDF-2; NetCDF-4/HDF5 files need the netCDF4 library)")
    p = _HeaderParser(buf)
    p.off = 4
    numrecs = p.u4()
    dims = []
    for _ in range(p.tagged_count(_NC_DIMENSION)):
        nm = p.name()
        size = p.i4()
        if size < 0:
            raise ValueError(f"corrupt NetCDF dimension {nm!r}")
        dims.append((nm, size))
    gattrs = p.attrs()
    variables = {}
    for _ in range(p.tagged_count(_NC_VARIABLE)):
        nm = p.name()
        ndims = p.i4()
        if ndims < 0 or ndims > 32:
            raise ValueError(f"corrupt NetCDF variable {nm!r}")
        dimids = [p.i4() for _ in range(ndims)]
        vattrs = p.attrs()
        nc_type = p.i4()
        p.i4()  # vsize: recomputed from dims/types below (some writers
        # store it with, some without, tail padding — never trust it)
        begin = p.i8() if version == 2 else p.u4()
        if nc_type not in _NC_TYPES:
            raise ValueError(f"unsupported nc_type {nc_type} on {nm!r}")
        if any(d < 0 or d >= len(dims) for d in dimids):
            raise ValueError(f"corrupt dimension ids on {nm!r}")
        variables[nm] = _Var(nm, dimids, vattrs, nc_type, begin)
    return version, numrecs, dims, gattrs, variables, p.off


class NetCDFReader:
    """Random-access AMBER NetCDF trajectory reader (context manager).

    Exposes ``n_frames``, ``n_atoms``, ``read(start, count) ->
    [count, n_atoms, 3] float32`` and ``boxes() -> [n_frames, 3, 3]
    float32 or None`` over a memory-mapped file — opening is cheap
    regardless of trajectory size.
    """

    def __init__(self, path):
        self._fh = open(path, "rb")
        try:
            self._mm = mmap.mmap(self._fh.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:
            self._fh.close()
            raise ValueError(f"{path}: empty file")
        try:
            self._parse(path)
        except Exception:
            self.close()
            raise

    def _parse(self, path):
        (_, numrecs, dims, _, variables, _) = _parse_header(self._mm)
        rec_dim = next((i for i, (_, sz) in enumerate(dims) if sz == 0), None)
        # Resolve shapes + classify record variables (in header order —
        # the order fixes their interleaving within a record slot).
        self._recsize = 0
        rec_vars = []
        for v in variables.values():
            sizes = [dims[d][1] for d in v.dimids]
            v.is_record = rec_dim is not None and v.dimids[:1] == [rec_dim]
            v.shape = tuple(sizes[1:] if v.is_record else sizes)
            if v.is_record:
                per_rec = _NC_TYPES[v.nc_type][1] * int(
                    np.prod(v.shape, dtype=np.int64))
                v._per_rec = per_rec
                rec_vars.append(v)
                self._recsize += _pad4(per_rec)
        if len(rec_vars) == 1:  # classic-format special rule: no padding
            self._recsize = rec_vars[0]._per_rec
        coords = variables.get("coordinates")
        if coords is None or not coords.is_record:
            raise ValueError(
                f"{path}: no record 'coordinates' variable (not an AMBER "
                "trajectory convention file)")
        if len(coords.shape) != 2 or coords.shape[1] != 3:
            raise ValueError(
                f"{path}: coordinates has per-frame shape {coords.shape}; "
                "expected [atom, 3]")
        n_atoms = coords.shape[0]
        if n_atoms <= 0:
            raise ValueError(f"{path}: non-positive atom count {n_atoms}")
        if numrecs == _STREAMING:  # infer from file size: records start
            # at the FIRST record variable's offset
            rec0 = min(v.begin for v in rec_vars)
            numrecs = max(0, (len(self._mm) - rec0) // self._recsize)
        need = max(v.begin + (numrecs - 1) * self._recsize + v._per_rec
                   for v in rec_vars)
        if numrecs > 0 and need > len(self._mm):
            raise ValueError(
                f"{path}: truncated NetCDF ({len(self._mm)} bytes; header "
                f"promises {need})")
        self.n_frames = int(numrecs)
        self.n_atoms = int(n_atoms)
        self._vars = variables
        self._coords = coords
        self._scale = np.float32(coords.attrs.get("scale_factor", 1.0))

    # -- data access -------------------------------------------------------

    def _record_series(self, var):
        """All records of one record variable as ``[n_frames, *shape]``."""
        dt, _ = _NC_TYPES[var.nc_type]
        n = int(np.prod(var.shape, dtype=np.int64))
        out = np.empty((self.n_frames, n), dtype=dt)
        for f in range(self.n_frames):
            out[f] = np.frombuffer(self._mm, dtype=dt, count=n,
                                   offset=var.begin + f * self._recsize)
        return out.reshape((self.n_frames,) + var.shape)

    def read(self, start, count):
        if start < 0 or count < 0 or start + count > self.n_frames:
            raise ValueError(
                f"frame range [{start}, {start + count}) out of "
                f"[0, {self.n_frames})")
        v = self._coords
        n = 3 * self.n_atoms
        out = np.empty((count, n), dtype=np.float32)
        dt, _ = _NC_TYPES[v.nc_type]
        for i in range(count):
            off = v.begin + (start + i) * self._recsize
            out[i] = np.frombuffer(self._mm, dtype=dt, count=n, offset=off)
        if self._scale != 1.0:
            out *= self._scale
        return out.reshape(count, self.n_atoms, 3)

    def frames_at(self, idx):
        """Gather arbitrary frames: ``[len(idx), n_atoms, 3] float32``.
        Contiguous runs in ``idx`` are read with one :meth:`read` call
        each, so sorted batches (the shuffled-iterator access pattern)
        touch the mmap in order."""
        idx = np.asarray(idx, dtype=np.int64).reshape(-1)
        out = np.empty((len(idx), self.n_atoms, 3), dtype=np.float32)
        i = 0
        while i < len(idx):
            j = i + 1
            while j < len(idx) and idx[j] == idx[j - 1] + 1:
                j += 1
            out[i:j] = self.read(int(idx[i]), j - i)
            i = j
        return out

    def times(self):
        """``[n_frames] float64`` times, or None when the file has none."""
        t = self._vars.get("time")
        if t is None or not t.is_record or t.shape != ():
            return None
        out = self._record_series(t).reshape(-1).astype(np.float64)
        # MDAnalysis NCDF semantics: scale_factor applies to ANY
        # variable carrying it, not just coordinates.
        return out * float(t.attrs.get("scale_factor", 1.0))

    def boxes(self):
        """``[n_frames, 3, 3] float32`` box matrices from cell_lengths/
        cell_angles, or None when the file carries no cell."""
        ln = self._vars.get("cell_lengths")
        an = self._vars.get("cell_angles")
        if ln is None or an is None or not (ln.is_record and an.is_record):
            return None
        if ln.shape != (3,) or an.shape != (3,):
            raise ValueError("corrupt cell_lengths/cell_angles shapes")
        lengths = self._record_series(ln).astype(np.float64)
        lengths *= float(ln.attrs.get("scale_factor", 1.0))
        angles = self._record_series(an).astype(np.float64)
        angles *= float(an.attrs.get("scale_factor", 1.0))
        from ..pbc import dcd_cell_to_box

        # (A, gamma, B, beta, alpha, C) in degrees — the DCD-record
        # layout dcd_cell_to_box auto-detects (degrees > 1).
        rec = np.stack([lengths[:, 0], angles[:, 2], lengths[:, 1],
                        angles[:, 1], angles[:, 0], lengths[:, 2]], axis=1)
        return dcd_cell_to_box(rec)

    def close(self):
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
            self._mm = None
        if getattr(self, "_fh", None) is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_netcdf(path):
    """Read an AMBER NetCDF trajectory: returns ``(frames [l, n, 3]
    float32, times [l] float64 or None, boxes [l, 3, 3] float32 or
    None)`` — the same tuple convention as :func:`read_trr`."""
    with NetCDFReader(path) as r:
        return r.read(0, r.n_frames), r.times(), r.boxes()


def scan_netcdf_boxes(path):
    """Per-frame box matrices of a ``.nc`` trajectory without decoding
    any coordinates (header walk + 48 bytes per frame)."""
    with NetCDFReader(path) as r:
        return r.boxes()


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------


def _nc_name(s: str) -> bytes:
    raw = s.encode()
    return struct.pack(">i", len(raw)) + raw.ljust(_pad4(len(raw)), b"\x00")


def _nc_attr(name: str, value) -> bytes:
    if isinstance(value, str):
        raw = value.encode()
        return (_nc_name(name) + struct.pack(">ii", 2, len(raw))
                + raw.ljust(_pad4(len(raw)), b"\x00"))
    arr = np.asarray(value)
    nc_type = {np.dtype(">f4"): 5, np.dtype(">f8"): 6,
               np.dtype(">i4"): 4}[arr.dtype.newbyteorder(">")]
    raw = arr.astype(arr.dtype.newbyteorder(">")).tobytes()
    return (_nc_name(name) + struct.pack(">ii", nc_type, arr.size)
            + raw.ljust(_pad4(len(raw)), b"\x00"))


def _nc_attrs(attrs: dict) -> bytes:
    if not attrs:
        return struct.pack(">ii", 0, 0)
    out = struct.pack(">ii", _NC_ATTRIBUTE, len(attrs))
    for k, v in attrs.items():
        out += _nc_attr(k, v)
    return out


class NetCDFWriter:
    """Incremental AMBER NetCDF trajectory writer (CDF-1): frames are
    appended chunk by chunk (bounded memory for ``python -m molann_tpu_torch convert``);
    the header's record count is back-patched on :meth:`close` with the
    number of frames actually appended, so callers need not know the
    total upfront. ``with_box`` fixes whether per-frame cell records
    are written (the variable list lives in the header, so it cannot
    vary per chunk). Coordinates/box are Angstrom, per the convention.
    """

    def __init__(self, path, *, title="written by molann_tpu",
                 with_box=False, dt=1.0):
        self._fh = open(path, "wb")
        self._title = title
        self._with_box = bool(with_box)
        self._dt = float(dt)
        self._n_atoms = None
        self._n_frames = 0

    def _write_header(self, n_atoms):
        """Emit the full header + fixed-variable data; records follow."""
        dims = [("frame", 0), ("spatial", 3), ("atom", n_atoms)]
        if self._with_box:
            dims += [("cell_spatial", 3), ("cell_angular", 3), ("label", 5)]
        dimid = {nm: i for i, (nm, _) in enumerate(dims)}

        # (name, nc_type, dims, attrs, fixed_data or None)
        fixed = [("spatial", 2, ["spatial"], {}, b"xyz")]
        record = [
            ("time", 5, ["frame"], {"units": "picosecond"}),
            ("coordinates", 5, ["frame", "atom", "spatial"],
             {"units": "angstrom"}),
        ]
        if self._with_box:
            fixed += [
                ("cell_spatial", 2, ["cell_spatial"], {}, b"abc"),
                ("cell_angular", 2, ["cell_angular", "label"], {},
                 b"alpha" b"beta " b"gamma"),
            ]
            record += [
                ("cell_lengths", 6, ["frame", "cell_spatial"],
                 {"units": "angstrom"}),
                ("cell_angles", 6, ["frame", "cell_angular"],
                 {"units": "degree"}),
            ]

        def vsize(nc_type, dim_names):
            n = 1
            for d in dim_names:
                if d != "frame":
                    n *= dims[dimid[d]][1]
            return _pad4(_NC_TYPES[nc_type][1] * n)

        def build(begins):
            out = b"CDF\x01" + struct.pack(">I", 0)  # numrecs patched later
            out += struct.pack(">ii", _NC_DIMENSION, len(dims))
            for nm, sz in dims:
                out += _nc_name(nm) + struct.pack(">i", sz)
            out += _nc_attrs({
                "Conventions": "AMBER",
                "ConventionVersion": "1.0",
                "program": "molann_tpu",
                "title": self._title,
            })
            allv = [(nm, t, dn, at) for nm, t, dn, at, _ in fixed]
            allv += [(nm, t, dn, at) for nm, t, dn, at in record]
            out += struct.pack(">ii", _NC_VARIABLE, len(allv))
            for nm, nc_type, dim_names, attrs in allv:
                out += _nc_name(nm) + struct.pack(">i", len(dim_names))
                for d in dim_names:
                    out += struct.pack(">i", dimid[d])
                out += _nc_attrs(attrs)
                out += struct.pack(">iiI", nc_type,
                                   vsize(nc_type, dim_names),
                                   begins.get(nm, 0))
            return out

        hlen = len(build({}))  # begins are fixed-width: length is final
        begins, off = {}, hlen
        for nm, nc_type, dim_names, _, data in fixed:
            begins[nm] = off
            off += vsize(nc_type, dim_names)
        self._recsize = 0
        for nm, nc_type, dim_names, _ in record:
            begins[nm] = off + self._recsize
            self._recsize += vsize(nc_type, dim_names)
        header = build(begins)
        assert len(header) == hlen
        self._fh.write(header)
        for nm, nc_type, dim_names, _, data in fixed:
            self._fh.write(data.ljust(vsize(nc_type, dim_names), b"\x00"))
        self._n_atoms = n_atoms

    def append(self, frames, box=None):
        """Append ``[k, n_atoms, 3]`` frames (atom count must match the
        first chunk); ``box``: ``[k, 3, 3]`` (or ``[3, 3]``, applied to
        every frame) box matrices, required iff the writer was opened
        with ``with_box=True``."""
        arr = np.ascontiguousarray(frames, dtype=">f4")
        if arr.ndim != 3 or arr.shape[-1] != 3:
            raise ValueError(
                f"expected [n_frames, n_atoms, 3], got {arr.shape}")
        k, n_atoms = arr.shape[0], arr.shape[1]
        if (box is not None) != self._with_box:
            raise ValueError(
                "box must be given exactly when the writer has "
                f"with_box={self._with_box}")
        if self._n_atoms is None:
            if n_atoms <= 0:
                raise ValueError("cannot write a 0-atom trajectory")
            self._write_header(n_atoms)
        elif n_atoms != self._n_atoms:
            raise ValueError(
                f"chunk has {n_atoms} atoms; writer opened with "
                f"{self._n_atoms}")
        if box is not None:
            from ..pbc import box_to_dcd_cell

            b = np.asarray(box, dtype=np.float64)
            if b.shape == (3, 3):
                b = np.broadcast_to(b, (k, 3, 3))
            if b.shape != (k, 3, 3):
                raise ValueError(f"box must be [k, 3, 3], got {b.shape}")
            cell = box_to_dcd_cell(b)  # (A, cos g, B, cos b, cos a, C)
            lengths = cell[:, (0, 2, 5)]
            angles = np.degrees(np.arccos(np.clip(cell[:, (4, 3, 1)],
                                                  -1.0, 1.0)))
        for i in range(k):
            t = np.float32((self._n_frames + i) * self._dt)
            self._fh.write(np.asarray(t, dtype=">f4").tobytes())
            self._fh.write(arr[i].tobytes())
            if box is not None:
                self._fh.write(lengths[i].astype(">f8").tobytes())
                self._fh.write(angles[i].astype(">f8").tobytes())
        self._n_frames += k

    def close(self):
        if self._fh is None:
            return
        if self._n_atoms is None:  # zero frames: still a valid empty file
            self._write_header(1)
            self._n_atoms = None
        self._fh.flush()
        self._fh.seek(4)
        self._fh.write(struct.pack(">I", self._n_frames))
        self._fh.close()
        self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_netcdf(path, frames, *, box=None, title="written by molann_tpu",
                 dt=1.0):
    """Write ``[n_frames, n_atoms, 3]`` float32 frames as an AMBER
    NetCDF trajectory. ``box``: optional ``[3, 3]`` (applied to every
    frame) or ``[n_frames, 3, 3]`` box matrices."""
    with NetCDFWriter(path, title=title, with_box=box is not None,
                      dt=dt) as w:
        w.append(frames, box=box)
    return path
