"""Pure-Python GROMACS trajectory support: TRR and XTC readers/writers.

Carried over from ``molann_tpu/io/xdr.py`` (numpy and ``struct`` only):
the writers write the same bytes and the readers read the same arrays.

These are the dependency-free counterparts of the native loader's TRR/XTC
paths (csrc/traj_loader.cpp) — writers for conversion/tests, readers as
the slow-but-dependable oracle. Cross-language round-trips (Python-written
files read by the C++ decoder and vice versa) are the compatibility tests.

Formats (both big-endian XDR):

- **TRR** (GROMACS full-precision): per-frame header ``magic 1993``,
  version string ``GMX_trn_file``, 13 int32 sizes/counters (ir, e, box,
  vir, pres, top, sym, x, v, f byte sizes; natoms, step, nre), time and
  lambda reals, then the payload blocks. Reals are float32 or float64 —
  inferred from ``box_size/9`` (or ``x_size/(3*natoms)``), per the
  GROMACS convention. We read coordinates (``x``) always and the
  velocity/force sections on request (``read_trr(velocities=True,
  forces=True)`` — restarts and force-matching data); the writer emits
  float32 frames with optional box/v/f sections.

- **XTC** (GROMACS compressed): per-frame ``magic 1995``, natoms, step,
  time, 3x3 box, then the public ``xdr3dfcoord`` compression: coordinates
  are scaled by ``precision`` (default 1000 -> 0.001 nm resolution),
  rounded to ints, and encoded with an adaptive-radix bit packer where
  consecutive atoms within ``smallnum`` of each other are run-length
  encoded as small deltas. Systems of <= 9 atoms are stored as plain
  floats (same rule as GROMACS).

The reference (zwpku/molann) has no trajectory IO at all — its forward
takes an in-memory tensor; these exist because MD users' trajectories
arrive in these formats.

Note on units: GROMACS trajectories are in nanometres while PDB/DCD use
Angstroms. This module does NOT rescale — it returns file values verbatim
(callers decide; ``python -m molann_tpu_torch convert --scale`` can rescale).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["read_trr", "write_trr", "read_xtc", "write_xtc",
           "TRRWriter", "XTCWriter"]


def _check_chunk(frames):
    arr = np.ascontiguousarray(frames, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected [n_frames, n_atoms, 3], got {arr.shape}")
    return arr


def _check_box(box, n_frames):
    if box is None:
        return None
    box = np.ascontiguousarray(box, dtype=np.float32)
    if box.shape == (3, 3):
        box = np.broadcast_to(box, (n_frames, 3, 3))
    elif box.shape != (n_frames, 3, 3):
        raise ValueError("box must be [3,3] or [n_frames,3,3]")
    return box


# ---------------------------------------------------------------------------
# TRR
# ---------------------------------------------------------------------------

_TRR_MAGIC = 1993
_TRR_VERSION = b"GMX_trn_file"


class TRRWriter:
    """Incremental coordinate-only TRR writer: frames are appended chunk
    by chunk, so arbitrarily long trajectories stream through a bounded
    buffer (``python -m molann_tpu_torch convert`` relies on this). Use as a context
    manager; :func:`write_trr` is the one-shot convenience wrapper."""

    def __init__(self, path, *, start_step=0, dt=1.0):
        self._fh = open(path, "wb")
        self._step = start_step
        self._dt = dt
        self._n_atoms = None

    def append(self, frames, box=None, velocities=None, forces=None):
        """Append ``[k, n_atoms, 3]`` frames (atom count must match the
        first chunk). ``box``: optional ``[3, 3]`` or ``[k, 3, 3]``.
        ``velocities``/``forces``: optional ``[k, n_atoms, 3]`` blocks
        written after the coordinates (the TRR v/f sections GROMACS
        restarts and force-matching consume)."""
        arr = _check_chunk(frames)
        k, n_atoms = arr.shape[0], arr.shape[1]
        if self._n_atoms is None:
            self._n_atoms = n_atoms
        elif n_atoms != self._n_atoms:
            raise ValueError(
                f"atom count changed mid-file ({self._n_atoms} -> {n_atoms})"
            )
        box = _check_box(box, k)

        def check_vf(a, label):
            if a is None:
                return None
            a = np.ascontiguousarray(a, dtype=np.float32)
            if a.shape != arr.shape:
                raise ValueError(
                    f"{label} must match frames {arr.shape}, got {a.shape}"
                )
            return a

        vel = check_vf(velocities, "velocities")
        frc = check_vf(forces, "forces")
        x_size = 3 * n_atoms * 4
        v_size = x_size if vel is not None else 0
        f_size = x_size if frc is not None else 0
        box_size = 9 * 4 if box is not None else 0
        fh = self._fh
        for f in range(k):
            fh.write(struct.pack(">i", _TRR_MAGIC))
            # GROMACS string serialization: int(len+1 incl. NUL), then an
            # XDR string (int len, bytes, pad to 4)
            fh.write(struct.pack(">ii", len(_TRR_VERSION) + 1,
                                 len(_TRR_VERSION)))
            fh.write(_TRR_VERSION.ljust(-(-len(_TRR_VERSION) // 4) * 4,
                                        b"\x00"))
            step = self._step
            fh.write(struct.pack(
                ">13i",
                0, 0, box_size, 0, 0, 0, 0,  # ir, e, box, vir, pres, top, sym
                x_size, v_size, f_size,      # x, v, f
                n_atoms, step, 0,            # natoms, step, nre
            ))
            fh.write(struct.pack(">ff", step * self._dt, 0.0))  # t, λ
            if box is not None:
                fh.write(box[f].astype(">f4").tobytes())
            fh.write(arr[f].astype(">f4").tobytes())
            if vel is not None:
                fh.write(vel[f].astype(">f4").tobytes())
            if frc is not None:
                fh.write(frc[f].astype(">f4").tobytes())
            self._step += 1

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_trr(path, frames, *, box=None, velocities=None, forces=None,
              start_step=0, dt=1.0):
    """Write ``[n_frames, n_atoms, 3]`` float32 frames as a TRR.
    ``box``: optional ``[3, 3]`` (applied to every frame) or
    ``[n_frames, 3, 3]`` float32 box matrices; ``velocities``/``forces``:
    optional ``[n_frames, n_atoms, 3]`` v/f sections."""
    with TRRWriter(path, start_step=start_step, dt=dt) as w:
        w.append(frames, box=box, velocities=velocities, forces=forces)
    return path


def read_trr(path, *, velocities=False, forces=False):
    """Read a TRR: returns ``(frames [n_frames, n_atoms, 3] float32,
    times [n_frames] float64, box or None)``. Handles float32 and float64
    files. With ``velocities=True`` / ``forces=True`` the corresponding
    TRR sections are appended to the return tuple (as ``[n_frames,
    n_atoms, 3]`` float32, or None when the file carries none); a file
    where only SOME frames carry the requested section is rejected —
    per-frame v/f strides are a GROMACS output option this reader does
    not reassemble."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames, times, boxes, vels, frcs = [], [], [], [], []
    off = 0
    while off + 4 <= len(data):
        (magic,) = struct.unpack_from(">i", data, off)
        if magic != _TRR_MAGIC:
            raise ValueError(
                f"bad TRR magic {magic} at offset {off} (expected 1993)"
            )
        off += 4
        (slen,) = struct.unpack_from(">i", data, off)  # len incl. NUL
        (xlen,) = struct.unpack_from(">i", data, off + 4)
        if xlen != slen - 1:
            raise ValueError(f"corrupt TRR version string at offset {off}")
        off += 8 + -(-xlen // 4) * 4
        (ir, e, box_size, vir, pres, top, sym, x_size, v_size, f_size,
         natoms, step, nre) = struct.unpack_from(">13i", data, off)
        off += 52
        if x_size <= 0 or natoms <= 0:
            raise ValueError("TRR frame carries no coordinates")
        if min(box_size, vir, pres, v_size, f_size) < 0:
            raise ValueError("corrupt TRR frame (negative section size)")
        # float width per the GROMACS convention
        width = (box_size // 9) if box_size else (x_size // (3 * natoms))
        if width not in (4, 8):
            raise ValueError(f"corrupt TRR sizes (real width {width})")
        # every payload size must be consistent with natoms/width (the
        # same header/payload check the native parser enforces)
        if x_size != 3 * natoms * width or any(
            s not in (0, 3 * natoms * width) for s in (v_size, f_size)
        ) or (box_size not in (0, 9 * width)):
            raise ValueError("corrupt TRR frame (section size mismatch)")
        rfmt = ">f8" if width == 8 else ">f4"
        (t,) = struct.unpack_from(">d" if width == 8 else ">f", data, off)
        off += 2 * width  # t, lambda
        if box_size:
            boxes.append(np.frombuffer(
                data, dtype=rfmt, count=9, offset=off).reshape(3, 3))
        off += box_size + vir + pres
        xs = np.frombuffer(data, dtype=rfmt, count=3 * natoms, offset=off)
        frames.append(xs.astype(np.float32).reshape(natoms, 3))
        times.append(t)
        off += x_size
        if velocities and v_size:
            vels.append(np.frombuffer(
                data, dtype=rfmt, count=3 * natoms, offset=off
            ).astype(np.float32).reshape(natoms, 3))
        off += v_size
        if forces and f_size:
            frcs.append(np.frombuffer(
                data, dtype=rfmt, count=3 * natoms, offset=off
            ).astype(np.float32).reshape(natoms, 3))
        off += f_size
    out = (
        np.asarray(frames, dtype=np.float32),
        np.asarray(times, dtype=np.float64),
        np.asarray(boxes, dtype=np.float32) if boxes else None,
    )
    for want, got, label in ((velocities, vels, "velocities"),
                             (forces, frcs, "forces")):
        if not want:
            continue
        if got and len(got) != len(frames):
            raise ValueError(
                f"only {len(got)} of {len(frames)} TRR frames carry "
                f"{label} (per-frame v/f strides are not supported)"
            )
        out = out + (np.asarray(got, np.float32) if got else None,)
    return out


# ---------------------------------------------------------------------------
# XTC — the xdr3dfcoord compression scheme
# ---------------------------------------------------------------------------

_XTC_MAGIC = 1995
_FIRSTIDX = 9
# adaptive-radix table of the public xdr3dfcoord scheme (GROMACS xdrfile)
_MAGICINTS = (
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64,
    80, 101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290,
    1625, 2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384,
    20642, 26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072,
    165140, 208063, 262144, 330280, 416127, 524287, 660561, 827625,
    1048576, 1321122, 1664250, 2097152, 2642245, 3328500, 4194304,
    5284491, 6657000, 8388607, 10568983, 13314000, 16777216,
)
_LASTIDX = len(_MAGICINTS)


def _sizeofint(size):
    num, bits = 1, 0
    while size >= num and bits < 32:
        bits += 1
        num <<= 1
    return bits


def _sizeofints(sizes):
    """Bits needed for the little-endian mixed-radix packing of one value
    per ``sizes`` entry (the multi-byte carry scheme of xdr3dfcoord)."""
    bytes_ = [1]
    for s in sizes:
        tmp = 0
        for k in range(len(bytes_)):
            tmp += bytes_[k] * s
            bytes_[k] = tmp & 0xFF
            tmp >>= 8
        while tmp:
            bytes_.append(tmp & 0xFF)
            tmp >>= 8
    num, bits = 1, 0
    while bytes_[-1] >= num:
        bits += 1
        num *= 2
    return bits + (len(bytes_) - 1) * 8


class _BitWriter:
    """MSB-first bit packer (sendbits/sendints semantics)."""

    def __init__(self):
        self.out = bytearray()
        self.lastbits = 0
        self.lastbyte = 0

    def bits(self, nbits, value):
        value &= (1 << nbits) - 1
        while nbits >= 8:
            self.lastbyte = (((self.lastbyte << 8)
                              | ((value >> (nbits - 8)) & 0xFF)) & 0xFFFFFFFF)
            self.out.append((self.lastbyte >> self.lastbits) & 0xFF)
            nbits -= 8
        if nbits > 0:
            self.lastbyte = ((self.lastbyte << nbits) | (value & ((1 << nbits) - 1))) & 0xFFFFFFFF
            self.lastbits += nbits
            if self.lastbits >= 8:
                self.lastbits -= 8
                self.out.append((self.lastbyte >> self.lastbits) & 0xFF)

    def ints(self, nbits, sizes, nums):
        """Mixed-radix pack ``nums`` (one digit per radix in ``sizes``)
        into ``nbits`` bits, little-endian byte digits, MSB-first stream."""
        bytes_ = []
        tmp = nums[0]
        while True:
            bytes_.append(tmp & 0xFF)
            tmp >>= 8
            if not tmp:
                break
        for i in range(1, len(nums)):
            if nums[i] >= sizes[i]:
                raise ValueError("xtc internal: num >= size")
            tmp = nums[i]
            for k in range(len(bytes_)):
                tmp += bytes_[k] * sizes[i]
                bytes_[k] = tmp & 0xFF
                tmp >>= 8
            while tmp:
                bytes_.append(tmp & 0xFF)
                tmp >>= 8
        if nbits >= len(bytes_) * 8:
            for b in bytes_:
                self.bits(8, b)
            self.bits(nbits - len(bytes_) * 8, 0)
        else:
            for b in bytes_[:-1]:
                self.bits(8, b)
            self.bits(nbits - (len(bytes_) - 1) * 8, bytes_[-1])

    def getvalue(self):
        out = bytes(self.out)
        if self.lastbits > 0:
            out += bytes([(self.lastbyte << (8 - self.lastbits)) & 0xFF])
        return out


class _BitReader:
    """MSB-first bit unpacker (receivebits/receiveints semantics)."""

    def __init__(self, data):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def bits(self, nbits):
        mask = (1 << nbits) - 1
        num = 0
        while nbits >= 8:
            self.lastbyte = ((self.lastbyte << 8) | self.data[self.cnt]) & 0xFFFFFFFF
            self.cnt += 1
            num |= (self.lastbyte >> self.lastbits) << (nbits - 8)
            nbits -= 8
        if nbits > 0:
            if self.lastbits < nbits:
                self.lastbits += 8
                self.lastbyte = ((self.lastbyte << 8) | self.data[self.cnt]) & 0xFFFFFFFF
                self.cnt += 1
            self.lastbits -= nbits
            num |= (self.lastbyte >> self.lastbits) & ((1 << nbits) - 1)
        return num & mask

    def ints(self, nbits, sizes):
        bytes_ = []
        while nbits > 8:
            bytes_.append(self.bits(8))
            nbits -= 8
        if nbits > 0:
            bytes_.append(self.bits(nbits))
        while len(bytes_) < 4:
            bytes_.append(0)
        nums = [0] * len(sizes)
        for i in range(len(sizes) - 1, 0, -1):
            num = 0
            for j in range(len(bytes_) - 1, -1, -1):
                num = (num << 8) | bytes_[j]
                bytes_[j] = num // sizes[i]
                num -= bytes_[j] * sizes[i]
            nums[i] = num
        nums[0] = (bytes_[0] | (bytes_[1] << 8) | (bytes_[2] << 16)
                   | (bytes_[3] << 24))
        return nums


def _compress_frame(coords, precision):
    """xdr3dfcoord body for one frame (natoms > 9): returns the bytes
    AFTER the inner natoms field (precision .. padded data)."""
    n = coords.shape[0]
    scaled = coords.astype(np.float64) * precision
    ints = np.where(scaled >= 0, scaled + 0.5, scaled - 0.5).astype(np.int64)
    if np.abs(ints).max(initial=0) > 2**31 - 3:
        raise ValueError(
            "coordinate * precision overflows the XTC integer range"
        )
    ip = ints.astype(np.int64)
    minint = ip.min(axis=0)
    maxint = ip.max(axis=0)
    sizeint = [int(maxint[k] - minint[k] + 1) for k in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)

    diffs = np.abs(np.diff(ip, axis=0)).sum(axis=1)
    mindiff = int(diffs.min()) if diffs.size else 2**31 - 1
    smallidx = _FIRSTIDX
    while smallidx < _LASTIDX - 1 and _MAGICINTS[smallidx] < mindiff:
        smallidx += 1

    header = struct.pack(">f", precision)
    header += struct.pack(">6i", *(int(v) for v in minint),
                          *(int(v) for v in maxint))
    header += struct.pack(">i", smallidx)

    maxidx = min(_LASTIDX - 1, smallidx + 8)
    minidx = maxidx - 8
    larger = _MAGICINTS[maxidx] // 2
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3

    w = _BitWriter()
    lip = [[int(ip[a, k]) for k in range(3)] for a in range(n)]
    prevcoord = [0, 0, 0]
    prevrun = -1
    i = 0
    while i < n:
        this = lip[i]
        is_small = 0
        if smallidx < maxidx and i >= 1 and all(
            abs(this[k] - prevcoord[k]) < larger for k in range(3)
        ):
            is_smaller = 1
        elif smallidx > minidx:
            is_smaller = -1
        else:
            is_smaller = 0
        if i + 1 < n and all(
            abs(this[k] - lip[i + 1][k]) < smallnum for k in range(3)
        ):
            # interchange first with second atom: improves run compression
            # of water-like triplets; the decoder unswaps at k == 0
            lip[i], lip[i + 1] = lip[i + 1], lip[i]
            this = lip[i]
            is_small = 1
        tmp = [this[k] - int(minint[k]) for k in range(3)]
        if bitsize == 0:
            for k in range(3):
                w.bits(bitsizeint[k], tmp[k])
        else:
            w.ints(bitsize, sizeint, tmp)
        prevcoord = list(this)
        i += 1

        run_vals = []
        if is_small == 0 and is_smaller == -1:
            is_smaller = 0
        while is_small and len(run_vals) < 8 * 3:
            this = lip[i]
            if is_smaller == -1 and (
                sum((this[k] - prevcoord[k]) ** 2 for k in range(3))
                >= smaller * smaller
            ):
                is_smaller = 0
            run_vals.extend(
                this[k] - prevcoord[k] + smallnum for k in range(3)
            )
            prevcoord = list(this)
            i += 1
            is_small = 0
            if i < n and all(
                abs(lip[i][k] - prevcoord[k]) < smallnum for k in range(3)
            ):
                is_small = 1
        run = len(run_vals)
        if run != prevrun or is_smaller != 0:
            prevrun = run
            w.bits(1, 1)
            w.bits(5, run + is_smaller + 1)
        else:
            w.bits(1, 0)
        for k in range(0, run, 3):
            w.ints(smallidx, sizesmall, run_vals[k : k + 3])
        if is_smaller != 0:
            smallidx += is_smaller
            if is_smaller < 0:
                smallnum = smaller
                smaller = (
                    _MAGICINTS[smallidx - 1] // 2
                    if smallidx > _FIRSTIDX else 0
                )
            else:
                smaller = smallnum
                smallnum = _MAGICINTS[smallidx] // 2
            sizesmall = [_MAGICINTS[smallidx]] * 3

    payload = w.getvalue()
    body = header + struct.pack(">i", len(payload)) + payload
    pad = -len(payload) % 4
    return body + b"\x00" * pad


def _decompress_frame(data, off, natoms):
    """Inverse of :func:`_compress_frame`: decode one frame body starting
    at ``off`` (the precision field). Returns (coords [n,3] f32, new_off)."""
    (precision,) = struct.unpack_from(">f", data, off)
    minint = list(struct.unpack_from(">3i", data, off + 4))
    maxint = list(struct.unpack_from(">3i", data, off + 16))
    (smallidx,) = struct.unpack_from(">i", data, off + 28)
    (nbytes,) = struct.unpack_from(">i", data, off + 32)
    off += 36
    if not (0 <= smallidx < _LASTIDX):
        raise ValueError(f"corrupt XTC smallidx {smallidx}")
    if nbytes < 0 or off + nbytes > len(data):
        raise ValueError("truncated XTC frame data")
    end = off + nbytes + (-nbytes % 4)

    sizeint = [maxint[k] - minint[k] + 1 for k in range(3)]
    if any(s > 0xFFFFFF for s in sizeint):
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsizeint = [0, 0, 0]
        bitsize = _sizeofints(sizeint)

    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3
    r = _BitReader(memoryview(data)[off:end])
    iout = np.empty((natoms, 3), dtype=np.int64)
    run = 0
    i = 0
    while i < natoms:
        if bitsize == 0:
            this = [r.bits(bitsizeint[k]) for k in range(3)]
        else:
            this = r.ints(bitsize, sizeint)
        this = [this[k] + minint[k] for k in range(3)]
        prev = list(this)
        i += 1

        flag = r.bits(1)
        is_smaller = 0
        if flag:
            v = r.bits(5)
            is_smaller = v % 3
            run = v - is_smaller
            is_smaller -= 1
        if run > 0:
            if i + run // 3 > natoms:
                raise ValueError("corrupt XTC run length")
            for k in range(0, run, 3):
                d = r.ints(smallidx, sizesmall)
                this = [d[j] + prev[j] - smallnum for j in range(3)]
                if k == 0:
                    # undo the encoder's first/second-atom interchange;
                    # prev stays on the EARLIER (swapped-out) atom so the
                    # next delta chains off the right position
                    this, prev = prev, this
                    iout[i - 1] = prev
                else:
                    prev = list(this)
                iout[i] = this
                i += 1
        else:
            iout[i - 1] = this
        smallidx += is_smaller
        if not (_FIRSTIDX <= smallidx < _LASTIDX):
            # a corrupt is_smaller stream can walk smallidx out of the
            # magic table (IndexError / zero-size ints otherwise)
            raise ValueError(f"corrupt XTC smallidx walk to {smallidx}")
        if is_smaller < 0:
            smallnum = smaller
            smaller = (
                _MAGICINTS[smallidx - 1] // 2 if smallidx > _FIRSTIDX else 0
            )
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = _MAGICINTS[smallidx] // 2
        sizesmall = [_MAGICINTS[smallidx]] * 3
    # scale on the f32 lattice exactly like GROMACS (int * float32):
    # keeps this oracle BIT-IDENTICAL to the native C++ decoder
    inv = np.float32(1.0) / np.float32(precision)
    out = (iout.astype(np.float32) * inv).astype(np.float32)
    return out, end


class XTCWriter:
    """Incremental XTC writer (same streaming contract as
    :class:`TRRWriter`); :func:`write_xtc` is the one-shot wrapper."""

    def __init__(self, path, *, precision=1000.0, start_step=0, dt=1.0):
        self._fh = open(path, "wb")
        self._precision = float(precision)
        self._step = start_step
        self._dt = dt
        self._n_atoms = None

    def append(self, frames, box=None):
        """Append ``[k, n_atoms, 3]`` frames (atom count must match the
        first chunk). ``box``: optional ``[3, 3]`` or ``[k, 3, 3]``."""
        arr = _check_chunk(frames)
        k, n_atoms = arr.shape[0], arr.shape[1]
        if self._n_atoms is None:
            self._n_atoms = n_atoms
        elif n_atoms != self._n_atoms:
            raise ValueError(
                f"atom count changed mid-file ({self._n_atoms} -> {n_atoms})"
            )
        box = _check_box(box, k)
        fh = self._fh
        for f in range(k):
            step = self._step
            fh.write(struct.pack(">iiif", _XTC_MAGIC, n_atoms, step,
                                 step * self._dt))
            b = box[f] if box is not None else np.zeros((3, 3), np.float32)
            fh.write(np.asarray(b, dtype=">f4").tobytes())
            fh.write(struct.pack(">i", n_atoms))
            if n_atoms <= 9:
                fh.write(arr[f].astype(">f4").tobytes())
            else:
                fh.write(_compress_frame(arr[f], self._precision))
            self._step += 1

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_xtc(path, frames, *, precision=1000.0, box=None, start_step=0,
              dt=1.0):
    """Write ``[n_frames, n_atoms, 3]`` frames as an XTC (compressed to
    1/``precision`` absolute resolution). ``box``: optional ``[3, 3]`` or
    ``[n_frames, 3, 3]``; zero box written when omitted."""
    with XTCWriter(path, precision=precision, start_step=start_step,
                   dt=dt) as w:
        w.append(frames, box=box)
    return path


def scan_xtc_boxes(path):
    """Per-frame box matrices of an XTC WITHOUT decoding coordinates:
    ``-> [n_frames, 3, 3] float32``. A seek walk over the frame headers
    (compressed blocks are skipped via their ``nbytes`` field), so huge
    trajectories scan in O(frames) tiny reads — this is how ``convert``
    carries cells alongside streamed coordinates."""
    boxes = []
    with open(path, "rb") as fh:
        while True:
            hdr = fh.read(56)
            if not hdr:
                break
            if len(hdr) < 56:
                raise ValueError("truncated XTC frame header")
            magic, natoms, _step = struct.unpack_from(">3i", hdr, 0)
            if magic != _XTC_MAGIC:
                raise ValueError(f"bad XTC magic {magic} (expected 1995)")
            if natoms <= 0:
                raise ValueError(f"corrupt XTC frame (natoms={natoms})")
            boxes.append(np.frombuffer(hdr, dtype=">f4", count=9,
                                       offset=16).reshape(3, 3))
            if natoms <= 9:
                fh.seek(12 * natoms, 1)
            else:
                sub = fh.read(36)
                if len(sub) < 36:
                    raise ValueError("truncated XTC frame data")
                (nbytes,) = struct.unpack_from(">i", sub, 32)
                if nbytes < 0:
                    raise ValueError("corrupt XTC frame (negative size)")
                fh.seek(nbytes + (-nbytes % 4), 1)
    return np.asarray(boxes, dtype=np.float32).reshape(-1, 3, 3)


def scan_trr_boxes(path):
    """Per-frame box matrices of a TRR without decoding coordinates:
    ``-> [n_frames, 3, 3] float32 or None`` (None when NO frame carries
    a box section). Frames without a box section in a mixed file (legal
    TRR — our own :class:`TRRWriter` takes ``box`` per append) get a
    zero box, keeping the result frame-aligned. Same seek-walk
    rationale as :func:`scan_xtc_boxes`; header validation mirrors
    :func:`read_trr`.
    """
    boxes = []
    any_box = False
    with open(path, "rb") as fh:
        while True:
            head = fh.read(4)
            if not head:
                break
            if len(head) < 4:
                raise ValueError("truncated TRR frame header")
            (magic,) = struct.unpack(">i", head)
            if magic != _TRR_MAGIC:
                raise ValueError(f"bad TRR magic {magic} (expected 1993)")
            sl = fh.read(8)
            slen, xlen = struct.unpack(">2i", sl)
            if xlen != slen - 1:
                raise ValueError("corrupt TRR version string")
            fh.seek(-(-xlen // 4) * 4, 1)
            hdr = fh.read(52)
            (_ir, _e, box_size, vir, pres, _top, _sym, x_size, v_size,
             f_size, natoms, _step, _nre) = struct.unpack(">13i", hdr)
            if x_size <= 0 or natoms <= 0:
                raise ValueError("TRR frame carries no coordinates")
            if min(box_size, vir, pres, v_size, f_size) < 0:
                raise ValueError("corrupt TRR frame (negative section "
                                 "size)")
            width = (box_size // 9) if box_size else (
                x_size // (3 * natoms))
            if width not in (4, 8):
                raise ValueError(f"corrupt TRR sizes (real width {width})")
            if x_size != 3 * natoms * width or any(
                s not in (0, 3 * natoms * width) for s in (v_size, f_size)
            ) or (box_size not in (0, 9 * width)):
                raise ValueError("corrupt TRR frame (section size "
                                 "mismatch)")
            fh.seek(2 * width, 1)  # t, lambda
            if box_size:
                raw = fh.read(9 * width)
                boxes.append(np.frombuffer(
                    raw, dtype=">f8" if width == 8 else ">f4",
                    count=9).reshape(3, 3))
                any_box = True
            else:
                boxes.append(np.zeros((3, 3)))
            fh.seek(vir + pres + x_size + v_size + f_size, 1)
    if not any_box:
        return None
    return np.asarray(boxes, dtype=np.float32)


def read_xtc(path):
    """Read an XTC: returns ``(frames [n_frames, n_atoms, 3] float32,
    times [n_frames] float64, box [n_frames, 3, 3] float32)``."""
    with open(path, "rb") as fh:
        data = fh.read()
    frames, times, boxes = [], [], []
    off = 0
    while off + 4 <= len(data):
        magic, natoms, step = struct.unpack_from(">3i", data, off)
        if magic != _XTC_MAGIC:
            raise ValueError(
                f"bad XTC magic {magic} at offset {off} (expected 1995)"
            )
        if natoms <= 0:
            # negative counts would walk the frame offset backwards;
            # zero-atom frames are not a thing GROMACS writes
            raise ValueError(f"corrupt XTC frame (natoms={natoms})")
        (t,) = struct.unpack_from(">f", data, off + 12)
        box = np.frombuffer(data, dtype=">f4", count=9,
                            offset=off + 16).reshape(3, 3)
        (natoms2,) = struct.unpack_from(">i", data, off + 52)
        if natoms2 != natoms:
            raise ValueError("corrupt XTC frame (atom count mismatch)")
        off += 56
        if natoms <= 9:
            xs = np.frombuffer(data, dtype=">f4", count=3 * natoms,
                               offset=off)
            frames.append(xs.astype(np.float32).reshape(natoms, 3))
            off += 12 * natoms
        else:
            coords, off = _decompress_frame(data, off, natoms)
            frames.append(coords)
        times.append(t)
        boxes.append(box.astype(np.float32))
    return (
        np.asarray(frames, dtype=np.float32),
        np.asarray(times, dtype=np.float64),
        np.asarray(boxes, dtype=np.float32),
    )
