"""Trajectory commands: ``convert`` and ``unwrap`` (the port of
``molann_tpu/cli/traj.py``).

``convert`` is host work: it streams frames chunk by chunk from any
reader to any writer. ``unwrap`` repairs periodic wrapping with the torch
functions of :mod:`molann_tpu_torch.pbc` on ``--device``.
"""

from __future__ import annotations

import numpy as np

from ._common import _device, _open_traj_writer, _traj_dims, add_device_arg


def cmd_convert(args):
    """Convert between trajectory formats, streaming chunk by chunk (the
    whole trajectory is never in memory). Inputs: .npy/.dcd/.trr/.xtc/.nc;
    outputs: .npy (frames or packed), .dcd, .trr, .xtc, .nc (Amber
    NetCDF). ``--scale`` multiplies coordinates (10 for GROMACS nm -> PDB/DCD
    Angstrom). Unit cells are kept when both formats carry them: the boxes
    ride one header scan and are scaled like the coordinates; ``--box
    lx,ly,lz`` overrides."""
    n_frames, fpf = _traj_dims(args.traj)
    n_atoms = fpf // 3
    chunk = max(1, int(args.chunk))
    out = str(args.out)
    scale = np.float32(args.scale)

    boxes = None
    if any(out.lower().endswith(e)
           for e in (".dcd", ".trr", ".xtc", ".nc", ".ncdf")):
        if args.box:
            try:
                lx, ly, lz = (float(v) for v in args.box.split(","))
            except ValueError:
                raise SystemExit(f"error: bad --box {args.box!r} "
                                 "(want lx,ly,lz)")
            # --box is in OUTPUT units: never scaled by --scale
            boxes = np.broadcast_to(
                np.diag([lx, ly, lz]).astype(np.float32), (n_frames, 3, 3))
        else:
            from ..io.reader import read_traj_boxes

            boxes = read_traj_boxes(args.traj)
            if boxes is not None and len(boxes) != n_frames:
                raise SystemExit(
                    f"error: {len(boxes)} boxes for {n_frames} frames")
            # scanned boxes are in input units: scale like coordinates
            if boxes is not None and scale != 1.0:
                boxes = boxes * scale  # f32 * f32, no upcast

    def chunks():
        from ..io.reader import open_frame_reader

        read, _, _ = open_frame_reader(args.traj)
        try:
            for s in range(0, n_frames, chunk):
                c = min(chunk, n_frames - s)
                block = read(s, c).reshape(c, fpf)
                yield s, (block * scale if scale != 1.0 else block)
        finally:
            read.close()

    writer = _open_traj_writer(out, xtc_precision=args.xtc_precision,
                               with_box=boxes is not None)
    if writer is not None:
        with writer:  # incremental: one chunk in flight at a time
            for s, c in chunks():
                if boxes is not None:
                    writer.append(c.reshape(-1, n_atoms, 3),
                                  box=boxes[s:s + c.shape[0]])
                else:
                    writer.append(c.reshape(-1, n_atoms, 3))
    else:
        shape = (n_frames, fpf) if args.packed else (n_frames, n_atoms, 3)
        dst = np.lib.format.open_memmap(out, mode="w+", dtype=np.float32,
                                        shape=shape)
        for s, c in chunks():
            dst[s:s + c.shape[0]] = c.reshape((c.shape[0],) + shape[1:])
        dst.flush()
    print(f"wrote {out}: {n_frames} frames x {n_atoms} atoms")
    return 0


def _load_frames_and_boxes(traj, boxarg):
    """Frames and per-frame box matrices for ``unwrap``: ``([l, n, 3]
    float32, [l, 3, 3] float32)``."""
    low = str(traj).lower()
    boxes = None
    if low.endswith(".xtc"):
        from ..io.xdr import read_xtc

        frames, _, boxes = read_xtc(traj)
    elif low.endswith(".trr"):
        from ..io.xdr import read_trr

        frames, _, boxes = read_trr(traj)
    elif low.endswith(".dcd"):
        from ..io.dcd import read_dcd
        from ..pbc import dcd_cell_to_box

        frames, cell = read_dcd(traj)
        if cell is not None:
            boxes = dcd_cell_to_box(cell)
    elif low.endswith(".nc") or low.endswith(".ncdf"):
        from ..io.netcdf import read_netcdf

        frames, _, boxes = read_netcdf(traj)
    elif low.endswith(".npy"):
        frames = np.load(traj)
        if frames.ndim != 3 or frames.shape[2] != 3:
            raise SystemExit(f"error: {traj} must be [l, n, 3] frames "
                             f"for unwrap, got {frames.shape}")
        frames = frames.astype(np.float32)
    else:
        raise SystemExit(f"error: unsupported trajectory {traj!r} "
                         "(.xtc/.trr/.dcd/.nc/.npy)")
    if boxarg:
        try:
            lx, ly, lz = (float(v) for v in boxarg.split(","))
        except ValueError:
            raise SystemExit(f"error: bad --box {boxarg!r} (want lx,ly,lz)")
        boxes = np.broadcast_to(np.diag([lx, ly, lz]).astype(np.float32),
                                (frames.shape[0], 3, 3))
    if boxes is None:
        raise SystemExit("error: the trajectory carries no box vectors; "
                         "pass --box lx,ly,lz (orthorhombic)")
    if boxes.shape[0] != frames.shape[0]:
        raise SystemExit(f"error: {boxes.shape[0]} boxes for "
                         f"{frames.shape[0]} frames (corrupt trajectory?)")
    if (np.abs(np.diagonal(boxes, axis1=1, axis2=2)) < 1e-6).any():
        raise SystemExit("error: trajectory box is zero/degenerate "
                         "(vacuum run?) — nothing to unwrap, or pass "
                         "--box to override")
    return frames, np.ascontiguousarray(boxes, dtype=np.float32)


def cmd_unwrap(args):
    """Repair periodic wrapping before feature extraction: ``whole``
    reassembles molecules broken across the box boundary (minimum image
    along a covalent bond tree guessed from the PDB; trjconv -pbc whole),
    ``nojump`` makes trajectories continuous in time (trjconv -pbc
    nojump), ``whole+nojump`` does both, on ``--device``."""
    import torch

    from ..pbc import bond_tree_levels, guess_bonds, make_whole, unwrap_time
    from ..topology import Universe

    device = _device(args)
    frames, boxes = _load_frames_and_boxes(args.traj, args.box)
    modes = args.mode.split("+")
    for m in modes:
        if m not in ("whole", "nojump"):
            raise SystemExit(f"error: unknown --mode part {m!r} "
                             "(whole, nojump, or whole+nojump)")
    x = torch.as_tensor(frames, device=device)
    box_t = torch.as_tensor(boxes, device=device)
    bonds = None
    if "whole" in modes:
        u = Universe(args.pdb)
        if len(u.atoms) != frames.shape[1]:
            raise SystemExit(f"error: PDB has {len(u.atoms)} atoms, "
                             f"trajectory has {frames.shape[1]}")
        bonds = guess_bonds(u, tolerance=args.tolerance)
        if not len(bonds):
            raise SystemExit("error: no covalent bonds detected in the "
                             "PDB (unknown elements?); cannot make whole")
        levels = bond_tree_levels(frames.shape[1], bonds)
        x = make_whole(x, box_t, levels=levels)
    if "nojump" in modes:
        x = unwrap_time(x, box_t)
    out_frames = x.cpu().numpy()

    # keep the cell with the repaired coordinates: a second unwrap pass or
    # GROMACS tools downstream need it
    writer = _open_traj_writer(args.out, with_box=True)
    if writer is not None:
        with writer:
            writer.append(out_frames, box=boxes)
    else:
        np.save(args.out, out_frames)
    msg = (f"wrote {args.out}: {out_frames.shape[0]} frames x "
           f"{out_frames.shape[1]} atoms ({args.mode})")
    if bonds is not None:
        def max_bond(f):
            return float(np.linalg.norm(
                f[:, bonds[:, 0]] - f[:, bonds[:, 1]], axis=-1).max())

        msg += (f"; max bond length {max_bond(frames):.2f} -> "
                f"{max_bond(out_frames):.2f} over {len(bonds)} guessed "
                "bonds")
    print(msg)
    return 0


def register(sub):
    pc = sub.add_parser(
        "convert",
        help="convert trajectories (.npy/.dcd/.trr/.xtc/.nc in; "
             ".npy/.dcd/.trr/.xtc/.nc out)")
    pc.add_argument("traj", help="input trajectory (.npy/.dcd/.trr/.xtc/.nc)")
    pc.add_argument("out", help="output path (.npy/.dcd/.trr/.xtc/.nc)")
    pc.add_argument("--packed", action="store_true",
                    help="write packed [n_frames, 3n] instead of "
                         "[n_frames, n_atoms, 3] (.npy outputs only)")
    pc.add_argument("--chunk", type=int, default=1 << 16,
                    help="frames per streaming chunk")
    pc.add_argument("--scale", type=float, default=1.0,
                    help="multiply coordinates (10 = GROMACS nm -> Angstrom)")
    pc.add_argument("--box", default=None, metavar="LX,LY,LZ",
                    help="orthorhombic cell for the output, in OUTPUT units "
                         "— not multiplied by --scale (default: carry the "
                         "input's per-frame boxes, scaled like the "
                         "coordinates, when it has them)")
    pc.add_argument("--xtc-precision", type=float, default=1000.0,
                    help="XTC output precision (resolution 1/precision)")
    pc.set_defaults(fn=cmd_convert)

    pu = sub.add_parser(
        "unwrap",
        help="repair periodic wrapping (make molecules whole / remove box "
             "jumps) before feature extraction")
    pu.add_argument("traj", help="wrapped trajectory (.xtc/.trr/.dcd/.nc; "
                                 ".npy with --box)")
    pu.add_argument("pdb", help="topology PDB (bond guessing; its "
                                "coordinates must be whole)")
    pu.add_argument("out", help="output (.npy/.dcd/.trr/.xtc/.nc)")
    pu.add_argument("--mode", default="whole",
                    choices=["whole", "nojump", "whole+nojump"],
                    help="whole = reassemble molecules across the boundary "
                         "(trjconv -pbc whole); nojump = continuous paths in "
                         "time (-pbc nojump)")
    pu.add_argument("--box", default=None, metavar="LX,LY,LZ",
                    help="orthorhombic box override (required for .npy "
                         "inputs, which carry no box)")
    pu.add_argument("--tolerance", type=float, default=0.45,
                    help="bond-guess distance tolerance (Angstrom) on top of "
                         "the covalent radii")
    add_device_arg(pu, "unwrap")
    pu.set_defaults(fn=cmd_unwrap)
