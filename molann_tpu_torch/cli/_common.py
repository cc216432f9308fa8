"""Shared plumbing of the CLI command modules (the port of
``molann_tpu/cli/_common.py``): model and trajectory loading and checks,
the per-extension trajectory writers, the grid grammar, ``--cull``, and
the port's own ``--device``."""

from __future__ import annotations

import numpy as np

DEVICES_TODO = ("--devices N > 1 (serving or training over several "
                "devices) is not ported to molann_tpu_torch yet (ROADMAP.md, "
                "queue 2, item 5)")


def _load_model(path, device):
    from ..io import load_model

    return load_model(path, device=device)


def add_device_arg(sp, what="run"):
    """The port's ``--device`` flag: the CUDA card unless asked for."""
    sp.add_argument("--device", default="cuda",
                    help=f"torch device to {what} on (default: the CUDA "
                         "card, an error without one; 'cpu' for the host)")


def _device(args):
    """``--device`` resolved by the port's rule (``RuntimeError`` where the
    card is asked for and there is none), after ``--devices`` is checked."""
    from .._device import resolve_device

    if getattr(args, "devices", 0) > 1:
        raise NotImplementedError(DEVICES_TODO)
    return resolve_device(args.device)


def _parse_grid(gridspec, d, *, subject=None):
    """Parse a ``lo:hi:n[,lo:hi:n...]`` grid option into ``d`` ``(lo, hi,
    n)`` triples, broadcasting a single spec to all dimensions — the one
    grammar shared by the fes/mep/msm/pmf subcommands (callers decide
    whether ``n`` means grid points or bins)."""
    specs = gridspec.split(",")
    if len(specs) == 1 and d > 1:
        specs = specs * d
    if len(specs) != d:
        prefix = f"{subject}; " if subject else ""
        raise SystemExit(f"error: {prefix}--grid needs 1 or {d} "
                         "lo:hi:n specs")
    out = []
    for spec in specs:
        try:
            lo, hi, n = spec.split(":")
            out.append((float(lo), float(hi), int(n)))
        except ValueError:
            raise SystemExit(f"error: bad --grid spec {spec!r} "
                             "(want lo:hi:n)")
    return out


def _open_traj_writer(out, *, xtc_precision=1000.0, with_box=False):
    """Incremental writer (context manager with ``append([c, n, 3])``) for
    ``.dcd``/``.trr``/``.xtc``/``.nc`` outputs, or None for ``.npy`` paths.
    With ``with_box`` the returned writer's ``append`` takes ``(frames,
    box=[k, 3, 3])`` whatever the format (DCD cell conversion here)."""
    low = str(out).lower()
    if low.endswith(".dcd"):
        from ..io.dcd import DCDWriter

        if with_box:
            from ..pbc import box_to_dcd_cell

            class _DCDBoxWriter(DCDWriter):
                def append(self, frames, box=None):
                    super().append(frames, cell=box_to_dcd_cell(box))

            return _DCDBoxWriter(out, has_cell=True)
        return DCDWriter(out)
    if low.endswith(".trr"):
        from ..io.xdr import TRRWriter

        return TRRWriter(out)
    if low.endswith(".xtc"):
        from ..io.xdr import XTCWriter

        return XTCWriter(out, precision=xtc_precision)
    if low.endswith(".nc") or low.endswith(".ncdf"):
        from ..io.netcdf import NetCDFWriter

        return NetCDFWriter(out, with_box=with_box)
    return None


def _model_dims(model):
    """(n_input_atoms, d_out) of a saved model."""
    from ..models.ann import model_dims

    return model_dims(model)


def _load_ref_positions(path, traj, n_atoms):
    """Reference coordinates ``[n_atoms, 3]`` for neighbor culling: an
    explicit ``--cull-ref`` file (.npy array, or any topology format the
    front-end reads: PDB/GRO/XYZ), else the trajectory's first frame."""
    if path:
        if str(path).lower().endswith(".npy"):
            ref = np.load(path)
            ref = ref[0] if ref.ndim == 3 else ref
        else:
            from ..topology import Universe

            ref = Universe(path).atoms.positions
    else:
        from ..io.reader import open_frame_reader

        read, n_frames, _ = open_frame_reader(traj)
        try:
            if n_frames < 1:
                raise SystemExit(
                    f"error: {traj} has no frames to cull against")
            ref = read(0, 1)[0]
        finally:
            read.close()
    ref = np.asarray(ref, dtype=np.float32)
    if ref.shape != (n_atoms, 3):
        raise SystemExit(
            f"error: cull reference has shape {ref.shape}; the model "
            f"takes [{n_atoms}, 3]")
    return ref


def _apply_cull(args, model, device):
    """Apply the ``--cull`` flags to a loaded model and put the blocked
    kernels' pair operand on ``device`` once.

    Returns ``(model, c_mat, report)``: the (possibly culled) model, the
    pair operand of :func:`~molann_tpu_torch.ops.fused.model_chunk_matrix`
    as a tensor on ``device`` for ``c_mat=`` (None where the model has no
    chunked pair table, e.g. after a cull shrank it), and the
    :class:`~molann_tpu_torch.ops.neighbor.CullReport` (None without
    ``--cull``), which is printed."""
    from ..ops.fused import model_chunk_matrix, model_select_mode

    report = None
    if args.cull:
        from ..ops.neighbor import cull_model

        ref = _load_ref_positions(args.cull_ref, args.traj,
                                  _model_dims(model)[0])
        model, report = cull_model(model, ref, tol=args.cull_tol,
                                   skin=args.skin)
        print(report)
    c_mat = None
    if model_select_mode(model) == "blocked":
        C = model_chunk_matrix(model)
        if C is not None:
            import torch

            c_mat = torch.as_tensor(C, device=device)
    return model, c_mat, report


def add_cull_args(sp):
    """The shared ``--cull`` option group (evaluate/forces)."""
    sp.add_argument("--cull", action="store_true",
                    help="cull coordination pair tables to r_cut+skin at "
                         "the reference frame (exact for d_max-truncated "
                         "features; see molann_tpu_torch.ops.neighbor)")
    sp.add_argument("--cull-ref", default=None, metavar="FILE",
                    help="reference coordinates for --cull (.npy or a "
                         "topology file; default: the trajectory's first "
                         "frame)")
    sp.add_argument("--skin", type=float, default=1.0,
                    help="cull skin: the result is valid while no atom "
                         "moves more than skin/2 from the reference "
                         "(default 1.0)")
    sp.add_argument("--cull-tol", type=float, default=1e-6,
                    help="per-pair switching tolerance defining r_cut for "
                         "features without d_max (default 1e-6)")


def _traj_dims(path):
    """(n_frames, floats_per_frame) of a .npy/.dcd/.trr/.xtc/.nc trajectory."""
    from ..io.reader import open_frame_reader

    try:
        read, n_frames, n_atoms = open_frame_reader(path)
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    read.close()
    return n_frames, 3 * n_atoms


def _check_traj(path, n_atoms):
    """Check the trajectory's atom count against the model's."""
    n_frames, fpf = _traj_dims(path)
    if fpf != 3 * n_atoms:
        raise SystemExit(
            f"error: trajectory {path} has {fpf // 3} atoms per frame; the "
            f"model takes {n_atoms}")
    return n_frames
