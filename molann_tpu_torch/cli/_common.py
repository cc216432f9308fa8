"""Shared plumbing of the CLI command modules (the port of
``molann_tpu/cli/_common.py``): model and trajectory loading and checks,
the per-extension trajectory writers, the grid grammar, ``--cull``, the
port's own ``--device``, and the ranks of ``--devices N``."""

from __future__ import annotations

import os
import sys

import numpy as np


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
    card is asked for and there is none)."""
    from .._device import resolve_device

    return resolve_device(args.device)


def _mesh_size(args):
    """``--devices N`` clamped to the devices of ``--device``'s kind (the
    cards, or the host's cores for ``--device cpu``), as the JAX command
    clamps to ``len(jax.devices())``; 0 where it is not given."""
    n = getattr(args, "devices", 0) or 0
    if n < 1:
        return 0
    if _device(args).type == "cuda":
        import torch

        return min(n, torch.cuda.device_count())
    return min(n, os.cpu_count() or 1)


def _rank_main(rank, n, port, body, args):
    """One rank of :func:`run_ranks`: join the group, run ``body``."""
    import torch
    import torch.distributed as dist

    from ..parallel import data_mesh, initialize_multihost

    if rank:  # rank 0 prints
        sys.stdout = open(os.devnull, "w")
    cpu = _device(args).type == "cpu"
    if cpu:  # the host's cores, shared: N ranks of all of them thrash
        torch.set_num_threads(max(1, torch.get_num_threads() // n))
    initialize_multihost(f"localhost:{port}", n, rank,
                         backend="gloo" if cpu else "nccl")
    try:
        rc = body(args, data_mesh(devices="cpu" if cpu else None))
    finally:
        dist.destroy_process_group()
    if rc:
        sys.exit(rc)


def run_ranks(args, body):
    """``body(args, mesh) -> exit code`` on the ranks of ``--devices``:
    without it, once with ``mesh=None``; on one device, once on a mesh of
    one; on N devices, in N processes of one rank each (NCCL on the cards,
    gloo on the host), started with ``spawn`` on a free localhost port,
    after the kernels are built here once. Returns rank 0's exit code, or
    the first failing rank's."""
    n = _mesh_size(args)
    if not n:
        return body(args, None)
    if n == 1:
        from ..parallel import data_mesh

        return body(args, data_mesh(1, devices=_device(args)))
    import torch.multiprocessing as mp

    from ..parallel.multihost import free_port

    if _device(args).type == "cuda":
        from ..ops import fused

        fused._library()
    ctx = mp.start_processes(_rank_main, args=(n, free_port(), body, args),
                             nprocs=n, join=False, start_method="spawn")
    try:
        while not ctx.join():
            pass
    except mp.ProcessExitedException as e:
        return e.exit_code
    return 0


def _shared_memmap(path, shape, mesh):
    """A float32 ``.npy`` memmap every rank of ``mesh`` writes its rows
    of: rank 0 creates it, the others open it after a barrier."""
    from ..parallel.data_parallel import barrier

    if mesh is None or mesh.rank == 0:
        out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32,
                                        shape=shape)
    if mesh is not None:
        barrier(mesh)
        if mesh.rank:
            out = np.load(path, mmap_mode="r+")
    return out


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
