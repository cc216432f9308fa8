"""Model inspection and trajectory evaluation commands: ``info``,
``evaluate``, ``forces``, ``committee`` (the port of
``molann_tpu/cli/evaluate.py``).

``evaluate`` and ``forces`` stream the trajectory in batches of
``--batch-size`` frames (the last batch short, as in the JAX command)
through the fused ops on ``--device``: on the card each batch is one launch
of the forward kernel (K1, or K6 for a blocked model) or of the cv+forces
kernel (K4, or K8). A blocked model whose CVs read few atoms takes K8's
compact gradients, and only the active atoms' rows are written into the
zero-filled forces file. ``committee`` runs its members eagerly, one after
another. Outputs stream to ``.npy`` memmaps.

``--devices N`` runs the commands on N ranks, one device each (the cards;
host processes with ``--device cpu``): ``evaluate`` and ``forces`` stream
through :func:`~molann_tpu_torch.serve.evaluate_trajectory` on the data
mesh, as the JAX commands do, and ``committee`` splits each batch; every
rank writes its rows straight into the memmaps, and rank 0 prints.
"""

from __future__ import annotations

import functools
import sys
import time

import numpy as np

from ._common import (_apply_cull, _check_traj, _device, _load_model,
                      _model_dims, _shared_memmap, add_cull_args,
                      add_device_arg, run_ranks)


def feature_table(feature_list):
    """The rows of the reference's ``get_feature_info()`` table (name,
    type, type_id, 1-based atom indices) as text, laid out as pandas'
    ``to_string`` lays it out, without pandas: a text column's cells carry
    a leading space and follow one space, the integer column follows two."""
    head = ("name", "type", "type_id", "atom indices (1-based)")
    seps = (" ", " ", "  ", " ")
    rows = [(f" {f.name}", f" {f.type_name}", str(f.type_id),
             f" {[int(i) for i in f.get_atom_indices()]}")
            for f in feature_list]
    idx = [str(i) for i in range(len(rows))]
    wi = max(len(s) for s in idx)
    widths = [max(len(h), *(len(r[c]) for r in rows))
              for c, h in enumerate(head)]

    def line(first, cells):
        return first.ljust(wi) + "".join(
            sep + cell.rjust(w) for sep, cell, w in zip(seps, cells, widths))

    return "\n".join([line("", head)]
                     + [line(i, r) for i, r in zip(idx, rows)])


def cmd_info(args):
    # the file is read on the host: info computes nothing
    model = _load_model(args.model, "cpu")
    from ..models.ann import AlignmentLayer, MolANN

    print(f"model: {type(model).__name__}")
    if isinstance(model, MolANN):
        pp = model.get_preprocessing_layer()
        fl = pp.feature_layer
        print(f"output dimension (features): {pp.output_dimension()}")
        print(f"MLP dims: {list(model.ann_layers.layer_dims)}")
        print("features:")
        print(feature_table(fl.feature_list))
        align = pp.align_layer
        if isinstance(align, AlignmentLayer):
            print(f"alignment: {len(align.align_atom_indices)} atoms, "
                  f"method={align.method}")
        else:
            print("alignment: none")
    return 0


class _Split:
    """Where a serving command's time goes: the host's reads and stores
    (host clock) and, on the card, the copy in, the kernel and the copy out
    (CUDA events, read once at the end), printed with ``--verbose``."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.host = {"read": 0.0, "store": 0.0, "device": 0.0}
        self.events = []
        self.t0 = time.perf_counter()

    def mark(self):
        if not self.cuda:
            return None
        import torch

        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def report(self, n_frames):
        total = time.perf_counter() - self.t0
        parts = [f"{k} {v:.6g} s" for k, v in self.host.items()]
        if self.events:
            import torch

            torch.cuda.synchronize()
            sums = [0.0, 0.0, 0.0]
            for evs in self.events:
                for k in range(3):
                    sums[k] += evs[k].elapsed_time(evs[k + 1]) / 1e3
            parts += [f"{k} {v:.6g} s" for k, v in
                      zip(("copy in", "kernel", "copy out"), sums)]
        rate = n_frames / total if total > 0 else float("inf")
        print(f"timing: {n_frames} frames in {total:.6g} s, {rate:.6g} "
              f"frames/s end to end; " + ", ".join(parts), file=sys.stderr)


def _evaluate_on_mesh(args, mesh, want_forces):
    """``evaluate``/``forces`` on the data mesh (``--devices``): the
    serving path of :func:`~molann_tpu_torch.serve.evaluate_trajectory`,
    each rank's rows written straight into the memmaps."""
    from ..parallel.data_parallel import barrier
    from ..serve import evaluate_trajectory

    model = _load_model(args.model, mesh.device)
    n_atoms, d_out = _model_dims(model)
    n_frames = _check_traj(args.traj, n_atoms)
    model, c_mat, _ = _apply_cull(args, model, mesh.device)
    quantum = 8 * mesh.size
    bs = min(args.batch_size, -(-n_frames // quantum) * quantum)
    y_out = _shared_memmap(args.out, (n_frames, d_out), mesh)
    g_out = None
    if want_forces:
        g_out = _shared_memmap(args.forces_out, (n_frames, 3 * n_atoms),
                               mesh)
    evaluate_trajectory(
        model, args.traj, mesh=mesh, forces=want_forces, batch_size=bs,
        tile=args.tile, interpret=args.interpret, backend=args.backend,
        component=getattr(args, "component", None), cvs_out=y_out,
        grads_out=None if g_out is None else g_out.reshape(-1, n_atoms, 3),
        grads_transform=np.negative,  # the force convention, in flight
        c_mat=c_mat)
    y_out.flush()
    if want_forces:
        g_out.flush()
    barrier(mesh)
    print(f"wrote {args.out}: {y_out.shape} ({mesh.size} devices)")
    if want_forces:
        print(f"wrote {args.forces_out}: {g_out.shape}")
    return 0


def _evaluate(args, want_forces):
    import torch

    from ..ops.fused import (
        active_atom_indices,
        check_tile_args,
        fused_cv_forces,
        fused_model_forward,
        model_select_mode,
    )
    from ..train.data import packed_batch_iterator

    check_tile_args(args.tile, args.interpret)  # before any file is written
    if args.devices:
        return run_ranks(args, functools.partial(_evaluate_on_mesh,
                                                 want_forces=want_forces))
    device = _device(args)
    model = _load_model(args.model, device)
    n_atoms, d_out = _model_dims(model)
    n_frames = _check_traj(args.traj, n_atoms)
    # --cull, and the pair operand of a blocked model put on the device once
    model, c_mat, _ = _apply_cull(args, model, device)
    # a blocked model whose CVs read few atoms: gradients on the active
    # atoms only; the untouched atoms' forces are the memmap's zeros
    compact_idx = None
    if want_forces and model_select_mode(model) == "blocked":
        compact_idx = active_atom_indices(model)
    kw = dict(tile=args.tile, interpret=args.interpret, c_mat=c_mat)
    component = getattr(args, "component", None)
    y_out = np.lib.format.open_memmap(
        args.out, mode="w+", dtype=np.float32, shape=(n_frames, d_out))
    g_out = None
    if want_forces:
        g_out = np.lib.format.open_memmap(
            args.forces_out, mode="w+", dtype=np.float32,
            shape=(n_frames, 3 * n_atoms))
    split = _Split(device)
    n_done = 0
    batches = packed_batch_iterator(
        args.traj, args.batch_size, shuffle=False, epochs=1,
        drop_remainder=False, backend=args.backend)
    with torch.no_grad():
        while True:
            t0 = time.perf_counter()
            xb = next(batches, None)
            t1 = time.perf_counter()
            split.host["read"] += t1 - t0
            if xb is None:
                break
            b = xb.shape[0]
            evs = [split.mark()]
            x = torch.from_numpy(xb).to(device)
            evs.append(split.mark())
            g = None
            if want_forces and compact_idx is not None:
                y, g = fused_cv_forces(model, x, component=component,
                                       compact_grads=True, **kw)
            elif want_forces:
                y, g = fused_cv_forces(model, x, component=component, **kw)
            else:
                y = fused_model_forward(model, x, **kw)
            evs.append(split.mark())
            y = y.cpu().numpy()
            g = None if g is None else g.cpu().numpy()
            evs.append(split.mark())
            t2 = time.perf_counter()
            split.host["device"] += t2 - t1
            if split.cuda:
                split.events.append(evs)
            y_out[n_done:n_done + b] = y
            if g is not None and compact_idx is not None:
                # g: [3, n_active, l] -> the active atoms' rows
                blk = g_out[n_done:n_done + b].reshape(-1, n_atoms, 3)
                blk[:, compact_idx, :] = np.negative(np.transpose(g,
                                                                  (2, 1, 0)))
            elif g is not None:
                g_out[n_done:n_done + b] = np.negative(g)  # forces
            n_done += b
            split.host["store"] += time.perf_counter() - t2
            if args.verbose:
                print(f"\r{n_done}/{n_frames} frames", end="",
                      file=sys.stderr)
    if args.verbose:
        print(file=sys.stderr)
    y_out.flush()
    if want_forces:
        g_out.flush()
    if args.verbose:
        split.report(n_done)
    print(f"wrote {args.out}: {y_out.shape}")
    if want_forces:
        print(f"wrote {args.forces_out}: {g_out.shape}")
    return 0


def cmd_evaluate(args):
    return _evaluate(args, want_forces=False)


def cmd_forces(args):
    return _evaluate(args, want_forces=True)


def cmd_committee(args):
    """Committee CV evaluation: mean + disagreement over member models.

    The std over members is the epistemic-uncertainty signal for adaptive
    sampling (train members with ``train --ensemble K``). With
    ``--calibrate REF_TRAJ`` the members are gauge-fixed (standardized and
    sign-aligned) on the reference frames first, as CVs defined only up to
    sign and scale need (autoencoder / VAMP / eigenfunction objectives).
    The members run eagerly on ``--device``, one after another; with
    ``--devices N`` each of N ranks takes its share of every batch.
    """
    return run_ranks(args, _committee)


def _committee(args, mesh):
    import torch

    from ..io.reader import open_frame_reader
    from ..train import (
        calibrated_committee,
        committee,
        committee_calibration,
        stack_models,
    )
    from ..train.data import packed_batch_iterator

    device = _device(args) if mesh is None else mesh.device
    models = [_load_model(p, device) for p in args.models]
    if len(models) < 2:
        print("error: a committee needs at least 2 member models",
              file=sys.stderr)
        return 1
    dims = [_model_dims(m) for m in models]
    if len(set(dims)) != 1:
        print(f"error: members disagree on (n_atoms, d_out): {dims}",
              file=sys.stderr)
        return 1
    n_atoms, d_out = dims[0]
    n_frames = _check_traj(args.traj, n_atoms)
    try:
        stacked = stack_models(models)
    except ValueError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1

    calib = None
    if args.calibrate:
        read, n_ref, na_ref = open_frame_reader(args.calibrate,
                                                backend=args.backend)
        try:
            if na_ref != n_atoms:
                print(f"error: --calibrate trajectory has {na_ref} atoms "
                      f"per frame; the models take {n_atoms}",
                      file=sys.stderr)
                return 1
            sel = np.unique(np.linspace(
                0, n_ref - 1, min(n_ref, args.calibrate_frames)).astype(int))
            x_ref = torch.as_tensor(
                np.concatenate([read(int(i), 1) for i in sel], axis=0),
                device=device)
        finally:
            read.close()
        with torch.no_grad():
            calib = committee_calibration(stacked, x_ref)

        def fn(x):
            return calibrated_committee(stacked, x, calibration=calib)
    else:
        def fn(x):
            return committee(stacked, x)

    mean_out = _shared_memmap(args.out, (n_frames, d_out), mesh)
    std_out = _shared_memmap(args.std_out, (n_frames, d_out), mesh)
    rank, size = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    n_done = 0
    with torch.no_grad():
        for xb in packed_batch_iterator(
                args.traj, args.batch_size, shuffle=False, epochs=1,
                drop_remainder=False, backend=args.backend):
            per = -(-xb.shape[0] // size)  # this rank's rows of the batch
            lo, hi = n_done + rank * per, min(n_done + (rank + 1) * per,
                                              n_done + xb.shape[0])
            if hi > lo:
                x = torch.from_numpy(xb[lo - n_done:hi - n_done]).to(
                    device).reshape(hi - lo, -1, 3)
                m, s = fn(x)
                mean_out[lo:hi] = m.cpu().numpy()
                std_out[lo:hi] = s.cpu().numpy()
            n_done += xb.shape[0]
    mean_out.flush()
    std_out.flush()
    if mesh is not None:
        from ..parallel.data_parallel import barrier

        barrier(mesh)
    mx = float(std_out.max()) if n_frames else 0.0
    print(f"wrote {args.out} (committee mean) and {args.std_out} "
          f"(disagreement): {mean_out.shape}, {len(models)} members"
          f"{', calibrated' if calib is not None else ''}; "
          f"max disagreement {mx:.4g}")
    return 0


def register(sub):
    pi = sub.add_parser("info", help="describe a saved model")
    pi.add_argument("model")
    pi.set_defaults(fn=cmd_info)

    def add_eval_args(sp):
        sp.add_argument("model")
        sp.add_argument("traj", help="trajectory (.npy/.dcd/.trr/.xtc/.nc)")
        sp.add_argument("--out", default="cvs.npy")
        sp.add_argument("--batch-size", type=int, default=1 << 20)
        sp.add_argument("--tile", type=int, default=None,
                        help="accepted for the JAX command's flags; the "
                             "CUDA kernels choose their own tile")
        sp.add_argument("--backend", default="auto",
                        choices=["auto", "native", "numpy"])
        sp.add_argument("--interpret", action="store_true",
                        help="accepted for the JAX command's flags; changes "
                             "nothing (--device cpu runs the plain versions)")
        sp.add_argument("--devices", type=int, default=0,
                        help="shard batches over N devices, one rank each "
                             "(the cards; host processes with --device "
                             "cpu)")
        sp.add_argument("--verbose", action="store_true",
                        help="progress, then the time split (read, copy in, "
                             "kernel, copy out, store) on stderr")
        add_device_arg(sp)
        add_cull_args(sp)

    pe = sub.add_parser("evaluate",
                        help="evaluate CV values over a trajectory")
    add_eval_args(pe)
    pe.set_defaults(fn=cmd_evaluate)

    pf = sub.add_parser("forces", help="evaluate CVs + biasing forces")
    add_eval_args(pf)
    pf.add_argument("--component", type=int, default=None)
    pf.add_argument("--forces-out", default="forces.npy")
    pf.set_defaults(fn=cmd_forces)

    pcm = sub.add_parser(
        "committee",
        help="committee CV evaluation: per-frame mean + member "
             "disagreement (epistemic uncertainty) over K models trained "
             "with `train --ensemble K`")
    pcm.add_argument("models", nargs="+",
                     help="2+ member models (.npz), e.g. "
                          "trained.member0.npz trained.member1.npz ...")
    pcm.add_argument("traj",
                     help="trajectory to score (.npy/.dcd/.trr/.xtc/.nc)")
    pcm.add_argument("--out", default="cvs.npy",
                     help="committee-mean CVs [n_frames, d]")
    pcm.add_argument("--std-out", default="uncertainty.npy",
                     help="member disagreement (std) [n_frames, d]: large "
                          "where the committee extrapolates")
    pcm.add_argument("--calibrate", default=None, metavar="REF_TRAJ",
                     help="gauge-fix members (standardize + sign-align) on "
                          "these reference frames first, as sign/scale-free "
                          "CVs (autoencoder / vamp / eigenfunction) need; "
                          "typically the training trajectory")
    pcm.add_argument("--calibrate-frames", type=int, default=4096,
                     help="max evenly-spaced reference frames used for "
                          "calibration")
    pcm.add_argument("--batch-size", type=int, default=1 << 16)
    pcm.add_argument("--backend", default="auto",
                     choices=["auto", "native", "numpy"])
    pcm.add_argument("--devices", type=int, default=0,
                     help="split each batch over N devices, one rank each "
                          "(the cards; host processes with --device cpu)")
    add_device_arg(pcm)
    pcm.set_defaults(fn=cmd_committee)
