"""Enhanced-sampling commands: sample, fes, reweight, mep, pmf (the port of
``molann_tpu/cli/sampling.py``).

The flags, printed lines, output files and exit codes are the JAX
commands'; ``--device`` is the port's own (the card unless ``cpu`` is
given). ``sample`` hands the integrators the CV as ``lambda x:
fused_model_forward(model, x)`` with the model's parameters frozen: on the
card every biased step runs the forward kernel and autograd the backward
kernel for the force (K1 and K2, or K6 and K7 where ``mode="auto"`` picks
the blocked family); on the CPU the same call runs the plain version.
"""

from __future__ import annotations

import numpy as np

from ._common import (_device, _load_model, _open_traj_writer, _parse_grid,
                      add_device_arg)


def cmd_sample(args):
    """Biased (or plain) Langevin sampling along a saved model's CVs on
    the toy internal-coordinate potential — the closed enhanced-sampling
    loop from the command line."""
    import torch

    from ..ops.fused import fused_model_forward
    from ..sampling import (
        ToyPeptidePotential,
        baoab_langevin,
        metadynamics_langevin,
        opes_langevin,
        overdamped_langevin,
        steered_langevin,
    )
    from ..topology import Universe

    device = _device(args)
    net = _load_model(args.model, device)
    for p in net.parameters():
        p.requires_grad_(False)

    def model(x):
        return fused_model_forward(net, x)

    u = Universe(args.pdb)
    free = tuple(int(a) - 1 for a in args.free_torsion.split(","))
    if len(free) != 4:
        raise SystemExit("error: --free-torsion needs 4 comma-separated "
                         "1-based atom serials")
    pot = ToyPeptidePotential(u, free_torsion=free, barrier=args.barrier)
    energy = pot.energy
    if args.path:
        from ..sampling import PathCV

        path = PathCV.from_mep(args.path)
        if args.tube_k > 0:
            wall = path.wall(model, k_wall=args.tube_k,
                             t_max=args.tube_max)
            energy = lambda x: pot.energy(x) + wall(x)  # noqa: E731
        model = path.along(model)  # bias acts on the 1-D progress s
    n = len(u.atoms)
    x0 = torch.as_tensor(
        np.repeat(u.atoms.positions[None], args.walkers, axis=0),
        dtype=torch.float32, device=device)
    generator = torch.Generator(device=device).manual_seed(args.seed)
    if args.integrator == "baoab" and args.bias != "none":
        raise SystemExit("error: --integrator baoab currently supports "
                         "--bias none only (biased runs use the "
                         "overdamped integrator)")
    bias = None
    if args.bias == "none":
        if args.integrator == "baoab":
            masses = u.atoms.masses.astype(np.float32)
            if (masses <= 0).any():
                raise SystemExit("error: could not guess a mass for every "
                                 "atom in the PDB (unknown element)")
            traj, _, _ = baoab_langevin(
                energy, x0, n_steps=args.steps, dt=args.dt,
                kT=args.kT, gamma=args.gamma, mass=masses,
                generator=generator, thin=args.thin,
            )
        else:
            traj, _ = overdamped_langevin(
                energy, x0, n_steps=args.steps, dt=args.dt, kT=args.kT,
                generator=generator, thin=args.thin,
            )
    elif args.bias == "metad":
        traj, _, bias = metadynamics_langevin(
            energy, model, x0, n_steps=args.steps, dt=args.dt,
            kT=args.kT, generator=generator, height=args.height,
            sigma=args.sigma, stride=args.stride,
            well_tempered_gamma=args.well_tempered_gamma,
        )
    elif args.bias == "opes":
        traj, _, bias = opes_langevin(
            energy, model, x0, n_steps=args.steps, dt=args.dt,
            kT=args.kT, generator=generator, sigma=args.sigma,
            stride=args.stride, barrier=args.bias_barrier,
            gamma=args.bias_gamma, adaptive=args.opes_adaptive,
            max_kernels=args.opes_max_kernels,
        )
    elif args.bias == "steered":
        if args.s0 is None or args.s1 is None:
            raise SystemExit(
                "error: --bias steered requires --s0 and --s1 "
                "(comma-separated start/end CV values)")
        s0 = [float(v) for v in args.s0.split(",")]
        s1 = [float(v) for v in args.s1.split(",")]
        traj, _ = steered_langevin(
            energy, model, x0, s0=s0, s1=s1,
            k_spring=args.k_spring, n_steps=args.steps, dt=args.dt,
            kT=args.kT, generator=generator, thin=args.thin,
        )
    else:  # pragma: no cover — argparse choices guard this
        raise SystemExit(f"unknown bias {args.bias}")

    frames = traj.reshape(-1, n, 3).cpu().numpy()
    writer = _open_traj_writer(args.out)
    if writer is not None:
        with writer:
            writer.append(frames)
    else:
        np.save(args.out, frames)
    cos_phi = np.cos(pot.phi(torch.from_numpy(frames)).numpy())
    print(f"wrote {args.out}: {frames.shape[0]} frames "
          f"({args.walkers} walker(s) x {frames.shape[0] // args.walkers} "
          f"records); free-torsion cos(phi) in "
          f"[{cos_phi.min():+.2f}, {cos_phi.max():+.2f}]")
    if bias is not None and args.bias_out:
        bias.save(args.bias_out)
        print(f"wrote {args.bias_out}: {bias.centers.shape[0]} deposits")
    return 0


def cmd_fes(args):
    """Reconstruct the free-energy surface from a saved bias file
    (``sample --bias-out``): metadynamics hills give F(s) = -V(s)
    (scaled by gamma/(gamma-1) for well-tempered runs), OPES kernel
    files give -kT log of the reweighted probability estimate; shifted
    so min F = 0 on the grid."""
    import torch

    from ..sampling import OpesBias, load_bias

    device = _device(args)
    bias = load_bias(args.hills).to(device)
    d = bias.centers.shape[1]
    axes = [
        np.linspace(lo, hi, n, dtype=np.float32)
        for lo, hi, n in _parse_grid(args.grid, d,
                                     subject=f"hills are {d}-dimensional")
    ]
    mesh = np.meshgrid(*axes, indexing="ij")
    grid = np.stack([m.ravel() for m in mesh], axis=-1)
    f = bias.free_energy_estimate(
        torch.as_tensor(grid, device=device)).cpu().numpy()
    f -= f.min()
    shape = tuple(len(a) for a in axes)
    if isinstance(bias, OpesBias):
        kind = f"OPES (gamma={bias.gamma:g}, barrier={bias.barrier:g})"
    else:
        kind = (f"well-tempered (gamma={bias.gamma:g})"
                if bias.gamma is not None else "standard")
    print(f"{args.hills}: {int(bias.n_active)} {kind} deposits, "
          f"{d}-d CV; barrier estimate (max-min on grid) = "
          f"{f.max():.4f}")
    if args.out:
        if args.out.endswith(".csv"):
            with open(args.out, "w") as fh:
                fh.write(",".join(f"s{i}" for i in range(d))
                         + ",free_energy\n")
                for row, val in zip(grid, f):
                    fh.write(",".join(f"{v:.6g}" for v in row)
                             + f",{val:.6g}\n")
        else:
            np.save(args.out, f.reshape(shape))
        print(f"wrote {args.out}: grid {shape}")
    return 0


def cmd_reweight(args):
    """Per-frame importance weights from a saved bias + the frames' CV
    values ('evaluate' output): w_t ∝ exp(+V(s_t)/kT), normalized to
    mean 1 — the last-bias estimator, for ``train --weights``."""
    import torch

    from ..sampling import OpesBias, load_bias

    device = _device(args)
    bias = load_bias(args.bias).to(device)
    cvs = np.asarray(np.load(args.cvs), np.float32)
    if cvs.ndim == 1:
        cvs = cvs[:, None]
    d = bias.centers.shape[1]
    if cvs.ndim != 2 or cvs.shape[1] != d:
        raise SystemExit(f"error: bias is over a {d}-d CV; {args.cvs} "
                         f"has shape {np.load(args.cvs, mmap_mode='r').shape}")
    cv_t = torch.as_tensor(cvs, device=device)
    if isinstance(bias, OpesBias):
        kT = args.kT if args.kT is not None else bias.kT
        w = bias.frame_weights(cv_t, kT)
    else:
        if args.kT is None:
            raise SystemExit("error: hills files carry no temperature; "
                             "pass --kT (the sampling temperature)")
        w = bias.frame_weights(cv_t, args.kT)
    w = np.asarray(w.cpu().numpy(), np.float32)
    np.save(args.out, w)
    ess = float(w.sum() ** 2 / (w**2).sum())
    print(f"wrote {args.out}: {w.shape[0]} weights, effective sample "
          f"size {ess:.1f} ({100.0 * ess / w.shape[0]:.1f}%)")
    return 0


def cmd_mep(args):
    """Minimum free-energy path (simplified string method) on a
    reconstructed FES: input is either a saved bias file (``sample
    --bias-out``; the smooth bias is differentiated directly) or a gridded
    FES .npy (``fes``/``pmf`` output) with its --grid spec (multilinear
    interpolation)."""
    import torch

    from ..sampling import grid_interpolator, linear_path, string_method

    device = _device(args)
    start = np.asarray([float(v) for v in args.start.split(",")],
                       np.float32)
    end = np.asarray([float(v) for v in args.end.split(",")], np.float32)
    if start.shape != end.shape:
        raise SystemExit("error: --start and --end dimensions differ")
    d = len(start)

    if str(args.fes).endswith(".npz"):
        from ..sampling import OpesBias, load_bias

        bias = load_bias(args.fes)
        if bias.centers.shape[1] != d:
            raise SystemExit(f"error: hills are {bias.centers.shape[1]}-"
                             f"dimensional, endpoints are {d}-dimensional")
        bias.to(device)
        if isinstance(bias, OpesBias):
            energy = bias.free_energy_estimate  # smooth, differentiable
        else:
            scale = (bias.gamma / (bias.gamma - 1.0)
                     if bias.gamma is not None else 1.0)

            def energy(z):
                return -scale * bias.energy(z)
    else:
        table = np.load(args.fes)
        if table.ndim == 2 and table.shape[0] == 2 and d == 1:
            # 'pmf' output convention: [2, n] = mids + F
            mids, table = [table[0]], table[1]
        else:
            if table.ndim != d:
                raise SystemExit(f"error: FES grid is {table.ndim}-"
                                 f"dimensional, endpoints are {d}-"
                                 "dimensional")
            if not args.grid:
                raise SystemExit("error: a gridded FES .npy needs --grid "
                                 "(the same lo:hi:n spec given to 'fes')")
            mids = []
            for (lo, hi, n), n_have in zip(_parse_grid(args.grid, d),
                                           table.shape):
                if n != n_have:
                    raise SystemExit(f"error: --grid says {n} points but "
                                     f"the FES axis has {n_have}")
                mids.append(np.linspace(lo, hi, n))
        finite = np.isfinite(table)
        fill = (float(table[finite].max()) + 5.0 if finite.any() and
                not finite.all() else None)
        energy = grid_interpolator(mids, table, fill=fill)

    imgs, e = string_method(
        energy, linear_path(torch.as_tensor(start, device=device),
                            torch.as_tensor(end, device=device),
                            args.images),
        n_iterations=args.iterations, step=args.step,
        pin_ends=args.pin_ends)
    imgs, e = imgs.cpu().numpy(), e.cpu().numpy()
    top = int(e.argmax())
    print(f"string converged over {args.iterations} iterations: "
          f"endpoints F = {e[0]:.4f} / {e[-1]:.4f}, barrier F = "
          f"{e.max():.4f} at image {top} "
          f"({', '.join(f'{v:.4f}' for v in imgs[top])})"
          + ("" if 0 < top < len(e) - 1 else
             " [WARNING: barrier at an endpoint — string may not bracket "
             "a transition]"))
    if args.out:
        if str(args.out).endswith(".csv"):
            with open(args.out, "w") as fh:
                fh.write(",".join(f"cv{i}" for i in range(d))
                         + ",free_energy\n")
                for row, v in zip(imgs, e):
                    fh.write(",".join(f"{c:.6g}" for c in row)
                             + f",{v:.6g}\n")
        else:
            np.save(args.out, np.concatenate([imgs, e[:, None]], axis=1))
        print(f"wrote {args.out}: {len(e)} images")
    return 0


def cmd_pmf(args):
    """Free-energy profile from umbrella-sampling windows via MBAR.

    Input: ``cvs.npy`` shaped [n_windows, n_samples] (one row of CV
    samples per window, e.g. from
    :func:`molann_tpu_torch.sampling.umbrella_sampling`), plus the window
    centers and spring constant. Writes/prints F over --grid.
    """
    import torch

    from ..sampling import mbar, pmf_from_samples

    device = _device(args)
    cvs = np.asarray(np.load(args.cvs), np.float32)
    if cvs.ndim != 2:
        raise SystemExit(f"error: {args.cvs} must be [n_windows, "
                         f"n_samples]; got shape {cvs.shape}")
    centers = np.asarray([float(v) for v in args.centers.split(",")],
                         np.float32)
    if len(centers) != cvs.shape[0]:
        raise SystemExit(f"error: {len(centers)} centers for "
                         f"{cvs.shape[0]} windows")
    pooled = cvs.reshape(-1)
    u_kn = (0.5 * args.k_spring
            * (pooled[None, :] - centers[:, None]) ** 2) / args.kT
    f_win, log_w = mbar(torch.as_tensor(u_kn, device=device),
                        np.full(cvs.shape[0], cvs.shape[1]))
    (lo, hi, n), = _parse_grid(args.grid, 1)
    edges = np.linspace(lo, hi, n + 1)  # n = bin count
    f = pmf_from_samples(pooled, log_w, edges, kT=args.kT)
    mids = (edges[1:] + edges[:-1]) / 2
    ok = np.isfinite(f)
    print(f"{args.cvs}: {cvs.shape[0]} windows x {cvs.shape[1]} samples; "
          f"window free energies (kT units, f0=0): "
          + ", ".join(f"{v:.3f}" for v in f_win.cpu().numpy()))
    print(f"PMF barrier estimate (max-min over populated bins) = "
          f"{f[ok].max():.4f}")
    if args.out:
        if str(args.out).endswith(".csv"):
            with open(args.out, "w") as fh:
                fh.write("cv,free_energy\n")
                for m, v in zip(mids, f):
                    fh.write(f"{m:.6g},{v:.6g}\n")
        else:
            np.save(args.out, np.stack([mids, f]))
        print(f"wrote {args.out}: {ok.sum()}/{len(f)} bins populated")
    return 0


def register(sub):
    ps = sub.add_parser(
        "sample",
        help="biased Langevin sampling along the model's CVs (toy "
             "potential; the closed enhanced-sampling loop)")
    ps.add_argument("model", help="saved CV model (.npz)")
    ps.add_argument("pdb", help="structure defining the toy potential")
    ps.add_argument("--bias", choices=["none", "metad", "opes", "steered"],
                    default="metad")
    ps.add_argument("--integrator", choices=["overdamped", "baoab"],
                    default="overdamped",
                    help="baoab = underdamped Langevin with per-atom "
                         "masses guessed from the PDB (--bias none only)")
    ps.add_argument("--gamma", type=float, default=5.0,
                    help="baoab friction (1/time)")
    ps.add_argument("--out", default="sampled.npy",
                    help="trajectory output (.npy/.dcd/.trr/.xtc/.nc)")
    ps.add_argument("--bias-out", default=None,
                    help="write metadynamics deposits (.npz)")
    ps.add_argument("--steps", type=int, default=5000)
    ps.add_argument("--walkers", type=int, default=4)
    ps.add_argument("--dt", type=float, default=2e-4)
    ps.add_argument("--kT", type=float, default=0.25)
    ps.add_argument("--thin", type=int, default=50,
                    help="record every N-th frame (none/steered)")
    ps.add_argument("--seed", type=int, default=0,
                    help="seed of the torch.Generator on the device (the "
                         "JAX command's key gives other numbers)")
    ps.add_argument("--free-torsion", default="5,7,9,15",
                    help="1-based atom serials of the free torsion")
    ps.add_argument("--barrier", type=float, default=6.0)
    ps.add_argument("--height", type=float, default=0.5,
                    help="metadynamics Gaussian height")
    ps.add_argument("--sigma", type=float, default=0.25)
    ps.add_argument("--stride", type=int, default=50,
                    help="metadynamics deposit stride (also the record "
                         "interval)")
    ps.add_argument("--well-tempered-gamma", type=float, default=None,
                    help="bias factor > 1 switches on well-tempered "
                         "metadynamics (hills decay; pick so that "
                         "kT*(gamma-1) ~ the barrier height)")
    ps.add_argument("--bias-barrier", type=float, default=8.0,
                    help="OPES: expected barrier height (caps the bias "
                         "depth; the one physical input)")
    ps.add_argument("--bias-gamma", type=float, default=None,
                    help="OPES bias factor (default: barrier/kT)")
    ps.add_argument("--opes-adaptive", action="store_true",
                    help="OPES: PLUMED bandwidth-shrink + moment-"
                         "preserving kernel compression (long runs "
                         "keep refining the bias in a bounded kernel "
                         "list)")
    ps.add_argument("--opes-max-kernels", type=int, default=None,
                    help="adaptive OPES: kernel-list slot bound "
                         "(default min(walkers x periods, 512))")
    ps.add_argument("--s0", default=None, help="steered start CV (comma)")
    ps.add_argument("--s1", default=None, help="steered end CV (comma)")
    ps.add_argument("--k-spring", type=float, default=10.0)
    ps.add_argument("--path", default=None, metavar="MEP",
                    help="bias the PATH PROGRESS s in [0, 1] along a "
                         "'mep --out' path (.npy/.csv) instead of the "
                         "raw CVs (Branduardi path CVs over the model)")
    ps.add_argument("--tube-k", type=float, default=0.0,
                    help="with --path: half-harmonic restraint strength "
                         "keeping walkers inside the transition tube")
    ps.add_argument("--tube-max", type=float, default=0.05,
                    help="tube width (CV distance squared) where the "
                         "--tube-k restraint switches on")
    add_device_arg(ps, "sample on")
    ps.set_defaults(fn=cmd_sample)

    pg = sub.add_parser(
        "fes",
        help="free-energy surface from a metadynamics hills file")
    pg.add_argument("hills", help="deposits .npz from sample --bias-out")
    pg.add_argument("--grid", default="-3.2:3.2:200",
                    metavar="LO:HI:N[,LO:HI:N...]",
                    help="CV grid, one comma-separated lo:hi:n per CV "
                         "dimension (a single spec is broadcast to all "
                         "dims); use --grid=... when lo is negative")
    pg.add_argument("--out", default=None,
                    help=".npy (grid-shaped) or .csv (long-form) output")
    add_device_arg(pg, "evaluate the bias on")
    pg.set_defaults(fn=cmd_fes)

    prw = sub.add_parser(
        "reweight",
        help="per-frame importance weights from a saved bias + CV "
             "values (for 'train --weights')")
    prw.add_argument("bias", help="hills/kernels .npz (sample --bias-out)")
    prw.add_argument("cvs", help=".npy CV values [T] or [T, d] "
                                 "('evaluate' output)")
    prw.add_argument("--kT", type=float, default=None,
                     help="sampling temperature (required for hills "
                          "files; OPES kernel files carry their own)")
    prw.add_argument("--out", default="weights.npy")
    add_device_arg(prw, "evaluate the bias on")
    prw.set_defaults(fn=cmd_reweight)

    pme = sub.add_parser(
        "mep",
        help="minimum free-energy path (string method) on a "
             "reconstructed FES")
    pme.add_argument("fes",
                     help="hills .npz (sample --bias-out) or FES grid "
                          ".npy (fes/pmf output)")
    pme.add_argument("--start", required=True,
                     help="comma-separated CV start point (use "
                          "--start=... when negative)")
    pme.add_argument("--end", required=True,
                     help="comma-separated CV end point")
    pme.add_argument("--grid", default=None, metavar="LO:HI:N[,...]",
                     help="grid spec of the FES .npy (same string given "
                          "to 'fes'; not needed for hills .npz or 'pmf' "
                          "[2, n] files)")
    pme.add_argument("--images", type=int, default=48)
    pme.add_argument("--iterations", type=int, default=4000)
    pme.add_argument("--step", type=float, default=1e-3)
    pme.add_argument("--pin-ends", action="store_true",
                     help="keep endpoints fixed instead of relaxing "
                          "them into the nearest minima")
    pme.add_argument("--out", default=None,
                     help=".npy ([m, d+1]: images + F) or .csv output")
    add_device_arg(pme, "relax the string on")
    pme.set_defaults(fn=cmd_mep)

    pp_ = sub.add_parser(
        "pmf",
        help="free-energy profile from umbrella windows (MBAR)")
    pp_.add_argument("cvs", help=".npy [n_windows, n_samples] CV samples")
    pp_.add_argument("--centers", required=True,
                     help="comma-separated window centers (one per row); "
                          "use --centers=... when the first is negative")
    pp_.add_argument("--k-spring", type=float, required=True,
                     help="harmonic restraint constant")
    pp_.add_argument("--kT", type=float, default=1.0)
    pp_.add_argument("--grid", default="-1:1:40", metavar="LO:HI:N",
                     help="CV histogram grid (use --grid=... when lo is "
                          "negative)")
    pp_.add_argument("--out", default=None,
                     help=".npy ([2, n]: mids + F) or .csv output")
    add_device_arg(pp_, "solve MBAR on")
    pp_.set_defaults(fn=cmd_pmf)
