"""Kinetics analysis commands: msm (the port of
``molann_tpu/cli/analysis.py``).

Host numpy work over a CV series, as in the JAX package: the flags,
printed lines, output file and exit codes are the JAX command's.
"""

from __future__ import annotations

import numpy as np

from ._common import _parse_grid


def cmd_msm(args):
    """Markov state model over a CV trajectory ('evaluate' output):
    grid-discretize, count lag transitions, reversible-MLE transition
    matrix, implied timescales + Chapman-Kolmogorov Markovianity check."""
    from ..sampling import ck_test, estimate_msm, grid_assign

    cvs = np.load(args.cvs)
    if cvs.ndim == 1:
        cvs = cvs[:, None]
    if cvs.ndim != 2:
        raise SystemExit(f"error: CVs must be [T] or [T, d], got "
                         f"{cvs.shape}")
    d = cvs.shape[1]
    edges = [
        np.linspace(lo, hi, n + 1)  # n = bin count for msm
        for lo, hi, n in _parse_grid(args.grid, d,
                                     subject=f"CVs are {d}-dimensional")
    ]
    n_states = int(np.prod([len(e) - 1 for e in edges]))

    labels = grid_assign(cvs, edges)
    if args.walkers > 1:
        if len(labels) % args.walkers:
            raise SystemExit(f"error: {len(labels)} samples do not "
                             f"divide into {args.walkers} walkers")
        # 'sample'/'evaluate' trajectories interleave walkers per record
        # ([t0w0, t0w1, ...]); split into one contiguous series each
        lw = labels.reshape(-1, args.walkers)
        series = [lw[:, w] for w in range(args.walkers)]
    else:
        series = labels

    m = estimate_msm(series, n_states, args.lag,
                     reversible=not args.nonreversible)
    pop = np.flatnonzero(m.pi > 0)
    print(f"{n_states} grid states ({pop.size} populated), lag "
          f"{args.lag} frames")
    order = pop[np.argsort(-m.pi[pop])][:5]
    print("top states by stationary weight: "
          + ", ".join(f"#{s}: {m.pi[s]:.3f}" for s in order))
    ts = m.timescales()
    k = min(args.n_timescales, len(ts))
    print("implied timescales (frames): "
          + ", ".join("inf" if not np.isfinite(t) else f"{t:.1f}"
                      for t in ts[:k]))
    extra_out = {}
    if args.bootstrap:
        from ..sampling import bootstrap_msm

        boot = bootstrap_msm(
            series, n_states, args.lag, n_samples=args.bootstrap,
            reversible=not args.nonreversible, n_timescales=k,
            seed=args.bootstrap_seed,
        )
        lo, hi = boot.timescale_ci()

        def fmt(v):
            return "inf" if not np.isfinite(v) else f"{v:.1f}"

        unit = ("trajectories" if args.walkers > 1
                else f"{boot.block}-frame circular blocks")
        print(f"bootstrap ({args.bootstrap} resamples of "
              f"{boot.n_resampled} {unit}), 95% CIs: "
              + ", ".join(f"[{fmt(a)}, {fmt(b)}]"
                          for a, b in zip(lo, hi)))
        pi_lo, pi_hi = boot.pi_ci()
        print("top-state populations: "
              + ", ".join(
                  f"#{s}: {m.pi[s]:.3f} [{pi_lo[s]:.3f}, {pi_hi[s]:.3f}]"
                  for s in order))
        extra_out.update(bootstrap_timescales=boot.timescales,
                         bootstrap_pi=boot.pi)
    if args.coarse:
        # one PCCA+ eigendecomposition serves both outputs
        tc, pic, chi = m.coarse_grain(args.coarse)
        assign = chi.argmax(axis=1)
        order_c = np.argsort(-pic)
        print(f"PCCA+ coarse-graining into {args.coarse} metastable "
              "sets (by weight): "
              + "; ".join(
                  f"set {int(c)}: pi={pic[c]:.3f}, states "
                  f"{np.flatnonzero((assign == c) & (m.pi > 0)).tolist()}"
                  for c in order_c))
        extra_out.update(assignments=assign, memberships=chi,
                         coarse_transition=tc, coarse_pi=pic)
    if args.mfpt_to:
        tgt = [int(s) for s in args.mfpt_to.split(",")]
        try:
            fp = m.mfpt(tgt)
        except ValueError as e:
            raise SystemExit(f"error: --mfpt-to: {e}")
        src = np.flatnonzero((m.pi > 0) & np.isfinite(fp) & (fp > 0))
        if src.size:
            wavg = float((fp[src] * m.pi[src]).sum() / m.pi[src].sum())
            print(f"MFPT to states {tgt}: pi-weighted mean "
                  f"{wavg:.1f} frames, max {fp[src].max():.1f} "
                  f"(from state {int(src[fp[src].argmax()])})")
        else:
            print(f"MFPT to states {tgt}: no populated source state "
                  "reaches the target")
        extra_out.update(mfpt=fp)
    if args.tpt:
        if ":" not in args.tpt:
            raise SystemExit("error: --tpt wants A1[,A2..]:B1[,B2..] "
                             "(colon-separated source/target state sets)")
        a_spec, b_spec = args.tpt.split(":", 1)
        src = [int(s) for s in a_spec.split(",")]
        tgt = [int(s) for s in b_spec.split(",")]
        r = m.tpt(src, tgt)
        print(f"TPT {src} -> {tgt}: rate {r.rate:.3e} /frame "
              f"(total reactive flux {r.total_flux:.3e} /lag)")
        for path, fx in r.pathways(n_paths=3):
            share = fx / r.total_flux if r.total_flux > 0 else 0.0
            print("  pathway " + " -> ".join(str(s) for s in path)
                  + f": {share:.0%} of the flux")
        extra_out.update(committor=r.q_plus, backward_committor=r.q_minus,
                         net_flux=r.net_flux, rate=np.float64(r.rate))
    n_frames = len(series[0]) if isinstance(series, list) else len(series)
    factors = tuple(f for f in (2, 4) if args.lag * f < n_frames // 10)
    if factors:
        errs = ck_test(series, n_states, args.lag, factors=factors,
                       reversible=not args.nonreversible)
        print("Chapman-Kolmogorov max|T(lag)^k - T(k lag)|: "
              + ", ".join(f"k={k_}: {v:.4f}" for k_, v in errs.items())
              + ("  [OK: Markovian at this lag]"
                 if max(errs.values()) < 0.1 else
                 "  [WARNING: memory at this lag — increase --lag or "
                 "refine the CVs]"))
    if args.out:
        np.savez(args.out, transition=m.transition, pi=m.pi,
                 lag=m.lag, eigenvalues=m.eigenvalues, **extra_out,
                 **{f"edges_{i}": e for i, e in enumerate(edges)})
        print(f"wrote {args.out}")
    return 0


def register(sub):
    pms = sub.add_parser(
        "msm",
        help="Markov state model over a CV trajectory (timescales + "
             "Chapman-Kolmogorov check)")
    pms.add_argument("cvs", help=".npy CV samples [T] or [T, d] "
                                 "('evaluate' output)")
    pms.add_argument("--lag", type=int, default=10,
                     help="lag time in frames")
    pms.add_argument("--grid", default="-1:1:10", metavar="LO:HI:NBINS",
                     help="discretization grid, one comma-separated "
                          "lo:hi:nbins per CV dim (use --grid=... when "
                          "lo is negative)")
    pms.add_argument("--walkers", type=int, default=1,
                     help="de-interleave W walkers recorded per frame "
                          "('sample --walkers W' output) into W "
                          "contiguous series")
    pms.add_argument("--nonreversible", action="store_true",
                     help="plain row-normalized MLE instead of the "
                          "detailed-balance-constrained one")
    pms.add_argument("--n-timescales", type=int, default=3)
    pms.add_argument("--bootstrap", type=int, default=0, metavar="N",
                     help="N bootstrap resamples (over walker "
                          "trajectories, or circular blocks of a single "
                          "one): 95%% CIs on timescales + populations")
    pms.add_argument("--bootstrap-seed", type=int, default=0)
    pms.add_argument("--coarse", type=int, default=0,
                     help="PCCA+ coarse-grain into N metastable sets "
                          "(prints sets; saves assignments/memberships/"
                          "coarse matrix with --out)")
    pms.add_argument("--mfpt-to", default=None, metavar="S1[,S2...]",
                     help="mean first-passage times to these grid "
                          "states (saved as 'mfpt' with --out)")
    pms.add_argument("--tpt", default=None, metavar="A1[,A2..]:B1[,B2..]",
                     help="transition path theory for the reaction "
                          "A -> B between the two grid-state sets: "
                          "committors, rate, dominant pathways (saved "
                          "as 'committor'/'net_flux'/'rate' with --out)")
    pms.add_argument("--out", default=None,
                     help=".npz output (transition, pi, eigenvalues, "
                          "edges)")
    pms.set_defaults(fn=cmd_msm)
