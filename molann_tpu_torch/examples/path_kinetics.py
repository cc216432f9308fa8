"""Mechanism and rate from a learned path: string -> path CVs -> TPT.

The reference's CVs exist to characterize rare transitions (README.rst:51
— reaction coordinates); this example carries that purpose all the way
to MECHANISM and RATE on a curved 2-D double well (one particle whose
xy-position is the CV space, so every step is easy to visualize):

1. the simplified string method finds the minimum-energy path through
   the curved valley — the mechanism — from nothing but the potential;
2. Branduardi path CVs turn the converged string into a 1-D progress
   coordinate ``s`` plus a tube distance; metadynamics along ``s``
   inside a tube restraint crosses the barrier at a temperature where
   unbiased dynamics stay trapped for the whole run;
3. kinetics, done honestly (a biased trajectory has no kinetics): at a
   warmer temperature where hops are observable, a long UNBIASED run is
   discretized along ``s``; the MSM passes the Chapman-Kolmogorov test,
   and transition path theory turns it into committors, the dominant
   pathway, and an A->B rate — cross-checked against the empirical
   first-passage statistics of the very same trajectory.

One particle's dynamics is a few small kernels a step, so every stage is
bound by launches wherever it runs.

Run on the card:
    python -m molann_tpu_torch.examples.path_kinetics
"""

import numpy as np
import torch

from .._device import resolve_device
from ..sampling import (
    PathCV,
    ck_test,
    estimate_msm,
    grid_assign,
    linear_path,
    metadynamics_langevin,
    overdamped_langevin,
    string_method,
)

DT = 2e-3
KT_COLD = 0.12
KT_WARM = 0.35
THIN_WARM = 5


def valley_potential(z):
    """Double well at x = +-1 joined by the curved valley
    y = 0.5 (1 - x^2); barrier 1.0 at (0, 0.5)."""
    x, y = z[..., 0], z[..., 1]
    return (x**2 - 1.0) ** 2 + 4.0 * (y - 0.5 * (1.0 - x**2)) ** 2


def particle_energy(x):
    return valley_potential(x[:, 0, :2])


def particle_cv(x):
    return x[:, 0, :2]


def empirical_first_passage(s, lo, hi, dt_frame):
    """Mean first-passage time lo-basin -> hi-basin from a scalar
    series: average time from each entry into ``s < lo`` until the next
    visit of ``s > hi``. Returns (mfpt, n_events)."""
    in_a = s < lo
    hits_b = np.flatnonzero(s > hi)
    entries = np.flatnonzero(in_a[1:] & ~in_a[:-1]) + 1
    if in_a[0]:
        entries = np.concatenate([[0], entries])
    times = []
    for t0 in entries:
        nxt = hits_b[np.searchsorted(hits_b, t0)] if (
            np.searchsorted(hits_b, t0) < len(hits_b)) else None
        if nxt is not None:
            times.append((nxt - t0) * dt_frame)
    return (float(np.mean(times)) if times else np.inf), len(times)


def find_path(*, n_iterations, device=None):
    """Stage 1: the string from the straight line between the wells.
    Returns ``(images [41, 2], energies [41])`` as host arrays."""
    start = torch.tensor([-1.0, 0.0], device=resolve_device(device))
    imgs, e = string_method(
        valley_potential, linear_path(start, [1.0, 0.0], 41),
        n_iterations=n_iterations, step=2e-3,
    )
    return imgs.cpu().numpy(), e.cpu().numpy()


def cold_runs(path, *, n_steps, device=None):
    """Stage 2: at kT 0.12 an unbiased run and metadynamics along the
    path's progress inside its tube, from the left well. Returns the two
    trajectories' x coordinates as host arrays."""
    dev = resolve_device(device)
    x0 = torch.tensor([[[-1.0, 0.0, 0.0]]], device=dev)
    traj_u, _ = overdamped_langevin(
        particle_energy, x0, n_steps=n_steps, dt=DT, kT=KT_COLD,
        generator=torch.Generator(dev).manual_seed(0), thin=20,
    )
    wall = path.wall(particle_cv, k_wall=50.0, t_max=0.05)
    traj_b, _, _ = metadynamics_langevin(
        lambda x: particle_energy(x) + wall(x), path.along(particle_cv),
        x0, n_steps=n_steps, dt=DT, kT=KT_COLD,
        generator=torch.Generator(dev).manual_seed(0), height=0.08,
        sigma=0.08, stride=100,
    )
    return (traj_u[..., 0, 0].cpu().numpy(),
            traj_b[..., 0, 0].cpu().numpy())


def warm_run(path, *, n_steps, device=None):
    """Stage 3: the long unbiased run at kT 0.35, as its progress series
    ``s`` along the path (host array, one value a recorded frame)."""
    dev = resolve_device(device)
    x0 = torch.tensor([[[-1.0, 0.0, 0.0]]], device=dev)
    traj_w, _ = overdamped_langevin(
        particle_energy, x0, n_steps=n_steps, dt=DT, kT=KT_WARM,
        generator=torch.Generator(dev).manual_seed(1), thin=THIN_WARM,
    )
    return path.progress(traj_w[:, 0, 0, :2]).cpu().numpy()


def main(quick=False, device=None):
    dev = resolve_device(device)
    # --- 1. mechanism: string method finds the curved valley ----------
    imgs, e = find_path(n_iterations=2000 if quick else 6000, device=dev)
    top = int(e.argmax())
    print(f"string: barrier {e.max():.3f} at image {top} "
          f"({imgs[top][0]:+.3f}, {imgs[top][1]:+.3f}) "
          f"[exact: 1.000 at (0, 0.5)]")

    # --- 2. rare-event sampling along the path at cold kT -------------
    path = PathCV(imgs)  # barrier ~ 8 kT at KT_COLD: unbiased never crosses
    x_u, x_b = cold_runs(path, n_steps=4000 if quick else 10000, device=dev)
    print(f"cold (kT={KT_COLD}): unbiased max x = {x_u.max():+.2f} "
          f"(trapped); path-metadynamics max x = {x_b.max():+.2f} "
          f"(crossed)")

    # --- 3. kinetics from a long unbiased run at warm kT --------------
    s = warm_run(path, n_steps=120_000 if quick else 400_000, device=dev)
    n_bins, lag = 12, 10
    labels = grid_assign(s, [np.linspace(0.0, 1.0, n_bins + 1)])
    msm = estimate_msm(labels, n_bins, lag)
    ck = ck_test(labels, n_bins, lag)
    print(f"MSM over s: lag {lag} frames, CK max error "
          f"{max(ck.values()):.3f} "
          f"({'Markovian' if max(ck.values()) < 0.1 else 'memory!'})")

    a_states, b_states = [0, 1], [n_bins - 2, n_bins - 1]
    r = msm.tpt(a_states, b_states)
    frame_time = DT * THIN_WARM  # time units per recorded frame
    rate = r.rate / frame_time
    pathway = r.pathways(n_paths=1)[0][0]
    mono = all(b >= a for a, b in zip(pathway, pathway[1:]))
    print(f"TPT A{a_states} -> B{b_states}: rate {rate:.3e} /time, "
          f"dominant pathway {'->'.join(map(str, pathway))} "
          f"({'monotone in s' if mono else 'NOT monotone'})")

    mfpt_emp, n_events = empirical_first_passage(
        s, lo=2.0 / n_bins, hi=1.0 - 2.0 / n_bins, dt_frame=frame_time)
    mfpt_msm = float(
        msm.mfpt(b_states)[labels[0]]) * frame_time
    print(f"MFPT A->B: empirical {mfpt_emp:.1f} ({n_events} events), "
          f"MSM {mfpt_msm:.1f}, 1/TPT-rate {1.0 / rate:.1f} "
          f"(same order expected)")

    return {
        "barrier": float(e.max()),
        "barrier_xy": imgs[top].tolist(),
        "cold_unbiased_max_x": float(x_u.max()),
        "cold_biased_max_x": float(x_b.max()),
        "ck_max": float(max(ck.values())),
        "rate": float(rate),
        "pathway_monotone": mono,
        "mfpt_empirical": mfpt_emp,
        "mfpt_msm": mfpt_msm,
        "n_events": n_events,
    }


if __name__ == "__main__":
    main()
