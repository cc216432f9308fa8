"""Adaptive learning of reaction coordinates — the reference's flagship
downstream workflow (zwpku/molann README.rst:51, "used in research
works ... adaptive learning of reaction coordinates"), run end-to-end
in-framework with NO prior knowledge of the second basin:

1. unbiased Langevin sampling is trapped in basin A; an autoencoder CV
   is trained on those trapped frames alone — its leading mode is the
   softest in-basin direction, which on this system is the free
   torsion itself;
2. adaptive rounds: well-tempered metadynamics along the CURRENT CV,
   then retrain the CV on everything sampled so far. A CV trained on
   one basin saturates at the basin edge (tanh flattens outside the
   training range, so the biasing force dies there) — each round's
   bias pushes to where the previous CV still has gradient, and the
   retrained CV extends further. Escape typically happens in round 2:
   the bias DISCOVERS basin B that no training frame ever visited;
3. the final round's byproducts give the unbiased statistics: the
   hills reconstruct the free-energy profile along the CV
   (``MetadBias.free_energy_estimate``) and last-bias reweighting
   (``MetadBias.frame_weights``) recovers unbiased basin populations from
   the biased trajectory. The well-tempered trajectory itself samples
   the tempered (flattened) ensemble, so uniform weights give the
   retraining data both-basin coverage.

Run on the card:
    python -m molann_tpu_torch.examples.adaptive_cv_loop
"""

import numpy as np
import torch

from .._device import resolve_device
from ..sampling import (
    ToyPeptidePotential,
    metadynamics_langevin,
    overdamped_langevin,
)
from ..systems import alanine_universe
from .biased_dynamics import train_cv

KT = 0.25
DT = 2e-4


def _cvs(cv_model, frames):
    """The model's CVs of host frames, as a host array ``[l, d]``."""
    with torch.no_grad():
        x = torch.as_tensor(frames, device=cv_model.ann_layers.layers[0]
                            .weight.device)
        return cv_model(x).cpu().numpy()


def separation(cv_model, frames_a, frames_b):
    """Basin separation score of a 1-d CV: |mean gap| / max in-basin
    spread on held-out frames from each basin."""
    za = _cvs(cv_model, frames_a)[:, 0]
    zb = _cvs(cv_model, frames_b)[:, 0]
    return abs(za.mean() - zb.mean()) / max(za.std(), zb.std(), 1e-9)


def main(quick=False, n_rounds=3, device=None):
    dev = resolve_device(device)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=5.0)  # 20 kT
    n_walkers = 4
    train_steps = 150 if quick else 400
    n_metad = 10000 if quick else 12000
    x0 = torch.as_tensor(
        np.repeat(u.atoms.positions[None], n_walkers, axis=0), device=dev)

    def cos_phi(x):
        return torch.cos(pot.phi(x.reshape(-1, 22, 3))).cpu().numpy()

    # --- 1. trapped unbiased data + initial CV -------------------------
    n_unbiased = 2000 if quick else 6000
    traj_u, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_unbiased, dt=DT, kT=KT,
        generator=torch.Generator(dev).manual_seed(0), thin=10,
    )
    frames0 = traj_u.reshape(-1, 22, 3).cpu().numpy()
    frames = frames0
    cos_u = cos_phi(traj_u)
    print(f"unbiased: cos(phi) in [{cos_u.min():+.2f}, {cos_u.max():+.2f}]"
          f" — trapped in basin A")
    cv_model, losses = train_cv(u, frames, num_steps=train_steps, seed=0,
                                device=dev)
    cv0 = cv_model
    print(f"CV (round 0, basin-A data only): loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}")

    # --- 2. adaptive rounds: bias along current CV, retrain ------------
    gamma = 1.0 + pot.barrier / KT
    escaped_round = None
    bias = frames1 = cos_b = cv_bias = None
    for rnd in range(1, n_rounds + 1):
        # hill width tracks the IN-BASIN fluctuation of the current CV
        # (its global std balloons once biased frames enter the
        # training set — hills wider than the CV range exert no force)
        z_basin = _cvs(cv_model, frames0)[:, 0]
        sigma = max(5.0 * z_basin.std(), 1e-3)
        cv_bias = cv_model  # the model whose CV space the hills live in
        traj_b, _, bias = metadynamics_langevin(
            pot.energy, cv_model, x0, n_steps=n_metad, dt=DT, kT=KT,
            generator=torch.Generator(dev).manual_seed(100 + rnd),
            height=2.0 * KT, sigma=sigma, stride=50,
            well_tempered_gamma=gamma,
        )
        frames1 = traj_b.reshape(-1, 22, 3).cpu().numpy()
        cos_b = cos_phi(traj_b)
        escaped = bool(cos_b.max() > 0.5)
        print(f"round {rnd}: WT metadynamics along current CV reaches "
              f"cos(phi) {cos_b.max():+.2f}"
              + (" — DISCOVERED basin B" if escaped else
                 " — basin edge, retraining with the new frames"))
        frames = np.concatenate([frames, frames1])
        cv_model, losses = train_cv(u, frames, num_steps=train_steps,
                                    seed=0, device=dev)
        print(f"  retrained CV on {len(frames)} frames: loss "
              f"{losses[0]:.4f} -> {losses[-1]:.4f}")
        if escaped and escaped_round is None:
            escaped_round = rnd
        if escaped:
            break

    # --- 3. evaluate: does the final CV separate the basins? -----------
    probe_a = frames1[cos_b < -0.5][:200]
    has_b = bool((cos_b > 0.5).any())
    probe_b = frames1[cos_b > 0.5][:200] if has_b else probe_a
    sep0 = separation(cv0, probe_a, probe_b)
    sep1 = separation(cv_model, probe_a, probe_b)
    print(f"basin separation |gap|/spread on held-out frames: "
          f"round-0 CV {sep0:.2f} -> final CV {sep1:.2f}")

    # --- 4. unbiased statistics from the last biased round -------------
    # (hills live in the CV space of the model that deposited them —
    # cv_bias, the one before the final retrain)
    z1 = _cvs(cv_bias, frames1)
    grid = np.linspace(z1.min(), z1.max(), 60)[:, None]
    fes = bias.free_energy_estimate(
        torch.as_tensor(grid, dtype=torch.float32, device=dev))
    fes = fes.cpu().numpy().astype(np.float64)
    fes -= fes.min()
    tail = torch.as_tensor(z1[len(z1) // 2:], device=dev)
    w = bias.frame_weights(tail, KT).cpu().numpy()
    cos_tail = cos_b[len(cos_b) // 2:]
    in_b = cos_tail > 0.0
    pop_b_biased = float(in_b.mean())
    pop_b = float(w[in_b].sum() / w.sum()) if in_b.any() else 0.0
    print(f"FES along the biasing CV: barrier estimate {fes.max():.2f} "
          f"({fes.max() / KT:.0f} kT)")
    print(f"basin-B population: {pop_b_biased:.1%} raw biased -> "
          f"{pop_b:.2%} reweighted (unbiased ensemble)")
    return {
        "escaped": escaped_round is not None,
        "escaped_round": escaped_round,
        "cos_unbiased_max": float(cos_u.max()),
        "cos_biased_max": float(cos_b.max()),
        "sep0": float(sep0),
        "sep1": float(sep1),
        "fes_barrier": float(fes.max()),
        "pop_b_reweighted": pop_b,
        "pop_b_biased": pop_b_biased,
    }


if __name__ == "__main__":
    main()
