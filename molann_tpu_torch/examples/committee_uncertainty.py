"""Committee disagreement flags the unexplored basin BEFORE sampling it.

The adaptive-CV loop (:mod:`.adaptive_cv_loop`) discovers new basins by
biasing along the current CV and watching the trajectory. A deep ensemble
gives the complementary, cheaper signal: train a COMMITTEE of CV models on
the frames you have (basin A only) and evaluate committee disagreement —
where all members agree the data constrained the model; where they
diverge the model is extrapolating. On alanine the committee trained
purely inside basin A disagrees far more on basin-B frames it has never
seen, so the disagreement map says "sample over there" without any biased
run: query-by-committee acquisition. ``fit_ensemble`` trains the members
one after another, each with its own optimizer, on the same batches
(bootstrap-resampled per member).

Run on the card:
    python -m molann_tpu_torch.examples.committee_uncertainty
"""

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..models.ann import (
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
)
from ..sampling import (
    ToyPeptidePotential,
    overdamped_langevin,
    rotate_torsion,
)
from ..systems import alanine_histogram_features, alanine_universe
from ..train import autoencoder_loss, calibrated_committee, fit_ensemble
from ..train.optim import Adam

KT = 0.25
DT = 2e-4
PHI = (4, 6, 8, 14)  # alanine phi backbone dihedral, 0-based


def sample_basin(pot, x0, *, n_steps, generator, n_walkers=4, thin=10):
    """``n_walkers`` copies of ``x0`` run on the generator's device;
    returns the recorded frames as a host array ``[T·W, n, 3]``."""
    x0 = torch.as_tensor(np.repeat(np.asarray(x0)[None], n_walkers, axis=0),
                         device=generator.device)
    traj, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_steps, dt=DT, kT=KT, generator=generator,
        thin=thin,
    )
    return traj.reshape(-1, x0.shape[1], 3).cpu().numpy()


def make_members(u, n_members, *, n_cv=1, hidden=16, seed=0, device=None):
    """K structurally-identical (encoder-as-MolANN, decoder) pairs that
    differ only in their init seeds."""
    dev = resolve_device(device)
    f_layer = FeatureLayer(alanine_histogram_features(u), u.atoms)
    pp = PreprocessingANN(None, f_layer)
    d = pp.output_dimension()
    members = []
    for i in range(n_members):
        g = torch.Generator().manual_seed(seed + 17 * i)
        enc = create_sequential_nn([d, hidden, n_cv], generator=g,
                                   device=dev)
        dec = create_sequential_nn([n_cv, hidden, d], generator=g,
                                   device=dev)
        members.append((MolANN(pp, enc), dec))
    return members


def ae_loss(member, batch):
    cv_model, dec = member
    return autoencoder_loss(
        cv_model.ann_layers, dec, cv_model.preprocessing_layer, batch
    )


def main(quick=False, n_members=4, device=None):
    dev = resolve_device(device)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=5.0)  # 20 kT: basins don't mix
    n_steps = 2000 if quick else 6000
    train_steps = 200 if quick else 600

    # --- frames: training data from basin A only; B is never trained on
    x_a = u.atoms.positions
    x_b = rotate_torsion(u, PHI, np.pi)
    frames_a = sample_basin(pot, x_a, n_steps=n_steps,
                            generator=torch.Generator(dev).manual_seed(0))
    probe_a = sample_basin(pot, x_a, n_steps=n_steps // 2,
                           generator=torch.Generator(dev).manual_seed(1))
    probe_b = sample_basin(pot, x_b, n_steps=n_steps // 2,
                           generator=torch.Generator(dev).manual_seed(2))
    probe_a = torch.as_tensor(probe_a, device=dev)   # held out
    probe_b = torch.as_tensor(probe_b, device=dev)   # unexplored basin
    cos_a = torch.cos(pot.phi(probe_a)).cpu().numpy()
    cos_b = torch.cos(pot.phi(probe_b)).cpu().numpy()
    print(f"training/probe A: cos(phi) ~ {cos_a.mean():+.2f}; "
          f"probe B: cos(phi) ~ {cos_b.mean():+.2f} (never trained on)")

    # --- committee: K autoencoder CVs -----------------------------------
    def batches(batch_size=256, seed=1):
        rng = np.random.default_rng(seed)
        for _ in range(train_steps):
            idx = rng.integers(0, len(frames_a), size=batch_size)
            yield frames_a[idx]

    result = fit_ensemble(
        make_members(u, n_members, device=dev), ae_loss, batches(),
        optimizer=functools.partial(Adam, lr=2e-3), bagging=True, seed=3,
    )
    losses = np.asarray(result.losses)
    print(f"committee of {n_members}: loss {losses[0].mean():.4f} -> "
          f"{losses[-1].mean():.4f} (member spread "
          f"{losses[-1].std():.4f})")

    # --- disagreement: low where trained, high in the unseen basin -----
    # autoencoder CVs are only defined up to sign/scale, so raw committee
    # std is gauge noise; calibrate each member on the TRAINING frames
    # (standardize + sign-align) and measure disagreement after that.
    stacked_cv = tuple(m[0] for m in result.models)  # the encoders
    x_ref = torch.as_tensor(frames_a, device=dev)
    with torch.no_grad():
        _, std_a = calibrated_committee(stacked_cv, probe_a, x_ref)
        _, std_b = calibrated_committee(stacked_cv, probe_b, x_ref)
    std_a = float(torch.mean(std_a))
    std_b = float(torch.mean(std_b))
    ratio = std_b / max(std_a, 1e-12)
    print(f"committee disagreement: basin A (trained) {std_a:.4f}, "
          f"basin B (unexplored) {std_b:.4f} -> ratio {ratio:.1f}x")
    print("the committee flags basin B as unexplored WITHOUT any biased "
          "run — the acquisition signal for adaptive sampling"
          if ratio > 2 else "WARNING: weak separation")
    return {"std_a": std_a, "std_b": std_b, "ratio": ratio,
            "losses": losses}


if __name__ == "__main__":
    main()
