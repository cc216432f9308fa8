"""The closed enhanced-sampling loop — the job the reference exists for.

The reference (zwpku/molann README.rst:51) trains CV networks whose
exports feed biased-MD engines; nothing in its repo ever *consumes* the
CVs. This example closes that loop entirely in-framework:

1. a toy double-well peptide potential on the alanine fixture
   (``molann_tpu_torch.sampling.potentials``) — the stand-in MD engine;
2. unbiased Langevin dynamics: walkers stay trapped in the starting
   basin (phi ~ pi) for the whole run;
3. training data from both basins (the second basin reached once by
   steered MD along the phi dihedral), an autoencoder CV trained on
   invariant features exactly like :mod:`.train_autoencoder_cv`;
4. metadynamics along the TRAINED one-dimensional CV: the accumulated
   bias pushes walkers over the barrier the unbiased runs never cross —
   escape driven by forces differentiated through the full
   feature+MLP stack.

Run on the card:
    python -m molann_tpu_torch.examples.biased_dynamics
"""

import functools

import numpy as np
import torch

from .._device import resolve_device
from ..feature import Feature
from ..models.ann import (
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
)
from ..sampling import (
    ToyPeptidePotential,
    metadynamics_langevin,
    overdamped_langevin,
    steered_langevin,
)
from ..systems import alanine_histogram_features, alanine_universe
from ..train import autoencoder_loss, fit, trainable_mask
from ..train.optim import Adam

KT = 0.25
DT = 2e-4


def phi_cv(u, use_angle_value):
    """[cos phi, sin phi] (or phi) of the backbone phi dihedral."""
    ag = (u.select_atoms("bynum 5") + u.select_atoms("bynum 7")
          + u.select_atoms("bynum 9") + u.select_atoms("bynum 15"))
    return PreprocessingANN(
        None, FeatureLayer([Feature("phi", "dihedral", ag)], u.atoms,
                           use_angle_value)
    )


def train_cv(u, frames, *, n_cv=1, num_steps=400, seed=0, device=None):
    """Autoencoder CV on invariant features (both-basin training data),
    built and trained on ``device``."""
    dev = resolve_device(device)
    f_layer = FeatureLayer(alanine_histogram_features(u), u.atoms)
    pp = PreprocessingANN(None, f_layer)
    d = pp.output_dimension()
    g = torch.Generator().manual_seed(seed)
    pair = (create_sequential_nn([d, 16, n_cv], generator=g, device=dev),
            create_sequential_nn([n_cv, 16, d], generator=g, device=dev))

    def loss_fn(p, batch):
        return autoencoder_loss(p[0], p[1], pp, batch)

    def batches(batch_size=256, seed=1):
        rng = np.random.default_rng(seed)
        while True:
            yield frames[rng.integers(0, len(frames), batch_size)]

    result = fit(pair, loss_fn, batches(),
                 optimizer=functools.partial(Adam, lr=2e-3),
                 num_steps=num_steps,
                 mask=trainable_mask(pair, lambda name, t: True))
    encoder, _ = result.model
    return MolANN(pp, encoder), result.losses


def _cos_phi(pot, x):
    return torch.cos(pot.phi(x.reshape(-1, 22, 3))).cpu().numpy()


def main(quick=False, device=None):
    dev = resolve_device(device)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=6.0)
    n_walkers = 2 if quick else 4
    x0 = torch.as_tensor(
        np.repeat(u.atoms.positions[None], n_walkers, axis=0), device=dev)

    # --- 1. unbiased dynamics: trapped ---------------------------------
    n_unbiased = 2000 if quick else 6000
    traj_u, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_unbiased, dt=DT, kT=KT,
        generator=torch.Generator(dev).manual_seed(0), thin=50,
    )
    cos_u = _cos_phi(pot, traj_u)
    print(f"unbiased: cos(phi) in [{cos_u.min():+.2f}, {cos_u.max():+.2f}]"
          f"  (start basin: cos(phi) ~ -1; never crosses)")

    # --- 2. reach basin B once (steered MD along phi) ------------------
    _, x_basin_b = steered_langevin(
        pot.energy, phi_cv(u, True), x0[:1], s0=[np.pi], s1=[0.0],
        k_spring=10.0, n_steps=3000, dt=DT, kT=KT,
        generator=torch.Generator(dev).manual_seed(1), thin=50,
    )
    print(f"steered pull: final cos(phi) = "
          f"{float(_cos_phi(pot, x_basin_b)[0]):+.2f}")

    # --- 3. training data from both basins + autoencoder CV ------------
    n_data = 1000 if quick else 3000
    data_a, _ = overdamped_langevin(
        pot.energy, x0[:1], n_steps=n_data, dt=DT, kT=KT,
        generator=torch.Generator(dev).manual_seed(2), thin=10,
    )
    data_b, _ = overdamped_langevin(
        pot.energy, x_basin_b, n_steps=n_data, dt=DT, kT=KT,
        generator=torch.Generator(dev).manual_seed(3), thin=10,
    )
    frames = torch.cat([data_a.reshape(-1, 22, 3),
                        data_b.reshape(-1, 22, 3)]).cpu().numpy()
    cv_model, losses = train_cv(
        u, frames, num_steps=150 if quick else 500, device=dev
    )
    with torch.no_grad():
        cvs = cv_model(torch.as_tensor(frames, device=dev))[:, 0]
    cvs = cvs.cpu().numpy()
    half = len(frames) // 2
    gap = abs(cvs[:half].mean() - cvs[half:].mean())
    spread = max(cvs[:half].std(), cvs[half:].std())
    print(f"trained CV: loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"basin separation {gap:.3f} vs in-basin spread {spread:.3f}")

    # --- 4. metadynamics along the TRAINED CV: escape ------------------
    sigma = max(0.5 * spread, 0.05 * gap)
    n_metad = 5000 if quick else 8000
    traj_b, _, bias = metadynamics_langevin(
        pot.energy, cv_model, x0, n_steps=n_metad, dt=DT, kT=KT,
        generator=torch.Generator(dev).manual_seed(4), height=2.0 * KT,
        sigma=sigma, stride=50,
    )
    cos_b = _cos_phi(pot, traj_b)
    per_walker = [float(_cos_phi(pot, traj_b[:, w]).max())
                  for w in range(n_walkers)]
    print(f"metadynamics along trained CV: cos(phi) reaches "
          f"{cos_b.max():+.2f}  (per walker: "
          f"{', '.join(f'{c:+.2f}' for c in per_walker)})")
    escaped = cos_b.max() > 0.5
    print("ESCAPED the start basin" if escaped
          else "no escape (increase n_steps / height)")

    grid = torch.as_tensor(np.linspace(cvs.min(), cvs.max(), 50)[:, None],
                           dtype=torch.float32, device=dev)
    fes = bias.free_energy_estimate(grid).cpu().numpy()
    print(f"free-energy estimate along CV: range "
          f"{fes.max() - fes.min():.2f} (units of kT: "
          f"{(fes.max() - fes.min()) / KT:.1f})")
    return {
        "cos_unbiased_max": float(cos_u.max()),
        "cos_biased_max": float(cos_b.max()),
        "escaped": bool(escaped),
        "cv_gap": float(gap),
        "cv_spread": float(spread),
    }


if __name__ == "__main__":
    main()
