"""End-to-end example: learn collective variables as generator
eigenfunctions — the second CV-learning method of the reference's
research ecosystem (zwpku/molann README.rst:51, "adaptive learning of
reaction coordinates"; the variational eigenfunction approach of the
Zhang/Li/Schütte line of work), run fully in-framework:

1. sample BOTH basins of the toy alanine potential with well-tempered
   metadynamics along the known phi dihedral (data generation only —
   the trained model never sees phi);
2. reweight the biased trajectory to the unbiased Boltzmann measure
   (``MetadBias.frame_weights``) — the eigenfunction loss consumes the
   weights directly, so biased data trains UNBIASED eigenfunctions;
3. minimize the variational loss: sum of Rayleigh quotients
   (1/beta)·E[|grad f_i|^2] under decreasing weights + an
   orthonormality penalty (its coordinate gradients differentiated a
   second time by autograd). Output 0 learns the SLOWEST mode — the
   interbasin reaction coordinate — and the Rayleigh quotients
   estimate the generator eigenvalues, whose gap separates the slow
   hopping mode from fast intra-basin relaxation.

Run on the card:
    python -m molann_tpu_torch.examples.train_eigenfunction_cv
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
from ..sampling import ToyPeptidePotential, metadynamics_langevin
from ..systems import alanine_histogram_features, alanine_universe
from ..train import eigenfunction_loss, fit, make_eigenfunction_loss
from ..train.optim import Adam
from .biased_dynamics import phi_cv

KT = 0.25
DT = 2e-4
BARRIER = 0.75  # 3 kT — low enough that basin B carries real weight


def _weighted_corr(a, b, w):
    w = w / w.sum()
    a = a - (w * a).sum()
    b = b - (w * b).sum()
    return float((w * a * b).sum()
                 / np.sqrt((w * a * a).sum() * (w * b * b).sum()))


def sample_both_basins(u, pot, *, n_steps, generator):
    """Stage 1: well-tempered metadynamics along the known phi, 6 walkers.
    Returns ``(frames [l, n, 3] on the walkers' device, cos_phi [l] host
    array, the bias, the phi [cos, sin] CV)``."""
    phi_cossin = phi_cv(u, False)
    x0 = torch.as_tensor(
        np.repeat(u.atoms.positions[None], 6, axis=0),
        device=generator.device)
    traj, _, bias = metadynamics_langevin(
        pot.energy, phi_cossin, x0, n_steps=n_steps, dt=DT, kT=KT,
        generator=generator, height=0.5, sigma=0.3, stride=50,
        well_tempered_gamma=1.0 + 3.0 / KT,
    )
    x_all = traj.reshape(-1, 22, 3)
    return x_all, torch.cos(pot.phi(x_all)).cpu().numpy(), bias, phi_cossin


def learn_eigenfunctions(u, x_all, cos_phi, bias, phi_cossin, *,
                         num_steps):
    """Stages 2-4 on the frames' device: the reweighting, 2 eigenfunctions
    trained for ``num_steps``, the spectrum and the mode structure.
    Returns the example's keys."""
    dev = x_all.device
    frames = x_all.cpu().numpy()

    # --- 2. reweight to the unbiased Boltzmann measure -----------------
    with torch.no_grad():
        w = bias.frame_weights(phi_cossin(x_all), KT).cpu().numpy()
    ess = float(w.sum() ** 2 / (w**2).sum())
    pop_b = float(w[cos_phi > 0].sum() / w.sum())
    print(f"{len(frames)} biased frames, effective sample size {ess:.0f}; "
          f"reweighted basin-B population {pop_b:.1%}")

    # --- 3. train 2 eigenfunctions on invariant features ---------------
    pp = PreprocessingANN(
        None, FeatureLayer(alanine_histogram_features(u), u.atoms)
    )
    model = MolANN(
        pp,
        create_sequential_nn([pp.output_dimension(), 24, 2],
                             generator=torch.Generator().manual_seed(1),
                             device=dev),
    )
    loss_fn = make_eigenfunction_loss(beta=1.0 / KT, alpha=50.0)

    def batches(batch_size=1024, seed=1):
        rng = np.random.default_rng(seed)
        while True:
            i = rng.integers(0, len(frames), batch_size)
            yield frames[i], w[i]

    res = fit(model, loss_fn, batches(),
              optimizer=functools.partial(Adam, lr=2e-3),
              num_steps=num_steps, log_every=500)
    model = res.model
    print(f"variational loss: {res.losses[0]:.2f} -> {res.losses[-1]:.2f}")

    # --- 4. spectrum + mode structure ----------------------------------
    _, aux = eigenfunction_loss(
        model, x_all, weights=torch.as_tensor(w, device=dev),
        beta=1.0 / KT, alpha=50.0, return_aux=True,
    )
    eigs = aux["eigenvalues"].detach().cpu().numpy()
    print(f"estimated generator eigenvalues: {eigs[0]:.3f} (slow, "
          f"interbasin) vs {eigs[1]:.3f} — spectral gap "
          f"{eigs[1] / eigs[0]:.1f}x")
    with torch.no_grad():
        zcv = model(x_all).cpu().numpy()
    basin = (cos_phi > 0).astype(float)
    # orthonormality (and the whole loss) lives in the REWEIGHTED
    # unbiased measure, so the diagnostics must be weighted too — the
    # unweighted correlation over the biased ensemble can look high even
    # when <f0, f1>_mu = 0 exactly
    corr_basin = _weighted_corr(zcv[:, 0], basin, w)
    corr_cvs = _weighted_corr(zcv[:, 0], zcv[:, 1], w)
    print(f"CV0 vs basin indicator: corr {corr_basin:+.2f} "
          f"(the hopping mode); CV0 vs CV1 corr {corr_cvs:+.2f} "
          f"(orthonormality)")
    return {
        "eigenvalues": eigs.tolist(),
        "gap": float(eigs[1] / eigs[0]),
        "corr_basin": corr_basin,
        "corr_cvs": corr_cvs,
        "ess": ess,
        "pop_b": pop_b,
    }


def main(quick=False, device=None):
    dev = resolve_device(device)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=BARRIER)

    # --- 1. both-basin data: WT metadynamics along the known phi -------
    x_all, cos_phi, bias, phi_cossin = sample_both_basins(
        u, pot, n_steps=(16000 if quick else 20000),
        generator=torch.Generator(dev).manual_seed(0))
    if not (cos_phi > 0.5).any():
        raise RuntimeError("metadynamics should reach basin B")
    return learn_eigenfunctions(u, x_all, cos_phi, bias, phi_cossin,
                                num_steps=(1000 if quick else 1500))


if __name__ == "__main__":
    main()
