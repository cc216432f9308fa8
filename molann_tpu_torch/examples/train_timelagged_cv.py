"""End-to-end example: learn collective variables from DYNAMICS with the
VAMP-2 time-lagged objective — the fourth CV-learning family of the
reference's research ecosystem (zwpku/molann README.rst:51, "adaptive
learning of reaction coordinates"; the variational approach for Markov
processes of Wu & Noé), run fully in-framework:

1. sample a long unbiased Langevin trajectory of the toy alanine
   potential at a LOW barrier (so interbasin hopping actually happens
   in unbiased dynamics — no bias, no reweighting needed here);
2. form time-lagged coordinate pairs (x_t, x_{t+tau}) per walker;
3. baseline: linear TICA on the invariant feature time series — its
   top autocorrelation bounds what any linear CV can do;
4. train a MolANN (same invariant features -> MLP, 1 output) by
   maximizing the VAMP-2 score; the learned nonlinear CV must match or
   beat the linear TICA autocorrelation and align with the interbasin
   hopping mode (the free torsion), which the model never sees.

Run on the card:
    python -m molann_tpu_torch.examples.train_timelagged_cv
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
from ..train import fit, make_vamp_loss, tica, vamp2_loss
from ..train.optim import Adam

KT = 0.25
DT = 2e-4
BARRIER = 0.625  # 2.5 kT: unbiased hopping every few thousand steps
THIN = 20
LAG = 25         # in recorded frames (= LAG*THIN integrator steps)


def _corr(a, b):
    a = a - a.mean()
    b = b - b.mean()
    return float((a * b).mean() / np.sqrt((a * a).mean() * (b * b).mean()))


def sample_hopping(u, pot, *, n_steps, generator):
    """Stage 1: the unbiased run from half the walkers in each basin.
    Returns ``(traj [T, W, n, 3] host array, cos_phi [T, W], hops)``."""
    # seed half the walkers in each basin (rotate_torsion flips the free
    # torsion by pi) so the hopping mode carries full statistical weight
    # from step 0 — an all-A start makes the slow interbasin mode's
    # variance tiny until enough hops accumulate, and TICA/VAMP would
    # lock onto the next-slowest intrabasin motion instead
    n_walkers = 8
    xb = rotate_torsion(u, (4, 6, 8, 14), np.pi)
    x0 = torch.as_tensor(np.concatenate([
        np.repeat(u.atoms.positions[None], n_walkers // 2, axis=0),
        np.repeat(xb[None], n_walkers - n_walkers // 2, axis=0),
    ]), device=generator.device)
    traj, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_steps, dt=DT, kT=KT, generator=generator,
        thin=THIN,
    )
    t_rec, w_cnt = traj.shape[:2]
    phi = pot.phi(traj.reshape(-1, 22, 3)).cpu().numpy()
    cos_phi = np.cos(phi).reshape(t_rec, w_cnt)
    hops = int(np.sum(np.abs(np.diff(np.sign(cos_phi), axis=0)) > 0))
    return traj.cpu().numpy(), cos_phi, hops


def learn_cv(u, traj, cos_phi, *, num_steps, device=None):
    """Stages 2-5: lagged pairs, the linear TICA baseline, the VAMP-2 CV
    trained for ``num_steps``, and its correlation with the basin
    indicator. Returns the example's keys but ``hops``."""
    dev = resolve_device(device)

    # --- 2. time-lagged pairs, per walker (contiguous series each) -----
    x_t = traj[:-LAG].reshape(-1, 22, 3)    # [T-LAG, W] flattened
    x_tau = traj[LAG:].reshape(-1, 22, 3)

    # --- 3. linear baseline: TICA on the invariant features ------------
    pp = PreprocessingANN(
        None, FeatureLayer(alanine_histogram_features(u), u.atoms)
    )
    with torch.no_grad():
        f_t = pp(torch.as_tensor(x_t, device=dev))
        f_tau = pp(torch.as_tensor(x_tau, device=dev))
    lin = tica(f_t, f_tau, lag=float(LAG))
    print(f"linear TICA: top autocorrelation {lin.eigenvalues[0]:.3f}, "
          f"implied timescale {lin.timescales()[0]:.0f} frames")

    # --- 4. nonlinear CV by VAMP-2 --------------------------------------
    model = MolANN(
        pp,
        create_sequential_nn([pp.output_dimension(), 24, 1],
                             generator=torch.Generator().manual_seed(1),
                             device=dev),
    )

    def batches(batch_size=2048, seed=1):
        rng = np.random.default_rng(seed)
        while True:
            i = rng.integers(0, len(x_t), batch_size)
            yield x_t[i], x_tau[i]

    res = fit(model, make_vamp_loss(), batches(),
              optimizer=functools.partial(Adam, lr=2e-3),
              num_steps=num_steps, log_every=200)
    model = res.model

    with torch.no_grad():
        _, aux = vamp2_loss(model, torch.as_tensor(x_t, device=dev),
                            torch.as_tensor(x_tau, device=dev),
                            return_aux=True)
    ac = float(aux["autocorrelations"][0])
    ts = -LAG / np.log(ac) if 0 < ac < 1 else float("inf")
    print(f"VAMP-2 CV: score {float(aux['vamp2']):.3f}, autocorrelation "
          f"{ac:.3f}, implied timescale {ts:.0f} frames")

    # --- 5. the learned CV is the hopping mode --------------------------
    with torch.no_grad():
        z = model(torch.as_tensor(traj.reshape(-1, 22, 3), device=dev))
    z = z[:, 0].cpu().numpy()
    corr_basin = abs(_corr(z, (cos_phi.reshape(-1) > 0).astype(float)))
    print(f"|corr(CV, basin indicator)| = {corr_basin:.2f} "
          f"(the model never saw phi)")
    return {
        "tica_ac": float(lin.eigenvalues[0]),
        "vamp_ac": ac,
        "vamp2": float(aux["vamp2"]),
        "corr_basin": corr_basin,
    }


def main(quick=False, device=None):
    dev = resolve_device(device)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=BARRIER)

    # --- 1. long unbiased trajectory with real interbasin hopping ------
    traj, cos_phi, hops = sample_hopping(
        u, pot, n_steps=(60000 if quick else 120000),
        generator=torch.Generator(dev).manual_seed(0))
    print(f"{traj.shape[0]} frames x {traj.shape[1]} walkers, {hops} basin "
          f"crossings")
    if not hops > 10:
        raise RuntimeError("need real hopping statistics; raise n_steps")
    res = learn_cv(u, traj, cos_phi, num_steps=(400 if quick else 800),
                   device=dev)
    return {"hops": hops, **res}


if __name__ == "__main__":
    main()
