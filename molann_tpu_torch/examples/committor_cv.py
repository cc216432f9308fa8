"""Train a committor CV and validate it by first-passage simulation.

The committor q(x) — the probability of reaching the product basin
before the reactant basin — is the ideal reaction coordinate; the
"committor test" (launching unbiased trajectories from predicted
iso-q=1/2 configurations and checking they commit ~50/50) is the
standard acceptance test for any trained CV. This example runs the full
workflow in-framework:

1. a double-well free torsion on the alanine fixture
   (``molann_tpu_torch.sampling.ToyPeptidePotential``, barrier 2.0 = 8 kT);
2. training data WITHOUT dynamics: a deterministic torsion sweep with
   Cartesian noise, Boltzmann importance weights (quadrature sampling —
   the same reweighting metadynamics frame_weights would provide);
3. a MolANN committor model (phi dihedral feature -> MLP -> sigmoid)
   trained with the variational committor loss
   (``molann_tpu_torch.train.committor_loss``);
4. validation by ``molann_tpu_torch.sampling.empirical_committor``: the
   model's predicted q=1/2 configuration commits ~50/50 in real
   first-passage dynamics, while confident predictions (q<0.05, q>0.95)
   commit to the matching basin.

Run on the card:
    python -m molann_tpu_torch.examples.committor_cv
"""

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
    empirical_committor,
    rotate_torsion,
)
from ..systems import alanine_universe
from ..train import committor_loss
from ..train.optim import Adam, warmup_cosine_decay_schedule

FREE = (4, 6, 8, 14)  # phi backbone dihedral (0-based)
KT = 0.25
BETA = 1.0 / KT
BARRIER = 2.0  # 8 kT
EDGE = 0.7  # basin definition: |cos(phi - phi_ref)| > EDGE


def build_committor_model(u, generator, device=None):
    """phi dihedral -> [cos, sin] -> MLP; q = sigmoid(output)."""
    sel = lambda s: u.select_atoms(f"bynum {s}")  # noqa: E731
    feat = Feature("phi", "dihedral",
                   sel(5) + sel(7) + sel(9) + sel(15))
    flayer = FeatureLayer([feat], u.atoms)
    pp = PreprocessingANN(None, flayer)
    return MolANN(pp, create_sequential_nn(
        [pp.output_dimension(), 16, 1], generator=generator,
        device=resolve_device(device)))


def main(quick=False, device=None):
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, free_torsion=FREE, barrier=BARRIER)
    phi_ref = float(pot.phi(torch.as_tensor(u.atoms.positions[None],
                                            device=dev))[0])

    # --- 1. quadrature training set: torsion sweep x Cartesian noise ---
    n_angles = 128 if quick else 384
    n_noise = 2 if quick else 4
    angles = np.linspace(-np.pi, np.pi, n_angles, endpoint=False)
    base = np.stack([rotate_torsion(u, FREE, a) for a in angles])
    frames = (
        np.repeat(base, n_noise, axis=0)
        + 0.02 * rng.normal(size=(n_angles * n_noise, 22, 3))
    ).astype(np.float32)
    x = torch.as_tensor(frames, device=dev)
    # importance weights for the phi quadrature: the free-torsion marginal
    # exp(-beta*V_phi). Weighting by the FULL energy would be wrong here:
    # the Cartesian noise excites stiff restraints by several kT, so
    # exp(-beta*V_total) collapses onto the luckiest noise draws and
    # destroys the symmetric phi coverage the variational problem needs.
    phi = pot.phi(x).cpu().numpy()
    v_phi = BARRIER / 2 * (1.0 - np.cos(2.0 * (phi - phi_ref)))
    weights = torch.as_tensor(np.exp(-BETA * v_phi).astype(np.float32),
                              device=dev)
    dcos = np.cos(phi - phi_ref)
    labels = torch.as_tensor(
        np.where(dcos > EDGE, 1, np.where(dcos < -EDGE, 2, 0)), device=dev)

    # --- 2. train the committor model ------------------------------------
    model = build_committor_model(u, torch.Generator().manual_seed(0), dev)
    steps = 600 if quick else 2000
    opt = Adam(model.parameters(), lr=1e-2,
               schedule=warmup_cosine_decay_schedule(
                   0.0, 1e-2, 50, steps, end_value=1e-4))

    def loss_fn(m):
        return committor_loss(m, x, labels, beta=BETA, alpha=200.0,
                              weights=weights)

    loss0 = loss1 = None
    for _ in range(steps):
        opt.zero_grad()
        value = loss_fn(model)
        value.backward()
        opt.step()
        value = value.detach()
        loss0 = float(value) if loss0 is None else loss0
        loss1 = float(value)
    print(f"committor training: loss {loss0:.3f} -> {loss1:.3f}")

    # --- 3. read the model's predictions over the sweep -------------------
    with torch.no_grad():
        q_pred = torch.sigmoid(
            model(torch.as_tensor(base, device=dev))[:, 0]).cpu().numpy()
    in_a = dcos[::n_noise] > EDGE
    in_b = dcos[::n_noise] < -EDGE
    print(f"predicted q: mean(A) = {q_pred[in_a].mean():.3f}, "
          f"mean(B) = {q_pred[in_b].mean():.3f}")

    # candidates: most confident A / closest to 1/2 / most confident B
    i_mid = int(np.abs(q_pred - 0.5).argmin())
    i_a = int(q_pred.argmin())
    i_b = int(q_pred.argmax())
    starts = torch.as_tensor(base[[i_a, i_mid, i_b]], device=dev)
    print(f"validation configs at phi offsets "
          f"{np.round(angles[[i_a, i_mid, i_b]], 2)} rad "
          f"(predicted q = {np.round(q_pred[[i_a, i_mid, i_b]], 3)})")

    # --- 4. the committor test: first-passage dynamics --------------------
    def mk(thresh_sign):
        return lambda xx: thresh_sign * (
            torch.cos(pot.phi(xx) - phi_ref)) > EDGE

    q_emp, frac = empirical_committor(
        pot.energy, starts, mk(+1.0), mk(-1.0),
        n_steps=4000 if quick else 8000, dt=1e-3, kT=KT,
        generator=torch.Generator(dev).manual_seed(1),
        n_replicas=64 if quick else 128,
    )
    q_emp, frac = q_emp.cpu().numpy(), frac.cpu().numpy()
    print(f"empirical committor: q(A-cand) = {q_emp[0]:.3f}, "
          f"q(1/2-cand) = {q_emp[1]:.3f}, q(B-cand) = {q_emp[2]:.3f} "
          f"(resolved {np.round(frac, 2)})")

    return {
        "loss0": loss0,
        "loss1": loss1,
        "pred_q_a": float(q_pred[in_a].mean()),
        "pred_q_b": float(q_pred[in_b].mean()),
        "pred_q_mid": float(q_pred[i_mid]),
        "emp_q_a": float(q_emp[0]),
        "emp_q_mid": float(q_emp[1]),
        "emp_q_b": float(q_emp[2]),
        "resolved_mid": float(frac[1]),
    }


if __name__ == "__main__":
    main()
