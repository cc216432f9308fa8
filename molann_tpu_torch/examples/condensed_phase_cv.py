"""Condensed-phase CVs at scale: coordination shells over a periodic
Lennard-Jones fluid, one-shot HLDA order parameter, blocked fused kernels.

The reference's feature set (bond/angle/dihedral/position) describes
single molecules; condensed-phase order parameters are contact COUNTS over
many pairs (PLUMED-style COORDINATION, this library's extension feature
type). This example runs the full condensed-phase workflow end to end:

1. a periodic LJ fluid with a real pair potential
   (``molann_tpu_torch.sampling.LennardJonesPotential``, minimum image
   under the box) — the stand-in MD engine;
2. overdamped Langevin from the lattice at two temperatures: cold
   walkers stay crystalline, hot walkers melt;
3. two all-pairs coordination-shell features carrying ``pbc_box=box``
   (thousands of switching-function pairs — far past the unrolled
   kernels' envelope, so ``mode="auto"`` selects the blocked kernels);
4. HLDA on the labeled ensembles → a one-shot linear CV over the shells
   that separates solid from fluid on held-out frames;
5. the CV packaged as a ``MolANN`` and evaluated through the blocked
   forward kernel (K6, ``csrc/fused_blocked.cu``) on the card, its plain
   version on the host — parity with the eager model, the serving route
   for condensed-phase models.

Run on the card:
    python -m molann_tpu_torch.examples.condensed_phase_cv
"""

import time

import numpy as np
import torch

from .._device import resolve_device
from ..feature import Feature
from ..models.ann import FeatureLayer, MolANN, PreprocessingANN, SequentialNN
from ..ops.fused import fused_model_forward, model_select_mode
from ..sampling import LennardJonesPotential, overdamped_langevin
from ..systems import lj_fluid
from ..train import hlda

EPSILON = 1.0
SPACING = 1.7
DT = 5e-4
# The hot phase runs at DT / HOT_SPLIT for HOT_SPLIT times the steps, the
# same simulated time and recorded frames. At DT itself the hot walkers do
# not melt, they blow up: a pair overshoots into the repulsive core
# (r ~ 0.2 sigma, a force of ~4e9) and the atoms are thrown to 1e10-1e28,
# where the minimum image returns rounding noise. The JAX example
# (examples/condensed_phase_cv.py) runs the hot phase at DT and its
# quick-size check passes only on how XLA's fused minimum image rounds
# coordinates of 1e13; tests/test_torch_port_examples_serving.py shows
# both packages leaving the box at the same step.
HOT_SPLIT = 2


def sample_phase(pot, x0, kT, *, n_steps, generator, thin, dt=DT):
    """Overdamped Langevin from the lattice; returns [T, W, n, 3]."""
    traj, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_steps, dt=dt, kT=kT,
        generator=generator, thin=thin,
    )
    return traj


def shell_features(u, box):
    """The two coordination shells under the periodic box."""
    return [
        Feature("shell1", "coordination", u.atoms, r0=1.35 * SPACING,
                pbc_box=box),
        Feature("shell2", "coordination", u.atoms, r0=2.2 * SPACING,
                nn=4, mm=8, pbc_box=box),
    ]


def hlda_model(flayer, res, device):
    """The HLDA direction as a ``MolANN``: one Linear ``2 -> 1`` after the
    shells, ``w = directions[:, :1]``, ``b = -mean @ w``."""
    w = np.asarray(res.directions[:, :1], np.float32)
    b = np.asarray(-(res.mean @ res.directions[:, :1]), np.float32)
    lin = torch.nn.Linear(2, 1, device=device)
    with torch.no_grad():
        lin.weight.copy_(torch.as_tensor(w.T))
        lin.bias.copy_(torch.as_tensor(b))
    return MolANN(PreprocessingANN(None, flayer), SequentialNN([lin]))


def main(quick=False, device=None):
    dev = resolve_device(device)
    n_side = 3 if quick else 5
    n_walkers = 2 if quick else 3
    n_steps = 3000 if quick else 6000
    kT_hot = (3.0 if quick else 2.5) * EPSILON  # small boxes melt harder
    thin = 50

    u, box = lj_fluid(n_side, SPACING)
    n_atoms = len(u.atoms)
    sigma = SPACING / 2 ** (1 / 6)  # lattice sits near the LJ minimum
    pot = LennardJonesPotential(n_atoms, box, epsilon=EPSILON, sigma=sigma)

    # --- 1+2: dynamics at two temperatures -----------------------------
    x0 = torch.as_tensor(
        np.repeat(u.atoms.positions[None], n_walkers, 0).astype(np.float32),
        device=dev,
    )
    cold = sample_phase(pot, x0, 0.3 * EPSILON, n_steps=n_steps,
                        generator=torch.Generator(dev).manual_seed(0),
                        thin=thin)
    hot = sample_phase(pot, x0, kT_hot, n_steps=HOT_SPLIT * n_steps,
                       generator=torch.Generator(dev).manual_seed(1),
                       thin=HOT_SPLIT * thin, dt=DT / HOT_SPLIT)
    # drop the equilibration third, flatten walkers into the frame axis
    burn = cold.shape[0] // 3
    cold = cold[burn:].reshape(-1, n_atoms, 3)
    hot = hot[burn:].reshape(-1, n_atoms, 3)

    # --- 3: coordination shells under the periodic box ------------------
    feats = shell_features(u, box)
    flayer = FeatureLayer(feats, u.atoms)
    n_pairs = n_atoms * (n_atoms - 1) // 2
    print(f"{n_atoms} atoms, {len(feats)} coordination shells x "
          f"{n_pairs} minimum-image pairs")

    with torch.no_grad():
        f_cold = flayer(cold).cpu().numpy()
        f_hot = flayer(hot).cpu().numpy()
    cold, hot = cold.cpu().numpy(), hot.cpu().numpy()

    # --- 4: one-shot HLDA CV on train halves, judged on held-out halves -
    def halves(f):
        m = f.shape[0] // 2
        return f[:m], f[m:]

    (tr_c, ho_c), (tr_h, ho_h) = halves(f_cold), halves(f_hot)
    (_, ho_xc), (_, ho_xh) = halves(cold), halves(hot)
    res = hlda(
        np.concatenate([tr_c, tr_h]),
        np.repeat([0, 1], [len(tr_c), len(tr_h)]),
    )
    cv_c, cv_h = res.transform(ho_c)[:, 0], res.transform(ho_h)[:, 0]
    gap = abs(cv_c.mean() - cv_h.mean())
    spread = max(cv_c.std(), cv_h.std())
    # the held-out frames classified by the midpoint of the training
    # halves' mean CVs, the fluid on the side of its training mean
    m_c = res.transform(tr_c)[:, 0].mean()
    m_h = res.transform(tr_h)[:, 0].mean()
    side = np.sign(m_h - m_c)
    mid = 0.5 * (m_c + m_h)
    accuracy = float(np.mean(np.concatenate([
        side * (cv_c - mid) < 0, side * (cv_h - mid) > 0])))
    print(f"held-out CV: solid {cv_c.mean():+.2f}±{cv_c.std():.2f}  "
          f"fluid {cv_h.mean():+.2f}±{cv_h.std():.2f}  "
          f"gap/spread = {gap / spread:.1f}, accuracy {accuracy:.3f}")

    # --- 5: package as a MolANN, evaluate via the blocked fused kernel --
    model = hlda_model(flayer, res, dev)
    mode = model_select_mode(model)
    x_eval = torch.as_tensor(np.concatenate([ho_xc[:32], ho_xh[:32]]),
                             device=dev)
    t0 = time.perf_counter()
    with torch.no_grad():
        y_fused = fused_model_forward(model, x_eval, mode=mode)
        y_fused = y_fused.cpu().numpy()[:, 0]
        t_fused = time.perf_counter() - t0
        y_eager = model(x_eval).cpu().numpy()[:, 0]
    err = float(np.abs(y_fused - y_eager).max()) / max(
        float(np.abs(y_eager).max()), 1e-9
    )
    print(f"fused mode={mode}: {x_eval.shape[0]} frames in "
          f"{t_fused:.2f}s (incl. build), parity rel={err:.2e}")

    return {
        "n_atoms": n_atoms,
        "n_pairs": n_pairs,
        "cv_gap": float(gap),
        "cv_spread": float(spread),
        "cv_accuracy": accuracy,
        "fused_mode": mode,
        "fused_rel_err": err,
        "shell1_solid": float(f_cold[:, 0].mean()),
        "shell1_fluid": float(f_hot[:, 0].mean()),
    }


if __name__ == "__main__":
    out = main()
    print(out)
    # the JAX example's cv_gap > 3 * cv_spread is met only by its hot
    # walkers' blow-up (HOT_SPLIT above); a melted fluid is told from the
    # solid on held-out frames and has lost neighbours
    assert out["cv_accuracy"] > 0.8
    assert out["shell1_fluid"] < out["shell1_solid"] - 1.0
    assert out["fused_mode"] == "blocked" and out["fused_rel_err"] < 1e-4
