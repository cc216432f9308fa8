"""End-to-end example: production CV + biasing-force serving.

The biased-MD serving workflow: a trained model evaluates collective
variables AND their coordinate gradients (the biasing forces are the
negated gradients) over trajectory batches arriving from disk. On the card
every batch is one launch of the fused CV-and-gradient kernel (K4,
``csrc/fused_unrolled.cu``): one read of the coordinates, CVs and
gradients written together; the trajectory format is handled by the
native loader (.npy or CHARMM/NAMD .dcd). The device is the caller's: on
``"cpu"`` the same call runs the kernel's plain PyTorch version.

Run on the card:
    python -m molann_tpu_torch.examples.serve_biased_md
"""

import os
import tempfile

import numpy as np
import torch

from .._device import resolve_device
from ..io import save_model, write_dcd
from ..ops import fused as F
from ..systems import alanine_model
from ..train import packed_batch_iterator

N_FRAMES = 4096
BATCH = 1024


def noisy_frames(u, n_frames=N_FRAMES, seed=0):
    """The fixture geometry plus 0.05 Å Gaussian noise, ``[n_frames, n,
    3]`` float32 (a stand-in for an MD engine's output)."""
    rng = np.random.default_rng(seed)
    return (
        u.atoms.positions[None]
        + 0.05 * rng.normal(size=(n_frames, len(u.atoms), 3))
    ).astype(np.float32)


def serve(model, xb):
    """CVs and the coordinate gradients of CV component 0 of one packed
    ``[B, 3n]`` batch: ``(cvs [B, d], grads [B, 3n])``."""
    return F.fused_cv_forces(model, xb, component=0)


def main(device=None):
    dev = resolve_device(device)
    workdir = tempfile.mkdtemp(prefix="molann_serve_")
    model, u = alanine_model(device=dev)

    # --- the artifacts a production setup would load -------------------
    model_path = os.path.join(workdir, "model.npz")
    save_model(model_path, model)

    # a fake trajectory, written as DCD (what MD engines emit)
    traj = os.path.join(workdir, "traj.dcd")
    write_dcd(traj, noisy_frames(u))

    # --- serving loop ---------------------------------------------------
    launched = F.KERNEL_LAUNCHES["cv_forces"]
    n_done = 0
    first = None
    for xb in packed_batch_iterator(traj, BATCH, shuffle=False, epochs=1,
                                    drop_remainder=False):
        cvs, grads = serve(model, torch.as_tensor(xb, device=dev))
        forces = -grads  # the biasing forces
        if first is None:
            first = (cvs, forces)
        n_done += xb.shape[0]
        print(f"batch done: {cvs.shape[0]} frames, CV[0] mean "
              f"{float(cvs[:, 0].mean()):+.4f}, |F|max "
              f"{float(forces.abs().max()):.3f}")
    print(f"served {n_done} frames from {traj}")

    # equivalent one-liner from the shell:
    #   python -m molann_tpu_torch forces model.npz traj.dcd --component 0 \
    #       --out cvs.npy --forces-out forces.npy
    return {
        "n_done": n_done,
        "cvs": first[0],
        "forces": first[1],
        "launches": F.KERNEL_LAUNCHES["cv_forces"] - launched,
        "model_path": model_path,
        "traj": traj,
    }


if __name__ == "__main__":
    main()
