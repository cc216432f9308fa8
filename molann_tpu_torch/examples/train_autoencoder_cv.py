"""End-to-end example: learn collective variables with an autoencoder.

The canonical MolANN-ecosystem workflow: preprocess MD frames into
invariant features, train an encoder/decoder pair whose bottleneck is the
learned CV, then export the encoder (preprocessing + encoder MLP) for use
by an enhanced-sampling engine, as a TorchScript engine artifact that
returns the CVs and their coordinate gradients.

Run on the card:
    python -m molann_tpu_torch.examples.train_autoencoder_cv
"""

import functools
import os
import tempfile

import numpy as np
import torch

from .._device import resolve_device
from ..io import export_artifact, save_model
from ..models.ann import (
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
)
from ..systems import alanine_histogram_features, alanine_universe
from ..train import (
    autoencoder_loss,
    fit,
    force_fn,
    save_trajectory,
    trainable_mask,
)
from ..train.optim import Adam


def make_synthetic_trajectory(u, n_frames=4096, seed=0):
    """Fake 'MD data': fixture geometry + correlated noise."""
    rng = np.random.default_rng(seed)
    base = u.atoms.positions[None]
    modes = rng.normal(size=(3, 22, 3)).astype(np.float32)
    amps = rng.normal(size=(n_frames, 3, 1, 1)).astype(np.float32)
    frames = base + 0.05 * (amps * modes).sum(axis=1)
    frames += 0.02 * rng.normal(size=frames.shape).astype(np.float32)
    return frames.astype(np.float32)


def main(device=None):
    dev = resolve_device(device)
    u = alanine_universe()
    features = alanine_histogram_features(u)

    # invariant features -> no alignment needed (PreprocessingANN(None, ...))
    f_layer = FeatureLayer(features, u.atoms, use_angle_value=False)
    pp = PreprocessingANN(None, f_layer)
    d = pp.output_dimension()

    n_cv = 2
    g = torch.Generator().manual_seed(0)
    encoder = create_sequential_nn([d, 16, n_cv], generator=g, device=dev)
    decoder = create_sequential_nn([n_cv, 16, d], generator=g, device=dev)

    frames = make_synthetic_trajectory(u)
    workdir = tempfile.mkdtemp(prefix="cv_example_")
    save_trajectory(os.path.join(workdir, "traj.npy"), frames)

    # train the (encoder, decoder) pair jointly: one model of two members
    pair = (encoder, decoder)

    def loss_fn(p, batch):
        enc, dec = p
        return autoencoder_loss(enc, dec, pp, batch)

    def batches(batch_size=512, seed=1):
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.integers(0, len(frames), size=batch_size)
            yield frames[idx]

    result = fit(
        pair, loss_fn, batches(), optimizer=functools.partial(Adam, lr=2e-3),
        num_steps=300, log_every=100,
        mask=trainable_mask(pair, lambda name, t: True),
        checkpoint_dir=os.path.join(workdir, "ckpts"), checkpoint_every=100,
    )
    encoder, decoder = result.model
    print(f"reconstruction loss: {result.losses[0]:.4f} -> "
          f"{result.losses[-1]:.4f}")

    # package preprocessing + encoder as the deployable CV model
    cv_model = MolANN(pp, encoder)
    x = torch.as_tensor(frames[:8], device=dev)
    with torch.no_grad():
        print("learned CVs for 8 frames:\n", cv_model(x).cpu().numpy())

    save_model(os.path.join(workdir, "cv_model.npz"), cv_model)
    artifact = os.path.join(workdir, "cv_model.pt")
    export_artifact(cv_model, n_atoms=22, path=artifact, with_gradient=True)

    # biasing forces on the first CV component
    f = force_fn(cv_model, component=0)(x)
    print("force norm per frame:",
          torch.linalg.norm(f, dim=(1, 2)).cpu().numpy())
    print("artifacts in:", workdir)
    return {"losses": result.losses, "artifact": artifact, "forces": f,
            "cv_model": cv_model, "x": x}


if __name__ == "__main__":
    main()
