"""The port's training loop, data and checkpoints against the JAX package.

``batch_iterator`` must give the JAX package's batches for the same seed;
``fit`` with ``torch.optim.Adam(lr=1e-3)`` must follow JAX ``fit`` with
``optax.adam(1e-3)`` (the same update formula) step by step; the fused and
the autograd trainers must agree; a checkpointed and resumed run must
equal an uninterrupted one bit for bit; a port-saved model must load in
the JAX package. Weights cross via ``save_model`` → ``load_model``;
inputs come from a numpy seed. Tolerances: loss traces and weights 1e-5;
outputs of a reloaded model 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molann_tpu.ann import create_sequential_nn as jcreate_sequential_nn
from molann_tpu.io import load_model as jload_model
from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train import autoencoder_loss as jautoencoder_loss
from molann_tpu.train import fit as jfit
from molann_tpu.train import make_eigenfunction_loss as jmake_eigenfunction_loss
from molann_tpu.train import mse_loss as jmse_loss
from molann_tpu.train.data import TrajectoryDataset as JTrajectoryDataset
from molann_tpu.train.data import batch_iterator as jbatch_iterator
from molann_tpu_torch.io import load_model, save_model
from molann_tpu_torch.models.ann import named_tensors
from molann_tpu_torch.systems import alanine_model
from molann_tpu_torch.train import (
    TrajectoryDataset,
    autoencoder_loss,
    batch_iterator,
    fit,
    latest_checkpoint,
    load_training_state,
    make_eigenfunction_loss,
    make_fused_train_step,
    make_train_step,
    masked_optimizer,
    mse_loss,
    save_training_state,
    save_trajectory,
    trainable_mask,
)

N = 22
TOL = 1e-5
REF = "preprocessing_layer.align_layer.ref_x"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("loop")
    jm, u = jalanine_model()
    path = jsave_model(str(d / "m.npz"), jm)
    rng = np.random.default_rng(31)
    frames = (u.atoms.positions[None]
              + 0.05 * rng.normal(size=(96, N, 3))).astype(np.float32)
    targets = rng.normal(size=(96, 3)).astype(np.float32)
    return jm, path, frames, targets


def _batches(frames, targets, seed=3, epochs=None, iterator=batch_iterator):
    return ((b, targets[idx]) for b, idx in iterator(
        frames, 16, seed=seed, epochs=epochs, return_indices=True))


def _weights(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("multiple_of,drop_remainder", [
    (1, True), (1, False), (4, False), (6, False)])
def test_batch_iterator_matches_jax(shuffle, multiple_of, drop_remainder):
    data = np.arange(37 * 3, dtype=np.float32).reshape(37, 1, 3)
    kw = dict(shuffle=shuffle, seed=5, epochs=2, multiple_of=multiple_of,
              drop_remainder=drop_remainder, return_indices=True)
    got = list(batch_iterator(data, 10, **kw))
    want = list(jbatch_iterator(data, 10, **kw))
    assert len(got) == len(want) > 0
    for (b, idx), (b_ref, idx_ref) in zip(got, want):
        np.testing.assert_array_equal(idx, idx_ref)
        np.testing.assert_array_equal(b, b_ref)


def test_trajectory_dataset_roundtrip(setup, tmp_path):
    _, _, frames, _ = setup
    path = save_trajectory(str(tmp_path / "t.npy"), frames)
    ds, jds = TrajectoryDataset(path), JTrajectoryDataset(path)
    assert (len(ds), ds.n_atoms) == (len(jds), jds.n_atoms) == (96, N)
    a = next(batch_iterator(ds, 32, seed=1))
    b = next(jbatch_iterator(jds, 32, seed=1))
    np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        save_trajectory(str(tmp_path / "bad.npy"), frames[:, :, :2])
    with pytest.raises(ValueError, match="multiple_of"):
        next(batch_iterator(frames[:3], 8, multiple_of=4))


def test_fit_matches_jax(setup):
    """Five Adam steps of the port's fit against JAX fit with optax."""
    jm, path, frames, targets = setup
    jres = jfit(jm, jmse_loss,
                _batches(frames, targets, iterator=jbatch_iterator),
                optimizer=optax.adam(1e-3), num_steps=5)
    res = fit(load_model(path, device="cpu"), mse_loss, _batches(frames, targets),
              num_steps=5)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=TOL, atol=TOL)
    for i, (w, b) in enumerate(jres.model.ann_layers.params):
        lin = res.model.ann_layers.layers[i]
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(w).T, atol=TOL)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(b),
                                   atol=TOL)
    np.testing.assert_array_equal(
        res.model.preprocessing_layer.align_layer.ref_x.numpy(),
        np.asarray(jm.preprocessing_layer.align_layer.ref_x))


@pytest.mark.parametrize("transposed", [False, True])
def test_fused_and_autograd_trainers_agree(setup, transposed):
    _, path, frames, targets = setup
    traces, weights = [], []
    for fused in (False, True):
        model = load_model(path, device="cpu")
        build = masked_optimizer(functools.partial(torch.optim.Adam, lr=1e-3),
                                 trainable_mask(model))
        opt = build(model)
        step = (make_fused_train_step(transposed_input=transposed) if fused
                else make_train_step(mse_loss))
        losses = []
        for x, y in _batches(frames, targets, epochs=1):
            if fused and transposed:
                x, y = x.reshape(len(x), 3 * N).T.copy(), y.T.copy()
            model, opt, loss = step(model, opt, (x, y))
            losses.append(float(loss))
        traces.append(losses)
        weights.append(_weights(model))
    assert len(traces[0]) == 6
    np.testing.assert_allclose(traces[1], traces[0], rtol=TOL, atol=TOL)
    for name, w in weights[0].items():
        np.testing.assert_allclose(weights[1][name].numpy(), w.numpy(),
                                   atol=TOL)


def test_checkpoint_resume_is_bit_identical(setup, tmp_path):
    """Ten steps with checkpoint_every=5, then a resume to 20, equal 20
    uninterrupted steps bit for bit."""
    _, path, frames, targets = setup

    full = fit(load_model(path, device="cpu"), mse_loss, _batches(frames, targets, seed=4),
               num_steps=20)
    ckpt = str(tmp_path / "ckpt")
    first = fit(load_model(path, device="cpu"), mse_loss, _batches(frames, targets, seed=4),
                num_steps=10, checkpoint_dir=ckpt, checkpoint_every=5)
    assert latest_checkpoint(ckpt).endswith("ckpt_0000000010")
    resumed = fit(load_model(path, device="cpu"), mse_loss,
                  _batches(frames, targets, seed=4), num_steps=20,
                  checkpoint_dir=ckpt, checkpoint_every=5)
    assert first.losses + resumed.losses == full.losses
    for name, w in _weights(full.model).items():
        assert torch.equal(_weights(resumed.model)[name], w)
    assert latest_checkpoint(ckpt).endswith("ckpt_0000000020")


def test_changed_optimizer_raises_on_resume(setup, tmp_path):
    _, path, frames, targets = setup
    ckpt = str(tmp_path / "ckpt")
    fit(load_model(path, device="cpu"), mse_loss, _batches(frames, targets), num_steps=2,
        checkpoint_dir=ckpt, checkpoint_every=2)
    for opt in (functools.partial(torch.optim.Adam, lr=1e-2),
                functools.partial(torch.optim.SGD, lr=1e-3)):
        with pytest.raises(ValueError, match="optimizer state mismatch"):
            fit(load_model(path, device="cpu"), mse_loss, _batches(frames, targets),
                optimizer=opt, num_steps=4, checkpoint_dir=ckpt)
    # a model file without its optimizer state is not a checkpoint
    (tmp_path / "ckpt" / "ckpt_0000000009.model.npz").write_bytes(b"")
    assert latest_checkpoint(ckpt).endswith("ckpt_0000000002")
    assert latest_checkpoint(str(tmp_path / "none")) is None


def test_saved_model_loads_in_jax(setup, tmp_path):
    _, path, frames, targets = setup
    model = fit(load_model(path, device="cpu"), mse_loss, _batches(frames, targets),
                num_steps=2).model
    out = save_model(str(tmp_path / "trained.npz"), model)
    jm = jload_model(out)
    with torch.no_grad():
        y = model(torch.from_numpy(frames)).numpy()
        y_back = load_model(out, device="cpu")(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(np.asarray(jm(jnp.asarray(frames))), y,
                               atol=1e-6)
    np.testing.assert_array_equal(y_back, y)
    flayer = alanine_model(device="cpu")[0].preprocessing_layer.feature_layer
    jf = jload_model(save_model(str(tmp_path / "f.npz"), flayer))
    with torch.no_grad():
        np.testing.assert_allclose(np.asarray(jf(jnp.asarray(frames))),
                                   flayer(torch.from_numpy(frames)).numpy(),
                                   atol=1e-6)


def test_masks(setup):
    _, path, frames, targets = setup
    model = load_model(path, device="cpu")
    mask = trainable_mask(model)
    assert mask == {**{n: True for n, _ in model.named_parameters()},
                    REF: False}
    opt = masked_optimizer(torch.optim.Adam, mask)(model)
    assert len(opt.param_groups[0]["params"]) == 4
    with pytest.raises(ValueError, match="lacks"):
        masked_optimizer(torch.optim.Adam, {"nope": True})(model)
    # ref_x marked trainable: both trainers move it, by the same step
    refs = []
    for fused in (False, True):
        model = load_model(path, device="cpu")
        mask = trainable_mask(model, lambda name, t: True)
        opt = masked_optimizer(functools.partial(torch.optim.Adam, lr=1e-3),
                               mask)(model)
        step = (make_fused_train_step(train_ref=True) if fused
                else make_train_step(mse_loss))
        x, y = next(_batches(frames, targets))
        step(model, opt, (x, y))
        refs.append(model.preprocessing_layer.align_layer.ref_x.detach())
    before = load_model(path, device="cpu").preprocessing_layer.align_layer.ref_x
    assert not torch.equal(refs[0], before)
    np.testing.assert_allclose(refs[1].numpy(), refs[0].numpy(), atol=TOL)


def _check_mlp(lins, jparams):
    for lin, (w, b) in zip(lins, jparams):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(w).T, atol=TOL)
        np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(b),
                                   atol=TOL)


def test_fit_on_bare_batches_matches_jax(setup):
    """A batch that is one array (the eigenfunction loss's bare ``x``) moves
    to the device whole, not split into its frames: five Adam steps of
    ``fit(model, make_eigenfunction_loss(), ...)`` against JAX ``fit``."""
    jm, path, frames, _ = setup

    def bare(iterator):
        return iterator(frames, 16, seed=2)

    jres = jfit(jm, jmake_eigenfunction_loss(alpha=5.0),
                bare(jbatch_iterator), optimizer=optax.adam(1e-3),
                num_steps=5)
    res = fit(load_model(path, device="cpu"),
              make_eigenfunction_loss(alpha=5.0), bare(batch_iterator),
              num_steps=5)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=TOL, atol=TOL)
    # the output bias shifts every CV by a constant, which the loss's
    # centred covariance and gradients do not see: its gradient is 0 up to
    # rounding, which Adam scales up to steps of lr, so it is held to
    # Adam's bound on 5 steps rather than to JAX's rounding
    lins = res.model.ann_layers.layers
    jparams = jres.model.ann_layers.params
    _check_mlp(lins[:-1], jparams[:-1])
    np.testing.assert_allclose(lins[-1].weight.detach().numpy(),
                               np.asarray(jparams[-1][0]).T, atol=TOL)
    b0 = np.asarray(jm.ann_layers.params[-1][1])
    for b in (lins[-1].bias.detach().numpy(), np.asarray(jparams[-1][1])):
        assert np.abs(b - b0).max() <= 5 * 1e-3 * (1 + 1e-6)


def _ae_loss(pair, x):
    m, dec = pair
    return autoencoder_loss(m.ann_layers, dec, m.preprocessing_layer, x)


def _jae_loss(pair, x):
    m, dec = pair
    return jautoencoder_loss(m.ann_layers, dec, m.preprocessing_layer, x)


@pytest.fixture(scope="module")
def pair_path(setup, tmp_path_factory):
    jm = setup[0]
    jdec = jcreate_sequential_nn([3, 6, 38], key=jax.random.PRNGKey(7))
    path = str(tmp_path_factory.mktemp("pair") / "pair.npz")
    return jsave_model(path, (jm, jdec)), (jm, jdec)


def test_pair_masks_and_fit_match_jax(setup, pair_path):
    """A ``(model, decoder)`` pair trains as one model, as JAX's pytree
    ``fit`` does: names carry the tuple index, the default mask freezes
    ``ref_x`` and trains both MLPs."""
    frames = setup[2]
    path, jpair = pair_path
    pair = load_model(path, device="cpu")
    assert isinstance(pair, tuple) and len(pair) == 2
    mask = trainable_mask(pair)
    assert mask["0.ann_layers.layers.0.weight"]
    assert mask["1.layers.0.weight"] and mask["1.layers.1.bias"]
    assert not mask["0." + REF]
    assert sum(mask.values()) == 8 and len(mask) == 9
    opt = masked_optimizer(torch.optim.Adam, mask)(pair)
    assert len(opt.param_groups[0]["params"]) == 8

    jres = jfit(jpair, _jae_loss, jbatch_iterator(frames, 16, seed=6),
                optimizer=optax.adam(1e-3), num_steps=5)
    res = fit(pair, _ae_loss, batch_iterator(frames, 16, seed=6),
              num_steps=5)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=TOL, atol=TOL)
    _check_mlp(res.model[0].ann_layers.layers,
               jres.model[0].ann_layers.params)
    _check_mlp(res.model[1].layers, jres.model[1].params)
    np.testing.assert_array_equal(
        res.model[0].preprocessing_layer.align_layer.ref_x.numpy(),
        np.asarray(jpair[0].preprocessing_layer.align_layer.ref_x))


def test_pair_checkpoint_resumes_bit_identical(setup, pair_path, tmp_path):
    frames = setup[2]
    path = pair_path[0]
    full = fit(load_model(path, device="cpu"), _ae_loss,
               batch_iterator(frames, 16, seed=8), num_steps=8)
    ckpt = str(tmp_path / "ckpt")
    first = fit(load_model(path, device="cpu"), _ae_loss,
                batch_iterator(frames, 16, seed=8), num_steps=4,
                checkpoint_dir=ckpt, checkpoint_every=4)
    resumed = fit(load_model(path, device="cpu"), _ae_loss,
                  batch_iterator(frames, 16, seed=8), num_steps=8,
                  checkpoint_dir=ckpt)
    assert first.losses + resumed.losses == full.losses
    assert isinstance(resumed.model, tuple)
    for a, b in zip(named_tensors(resumed.model), named_tensors(full.model)):
        assert a[0] == b[0] and torch.equal(a[1], b[1])
    # the pair's state round-trips through the checkpoint functions
    build = masked_optimizer(torch.optim.Adam, trainable_mask(full.model))
    opt = build(full.model)
    prefix = save_training_state(str(tmp_path / "again"), full.model, opt, 3)
    model, opt2, step = load_training_state(prefix, build, device="cpu")
    assert step == 3 and isinstance(model, tuple)
    assert len(opt2.param_groups[0]["params"]) == 8
