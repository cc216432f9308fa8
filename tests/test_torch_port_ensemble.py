"""The port's committees against the JAX package's ``train/ensemble.py``.

Three alanine members (JAX keys 0-2, carried across by ``.npz``), 64 noisy
frames from a numpy seed. The committee functions and ``fit_ensemble``
without bagging (five Adam steps at 1e-3 of the MSE loss) are held to the
JAX package within 1e-5; bagging, which draws from ``torch.Generator`` where
JAX draws from its PRNG, to its own repeats, bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train import calibrated_committee as jcalibrated_committee
from molann_tpu.train import committee as jcommittee
from molann_tpu.train import committee_calibration as jcommittee_calibration
from molann_tpu.train import ensemble_apply as jensemble_apply
from molann_tpu.train import fit_ensemble as jfit_ensemble
from molann_tpu.train import mse_loss as jmse_loss
from molann_tpu.train import stack_models as jstack_models
from molann_tpu.train import unstack_model as junstack_model
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import create_sequential_nn, named_tensors
from molann_tpu_torch.train import (
    batch_iterator,
    calibrated_committee,
    committee,
    committee_calibration,
    ensemble_apply,
    ensemble_size,
    fit_ensemble,
    make_ensemble_train_step,
    masked_optimizer,
    mse_loss,
    reinitialized_members,
    stack_models,
    trainable_mask,
    unstack_model,
)

N = 22
K = 3
TOL = 1e-5
REF = "preprocessing_layer.align_layer.ref_x"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("ensemble")
    jms, paths = [], []
    for i in range(K):
        jm, u = jalanine_model(key=jax.random.PRNGKey(i))
        jms.append(jm)
        paths.append(jsave_model(str(d / f"m{i}.npz"), jm))
    rng = np.random.default_rng(21)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(64, N, 3))).astype(np.float32)
    y = rng.normal(size=(64, 3)).astype(np.float32)
    return jms, paths, x, y


def _members(paths):
    return [load_model(p, device="cpu") for p in paths]


def _batches(x, y, iterator=batch_iterator):
    return ((b, y[idx]) for b, idx in iterator(x, 16, seed=3,
                                               return_indices=True))


def test_stack_unstack_round_trip(setup):
    _, paths, x, _ = setup
    members = _members(paths)
    stacked = stack_models(members)
    assert ensemble_size(stacked) == K
    for i, m in enumerate(members):
        assert unstack_model(stacked, i) is m
    with pytest.raises(ValueError, match="at least 2"):
        stack_models(members[:1])
    other = load_model(paths[0], device="cpu")
    other.ann_layers = create_sequential_nn([38, 6, 3])
    with pytest.raises(ValueError, match="member 1 has a different"):
        stack_models([members[0], other])
    with pytest.raises(ValueError, match="member 2 has a different"):
        stack_models([members[0], members[1], members[2].ann_layers])


def test_committee_functions_match_jax(setup):
    jms, paths, x, _ = setup
    jst = jstack_models(jms)
    st = stack_models(_members(paths))
    xt = torch.as_tensor(x)
    xj = jnp.asarray(x)
    with torch.no_grad():
        got = [ensemble_apply(st, xt), *committee(st, xt),
               *committee_calibration(st, xt[:32]),
               *calibrated_committee(st, xt[32:], xt[:32])]
        cal = committee_calibration(st, xt[:32])
        again = calibrated_committee(st, xt[32:], calibration=cal)
    want = [jensemble_apply(jst, xj), *jcommittee(jst, xj),
            *jcommittee_calibration(jst, xj[:32]),
            *jcalibrated_committee(jst, xj[32:], xj[:32])]
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL)
    for a, b in zip(again, got[6:]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="x_ref or calibration"):
        calibrated_committee(st, xt)


def test_fit_ensemble_matches_jax(setup):
    """Five Adam steps of three members on shared batches, against JAX's
    one vmapped step."""
    jms, paths, x, y = setup
    jres = jfit_ensemble(jms, jmse_loss, _batches(x, y, _jax_iterator()),
                         optimizer=optax.adam(1e-3), num_steps=5)
    res = fit_ensemble(_members(paths), mse_loss, _batches(x, y),
                       num_steps=5)
    np.testing.assert_allclose(res.losses, jres.losses, rtol=TOL, atol=TOL)
    for i, m in enumerate(res.models):
        jm = junstack_model(jres.models, i)
        for lin, (w, b) in zip(m.ann_layers.layers, jm.ann_layers.params):
            np.testing.assert_allclose(lin.weight.detach().numpy(),
                                       np.asarray(w).T, atol=TOL)
            np.testing.assert_allclose(lin.bias.detach().numpy(),
                                       np.asarray(b), atol=TOL)
        np.testing.assert_array_equal(
            dict(named_tensors(m))[REF].numpy(),
            np.asarray(jm.preprocessing_layer.align_layer.ref_x))


def _jax_iterator():
    from molann_tpu.train.data import batch_iterator as jbatch_iterator

    return jbatch_iterator


def test_bagging_repeats_and_decorrelates(setup):
    """Members with identical weights drift apart under bagging; the same
    seed gives the same bits."""
    _, paths, x, y = setup

    def run(seed):
        members = [load_model(paths[0], device="cpu") for _ in range(K)]
        return fit_ensemble(members, mse_loss, _batches(x, y), num_steps=4,
                            bagging=True, seed=seed)

    a, b, c = run(0), run(0), run(1)
    assert a.losses == b.losses
    for ma, mb in zip(a.models, b.models):
        for (_, ta), (_, tb) in zip(named_tensors(ma), named_tensors(mb)):
            assert torch.equal(ta, tb)
    w = [m.ann_layers.layers[0].weight for m in a.models]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])
    assert a.losses[0][0] != a.losses[0][1]
    assert c.losses != a.losses


def test_member_batches_and_step_errors(setup):
    _, paths, x, y = setup
    members = _members(paths)
    build = masked_optimizer(functools.partial(torch.optim.Adam, lr=1e-3),
                             trainable_mask(members[0]))
    opts = [build(m) for m in members]
    step = make_ensemble_train_step(mse_loss, batch_mode="member")
    xs = torch.as_tensor(np.stack([x[:16], x[16:32], x[32:48]]))
    ys = torch.as_tensor(np.stack([y[:16], y[16:32], y[32:48]]))
    ref = [float(mse_loss(m, (xs[i], ys[i])).detach())
           for i, m in enumerate(members)]
    _, _, losses = step(members, opts, (xs, ys))
    np.testing.assert_allclose(losses.numpy(), ref, rtol=1e-6)
    with pytest.raises(ValueError, match="unknown batch_mode"):
        make_ensemble_train_step(mse_loss, batch_mode="nope")
    with pytest.raises(ValueError, match="generator"):
        make_ensemble_train_step(mse_loss, batch_mode="bagging")(
            members, opts, (xs[0], ys[0]))


def test_reinitialized_members(setup):
    _, paths, x, _ = setup
    model = load_model(paths[0], device="cpu")
    a = reinitialized_members(model, 3, seed=5)
    b = reinitialized_members(model, 3, seed=5)
    c = reinitialized_members(model, 3, seed=6)
    assert len(a) == 3
    for m in a:
        assert m.preprocessing_layer is model.preprocessing_layer
        assert [tuple(t.shape) for _, t in named_tensors(m)] == [
            tuple(t.shape) for _, t in named_tensors(model)]
        assert m.ann_layers.activation == model.ann_layers.activation
    for ma, mb in zip(a, b):
        assert all(torch.equal(p, q) for p, q in zip(ma.parameters(),
                                                     mb.parameters()))
    w = [m.ann_layers.layers[0].weight for m in a]
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[0], w[2])
    assert not torch.equal(w[0], c[0].ann_layers.layers[0].weight)
    stack_models(a)
    # a (model, decoder) pair re-draws both MLPs and keeps its shape
    pair = reinitialized_members((model, create_sequential_nn([3, 38])), 2)
    assert all(isinstance(p, tuple) and len(p) == 2 for p in pair)
    assert not torch.equal(pair[0][1].layers[0].weight,
                           pair[1][1].layers[0].weight)
    with pytest.raises(ValueError, match="at least 2"):
        reinitialized_members(model, 1)
    with pytest.raises(TypeError, match="cannot reinitialize"):
        reinitialized_members(model.preprocessing_layer, 2)


def test_mesh_is_not_ported(setup):
    """``mesh=`` takes a data mesh (two ranks: test_torch_port_mesh_train.py);
    anything else is refused, and a mesh of one rank without collectives
    trains as ``mesh=None`` does, bit for bit."""
    from molann_tpu_torch.parallel import data_mesh

    _, paths, x, y = setup
    with pytest.raises(TypeError, match="data_mesh"):
        fit_ensemble(_members(paths), mse_loss, _batches(x, y), mesh=object())
    with pytest.raises(TypeError, match="data_mesh"):
        make_ensemble_train_step(mse_loss, mesh=object())
    runs = [fit_ensemble(_members(paths), mse_loss, _batches(x, y),
                         num_steps=3, bagging=True, mesh=mesh)
            for mesh in (None, data_mesh(devices="cpu"))]
    assert runs[0].losses == runs[1].losses
    for a, b in zip(*(r.models for r in runs)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
