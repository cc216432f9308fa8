"""The port's CV-learning objectives against the JAX package.

Alanine with a ``[38, 8, 2]`` head (weights and a decoder carried across by
``.npz``), 128 noisy frames from a numpy seed, through the JAX objectives
(jitted) and the port's (eager torch on the CPU). Tolerances: values 1e-5
(``assert_allclose`` with ``atol=rtol=1e-5``: absolute at the scale of one,
relative for the eigenvalue estimates of a few hundred, whose float32
spacing alone is 3e-5); parameter gradients, and coordinate gradients,
5e-5·max(1, max|g|). TICA on dyadic inputs, whose float32 moments are exact
in both packages, and HLDA: 1e-10. The lagged-pair iterator: exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.ann import create_sequential_nn as jcreate_sequential_nn
from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train import autoencoder_loss as jautoencoder_loss
from molann_tpu.train import committor_loss as jcommittor_loss
from molann_tpu.train import cv_coordinate_gradients as jcv_coordinate_gradients
from molann_tpu.train import eigenfunction_loss as jeigenfunction_loss
from molann_tpu.train import hlda as jhlda
from molann_tpu.train import lagged_pair_iterator as jlagged_pair_iterator
from molann_tpu.train import tica as jtica
from molann_tpu.train import timelagged_autoencoder_loss as jtae_loss
from molann_tpu.train import vamp2_loss as jvamp2_loss
from molann_tpu.train import vamp2_score as jvamp2_score
from molann_tpu.train.losses import registry as jregistry
from molann_tpu_torch.io import load_model
from molann_tpu_torch.train import (
    autoencoder_loss,
    committor_loss,
    cv_coordinate_gradients,
    eigenfunction_loss,
    hlda,
    lagged_pair_iterator,
    tica,
    timelagged_autoencoder_loss,
    vamp2_loss,
    vamp2_score,
)
from molann_tpu_torch.train.losses import registry

N = 22
L = 128
VAL = 1e-5
GRAD = 5e-5
EXACT = 1e-10


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("objectives")
    jm, u = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(3))
    jdec = jcreate_sequential_nn([2, 8, 38], key=jax.random.PRNGKey(4))
    path = jsave_model(str(d / "pair.npz"), (jm, jdec))
    model, dec = load_model(path, device="cpu")
    rng = np.random.default_rng(11)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(L, N, 3))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=L).astype(np.float32)
    labels = rng.permutation(np.repeat([1, 0, 2], [40, 48, 40])).astype(
        np.int32)
    return dict(jm=jm, jdec=jdec, model=model, dec=dec, x=x, w=w,
                labels=labels)


def _close_grad(got, want):
    want = np.asarray(want, np.float64)
    tol = GRAD * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64), want, atol=tol,
                               rtol=0)


def _check_mlp_grads(lins, jparams):
    """An MLP's weight and bias gradients (torch ``[d_out, d_in]``) against
    JAX's (``[d_in, d_out]``)."""
    assert len(lins) == len(jparams)
    for lin, (gw, gb) in zip(lins, jparams):
        _close_grad(lin.weight.grad.numpy().T, gw)
        _close_grad(lin.bias.grad.numpy(), gb)


def _zero(*modules):
    for m in modules:
        for p in m.parameters():
            p.grad = None


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("lagged", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_autoencoder_losses_match_jax(setup, lagged, weighted):
    s = setup
    x, w = s["x"], s["w"] if weighted else None
    xs = (x[:-1], x[1:]) if lagged else (x,)
    ws = None if w is None else (w[:-1] if lagged else w)

    def jloss(pair):
        m, dec = pair
        args = [jnp.asarray(a) for a in xs]
        fn = jtae_loss if lagged else jautoencoder_loss
        return fn(m.ann_layers, dec, m.preprocessing_layer, *args, weights=ws)

    jl, (jgm, jgd) = jax.jit(jax.value_and_grad(jloss))((s["jm"], s["jdec"]))
    model, dec = s["model"], s["dec"]
    _zero(model, dec)
    fn = timelagged_autoencoder_loss if lagged else autoencoder_loss
    loss = fn(model.ann_layers, dec, model.preprocessing_layer,
              *[_t(a) for a in xs], weights=ws)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=VAL, rtol=VAL)
    _check_mlp_grads(model.ann_layers.layers, jgm.ann_layers.params)
    _check_mlp_grads(dec.layers, jgd.params)


def test_cv_coordinate_gradients_match_jax(setup):
    s = setup
    want = jax.jit(jcv_coordinate_gradients)(s["jm"], jnp.asarray(s["x"]))
    got = cv_coordinate_gradients(s["model"], _t(s["x"]))
    assert tuple(got.shape) == (2, L, N, 3) == want.shape
    _close_grad(got.detach().numpy(), want)
    # differentiable once more: the graph is kept under grad mode
    assert got.requires_grad
    with torch.no_grad():
        assert not cv_coordinate_gradients(s["model"], _t(s["x"])
                                           ).requires_grad


@pytest.mark.parametrize("weighted", [False, True])
def test_eigenfunction_loss_matches_jax(setup, weighted):
    """Value, aux and the parameter gradient, which is second order:
    ``∂/∂θ E[|∇ₓ f|²]`` through the QCP alignment and the features."""
    s = setup
    w = s["w"] if weighted else None

    def jloss(m, xx):
        return jeigenfunction_loss(m, xx, beta=2.0, alpha=5.0, weights=w,
                                   return_aux=True)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        s["jm"], jnp.asarray(s["x"]))
    model = s["model"]
    _zero(model)
    loss, aux = eigenfunction_loss(model, _t(s["x"]), beta=2.0, alpha=5.0,
                                   weights=w, return_aux=True)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=VAL, rtol=VAL)
    for key in ("eigenvalues", "cov"):
        np.testing.assert_allclose(aux[key].detach().numpy(),
                                   np.asarray(jaux[key]), atol=VAL, rtol=VAL)
    _check_mlp_grads(model.ann_layers.layers, jg.ann_layers.params)
    assert model.preprocessing_layer.align_layer.ref_x.grad is None


@pytest.mark.parametrize("case", ["weighted", "no_basin_a"])
def test_committor_loss_matches_jax(setup, case):
    """Weighted, and a batch with no frame in A: the penalty's untaken
    branch must give a zero gradient, not NaN."""
    s = setup
    labels = s["labels"].copy()
    if case == "no_basin_a":
        labels[labels == 1] = 0
    w = s["w"]

    def jloss(m, xx):
        return jcommittor_loss(m, xx, labels, beta=2.0, alpha=50.0,
                               weights=w, return_aux=True)

    (jl, jaux), jg = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        s["jm"], jnp.asarray(s["x"]))
    model = s["model"]
    _zero(model)
    loss, aux = committor_loss(model, _t(s["x"]), _t(labels), beta=2.0,
                               alpha=50.0, weights=w, return_aux=True)
    loss.backward()
    assert np.isfinite(float(loss))
    np.testing.assert_allclose(loss.item(), float(jl), atol=VAL, rtol=VAL)
    for key in ("dirichlet", "mean_q_a", "mean_q_b"):
        np.testing.assert_allclose(float(aux[key]), float(jaux[key]),
                                   atol=VAL, rtol=VAL)
    if case == "no_basin_a":
        assert float(aux["mean_q_a"]) == 0.0
    for lin in model.ann_layers.layers:
        assert torch.isfinite(lin.weight.grad).all()
    _check_mlp_grads(model.ann_layers.layers, jg.ann_layers.params)


@pytest.mark.parametrize("weighted", [False, True])
def test_vamp2_score_matches_jax(weighted):
    rng = np.random.default_rng(7)
    f0 = rng.normal(size=(256, 3)).astype(np.float32)
    ft = (0.8 * f0 + 0.6 * rng.normal(size=(256, 3))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=256).astype(np.float32) if weighted \
        else None
    want = jvamp2_score(jnp.asarray(f0), jnp.asarray(ft), weights=w)
    got = vamp2_score(_t(f0), _t(ft), weights=w)
    np.testing.assert_allclose(float(got), float(want), atol=VAL, rtol=VAL)


@pytest.mark.parametrize("weighted", [False, True])
def test_vamp2_loss_matches_jax(setup, weighted):
    s = setup
    x = s["x"]
    w = s["w"][:-4] if weighted else None

    def jloss(m):
        return jvamp2_loss(m, jnp.asarray(x[:-4]), jnp.asarray(x[4:]),
                           weights=w)

    jl, jg = jax.jit(jax.value_and_grad(jloss))(s["jm"])
    model = s["model"]
    _zero(model)
    loss = vamp2_loss(model, _t(x[:-4]), _t(x[4:]), weights=w)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), atol=VAL, rtol=VAL)
    _check_mlp_grads(model.ann_layers.layers, jg.ann_layers.params)

    _, jaux = jvamp2_loss(s["jm"], jnp.asarray(x[:-4]), jnp.asarray(x[4:]),
                          weights=w, return_aux=True)
    with torch.no_grad():
        _, aux = vamp2_loss(model, _t(x[:-4]), _t(x[4:]), weights=w,
                            return_aux=True)
    np.testing.assert_allclose(float(aux["vamp2"]), float(jaux["vamp2"]),
                               atol=VAL, rtol=VAL)
    np.testing.assert_allclose(aux["autocorrelations"].numpy(),
                               np.asarray(jaux["autocorrelations"]),
                               atol=VAL, rtol=VAL)


def _dyadic_pairs(seed):
    """Lagged feature pairs of quarter integers with uniform or (1, 3)
    weights over 64 rows: every float32 moment is exact, so the JAX
    package's float32 sums and the port's agree to the bit."""
    rng = np.random.default_rng(seed)
    f0 = rng.integers(-4, 5, size=(64, 3)) / 4
    ft = np.clip(f0 + rng.integers(-1, 2, size=(64, 3)) / 4, -1, 1)
    w = rng.permutation(np.repeat([1.0, 3.0], 32))
    return f0, ft, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("reversible", [True, False])
def test_tica_matches_jax(reversible, weighted):
    f0, ft, w = _dyadic_pairs(5)
    w = w if weighted else None
    want = jtica(f0, ft, weights=w, reversible=reversible, lag=3.0)
    got = tica(f0, ft, weights=w, reversible=reversible, lag=3.0)
    for key in ("eigenvalues", "modes", "mean"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   atol=EXACT, rtol=0)
    np.testing.assert_allclose(got.timescales(), want.timescales(),
                               atol=EXACT, rtol=0)
    np.testing.assert_allclose(got.transform(f0), np.asarray(
        want.transform(f0), np.float64), atol=1e-6)
    assert got.lag == 3.0
    # n_modes keeps the slowest
    assert tica(f0, ft, n_modes=1).modes.shape == (3, 1)


def test_tica_on_float32_noise_matches_jax():
    """Random float32 features: the moments' float32 sums may round
    differently, so held at float32's 1e-5."""
    rng = np.random.default_rng(9)
    z = rng.normal(size=(512, 4)).astype(np.float32)
    want = jtica(z[:-2], z[2:])
    got = tica(torch.as_tensor(z[:-2]), torch.as_tensor(z[2:]))
    np.testing.assert_allclose(got.eigenvalues, want.eigenvalues,
                               atol=VAL, rtol=VAL)
    with pytest.raises(ValueError, match="matching"):
        tica(z[:-2], z[2:, :3])


@pytest.mark.parametrize("harmonic", [True, False])
def test_hlda_matches_jax(harmonic):
    rng = np.random.default_rng(3)
    f = np.concatenate([rng.normal(size=(200, 3)) * [0.1, 1.0, 0.5],
                        rng.normal(size=(200, 3)) * [0.3, 1.0, 0.5] + 1.0,
                        rng.normal(size=(150, 3)) - [1.0, 0.0, 2.0]])
    lab = np.repeat([0, 1, 2], [200, 200, 150])
    want = jhlda(f, lab, harmonic=harmonic)
    got = hlda(f, lab, harmonic=harmonic)
    for key in ("directions", "eigenvalues", "mean", "class_means",
                "classes"):
        np.testing.assert_allclose(getattr(got, key), getattr(want, key),
                                   atol=EXACT, rtol=0)
    np.testing.assert_allclose(got.transform(f), want.transform(f),
                               atol=EXACT, rtol=0)
    with pytest.raises(ValueError, match="2 distinct"):
        hlda(f, np.zeros(len(f)))


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("shuffle,multiple_of", [(True, 1), (False, 1),
                                                 (True, 4)])
def test_lagged_pair_iterator_matches_jax(weighted, shuffle, multiple_of):
    data = np.arange(41 * 3, dtype=np.float32).reshape(41, 1, 3)
    w = np.linspace(0.5, 2.0, 41).astype(np.float32) if weighted else None
    kw = dict(shuffle=shuffle, seed=5, epochs=2, multiple_of=multiple_of,
              weights=w)
    got = list(lagged_pair_iterator(data, 10, 3, **kw))
    want = list(jlagged_pair_iterator(data, 10, 3, **kw))
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert len(a) == len(b) == (3 if weighted else 2)
        for u, v in zip(a, b):
            np.testing.assert_array_equal(u, v)
    with pytest.raises(ValueError, match="lag"):
        next(lagged_pair_iterator(data, 10, 41))
    with pytest.raises(ValueError, match="weights"):
        next(lagged_pair_iterator(data, 10, 3, weights=np.ones(5)))


def test_registry_has_the_jax_keys(setup):
    assert sorted(registry) == sorted(jregistry)
    s = setup
    x = _t(s["x"][:32])
    eig = registry["eigenfunction"](s["model"], x)
    jeig = jax.jit(jregistry["eigenfunction"])(s["jm"],
                                               jnp.asarray(s["x"][:32]))
    np.testing.assert_allclose(float(eig), float(jeig), atol=VAL, rtol=VAL)
    vamp = registry["vamp"](s["model"], (x[:-2], x[2:]))
    jvamp = jax.jit(jregistry["vamp"])(s["jm"], (jnp.asarray(s["x"][:30]),
                                                 jnp.asarray(s["x"][2:32])))
    np.testing.assert_allclose(float(vamp), float(jvamp), atol=VAL, rtol=VAL)
