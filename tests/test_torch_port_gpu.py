"""The port's CUDA kernels on the card (skipped without one).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX). Each kernel is held
against its plain PyTorch version on the same card; the sums over frames of
the backward and train kernels against a float64 plain version, the
steadier reference for a sum over thousands of float32 terms. Tolerances:
values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52); losses 1e-5 relative (float32 frames
against float64: the per-frame values differ by up to ~2e-7).
"""

import numpy as np
import pytest
import torch

from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import alanine_model

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
LOSS_RTOL = 1e-5
N = 22


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _frames(u, l, device, seed=3):
    rng = np.random.default_rng(seed)
    return torch.as_tensor((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(l, N, 3))).astype(np.float32), device=device)


def _close(g, g_ref):
    scale = max(1.0, float(g_ref.abs().max()))
    np.testing.assert_allclose(g.double().cpu().numpy(),
                               g_ref.cpu().numpy(), atol=GRAD_RTOL * scale)


def _f64(parts):
    spec, align_idx, ref_x, params, act = parts
    return (spec, align_idx, None if ref_x is None else ref_x.double(),
            tuple((w.double(), b.double()) for w, b in params), act)


def _train_check(model, x, yt, train_ref, transposed=False):
    """The train kernel against its float64 plain version."""
    parts = F._extract_model(model)
    l = x.shape[0]
    if transposed:
        loss, grads = F.fused_train_grads(
            model, x.reshape(l, 3 * N).T.contiguous(), yt.T.contiguous(),
            transposed_input=True, train_ref=train_ref)
    else:
        loss, grads = F.fused_train_grads(model, x, yt, train_ref=train_ref)
    loss_ref, gp_ref, gref_ref = F.train_grads_plain(
        *_f64(parts), x.double(), yt.double(), train_ref)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=LOSS_RTOL)
    g = list(grads.values())
    for got, want in zip(g, [t for wb in gp_ref for t in wb]):
        _close(got, want)
    if gref_ref is not None:
        _close(g[-1], gref_ref)
    return loss, grads


def _check(y, g, y_ref, g_ref):
    np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                               atol=VAL_ATOL)
    scale = max(1.0, float(g_ref.abs().max()))
    np.testing.assert_allclose(g.cpu().numpy(), g_ref.cpu().numpy(),
                               atol=GRAD_RTOL * scale)


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 127, 1000, 4097])
@pytest.mark.parametrize("component", [None, 1, -1])
def test_kernels_match_plain(cuda, l, component):
    """Both kernels, all layouts, ragged last blocks."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(1),
                             device=cuda)
    x = _frames(u, l, cuda)
    parts = F._extract_model(model)
    comp = None if component is None else component % 3
    y_ref, g_ref = F.cv_forces_plain(*parts, x, comp)
    before = dict(F.KERNEL_LAUNCHES)
    y, g = F.fused_cv_forces(model, x, component=component)
    yp, gp = F.fused_cv_forces(model, x.reshape(l, 3 * N),
                               component=component, transposed_outputs=True)
    yt, gt = F.fused_cv_forces(model, x.reshape(l, 3 * N).T.contiguous(),
                               component=component, transposed_input=True)
    y1 = F.fused_model_forward(model, x)
    torch.cuda.synchronize()
    _check(y, g, y_ref, g_ref)
    _check(yp.T, gp.T.reshape(l, N, 3), y_ref, g_ref)
    _check(yt.T, gt.T.reshape(l, N, 3), y_ref, g_ref)
    np.testing.assert_allclose(y1.detach().cpu().numpy(),
                               y_ref.cpu().numpy(), atol=VAL_ATOL)
    assert F.KERNEL_LAUNCHES["cv_forces"] == before["cv_forces"] + 3
    assert F.KERNEL_LAUNCHES["forward"] == before["forward"] + 1


@pytest.mark.gpu
@pytest.mark.parametrize("case", [
    dict(use_angle_value=True), dict(include_position=False),
    dict(activation="relu"), dict(activation="sigmoid"),
    dict(activation="identity", hidden_dims=(64, 64, 64, 2)),
])
def test_model_variants(cuda, case):
    model, u = alanine_model(generator=torch.Generator().manual_seed(2),
                             device=cuda, **case)
    x = _frames(u, 300, cuda, seed=4)
    y_ref, g_ref = F.cv_forces_plain(*F._extract_model(model), x)
    y, g = F.fused_cv_forces(model, x)
    _check(y, g, y_ref, g_ref)
    yt = torch.as_tensor(np.random.default_rng(8).normal(
        size=tuple(y.shape)).astype(np.float32), device=cuda)
    _train_check(model, x, yt, train_ref=True)


@pytest.mark.gpu
def test_feature_layer_only_goldens(cuda):
    model, u = alanine_model(device=cuda)
    flayer = model.preprocessing_layer.feature_layer
    x = torch.as_tensor(u.atoms.positions[None], device=cuda)
    y = F.fused_model_forward(flayer, x)
    with torch.no_grad():
        np.testing.assert_allclose(y.cpu().numpy(),
                                   flayer(x.cpu()).numpy(), atol=1e-6)


@pytest.mark.gpu
def test_wrapper_checks(cuda):
    model, u = alanine_model(device=cuda)
    x = _frames(u, 8, cuda)
    with pytest.raises(TypeError, match="float32"):
        F.fused_cv_forces(model, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_cv_forces(model, x.reshape(8, 3 * N).T,
                          transposed_input=True)
    with pytest.raises(ValueError, match="model.to"):
        F.fused_cv_forces(alanine_model()[0], x.detach())
    y, g = F.fused_cv_forces(model, x.detach()[:0])
    assert y.shape == (0, 3) and g.shape == (0, N, 3)
    with pytest.raises(TypeError, match="float32"):
        F.fused_train_grads(model, x, torch.zeros(8, 3, device=cuda,
                                                  dtype=torch.float64))


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 127, 4097])
def test_backward_kernel_matches_plain(cuda, l):
    """Autograd through fused_model_forward on the card (K1, then K2) for
    x, ref_x and the parameters against the float64 plain backward."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(1),
                             device=cuda)
    x = _frames(u, l, cuda)
    gy = torch.as_tensor(np.random.default_rng(5).normal(
        size=(l, 3)).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    ref_x = parts[2].requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    before = dict(F.KERNEL_LAUNCHES)
    y = F.fused_model_forward(model, xg)
    leaves = [xg, ref_x, *(t for wb in parts[3] for t in wb)]
    got = torch.autograd.grad(y, leaves, gy)
    ref_x.requires_grad_(False)
    assert F.KERNEL_LAUNCHES["forward"] == before["forward"] + 1
    assert F.KERNEL_LAUNCHES["backward"] == before["backward"] + 1
    gx_ref, gp_ref, gref_ref = F.backward_plain(*_f64(parts), x.double(),
                                                gy.double())
    for g, g_ref in zip(got, [gx_ref, gref_ref,
                              *(t for wb in gp_ref for t in wb)]):
        _close(g, g_ref)


@pytest.mark.gpu
def test_fused_mse_reaches_the_weights(cuda):
    """The fault the backward kernel repairs: an MSE through
    fused_model_forward on the card gives the weights their gradients."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(2),
                             device=cuda)
    x = _frames(u, 3000, cuda)
    yt = torch.as_tensor(np.random.default_rng(6).normal(
        size=(3000, 3)).astype(np.float32), device=cuda)
    ((F.fused_model_forward(model, x) - yt) ** 2).mean().backward()
    _, gp_ref, _ = F.train_grads_plain(*_f64(F._extract_model(model)),
                                       x.double(), yt.double())
    for lin, (gw, gb) in zip(model.ann_layers.layers, gp_ref):
        _close(lin.weight.grad, gw)
        _close(lin.bias.grad, gb)
    assert model.preprocessing_layer.align_layer.ref_x.grad is None


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 127, 4097])
@pytest.mark.parametrize("train_ref", [False, True])
@pytest.mark.parametrize("transposed", [False, True])
def test_train_kernel_matches_plain(cuda, l, train_ref, transposed):
    model, u = alanine_model(generator=torch.Generator().manual_seed(3),
                             device=cuda)
    x = _frames(u, l, cuda)
    yt = torch.as_tensor(np.random.default_rng(7).normal(
        size=(l, 3)).astype(np.float32), device=cuda)
    before = F.KERNEL_LAUNCHES["train"]
    _, grads = _train_check(model, x, yt, train_ref, transposed)
    assert F.KERNEL_LAUNCHES["train"] == before + 1
    if not train_ref:
        assert not grads["preprocessing_layer.align_layer.ref_x"].any()


@pytest.mark.gpu
def test_sums_over_frames_are_deterministic(cuda):
    """Two launches of each training kernel give the same bits."""
    model, u = alanine_model(device=cuda)
    x = _frames(u, 20000, cuda)
    yt = torch.randn(20000, 3, device=cuda)
    a = F.fused_train_grads(model, x, yt, train_ref=True)
    b = F.fused_train_grads(model, x, yt, train_ref=True)
    assert torch.equal(a[0], b[0])
    assert all(torch.equal(a[1][k], b[1][k]) for k in a[1])
    xg = x.clone().requires_grad_(True)
    y = F.fused_model_forward(model, xg)
    leaves = [xg, *model.parameters()]
    g1 = torch.autograd.grad(y, leaves, yt, retain_graph=True)
    g2 = torch.autograd.grad(y, leaves, yt)
    assert all(torch.equal(p, q) for p, q in zip(g1, g2))
