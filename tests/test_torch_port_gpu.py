"""The port's CUDA kernels on the card (skipped without one).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX). Each kernel is held
against its plain PyTorch version on the same card. Tolerances: values 1e-5
abs; gradients 2e-4·max(1, max|g|) (tests/test_parity_torch.py:25,52).
"""

import numpy as np
import pytest
import torch

from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import alanine_model

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
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
    np.testing.assert_allclose(y1.cpu().numpy(), y_ref.cpu().numpy(),
                               atol=VAL_ATOL)
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
    with pytest.raises(NotImplementedError, match="K2"):
        F.fused_model_forward(model, x.requires_grad_(True))
    with pytest.raises(ValueError, match="model.to"):
        F.fused_cv_forces(alanine_model()[0], x.detach())
    y, g = F.fused_cv_forces(model, x.detach()[:0])
    assert y.shape == (0, 3) and g.shape == (0, N, 3)
