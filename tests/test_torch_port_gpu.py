"""The port's CUDA kernels on the card (skipped without one).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -p no:cacheprovider -m gpu \\
        tests/test_torch_port_gpu.py

(``--noconftest``: tests/conftest.py sets up JAX). Each kernel is held
against its plain PyTorch version on the same card; the sums over frames of
the backward and train kernels (unrolled and blocked) against a float64
plain version, the steadier reference for a sum over thousands of float32
terms; every body of the edge-product probe against its plain version and
float64. Tolerances:
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
        F.fused_cv_forces(alanine_model(device="cpu")[0], x.detach())
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


# ---------------------------------------------------------------------------
# The blocked kernels (K6, K8). Values 1e-5 (5e-5 for sums over thousands
# of pairs); gradients 2e-4·max(1, max|g|), against float64 plain versions.
# ---------------------------------------------------------------------------


def _assert_grads(g, g_ref, slack, atol):
    """Every atom within ``atol`` of the float64 gradient; the two atoms of
    a pair at ``d_max`` or at half a box length, where float32 and float64
    may take different sides, within ``atol`` plus the jump that pair can
    make (``fused_blocked.gradient_jump_slack``)."""
    err = (g.double() - g_ref).abs().amax(dim=-1)
    assert float((err - slack).max()) <= atol


def _blocked_models(cuda):
    from molann_tpu_torch.systems import lj_fluid_model, peptide_model

    def seeded(seed):
        return torch.Generator().manual_seed(seed)

    return {
        "peptide": lambda: peptide_model(12, generator=seeded(1),
                                         device=cuda)[:2] + (0.05, VAL_ATOL),
        "lj": lambda: lj_fluid_model(4, generator=seeded(2),
                                     device=cuda)[:2] + (0.6, 5e-5),
        "alanine": lambda: alanine_model(generator=seeded(3),
                                         device=cuda) + (0.05, VAL_ATOL),
        "alanine_angles": lambda: alanine_model(
            generator=seeded(4), use_angle_value=True, activation="relu",
            device=cuda) + (0.05, VAL_ATOL),
    }


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 33, 1000])
@pytest.mark.parametrize("component", [None, -1])
@pytest.mark.parametrize("name", ["peptide", "lj", "alanine",
                                  "alanine_angles"])
def test_blocked_kernels_match_plain(cuda, name, component, l):
    """K6 and K8 on every layout, ragged last blocks, launches counted."""
    from molann_tpu_torch.ops import fused_blocked as FB

    model, u, sigma, val_tol = _blocked_models(cuda)[name]()
    n = u.atoms.n_atoms
    rng = np.random.default_rng(5)
    x = torch.as_tensor((u.atoms.positions[None] + sigma * rng.normal(
        size=(l, n, 3))).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    d_out = F._out_dim(parts[0], parts[3])
    comp = None if component is None else component % d_out
    y_ref, g_ref = FB.blocked_cv_forces_plain(*_f64(parts), x.double(), comp)
    before = dict(F.KERNEL_LAUNCHES)
    kw = dict(component=component, mode="blocked")
    outs = [F.fused_cv_forces(model, x, **kw)]
    y, g = F.fused_cv_forces(model, x.reshape(l, 3 * n), **kw)
    outs.append((y, g.reshape(l, n, 3)))
    y, g = F.fused_cv_forces(model, x.reshape(l, 3 * n).T.contiguous(),
                             transposed_input=True, **kw)
    outs.append((y.T, g.T.reshape(l, n, 3)))
    if l != 3:
        y, g = F.fused_cv_forces(model, x.permute(2, 1, 0).contiguous(), **kw)
        outs.append((y.T, g.permute(2, 1, 0)))
    with torch.no_grad():
        y6 = F.fused_model_forward(model, x, mode="blocked")
    torch.cuda.synchronize()
    scale = max(1.0, float(g_ref.abs().max()))
    slack = FB.gradient_jump_slack(parts[0], parts[3], x.double())
    for y, g in outs:
        np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                                   atol=val_tol)
        _assert_grads(g, g_ref, slack, GRAD_RTOL * scale)
        assert torch.equal(y, outs[0][0]) and torch.equal(g, outs[0][1])
    np.testing.assert_allclose(y6.cpu().numpy(), y_ref.cpu().numpy(),
                               atol=val_tol)
    assert F.KERNEL_LAUNCHES["blocked_cv_forces"] == \
        before["blocked_cv_forces"] + len(outs)
    assert F.KERNEL_LAUNCHES["blocked_forward"] == \
        before["blocked_forward"] + 1


@pytest.mark.gpu
def test_blocked_refuses_grad_and_bad_inputs(cuda):
    from molann_tpu_torch.systems import peptide_model

    model, u = peptide_model(14, device=cuda)
    n = u.atoms.n_atoms
    x = torch.as_tensor(u.atoms.positions[None], device=cuda)
    before = dict(F.KERNEL_LAUNCHES)
    y = F.fused_model_forward(model, x)  # the weights require grad
    assert y.requires_grad and y.shape == (1, 2)
    y.sum().backward()
    assert all(p.grad is not None and bool(p.grad.abs().max() > 0)
               for p in model.parameters())
    assert F.KERNEL_LAUNCHES["blocked_forward"] == \
        before["blocked_forward"] + 1
    assert F.KERNEL_LAUNCHES["blocked_backward"] == \
        before["blocked_backward"] + 1
    with torch.no_grad():
        y_val = F.fused_model_forward(model, x)
    assert y_val.shape == (1, 2) and not y_val.requires_grad
    assert F.KERNEL_LAUNCHES["blocked_backward"] == \
        before["blocked_backward"] + 1
    with pytest.raises(TypeError, match="float32"):
        F.fused_cv_forces(model, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        F.fused_cv_forces(model, x.expand(4, n, 3).permute(2, 1, 0))
    with pytest.raises(ValueError, match="model.to"):
        F.fused_cv_forces(peptide_model(14, device="cpu")[0], x)
    y, g = F.fused_cv_forces(model, x[:0])
    assert y.shape == (0, 2) and g.shape == (0, n, 3)
    loss, grads = F.fused_train_grads(model, x,
                                      torch.zeros(1, 2, device=cuda))
    assert F.KERNEL_LAUNCHES["blocked_train"] == before["blocked_train"] + 1
    np.testing.assert_allclose(float(loss), float((y_val ** 2).mean()),
                               rtol=LOSS_RTOL)
    with pytest.raises(ValueError, match="MLP head"):
        F.fused_train_grads(model.preprocessing_layer, x,
                            torch.zeros(1, 355, device=cuda))
    with pytest.raises(TypeError, match="float32"):
        F.fused_train_grads(model, x, torch.zeros(1, 2, device=cuda).double())
    with pytest.raises(ValueError, match="y_target is on"):
        F.fused_train_grads(model, x, torch.zeros(1, 2))


@pytest.mark.gpu
def test_blocked_compaction_on_the_card(cuda):
    """A 500-atom peptide with three features: inactive atoms exactly 0,
    compact_grads equal to the gathered full gradient, bit for bit."""
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import FeatureLayer, PreprocessingANN
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.systems import synthetic_peptide

    u = synthetic_peptide(100)

    def sel(name, resid):
        return u.select_atoms(f"name {name} and resid {resid}")

    pp = PreprocessingANN(None, FeatureLayer([
        Feature("b", "bond", sel("CA", 2) + sel("CA", 12)),
        Feature("d", "dihedral",
                sel("C", 5) + sel("N", 6) + sel("CA", 6) + sel("C", 6)),
        Feature("c", "coordination", u.select_atoms("name CA and resid 20:60"),
                r0=6.0, nn=3, mm=7, d_max=14.0),
    ], u.atoms))
    active = F.active_atom_indices(pp)
    assert active is not None
    rng = np.random.default_rng(6)
    x = torch.as_tensor((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(257, 500, 3))).astype(np.float32), device=cuda)
    y_ref, g_ref = FB.blocked_cv_forces_plain(*_f64(F._extract_model(pp)),
                                              x.double(), 2)
    y, g = F.fused_cv_forces(pp, x, component=2)
    y_c, g_c = F.fused_cv_forces(pp, x, component=2, compact_grads=True)
    _check(y, g, y_ref, g_ref)
    idx = torch.as_tensor(active, device=cuda)
    mask = torch.ones(500, dtype=torch.bool, device=cuda)
    mask[idx] = False
    assert not g[:, mask].any()
    assert torch.equal(y_c, y)
    assert torch.equal(g_c, g.permute(2, 1, 0)[:, idx])


@pytest.mark.gpu
def test_blocked_serving_from_file(cuda, tmp_path):
    """evaluate_trajectory with its default device and c_mat, tail batch."""
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.systems import lj_fluid_model

    model, u, _ = lj_fluid_model(4)  # on the card by default
    assert next(model.parameters()).device.type == "cuda"
    rng = np.random.default_rng(7)
    x = (u.atoms.positions[None] + 0.6 * rng.normal(
        size=(300, 64, 3))).astype(np.float32)
    path = str(tmp_path / "traj.npy")
    np.save(path, x)
    before = dict(F.KERNEL_LAUNCHES)
    cvs, grads = evaluate_trajectory(model, path, forces=True, batch_size=128)
    only = evaluate_trajectory(model, path, batch_size=128, c_mat=None)
    assert F.KERNEL_LAUNCHES["blocked_cv_forces"] == \
        before["blocked_cv_forces"] + 3
    assert F.KERNEL_LAUNCHES["blocked_forward"] == \
        before["blocked_forward"] + 3
    y_ref, g_ref = FB.blocked_cv_forces_plain(
        *_f64(F._extract_model(model)), torch.as_tensor(x, device=cuda).double())
    np.testing.assert_allclose(cvs, y_ref.cpu().numpy(), atol=5e-5)
    np.testing.assert_allclose(only, cvs, atol=0)
    scale = max(1.0, float(g_ref.abs().max()))
    parts = F._extract_model(model)
    slack = FB.gradient_jump_slack(parts[0], parts[3],
                                   torch.as_tensor(x, device=cuda).double())
    _assert_grads(torch.as_tensor(grads, device=cuda), g_ref, slack,
                  GRAD_RTOL * scale)


# ---------------------------------------------------------------------------
# The blocked training kernels (K7, K5), against float64 plain versions
# ---------------------------------------------------------------------------


def _flat(gparams):
    return [t for wb in gparams for t in wb]


def _in_layout(x, layout):
    l, n = x.shape[:2]
    if layout == "t":
        return x.reshape(l, 3 * n).T.contiguous()
    if layout == "cmajor":
        return x.permute(2, 1, 0).contiguous()
    return x


def _to_lnd(g, layout, n):
    if layout == "t":
        return g.T.reshape(-1, n, 3)
    if layout == "cmajor":
        return g.permute(2, 1, 0)
    return g


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 33, 1000])
@pytest.mark.parametrize("layout", ["lnd", "t", "cmajor"])
@pytest.mark.parametrize("name", ["peptide", "lj", "alanine",
                                  "alanine_angles"])
def test_blocked_backward_and_train_match_plain(cuda, name, layout, l):
    """K7 under autograd (gx in the layout of x, the weights, ref_x) and K5
    (train_ref where the model aligns), ragged tails, launches counted, two
    launches with the same bits."""
    from molann_tpu_torch.ops import fused_blocked as FB

    model, u, sigma, _ = _blocked_models(cuda)[name]()
    n = u.atoms.n_atoms
    rng = np.random.default_rng(8)
    x = torch.as_tensor((u.atoms.positions[None] + sigma * rng.normal(
        size=(l, n, 3))).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    d_out = F._out_dim(parts[0], parts[3])
    gy = torch.as_tensor(rng.normal(size=(l, d_out)).astype(np.float32),
                         device=cuda)
    has_ref = FB.blocked_layout(parts[0], parts[1]).has_align
    gx_r, gp_r, gref_r = FB.blocked_backward_plain(*_f64(parts), x.double(),
                                                   gy.double())
    before = dict(F.KERNEL_LAUNCHES)
    xin = _in_layout(x, layout).requires_grad_(True)
    leaves = [xin, *_flat(parts[3])]
    if has_ref:
        leaves.append(parts[2].requires_grad_(True))
    y = F.fused_model_forward(model, xin, mode="blocked")
    got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, gy)
    torch.cuda.synchronize()
    assert got[0].shape == xin.shape
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    slack = FB.gradient_jump_slack(parts[0], parts[3], x.double())
    _assert_grads(_to_lnd(got[0], layout, n), gx_r, slack,
                  GRAD_RTOL * max(1.0, float(gx_r.abs().max())))
    for g, want in zip(got[1:], _flat(gp_r) + ([gref_r] if has_ref else [])):
        _close(g, want)
    assert F.KERNEL_LAUNCHES["blocked_backward"] == \
        before["blocked_backward"] + 2
    assert F.KERNEL_LAUNCHES["blocked_forward"] == \
        before["blocked_forward"] + 1
    if has_ref:
        parts[2].requires_grad_(False)

    for train_ref in (False, True) if has_ref else (False,):
        loss_r, gp_r, gref_r = FB.blocked_train_grads_plain(
            *_f64(parts), x.double(), gy.double(), train_ref)
        yt = gy if layout == "lnd" else gy.T.contiguous()
        loss, grads = F.fused_train_grads(model, xin.detach(), yt,
                                          mode="blocked", train_ref=train_ref)
        loss2, grads2 = F.fused_train_grads(model, xin.detach(), yt,
                                            mode="blocked",
                                            train_ref=train_ref)
        np.testing.assert_allclose(float(loss), float(loss_r),
                                   rtol=LOSS_RTOL)
        want = _flat(gp_r) + ([gref_r] if gref_r is not None else [])
        for g, w in zip(grads.values(), want):
            _close(g, w)
        assert torch.equal(loss, loss2)
        assert all(torch.equal(grads[k], grads2[k]) for k in grads)
    assert F.KERNEL_LAUNCHES["blocked_train"] == \
        before["blocked_train"] + (4 if has_ref else 2)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["peptide", "lj", "alanine"])
def test_blocked_backward_without_gx(cuda, name):
    """K7 asked for the parameter (and ref_x) sums alone: no pair gradient,
    no accumulators, no gather; against float64, two launches the same
    bits."""
    from molann_tpu_torch.ops import fused_blocked as FB

    model, u, sigma, _ = _blocked_models(cuda)[name]()
    rng = np.random.default_rng(11)
    l = 517
    x = torch.as_tensor((u.atoms.positions[None] + sigma * rng.normal(
        size=(l, u.atoms.n_atoms, 3))).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    gy = torch.as_tensor(rng.normal(size=(l, F._out_dim(
        parts[0], parts[3]))).astype(np.float32), device=cuda)
    has_ref = FB.blocked_layout(parts[0], parts[1]).has_align
    _, gp_r, gref_r = FB.blocked_backward_plain(*_f64(parts), x.double(),
                                                gy.double())
    leaves = _flat(parts[3])
    if has_ref:
        leaves.append(parts[2].requires_grad_(True))
    y = F.fused_model_forward(model, x, mode="blocked")
    got = torch.autograd.grad(y, leaves, gy, retain_graph=True)
    again = torch.autograd.grad(y, leaves, gy)
    if has_ref:
        parts[2].requires_grad_(False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for g, want in zip(got, _flat(gp_r) + ([gref_r] if has_ref else [])):
        _close(g, want)


@pytest.mark.gpu
@pytest.mark.parametrize("nn,mm,d_max,box_kind", [
    (6, 12, 3.6, "ortho"), (4, 8, None, "ortho"), (8, 16, 3.6, None),
    (6, 12, None, None), (3, 7, 3.6, "ortho"), (6, 12, 3.6, "triclinic")])
def test_blocked_pair_forms(cuda, nn, mm, d_max, box_kind):
    """Compiled instances of the pair loop and the generic body (other
    exponents, a triclinic box), forward only and with the pair gradient:
    K6, K8, K7 and K5 against float64."""
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import (
        FeatureLayer,
        MolANN,
        PreprocessingANN,
        create_sequential_nn,
    )
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.systems import lj_fluid

    u, box = lj_fluid(3)
    if box_kind == "triclinic":
        box = np.diag(box)
        box[1, 0], box[2, 1] = 0.4, -0.3
    elif box_kind is None:
        box = None
    pp = PreprocessingANN(None, FeatureLayer([Feature(
        "q", "coordination", u.atoms, r0=2.0, nn=nn, mm=mm, pbc_box=box,
        d_max=d_max)], u.atoms))
    head = create_sequential_nn([1, 4, 2],
                                generator=torch.Generator().manual_seed(4),
                                device=cuda)
    with torch.no_grad():
        head.layers[0].weight.mul_(1e-2)
    model = MolANN(pp, head)
    rng = np.random.default_rng(12)
    l = 300
    x = torch.as_tensor((u.atoms.positions[None] + 0.6 * rng.normal(
        size=(l, 27, 3))).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    gy = torch.as_tensor(rng.normal(size=(l, 2)).astype(np.float32),
                         device=cuda)
    slack = FB.gradient_jump_slack(parts[0], parts[3], x.double())
    y_ref, g_ref = FB.blocked_cv_forces_plain(*_f64(parts), x.double())
    y, g = F.fused_cv_forces(model, x, mode="blocked")
    with torch.no_grad():
        y6 = F.fused_model_forward(model, x, mode="blocked")
    np.testing.assert_allclose(y.cpu().numpy(), y_ref.cpu().numpy(),
                               atol=5e-5)
    np.testing.assert_allclose(y6.cpu().numpy(), y_ref.cpu().numpy(),
                               atol=5e-5)
    _assert_grads(g, g_ref, slack,
                  GRAD_RTOL * max(1.0, float(g_ref.abs().max())))
    gx_r, gp_r, _ = FB.blocked_backward_plain(*_f64(parts), x.double(),
                                              gy.double())
    xg = x.clone().requires_grad_(True)
    got = torch.autograd.grad(F.fused_model_forward(model, xg, mode="blocked"),
                              [xg, *_flat(parts[3])], gy)
    _assert_grads(got[0], gx_r, slack,
                  GRAD_RTOL * max(1.0, float(gx_r.abs().max())))
    for a, want in zip(got[1:], _flat(gp_r)):
        _close(a, want)
    loss_r, gp_r, _ = FB.blocked_train_grads_plain(*_f64(parts), x.double(),
                                                   gy.double())
    loss, grads = F.fused_train_grads(model, x, gy, mode="blocked")
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    for a, want in zip(grads.values(), _flat(gp_r)):
        _close(a, want)


@pytest.mark.gpu
@pytest.mark.parametrize("hidden_dims", [(32, 2), (6, 3), (9, 70, 2)])
@pytest.mark.parametrize("l", [5, 1000])
def test_blocked_tiled_layers_and_register_sums(cuda, hidden_dims, l):
    """The full-width peptide: the first layer register-tiled forwards and
    backwards (output counts that are and are not multiples of four, a
    tiled layer above the first), its weight gradient summed in the threads'
    registers, the feature adjoints through the batches."""
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.systems import peptide_model

    model, u = peptide_model(60, hidden_dims=hidden_dims,
                             generator=torch.Generator().manual_seed(6),
                             device=cuda)
    rng = np.random.default_rng(13)
    x = torch.as_tensor((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(l, u.atoms.n_atoms, 3))).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    d_out = hidden_dims[-1]
    gy = torch.as_tensor(rng.normal(size=(l, d_out)).astype(np.float32),
                         device=cuda)
    y_ref, g_ref = FB.blocked_cv_forces_plain(*_f64(parts), x.double())
    y, g = F.fused_cv_forces(model, x)
    _check(y, g, y_ref, g_ref)
    gx_r, gp_r, _ = FB.blocked_backward_plain(*_f64(parts), x.double(),
                                              gy.double())
    xg = x.clone().requires_grad_(True)
    yk = F.fused_model_forward(model, xg)
    leaves = [xg, *_flat(parts[3])]
    got = torch.autograd.grad(yk, leaves, gy, retain_graph=True)
    again = torch.autograd.grad(yk, leaves, gy)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, want in zip(got, [gx_r, *_flat(gp_r)]):
        _close(a, want)
    loss_r, gp_r, _ = FB.blocked_train_grads_plain(*_f64(parts), x.double(),
                                                   gy.double())
    loss, grads = F.fused_train_grads(model, x, gy)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    for a, want in zip(grads.values(), _flat(gp_r)):
        _close(a, want)


@pytest.mark.gpu
def test_blocked_sums_in_device_memory(cuda):
    """A head too wide for shared memory keeps each block's running sums
    in its row of the partials (acc_global)."""
    from molann_tpu_torch.ops import fused_blocked as FB
    from molann_tpu_torch.systems import peptide_model

    model, u = peptide_model(14, hidden_dims=(512, 2),
                             generator=torch.Generator().manual_seed(5),
                             device=cuda)
    assert F.model_select_mode(model) == "blocked"
    parts = F._extract_model(model)
    width = 1 + F._grad_width(None, parts[3])
    assert 4 * width > FB._SMEM_MAX // 2
    rng = np.random.default_rng(9)
    l = 777
    x = torch.as_tensor((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(l, u.atoms.n_atoms, 3))).astype(np.float32), device=cuda)
    yt = torch.as_tensor(rng.normal(size=(l, 2)).astype(np.float32),
                         device=cuda)
    loss_r, gp_r, _ = FB.blocked_train_grads_plain(*_f64(parts), x.double(),
                                                   yt.double())
    loss, grads = F.fused_train_grads(model, x, yt)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    for g, w in zip(grads.values(), _flat(gp_r)):
        _close(g, w)
    gx_r, gp_r, _ = FB.blocked_backward_plain(*_f64(parts), x.double(),
                                              yt.double())
    xg = x.clone().requires_grad_(True)
    got = torch.autograd.grad(F.fused_model_forward(model, xg),
                              [xg, *_flat(parts[3])], yt)
    for g, w in zip(got, [gx_r, *_flat(gp_r)]):
        _close(g, w)


@pytest.mark.gpu
def test_blocked_trainers_on_the_card(cuda):
    """fit(fused_mse_loss) runs K6 + K7, make_fused_train_step K5; both
    lower the loss and agree step for step."""
    import functools

    from molann_tpu_torch.systems import peptide_model
    from molann_tpu_torch.train import (
        fit,
        fused_mse_loss,
        make_fused_train_step,
        masked_optimizer,
        trainable_mask,
    )

    def student():
        return peptide_model(14, generator=torch.Generator().manual_seed(2),
                             device=cuda)[0]

    teacher, u = peptide_model(14, generator=torch.Generator().manual_seed(3),
                               device=cuda)
    rng = np.random.default_rng(10)
    x = (u.atoms.positions[None] + 0.05 * rng.normal(
        size=(512, u.atoms.n_atoms, 3))).astype(np.float32)
    with torch.no_grad():
        y = F.fused_model_forward(teacher, torch.as_tensor(
            x, device=cuda)).cpu().numpy()
    batches = [(x[s:s + 256], y[s:s + 256]) for s in (0, 256)] * 4
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    before = dict(F.KERNEL_LAUNCHES)
    res = fit(student(), fused_mse_loss, iter(batches), optimizer=adam,
              num_steps=8)
    assert F.KERNEL_LAUNCHES["blocked_backward"] == \
        before["blocked_backward"] + 8
    model = student()
    opt = masked_optimizer(adam, trainable_mask(model))(model)
    step = make_fused_train_step()
    losses = []
    for batch in batches:
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    assert F.KERNEL_LAUNCHES["blocked_train"] == before["blocked_train"] + 8
    assert res.losses[-1] < res.losses[0] and losses[-1] < losses[0]
    np.testing.assert_allclose(losses, res.losses, rtol=1e-4)


# ---------------------------------------------------------------------------
# Coordination features in the unrolled kernels (K1-K4)
# ---------------------------------------------------------------------------


def _coordination_model(kind, cuda):
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import (
        AlignmentLayer,
        FeatureLayer,
        MolANN,
        PreprocessingANN,
        create_sequential_nn,
    )
    from molann_tpu_torch.systems import alanine_universe

    u = alanine_universe()
    feats = [Feature("c1", "coordination", u.select_atoms("bynum 2 5 7"),
                     group_b=u.select_atoms("bynum 15 17 19"), r0=3.0)]
    align = None
    if kind == "two":
        feats += [
            Feature("b1", "bond", u.select_atoms("bynum 2 5")),
            Feature("c2", "coordination", u.select_atoms("bynum 1:9"),
                    r0=2.5, nn=3, mm=7, pbc_box=np.asarray([9.0, 10.0, 11.0]),
                    d_max=4.0),
            Feature("p1", "position", u.select_atoms("bynum 9 11")),
        ]
        align = AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms,
                               device=cuda)
    elif kind == "full":  # the envelope's 96 pairs: 6 x 16
        feats = [Feature("c", "coordination", u.select_atoms("bynum 1:6"),
                         group_b=u.select_atoms("bynum 7:22"), r0=4.0, nn=4,
                         mm=8)]
    pp = PreprocessingANN(align, FeatureLayer(feats, u.atoms))
    head = create_sequential_nn([pp.output_dimension(), 4, 2],
                                generator=torch.Generator().manual_seed(5),
                                device=cuda)
    return MolANN(pp, head), u


@pytest.mark.gpu
@pytest.mark.parametrize("l", [1, 127, 4097])
@pytest.mark.parametrize("kind", ["one", "two", "full"])
def test_unrolled_coordination_matches_plain(cuda, kind, l):
    """K1, K4, K2 and K3 on models with coordination features."""
    model, u = _coordination_model(kind, cuda)
    assert F.model_select_mode(model) == "unrolled"
    rng = np.random.default_rng(11)
    # the aligned model gets thermal noise: three align atoms thrown 0.4 A
    # apart come near a degenerate alignment, where float32 and float64
    # QCP part by more than the tolerance on either side
    sigma = 0.15 if kind == "two" else 0.4
    x = torch.as_tensor((u.atoms.positions[None] + sigma * rng.normal(
        size=(l, N, 3))).astype(np.float32), device=cuda)
    parts = F._extract_model(model)
    gy = torch.as_tensor(rng.normal(size=(l, 2)).astype(np.float32),
                         device=cuda)
    from molann_tpu_torch.ops.fused_blocked import gradient_jump_slack
    slack = gradient_jump_slack(parts[0], parts[3], x.double())
    before = dict(F.KERNEL_LAUNCHES)
    for comp in (None, 1):
        y_ref, g_ref = F.cv_forces_plain(*_f64(parts), x.double(), comp)
        y, g = F.fused_cv_forces(model, x, component=comp)
        yt, gt = F.fused_cv_forces(model, x.reshape(l, 3 * N).T.contiguous(),
                                   component=comp, transposed_input=True)
        tol = GRAD_RTOL * max(1.0, float(g_ref.abs().max()))
        for yy, gg in ((y, g), (yt.T, gt.T.reshape(l, N, 3))):
            np.testing.assert_allclose(yy.cpu().numpy(), y_ref.cpu().numpy(),
                                       atol=VAL_ATOL)
            _assert_grads(gg, g_ref, slack, tol)
    with torch.no_grad():
        y1 = F.fused_model_forward(model, x)
    np.testing.assert_allclose(y1.cpu().numpy(), y_ref.cpu().numpy(),
                               atol=VAL_ATOL)
    xg = x.clone().requires_grad_(True)
    leaves = [xg, *_flat(parts[3])]
    got = torch.autograd.grad(F.fused_model_forward(model, xg), leaves, gy)
    gx_r, gp_r, _ = F.backward_plain(*_f64(parts), x.double(), gy.double())
    _assert_grads(got[0], gx_r, slack,
                  GRAD_RTOL * max(1.0, float(gx_r.abs().max())))
    for g, w in zip(got[1:], _flat(gp_r)):
        _close(g, w)
    loss_r, gp_r, _ = F.train_grads_plain(*_f64(parts), x.double(),
                                          gy.double())
    loss, grads = F.fused_train_grads(model, x, gy)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=LOSS_RTOL)
    for g, w in zip(grads.values(), _flat(gp_r)):
        _close(g, w)
    assert F.KERNEL_LAUNCHES["cv_forces"] == before["cv_forces"] + 4
    assert F.KERNEL_LAUNCHES["train"] == before["train"] + 1
    assert F.KERNEL_LAUNCHES["backward"] == before["backward"] + 1


# ---------------------------------------------------------------------------
# The edge-product probe (K9)
# ---------------------------------------------------------------------------

# kernel against plain, as a fraction of max|truth|: the bodies with exact
# products differ by the order of a few f32 additions at most
EDGE_VS_PLAIN = 5e-7
EDGE_VS_F64 = {"f32": 5e-7, "gather": 5e-7, "split3": 5e-7, "fixed4": 5e-7,
               "bf16": 4e-3, "fixed2": 2e-4, "int8": 1.0}


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(552, 304, 1024), (37, 50, 64),
                                   (16, 16, 128)])
@pytest.mark.parametrize("variant", ["f32", "bf16", "int8", "split3",
                                     "fixed4", "fixed2", "gather"])
def test_edge_mm_matches_plain(cuda, variant, shape):
    """Every body at the probe's shape and at shapes that are no multiple
    of a tile, against its plain version and float64."""
    from molann_tpu_torch.probes import edge_mm_probe as EP

    m, k, n = shape
    rng = np.random.default_rng(12)
    D = torch.as_tensor((rng.integers(-1, 2, size=(m, k)) * (
        rng.random((m, k)) < 0.05)).astype(np.float32), device=cuda)
    scale = 3000.0 if variant == "int8" else 30.0
    x = torch.as_tensor(((rng.random((k, n)) * 2 - 1) * scale).astype(
        np.float32), device=cuda)
    before = F.KERNEL_LAUNCHES["edge_mm"]
    got = EP.edge_mm(D, x, variant)
    torch.cuda.synchronize()
    assert F.KERNEL_LAUNCHES["edge_mm"] == before + 1
    plain = EP.edge_mm_plain(D, x, variant)
    truth = D.double() @ x.double()
    top = float(truth.abs().max()) + 1e-30
    assert float((got - plain).abs().max()) / top <= EDGE_VS_PLAIN
    assert float((got.double() - truth).abs().max()) / top <= \
        EDGE_VS_F64[variant]
    assert torch.equal(got, EP.edge_mm(D, x, variant))


@pytest.mark.gpu
def test_edge_mm_refuses_what_the_kernel_does_not_take(cuda):
    from molann_tpu_torch.probes import edge_mm_probe as EP

    D = torch.zeros(16, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 64"):
        EP.edge_mm(D, torch.zeros(16, 65, device=cuda), "f32")
    with pytest.raises(TypeError, match="float32"):
        EP.edge_mm(D.double(), torch.zeros(16, 64, device=cuda).double(),
                   "f32")
    with pytest.raises(ValueError, match="0 and ±1"):
        EP.edge_mm(D + 0.5, torch.zeros(16, 64, device=cuda), "gather")
    with pytest.raises(ValueError, match="D is on"):
        EP.edge_mm(D.cpu(), torch.zeros(16, 64, device=cuda), "f32")


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["unrolled", "blocked"])
@pytest.mark.parametrize("activation", sorted(F.KERNEL_ACTIVATIONS))
def test_every_activation_in_both_families(cuda, activation, mode):
    """Each activation the reference serialises through K1, K4, K2 and K3
    (or K6, K8, K7 and K5) on a head of two hidden layers, against float64
    plain versions: values, gx, and the parameter and ref_x sums."""
    model, u = alanine_model(hidden_dims=(8, 6, 3), activation=activation,
                             generator=torch.Generator().manual_seed(4),
                             device=cuda)
    parts = F._extract_model(model)
    x = _frames(u, 777, cuda, seed=8)
    gy = torch.as_tensor(np.random.default_rng(9).normal(
        size=(777, 3)).astype(np.float32), device=cuda)
    with torch.no_grad():
        y1 = F.fused_model_forward(model, x, mode=mode)
    y_ref, g_ref = F.cv_forces_plain(*_f64(parts), x.double())
    y, g = F.fused_cv_forces(model, x, mode=mode)
    for v in (y1, y):
        np.testing.assert_allclose(v.double().cpu().numpy(),
                                   y_ref.cpu().numpy(), atol=VAL_ATOL)
    _close(g, g_ref)
    ref_x = parts[2].requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    leaves = [xg, ref_x, *(t for wb in parts[3] for t in wb)]
    got = torch.autograd.grad(F.fused_model_forward(model, xg, mode=mode),
                              leaves, gy)
    ref_x.requires_grad_(False)
    gx_ref, gp_ref, gref_ref = F.backward_plain(*_f64(parts), x.double(),
                                                gy.double())
    for v, v_ref in zip(got, [gx_ref, gref_ref,
                              *(t for wb in gp_ref for t in wb)]):
        _close(v, v_ref)
    loss, grads = F.fused_train_grads(model, x, gy, mode=mode, train_ref=True)
    loss_ref, gp_ref, gref_ref = F.train_grads_plain(
        *_f64(parts), x.double(), gy.double(), True)
    assert abs(float(loss) - float(loss_ref)) <= LOSS_RTOL * float(loss_ref)
    for v, v_ref in zip(grads.values(),
                        [*(t for wb in gp_ref for t in wb), gref_ref]):
        _close(v, v_ref)


@pytest.mark.gpu
def test_wide_head_runs_blocked_under_auto(cuda):
    """A [38, 65, 3] head: the blocked kernels under "auto", the unrolled
    ones refuse it."""
    model, u = alanine_model(hidden_dims=(65, 3),
                             generator=torch.Generator().manual_seed(5),
                             device=cuda)
    x = _frames(u, 300, cuda)
    before = dict(F.KERNEL_LAUNCHES)
    y, g = F.fused_cv_forces(model, x)
    assert F.KERNEL_LAUNCHES["blocked_cv_forces"] == \
        before["blocked_cv_forces"] + 1
    y_ref, g_ref = F.cv_forces_plain(*_f64(F._extract_model(model)),
                                     x.double())
    np.testing.assert_allclose(y.double().cpu().numpy(), y_ref.cpu().numpy(),
                               atol=VAL_ATOL)
    _close(g, g_ref)
    with pytest.raises(ValueError, match="mode='blocked'"):
        F.fused_cv_forces(model, x, mode="unrolled")
