"""The port's training ops against the JAX package.

On the CPU the wrappers run the plain versions of the backward (K2) and
train (K3) kernels. They are held against the Pallas kernels run in
interpret mode, computed once for the module: ``jax.vjp`` of
``fused_model_forward`` (K1 then K2) and ``fused_train_grads`` (K3), on 40
frames with ``tile=32`` so that the ragged last tile is masked. Weights
cross via ``save_model`` → ``load_model``; inputs come from a numpy seed.
Tolerances: values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52); losses 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.io import save_model
from molann_tpu.ops import fused as JF
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu_torch.feature import Feature
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import (
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
    named_tensors,
)
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import alanine_model, alanine_universe
from molann_tpu_torch.train import fit, make_fused_train_step, make_train_step

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
LOSS_RTOL = 1e-6
N = 22
L = 40
W0, B0 = "ann_layers.layers.0.weight", "ann_layers.layers.0.bias"
REF = "preprocessing_layer.align_layer.ref_x"


def _close_grads(g, g_ref):
    g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
    g_ref = np.asarray(g_ref)
    scale = max(1.0, float(np.abs(g_ref).max()))
    np.testing.assert_allclose(g, g_ref, atol=GRAD_RTOL * scale)


def _jax_grads(gm):
    """A JAX gradient pytree → ``{port name: array}`` in torch's layout."""
    out = {REF: np.asarray(gm.preprocessing_layer.align_layer.ref_x)}
    for i, (w, b) in enumerate(gm.ann_layers.params):
        out[f"ann_layers.layers.{i}.weight"] = np.asarray(w).T
        out[f"ann_layers.layers.{i}.bias"] = np.asarray(b)
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm, u = jalanine_model()
    path = save_model(str(tmp_path_factory.mktemp("m") / "m.npz"), jm)
    rng = np.random.default_rng(21)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(L, N, 3))).astype(np.float32)
    gy = rng.normal(size=(L, 3)).astype(np.float32)
    yt = rng.normal(size=(L, 3)).astype(np.float32)
    xj = jnp.asarray(x)
    y, vjp = jax.vjp(
        lambda m, xx: JF.fused_model_forward(m, xx, tile=32, bwd_tile=32,
                                             interpret=True), jm, xj)
    gm, gx = vjp(jnp.asarray(gy))
    backward = {"y": np.asarray(y), "gx": np.asarray(gx), **_jax_grads(gm)}
    train = {}
    for train_ref in (False, True):
        loss, g = JF.fused_train_grads(jm, xj, jnp.asarray(yt), tile=32,
                                       interpret=True, train_ref=train_ref)
        train[train_ref] = (float(loss), _jax_grads(g))
    return path, x, gy, yt, backward, train


@pytest.mark.parametrize("packed", [False, True])
def test_backward_matches_jax(setup, packed):
    """Autograd through the port's fused_model_forward against jax.vjp of
    the JAX one: gx, the parameters and ref_x."""
    path, x, gy, _, ref, _ = setup
    tm = load_model(path, device="cpu")
    ref_x = tm.preprocessing_layer.align_layer.ref_x.requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    xin = xt.reshape(L, 3 * N) if packed else xt
    y = F.fused_model_forward(tm, xin, tile=32, bwd_tile=32)
    y.backward(torch.from_numpy(gy))
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=VAL_ATOL)
    _close_grads(xt.grad, ref["gx"])
    _close_grads(ref_x.grad, ref[REF])
    for name, p in tm.named_parameters():
        _close_grads(p.grad, ref[name])


def test_fused_forward_reaches_the_weights(setup):
    """An MSE through fused_model_forward gives the weights the gradients
    of JAX's fused MSE; the frozen ref_x buffer gets none."""
    path, x, _, yt, _, train = setup
    tm = load_model(path, device="cpu")
    pred = F.fused_model_forward(tm, torch.from_numpy(x))
    loss = ((pred - torch.from_numpy(yt)) ** 2).mean()
    loss.backward()
    loss_ref, g_ref = train[False]
    np.testing.assert_allclose(float(loss.detach()), loss_ref, rtol=LOSS_RTOL)
    for name, p in tm.named_parameters():
        _close_grads(p.grad, g_ref[name])
    assert tm.preprocessing_layer.align_layer.ref_x.grad is None


@pytest.mark.parametrize("layout", ["frames", "packed", "transposed"])
@pytest.mark.parametrize("train_ref", [False, True])
def test_train_grads_match_jax(setup, layout, train_ref):
    path, x, _, yt, _, train = setup
    tm = load_model(path, device="cpu")
    xt, ytt = torch.from_numpy(x), torch.from_numpy(yt)
    kw = dict(tile=32, train_ref=train_ref)
    if layout == "frames":
        loss, grads = F.fused_train_grads(tm, xt, ytt, **kw)
    elif layout == "packed":
        loss, grads = F.fused_train_grads(tm, xt.reshape(L, 3 * N), ytt, **kw)
    else:
        loss, grads = F.fused_train_grads(
            tm, xt.reshape(L, 3 * N).T.contiguous(), ytt.T.contiguous(),
            transposed_input=True, **kw)
    loss_ref, g_ref = train[train_ref]
    assert loss.ndim == 0
    np.testing.assert_allclose(float(loss), loss_ref, rtol=LOSS_RTOL)
    assert list(grads) == [name for name, _ in named_tensors(tm)]
    assert grads[W0].shape == tm.ann_layers.layers[0].weight.shape
    for name, g in grads.items():
        _close_grads(g, g_ref[name])
    if not train_ref:
        assert not grads[REF].any() and not g_ref[REF].any()


def test_launch_counters_stay_zero_on_cpu(setup):
    path, x, _, yt, _, _ = setup
    tm = load_model(path, device="cpu")
    for k in F.KERNEL_LAUNCHES:
        F.KERNEL_LAUNCHES[k] = 0
    xt = torch.from_numpy(x).requires_grad_(True)
    F.fused_model_forward(tm, xt).sum().backward()
    F.fused_train_grads(tm, xt.detach(), torch.from_numpy(yt), train_ref=True)
    assert F.KERNEL_LAUNCHES == dict.fromkeys(F.KERNEL_LAUNCHES, 0)


def test_errors():
    model, u = alanine_model(device="cpu")
    x = torch.as_tensor(u.atoms.positions[None])
    y = torch.zeros(1, 3)
    # the blocked formulation trains any system, alanine included
    loss_b, grads_b = F.fused_train_grads(model, x, y, mode="blocked")
    loss_u, grads_u = F.fused_train_grads(model, x, y, mode="unrolled")
    np.testing.assert_allclose(float(loss_b), float(loss_u), rtol=LOSS_RTOL)
    for name in grads_u:
        _close_grads(grads_b[name], grads_u[name].numpy())
    with pytest.raises(ValueError, match="c_mat"):
        F.fused_train_grads(model, x, y, c_mat=np.zeros((2, 2)))
    with pytest.raises(ValueError, match="mode"):
        F.fused_train_grads(model, x, y, mode="fast")
    with pytest.raises(ValueError, match="precision"):
        F.fused_train_grads(model, x, y, precision="fp8")
    with pytest.raises(ValueError, match="y_target"):
        F.fused_train_grads(model, x, torch.zeros(2, 3))
    with pytest.raises(ValueError, match="transposed"):
        F.fused_train_grads(model, x.reshape(1, 3 * N), y.T,
                            transposed_input=True)
    with pytest.raises(ValueError, match="y_target"):
        F.fused_train_grads(model, x.reshape(1, 3 * N).T, y,
                            transposed_input=True)
    with pytest.raises(ValueError, match="at least one frame"):
        F.fused_train_grads(model, x[:0], y[:0])
    with pytest.raises(TypeError):
        F.fused_train_grads(object(), x, y)

    u = alanine_universe()
    coord = FeatureLayer([Feature("c1", "coordination",
                                  u.select_atoms("bynum 2 5"),
                                  group_b=u.select_atoms("bynum 15 17"),
                                  r0=3.0)], u.atoms)
    # coordination features inside the envelope train and differentiate
    head = create_sequential_nn([1, 3, 1],
                                generator=torch.Generator().manual_seed(0))
    cmodel = MolANN(PreprocessingANN(None, coord), head)
    loss_c, grads_c = F.fused_train_grads(cmodel, x, torch.zeros(1, 1))
    np.testing.assert_allclose(float(loss_c), float((cmodel(x) ** 2).mean().detach()),
                               rtol=LOSS_RTOL)
    assert grads_c["ann_layers.layers.0.weight"].abs().max() > 0
    xg = x.clone().requires_grad_(True)
    F.fused_model_forward(coord, xg).sum().backward()
    assert xg.grad.abs().max() > 0

    for make in (lambda: make_train_step(None, mesh=object()),
                 lambda: make_fused_train_step(mesh=object()),
                 lambda: fit(model, None, [], mesh=object())):
        with pytest.raises(TypeError, match="data_mesh"):
            make()
