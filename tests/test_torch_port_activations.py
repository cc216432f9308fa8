"""Every activation the JAX package serialises, through the port.

``molann_tpu.io.save_model`` writes a head's activation by name: tanh,
relu, sigmoid, gelu (``jax.nn.gelu``'s tanh form), elu, celu, softplus,
swish and identity. For each, an alanine model with a ``38 → 8 → 3`` head
is built in the JAX package, crosses to the port through the ``.npz``, and
the port's eager model and the plain versions of both kernel families
(unrolled: ``cv_forces_plain``, ``backward_plain``, ``train_grads_plain``;
blocked: their ``blocked_*`` twins), also through the public wrappers on
the CPU, are held against the JAX model's values and its gradients by
``jax.vjp`` and ``jax.grad`` on the same frames. A wide head (``[38, 65,
3]``, past the unrolled kernels' width cap) goes to the blocked family
under ``mode="auto"`` and gives the reference's values and gradients.
Tolerances: values 1e-5 abs; parameter and coordinate gradients
5e-5·max(1, max|g|).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.io import save_model
from molann_tpu.io.serialize import ACTIVATIONS as JAX_ACTIVATIONS
from molann_tpu.models.ann import MolANN as JMolANN
from molann_tpu.models.ann import create_sequential_nn as jax_sequential_nn
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu_torch.io import load_model
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.ops import fused_blocked as FB

VAL_ATOL = 1e-5
GRAD_RTOL = 5e-5
L = 24


def close_grads(g, g_ref):
    g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
    g_ref = np.asarray(g_ref)
    scale = max(1.0, float(np.abs(g_ref).max()))
    np.testing.assert_allclose(g, g_ref, atol=GRAD_RTOL * scale)


def jax_reference(tmp_path, activation, dims=(38, 8, 3), seed=0):
    """The JAX model with ``activation`` in its head, the port's model
    loaded from its ``.npz``, frames, cotangents and labels, and the JAX
    values and gradients: ``y``, ``gx`` of sum(y), the VJP of ``gy`` (x,
    weights, ref_x) and the MSE loss's gradient (weights, ref_x)."""
    jm, u = jalanine_model()
    head = jax_sequential_nn(list(dims), JAX_ACTIVATIONS[activation],
                             key=jax.random.PRNGKey(seed))
    jm = JMolANN(jm.preprocessing_layer, head)
    tm = load_model(save_model(str(tmp_path / f"{activation}.npz"), jm),
                    device="cpu")
    rng = np.random.default_rng(seed + 1)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(L, u.atoms.n_atoms, 3))).astype(np.float32)
    gy = rng.normal(size=(L, dims[-1])).astype(np.float32)
    yt = rng.normal(size=(L, dims[-1])).astype(np.float32)
    xj = jnp.asarray(x)
    y, vjp = jax.vjp(lambda m, xx: m(xx), jm, xj)
    gm, gx_vjp = vjp(jnp.asarray(gy))
    gx_sum = jax.grad(lambda xx: jm(xx).sum())(xj)
    loss, gt = jax.value_and_grad(
        lambda m: jnp.mean((m(xj) - jnp.asarray(yt)) ** 2))(jm)

    def params_of(g):
        return ([(np.asarray(w).T, np.asarray(b)) for w, b in g.ann_layers.params],
                np.asarray(g.preprocessing_layer.align_layer.ref_x))

    ref = {"y": np.asarray(y), "gx_sum": np.asarray(gx_sum),
           "gx_vjp": np.asarray(gx_vjp), "vjp": params_of(gm),
           "loss": float(loss), "train": params_of(gt)}
    return tm, [torch.from_numpy(a) for a in (x, gy, yt)], ref


def check_grads(gparams, g_ref, ref):
    ref_params, ref_ref = ref
    assert len(gparams) == len(ref_params)
    for (gw, gb), (rw, rb) in zip(gparams, ref_params):
        close_grads(gw, rw)
        close_grads(gb, rb)
    close_grads(g_ref, ref_ref)


@pytest.mark.parametrize("activation", sorted(JAX_ACTIVATIONS))
def test_activation_matches_jax(tmp_path, activation):
    tm, (x, gy, yt), ref = jax_reference(tmp_path, activation)
    assert tm.ann_layers.activation == activation
    parts = F._extract_model(tm)

    # the eager model
    xg = x.clone().requires_grad_(True)
    y = tm(xg)
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=VAL_ATOL)
    (gx,) = torch.autograd.grad(y.sum(), xg)
    close_grads(gx, ref["gx_sum"])

    # both families' plain versions ...
    for cv_forces, backward, train in (
            (F.cv_forces_plain, F.backward_plain, F.train_grads_plain),
            (FB.blocked_cv_forces_plain, FB.blocked_backward_plain,
             FB.blocked_train_grads_plain)):
        yy, gg = cv_forces(*parts, x)
        np.testing.assert_allclose(yy.numpy(), ref["y"], atol=VAL_ATOL)
        close_grads(gg, ref["gx_sum"])
        gx_b, gparams, g_ref = backward(*parts, x, gy)
        close_grads(gx_b, ref["gx_vjp"])
        check_grads(gparams, g_ref, ref["vjp"])
        loss, gparams, g_ref = train(*parts, x, yt, True)
        np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
        check_grads(gparams, g_ref, ref["train"])

    # ... and the public wrappers, which no longer refuse any of them
    for mode in ("unrolled", "blocked"):
        yy, gg = F.fused_cv_forces(tm, x, mode=mode)
        np.testing.assert_allclose(yy.numpy(), ref["y"], atol=VAL_ATOL)
        close_grads(gg, ref["gx_sum"])
        loss, grads = F.fused_train_grads(tm, x, yt, mode=mode,
                                          train_ref=True)
        np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
        for i, (rw, rb) in enumerate(ref["train"][0]):
            close_grads(grads[f"ann_layers.layers.{i}.weight"], rw)
            close_grads(grads[f"ann_layers.layers.{i}.bias"], rb)


@pytest.mark.parametrize("dims", [(38, 65, 3), (38, 4, 4, 4, 4, 3)])
def test_wide_head_goes_blocked(tmp_path, dims):
    """A head past the unrolled kernels' caps (width 64, four layers) is
    served and trained through the blocked family under ``"auto"`` with the
    reference's values and gradients; ``mode="unrolled"`` still raises."""
    tm, (x, gy, yt), ref = jax_reference(tmp_path, "tanh", dims, seed=3)
    assert F.model_select_mode(tm) == "blocked"
    y, g = F.fused_cv_forces(tm, x)
    np.testing.assert_allclose(y.numpy(), ref["y"], atol=VAL_ATOL)
    close_grads(g, ref["gx_sum"])
    xg = x.clone().requires_grad_(True)
    y = F.fused_model_forward(tm, xg)
    leaves = [xg, *tm.parameters()]
    gx, *gp = torch.autograd.grad(y, leaves, gy)
    close_grads(gx, ref["gx_vjp"])
    for (gw, gb), (rw, rb) in zip(zip(gp[0::2], gp[1::2]), ref["vjp"][0]):
        close_grads(gw, rw)
        close_grads(gb, rb)
    loss, grads = F.fused_train_grads(tm, x, yt)
    np.testing.assert_allclose(float(loss), ref["loss"], rtol=1e-5)
    for i, (rw, rb) in enumerate(ref["train"][0]):
        close_grads(grads[f"ann_layers.layers.{i}.weight"], rw)
        close_grads(grads[f"ann_layers.layers.{i}.bias"], rb)
    for fn in (F.fused_cv_forces, F.fused_model_forward):
        with pytest.raises(ValueError, match="mode='blocked'"):
            fn(tm, x, mode="unrolled")
