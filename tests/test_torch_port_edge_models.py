"""The port against the JAX package on the models at the edge of the
unrolled kernels' envelope.

``chignolin`` is ``scripts/tpu_validation.py``'s config 5 (:118-140): a
10-residue synthetic peptide (50 atoms) aligned on its CA atoms, a CA
position feature plus the backbone features (85 columns), ``[85, 32, 2]``.
``envelope_corner`` is the largest model both packages still serve
unrolled: 60 atoms, 92 columns (12 CA positions, the φ/ψ dihedrals and
CA-CA bonds, one coordination number over 91 pairs), ``[92, 64, 64, 64,
2]``. Both are built the same way in both packages; the JAX weights cross
via ``save_model`` → ``load_model``.

On the CPU the port's fused entry points run the kernels' plain versions.
Everything is held against the JAX jnp path (``model(x)`` and its VJP),
the reference config 5 itself uses (``ypr = pmodel(xp)``, :132-133): 64
frames from a numpy seed, components None and 0. The Pallas kernels are
not run in interpret mode at these sizes: 64 frames of config 5 take
minutes there.

The port's eager model runs the jnp path's float32 math and is held to it
in float32. The fused entry points run the kernels' arithmetic, which
keeps more of float32's precision through the alignment than the jnp
path does: on the corner model the jnp path's float32 coordinate gradient
is 1.26e-4 of its largest entry away from the same path in float64, the
plain fused version 7e-6. So the fused entry points are held to the jnp
path evaluated in float64 (``jax.enable_x64``), the answer both
approximate. Tolerances, as at :137: values 1e-5 abs; coordinate and
parameter gradients 1e-4 relative to the reference's largest entry;
losses 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.ann import AlignmentLayer as JAlignmentLayer
from molann_tpu.ann import FeatureLayer as JFeatureLayer
from molann_tpu.ann import MolANN as JMolANN
from molann_tpu.ann import PreprocessingANN as JPreprocessingANN
from molann_tpu.ann import create_sequential_nn as jcreate_sequential_nn
from molann_tpu.feature import Feature as JFeature
from molann_tpu.io import save_model
from molann_tpu.ops import fused as JF
from molann_tpu.systems import peptide_backbone_features as jbackbone
from molann_tpu.systems import synthetic_peptide as jsynthetic_peptide
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import named_tensors
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import chignolin_model, envelope_corner_model

VAL_ATOL = 1e-5
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-6
L = 64
REF = "preprocessing_layer.align_layer.ref_x"
MODELS = ("chignolin", "envelope_corner")


def _jax_chignolin():
    """tpu_validation.py:119-128, verbatim but for the names."""
    up = jsynthetic_peptide(10)
    feats = [JFeature("pos", "position", up.select_atoms("name CA"))]
    feats += jbackbone(up)
    pp = JPreprocessingANN(
        JAlignmentLayer(up.select_atoms("name CA"), up.atoms),
        JFeatureLayer(feats, up.atoms))
    return JMolANN(pp, jcreate_sequential_nn(
        [pp.output_dimension(), 32, 2], key=jax.random.PRNGKey(0))), up


def _jax_corner():
    """The JAX twin of ``molann_tpu_torch.systems.envelope_corner_model``."""
    up = jsynthetic_peptide(12)
    ca = up.select_atoms("name CA")
    feats = [JFeature("pos", "position", ca),
             *(f for f in jbackbone(up) if f.type_name != "angle"),
             JFeature("contacts", "coordination",
                      up.select_atoms("name CA or (name N and resid 1 2)"),
                      r0=6.0)]
    pp = JPreprocessingANN(JAlignmentLayer(ca, up.atoms),
                           JFeatureLayer(feats, up.atoms))
    return JMolANN(pp, jcreate_sequential_nn(
        [pp.output_dimension(), 64, 64, 64, 2],
        key=jax.random.PRNGKey(1))), up


JAX_MODELS = {"chignolin": _jax_chignolin, "envelope_corner": _jax_corner}
PORT_MODELS = {"chignolin": chignolin_model,
               "envelope_corner": envelope_corner_model}
SIZES = {"chignolin": (50, 85, 0, [85, 32, 2]),
         "envelope_corner": (60, 92, 91, [92, 64, 64, 64, 2])}


def _jax_grads(gm):
    """A JAX gradient pytree → ``{port name: array}`` in torch's layout."""
    out = {REF: np.asarray(gm.preprocessing_layer.align_layer.ref_x)}
    for i, (w, b) in enumerate(gm.ann_layers.params):
        out[f"ann_layers.layers.{i}.weight"] = np.asarray(w).T
        out[f"ann_layers.layers.{i}.bias"] = np.asarray(b)
    return out


def _close(got, want, what):
    """``got`` within 1e-4 of ``want``'s largest entry."""
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0, what
    err = float(np.abs(got.reshape(want.shape) - want).max())
    assert err <= GRAD_RTOL * scale, f"{what}: {err} > {GRAD_RTOL} * {scale}"


def _refs(m, x, gy, yt):
    """The jnp path's values, its MSE against ``yt`` and its VJP (``(model
    grads, gx)``, each stacked) of four cotangents: ones (component None),
    one-hot column 0, ``gy`` and the MSE's: one forward, one backward."""
    y, vjp = jax.vjp(lambda mm, v: mm(v), m, x)
    cts = jnp.stack([jnp.ones_like(y), jnp.zeros_like(y).at[:, 0].set(1.0),
                     gy, 2.0 * (y - yt) / y.size])
    return y, jnp.mean((y - yt) ** 2), jax.vmap(vjp)(cts)


_REFS = jax.jit(_refs)
COTANGENT = {None: 0, 0: 1, "vjp": 2, "mse": 3}


def _references(jm, x, gy, yt):
    """``{"y", "mse", (k, "x"), (k, name)}`` of :func:`_refs` as numpy,
    ``k`` a key of :data:`COTANGENT`, names the port's."""
    y, mse, (gm, gx) = _REFS(jm, x, gy, yt)
    out = {"y": np.asarray(y), "mse": float(mse)}
    for k, i in COTANGENT.items():
        out[k, "x"] = np.asarray(gx[i])
        for name, g in _jax_grads(
                jax.tree_util.tree_map(lambda a, i=i: a[i], gm)).items():
            out[k, name] = g
    return out


def _float64(a):
    return (a.astype(jnp.float64) if jnp.issubdtype(a.dtype, jnp.floating)
            else a)


@pytest.fixture(scope="module", params=MODELS)
def edge(request, tmp_path_factory):
    """The JAX model, the file its weights cross in, 64 frames, a ``gy``
    and a ``yt``, and the jnp path's references in float32 (``"f32"``) and
    float64 (``"f64"``)."""
    name = request.param
    jm, u = JAX_MODELS[name]()
    path = save_model(str(tmp_path_factory.mktemp(name) / "m.npz"), jm)
    rng = np.random.default_rng(41)
    x = (u.atoms.positions[None] + 0.05 * rng.normal(
        size=(L, u.atoms.n_atoms, 3))).astype(np.float32)
    d = SIZES[name][3][-1]
    gy = rng.normal(size=(L, d)).astype(np.float32)
    yt = rng.normal(size=(L, d)).astype(np.float32)
    ref = {"f32": _references(jm, x, gy, yt)}
    with jax.enable_x64():
        ref["f64"] = _references(
            jax.tree_util.tree_map(_float64, jm),
            *(a.astype(np.float64) for a in (x, gy, yt)))
    return name, jm, path, x, gy, yt, ref


def test_both_packages_serve_it_unrolled(edge):
    """Both packages place the model in the unrolled family, at the sizes
    that put it at the envelope's edge; the port's copy of the model agrees
    with its own builder."""
    name, jm, path, *_ = edge
    tm = load_model(path, device="cpu")
    n_atoms, n_cols, n_pairs, dims = SIZES[name]
    assert JF.model_select_mode(jm) == "unrolled"
    assert F.model_select_mode(tm) == "unrolled"
    spec, _, _, params, _ = F._extract_model(tm)
    assert (spec.n_input_atoms, spec.out_dim) == (n_atoms, n_cols)
    assert sum(p for _, p in spec.coord_slices) == n_pairs
    assert [params[0][0].shape[1], *(w.shape[0] for w, _ in params)] == dims
    own, _ = PORT_MODELS[name](device="cpu")
    own_spec = F._extract_model(own)[0]
    assert (own_spec.n_input_atoms, own_spec.out_dim) == (n_atoms, n_cols)
    assert own_spec.position_idx == spec.position_idx
    assert own_spec.coord_pairs == spec.coord_pairs


@pytest.mark.parametrize("route", ["eager", "fused_cv_forces",
                                   "fused_cv_forces [3n, l]"])
@pytest.mark.parametrize("component", [None, 0])
def test_values_and_coordinate_gradients(edge, route, component):
    name, _, path, x, _, _, ref = edge
    tm = load_model(path, device="cpu")
    xt = torch.from_numpy(x)
    if route == "eager":
        xg = xt.clone().requires_grad_(True)
        y = tm(xg)
        out = y.sum() if component is None else y[:, component].sum()
        (g,) = torch.autograd.grad(out, xg)
    elif route == "fused_cv_forces":
        y, g = F.fused_cv_forces(tm, xt, component=component)
    else:
        y, g = F.fused_cv_forces(tm, xt.reshape(L, -1).T.contiguous(),
                                 component=component, transposed_input=True)
        y, g = y.T, g.T
    ref = ref["f32" if route == "eager" else "f64"]
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=VAL_ATOL)
    _close(g, ref[component, "x"], f"{name} {route} gx")


@pytest.mark.parametrize("route", ["eager", "fused_model_forward"])
def test_vjp_of_every_tensor(edge, route):
    """Autograd of ``sum(gy * model(x))``: the values, gx, every weight and
    ``ref_x``, against the jnp path's VJP of ``gy``."""
    _, _, path, x, gy, _, ref = edge
    ref = ref["f32" if route == "eager" else "f64"]
    tm = load_model(path, device="cpu")
    ref_x = tm.preprocessing_layer.align_layer.ref_x.requires_grad_(True)
    xg = torch.from_numpy(x).requires_grad_(True)
    y = tm(xg) if route == "eager" else F.fused_model_forward(tm, xg)
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=VAL_ATOL)
    names = [n for n, _ in named_tensors(tm)]
    leaves = [xg, *(t for _, t in named_tensors(tm))]
    got = torch.autograd.grad(y, leaves, torch.from_numpy(gy))
    for name, g in zip(["x", *names], got):
        _close(g, ref["vjp", name], name)
    assert REF in names and ref_x.requires_grad


@pytest.mark.parametrize("layout", ["frames", "transposed"])
@pytest.mark.parametrize("train_ref", [False, True])
def test_train_grads(edge, train_ref, layout):
    """``fused_train_grads``: the MSE and its gradients against the jnp
    path's MSE and its VJP; ``ref_x``'s gradient is zero unless asked
    for."""
    _, _, path, x, _, yt, ref = edge
    tm = load_model(path, device="cpu")
    xt, ytt = torch.from_numpy(x), torch.from_numpy(yt)
    if layout == "frames":
        loss, grads = F.fused_train_grads(tm, xt, ytt, train_ref=train_ref)
    else:
        loss, grads = F.fused_train_grads(
            tm, xt.reshape(L, -1).T.contiguous(), ytt.T.contiguous(),
            transposed_input=True, train_ref=train_ref)
    ref = ref["f64"]
    np.testing.assert_allclose(float(loss), ref["mse"], rtol=LOSS_RTOL)
    assert list(grads) == [n for n, _ in named_tensors(tm)]
    if not train_ref:
        assert not grads.pop(REF).any()
    for name, g in grads.items():
        _close(g, ref["mse", name], name)
