"""Coordination features in the unrolled fused ops, against the JAX package.

Models of at most 64 atoms and 96 coordination pairs are served by the
unrolled family (``select_mode``). The same numpy frames go through the
JAX unrolled functions (Pallas kernels in interpret mode, as
tests/test_fused.py runs them: 32 frames a tile) and the port's wrappers,
which on the CPU run the kernels' plain versions; weights cross through
the ``.npz``. ``csrc/frame_math.cuh``'s coordination rows and their
adjoint are compiled with ``g++`` and held against float64 plain versions.
Tolerances: values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52); the loss 1e-6 relative.
"""

import ctypes
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu import systems as JS
from molann_tpu.feature import Feature as JFeature
from molann_tpu.io import save_model as jsave_model
from molann_tpu.models import ann as JA
from molann_tpu.ops import fused as JF
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import named_tensors
from molann_tpu_torch.ops import fused as F
from test_torch_port_frame_math import host_lib  # noqa: F401  (fixture)

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
LOSS_RTOL = 1e-6
L = 40
BOX = (9.0, 10.0, 11.0)


def build(kind):
    """A 22-atom model with one coordination feature, or with two (one
    under a periodic box with ``d_max``) beside a bond and an aligned
    position feature."""
    u = JS.alanine_universe()
    if kind == "one":
        feats = [JFeature("c1", "coordination", u.select_atoms("bynum 2 5 7"),
                          group_b=u.select_atoms("bynum 15 17 19"), r0=3.0)]
        align = None
    else:
        feats = [
            JFeature("c1", "coordination", u.select_atoms("bynum 2 5 7"),
                     group_b=u.select_atoms("bynum 15 17 19"), r0=3.0),
            JFeature("b1", "bond", u.select_atoms("bynum 2 5")),
            JFeature("c2", "coordination", u.select_atoms("bynum 1:9"),
                     r0=2.5, nn=3, mm=7, pbc_box=np.asarray(BOX), d_max=4.0),
            JFeature("p1", "position", u.select_atoms("bynum 9 11")),
        ]
        align = JA.AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms)
    pp = JA.PreprocessingANN(align, JA.FeatureLayer(feats, u.atoms))
    head = JA.create_sequential_nn([pp.output_dimension(), 4, 2],
                                   key=jax.random.PRNGKey(5))
    return JA.MolANN(pp, head), u


def jax_named(gm):
    out = {}
    align = gm.preprocessing_layer.align_layer
    if getattr(align, "ref_x", None) is not None:
        out["align_layer.ref_x"] = np.asarray(align.ref_x)
    for i, (w, b) in enumerate(gm.ann_layers.params):
        out[f"layers.{i}.weight"] = np.asarray(w).T
        out[f"layers.{i}.bias"] = np.asarray(b)
    return out


def by_suffix(ref, name):
    (key,) = [k for k in ref if name.endswith(k)]
    return ref[key]


@functools.lru_cache(maxsize=None)
def reference(kind):
    """The JAX unrolled functions on a case, computed once."""
    jm, u = build(kind)
    rng = np.random.default_rng(41)
    x = (u.atoms.positions[None] + 0.4 * rng.normal(
        size=(L, len(u.atoms), 3))).astype(np.float32)
    gy = rng.normal(size=(L, 2)).astype(np.float32)
    yt = rng.normal(size=(L, 2)).astype(np.float32)
    xj = jnp.asarray(x)
    kw = dict(tile=32, interpret=True, mode="unrolled")
    assert JF.model_select_mode(jm) == "unrolled"
    y, vjp = jax.vjp(lambda m, xx: JF.fused_model_forward(
        m, xx, bwd_tile=32, **kw), jm, xj)
    gm, gx = vjp(jnp.asarray(gy))
    out = {"jm": jm, "x": x, "gy": gy, "yt": yt, "y": np.asarray(y),
           "gx": np.asarray(gx), "backward": jax_named(gm)}
    for comp in (None, 1):
        out["forces", comp] = tuple(np.asarray(a) for a in JF.fused_cv_forces(
            jm, xj, component=comp, **kw))
    train_ref = kind == "two"
    loss, g = JF.fused_train_grads(jm, xj, jnp.asarray(yt),
                                   train_ref=train_ref, **kw)
    out["train"] = (float(loss), jax_named(g), train_ref)
    return out


def port_model(tmp_path, ref):
    return load_model(jsave_model(str(tmp_path / "m.npz"), ref["jm"]),
                      device="cpu")


def close_grads(g, g_ref):
    g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
    g_ref = np.asarray(g_ref)
    np.testing.assert_allclose(
        g, g_ref, atol=GRAD_RTOL * max(1.0, float(np.abs(g_ref).max())))


@pytest.mark.parametrize("component", [None, 1])
@pytest.mark.parametrize("kind", ["one", "two"])
def test_values_and_forces_match_jax(tmp_path, kind, component):
    ref = reference(kind)
    tm = port_model(tmp_path, ref)
    assert F.model_select_mode(tm) == "unrolled"
    xt = torch.from_numpy(ref["x"])
    y_ref, g_ref = ref["forces", component]
    y, g = F.fused_cv_forces(tm, xt, component=component)
    with torch.no_grad():
        y1 = F.fused_model_forward(tm, xt)
    np.testing.assert_allclose(y.numpy(), y_ref, atol=VAL_ATOL)
    np.testing.assert_allclose(y1.numpy(), ref["y"], atol=VAL_ATOL)
    assert np.abs(g_ref).max() > 1e-3
    close_grads(g, g_ref)
    yt_, gt_ = F.fused_cv_forces(tm, xt.reshape(L, -1).T.contiguous(),
                                 component=component, transposed_input=True)
    np.testing.assert_allclose(yt_.T.numpy(), y_ref, atol=VAL_ATOL)
    close_grads(gt_.T.reshape(g.shape), g_ref)


@pytest.mark.parametrize("kind", ["one", "two"])
def test_backward_matches_jax(tmp_path, kind):
    ref = reference(kind)
    tm = port_model(tmp_path, ref)
    tensors = dict(named_tensors(tm))
    for t in tensors.values():
        t.requires_grad_(True)
    xt = torch.from_numpy(ref["x"]).requires_grad_(True)
    y = F.fused_model_forward(tm, xt)
    grads = torch.autograd.grad(y, [xt, *tensors.values()],
                                torch.from_numpy(ref["gy"]))
    close_grads(grads[0], ref["gx"])
    for tname, g in zip(tensors, grads[1:]):
        close_grads(g, by_suffix(ref["backward"], tname))


@pytest.mark.parametrize("kind", ["one", "two"])
def test_train_grads_match_jax(tmp_path, kind):
    ref = reference(kind)
    tm = port_model(tmp_path, ref)
    loss_ref, g_ref, train_ref = ref["train"]
    loss, grads = F.fused_train_grads(tm, torch.from_numpy(ref["x"]),
                                      torch.from_numpy(ref["yt"]),
                                      train_ref=train_ref)
    np.testing.assert_allclose(float(loss), loss_ref, rtol=LOSS_RTOL)
    for tname, g in grads.items():
        close_grads(g, by_suffix(g_ref, tname))


def test_envelope_is_96_pairs():
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import FeatureLayer
    from molann_tpu_torch.systems import alanine_universe

    u = alanine_universe()
    x = torch.as_tensor(u.atoms.positions[None])
    fits = FeatureLayer([Feature("c", "coordination",
                                 u.select_atoms("bynum 1:14"), r0=3.0)],
                        u.atoms)  # 91 pairs
    assert F.model_select_mode(fits) == "unrolled"
    np.testing.assert_allclose(F.fused_model_forward(fits, x).numpy(),
                               fits(x).numpy(), atol=VAL_ATOL)
    past = FeatureLayer([Feature("c", "coordination",
                                 u.select_atoms("bynum 1:15"), r0=3.0)],
                        u.atoms)  # 105 pairs
    assert F.model_select_mode(past) == "blocked"
    with pytest.raises(ValueError, match="coordination pairs"):
        F.fused_model_forward(past, x, mode="unrolled")
    np.testing.assert_allclose(F.fused_model_forward(past, x).numpy(),
                               past(x).numpy(), atol=VAL_ATOL)
    par = F.coord_parameters(fits.spec)
    assert par.shape == (1, F.COORD_FLOATS) and par.dtype == np.float32
    assert par[0, 0] == 3.0 and par[0, 3] == 0.0 and par[0, 7] == 0.0


def f64(parts):
    spec, align_idx, ref_x, params, act = parts
    return (spec, align_idx, None if ref_x is None else ref_x.double(),
            tuple((w.double(), b.double()) for w, b in params), act)


@pytest.mark.parametrize("kind", ["one", "two"])
def test_frame_math_on_the_host(host_lib, tmp_path, kind):  # noqa: F811
    """The kernels' per-frame coordination rows and their adjoint, compiled
    with g++: values, gx, the parameter sums and the loss against float64
    plain versions."""
    ref = reference(kind)
    tm = port_model(tmp_path, ref)
    parts = F._extract_model(tm)
    spec, align_idx, ref_x, params, act = parts
    x = torch.from_numpy(ref["x"])
    n3 = 3 * spec.n_input_atoms
    xs = x.reshape(L, n3).contiguous()
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              "backward")
    sargs, skeep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                                "cv_forces")
    y = torch.empty(L, 2)
    y1 = torch.empty(L, 2)
    g = torch.empty(L, n3)
    host_lib.host_forward(ctypes.addressof(sargs), xs.data_ptr(),
                          y1.data_ptr(), L)
    host_lib.host_cv_forces(ctypes.addressof(sargs), xs.data_ptr(),
                            y.data_ptr(), g.data_ptr(), L, -1)
    del skeep
    y_ref, g_ref = F.cv_forces_plain(*f64(parts), x.double())
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=VAL_ATOL)
    np.testing.assert_allclose(y1.numpy(), y_ref.numpy(), atol=VAL_ATOL)
    close_grads(g.reshape(x.shape), g_ref)

    gy = torch.from_numpy(ref["gy"])
    flat = torch.zeros(F._grad_width(align_idx, params))
    gx = torch.empty(L, n3)
    host_lib.host_backward(ctypes.addressof(args), xs.data_ptr(),
                           gy.data_ptr(), gx.data_ptr(), flat.data_ptr(), L, 1)
    gx_r, gp_r, gref_r = F.backward_plain(*f64(parts), x.double(), gy.double())
    gparams, g_refx = F._unpack_grads(flat, align_idx, ref_x, params)
    close_grads(gx.reshape(x.shape), gx_r)
    for (gw, gb), (gw_r, gb_r) in zip(gparams, gp_r):
        close_grads(gw, gw_r)
        close_grads(gb, gb_r)
    if g_refx is not None:
        close_grads(g_refx, gref_r)

    yt = torch.from_numpy(ref["yt"])
    flat = torch.zeros_like(flat)
    loss = host_lib.host_train(ctypes.addressof(args), xs.data_ptr(),
                               yt.data_ptr(), flat.data_ptr(), L, 0)
    loss_r, gp_r, _ = F.train_grads_plain(*f64(parts), x.double(),
                                          yt.double())
    np.testing.assert_allclose(loss, float(loss_r), rtol=1e-5)
    for (gw, gb), (gw_r, gb_r) in zip(
            F._unpack_grads(flat, align_idx, ref_x, params)[0], gp_r):
        close_grads(gw, gw_r)
        close_grads(gb, gb_r)
    del keep
