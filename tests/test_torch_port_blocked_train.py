"""The port's blocked training path against the JAX package, on the CPU.

The same numpy inputs from a seed go through the JAX function and the
port's; weights cross through the ``.npz``. The JAX side runs the Pallas
blocked kernels as its own tests do (``interpret=True, mode="blocked",
precision="exact"``, small tiles so that the last one is ragged), once per
module: ``jax.vjp`` of ``fused_model_forward`` (the blocked forward, then
the blocked backward kernel) and ``fused_train_grads`` (the blocked train
kernel). The fluid with streamed pairs, where interpret mode is slow, runs
through the JAX plain path (``model(x)`` and ``jax.grad``). On the CPU the
port runs the kernels' plain versions. Tolerances: the loss 1e-5 relative;
every gradient 5e-5·max(1, max|g|) (tests/test_fused_blocked.py:83-95), gx
with ``gradient_jump_slack`` where a pair sits on a threshold.
"""

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
from molann_tpu_torch import systems as TS
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import named_tensors
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.ops import fused_blocked as FB
from molann_tpu_torch.train import (
    fit,
    fused_mse_loss,
    make_fused_train_step,
    masked_optimizer,
    trainable_mask,
)

LOSS_RTOL = 1e-5
GRAD = 5e-5


def frames(u, l, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    return (u.atoms.positions[None] + sigma * rng.normal(
        size=(l, len(u.atoms), 3))).astype(np.float32)


def close_grads(g, g_ref, slack=None):
    g = g.detach().numpy() if torch.is_tensor(g) else np.asarray(g)
    g_ref = np.asarray(g_ref)
    assert g.shape == g_ref.shape
    err = np.abs(g - g_ref)
    if slack is not None:
        err = err.max(axis=-1) - slack
    assert err.max() <= GRAD * max(1.0, float(np.abs(g_ref).max()))


def jax_named(gm):
    """A JAX gradient pytree (shaped like the model) → ``{suffix of the
    port's tensor name: array}`` in torch's layout."""
    out = {}
    pp = getattr(gm, "preprocessing_layer", gm)
    align = getattr(pp, "align_layer", None)
    if align is not None and getattr(align, "ref_x", None) is not None:
        out["align_layer.ref_x"] = np.asarray(align.ref_x)
    head = getattr(gm, "ann_layers", None)
    if head is not None:
        for i, (w, b) in enumerate(head.params):
            out[f"layers.{i}.weight"] = np.asarray(w).T
            out[f"layers.{i}.bias"] = np.asarray(b)
    return out


def by_suffix(ref, name):
    (key,) = [k for k in ref if name.endswith(k)]
    return ref[key]


def feature_layer_only():
    u = JS.alanine_universe()
    feats = [JFeature("p1", "position", u.select_atoms("resid 2"))]
    feats += JS.alanine_histogram_features(u)
    return JA.PreprocessingANN(
        JA.AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms),
        JA.FeatureLayer(feats, u.atoms)), u


# name -> (builder, frames, noise, JAX tile, JAX mode, train_ref values)
CASES = {
    "peptide": (lambda: JS.peptide_model(n_residues=5), 40, 0.05, 32,
                "blocked", (False,)),
    "alanine": (lambda: JS.alanine_model(), 40, 0.05, 32, "blocked",
                (False, True)),
    "fluid_resident": (lambda: JS.lj_fluid_model(3)[:2], 12, 1.5, 8, "auto",
                       (False,)),
    "features_only": (feature_layer_only, 40, 0.05, 32, "blocked", ()),
}


@functools.lru_cache(maxsize=None)
def reference(name):
    """The JAX results of a case, computed once: ``jax.vjp`` of the blocked
    forward given gy, and the blocked train kernel's loss and gradients."""
    build, l, sigma, tile, mode, train_refs = CASES[name]
    jm, u = build()
    rng = np.random.default_rng(31)
    x = frames(u, l, 30, sigma)
    kw = dict(interpret=True, mode=mode, precision="exact")
    xj = jnp.asarray(x)
    y, vjp = jax.vjp(lambda m, xx: JF.fused_model_forward(
        m, xx, tile=tile, bwd_tile=tile, **kw), jm, xj)
    d = y.shape[1]
    gy = rng.normal(size=(l, d)).astype(np.float32)
    yt = rng.normal(size=(l, d)).astype(np.float32)
    gm, gx = vjp(jnp.asarray(gy))
    out = {"jm": jm, "x": x, "gy": gy, "yt": yt, "y": np.asarray(y),
           "gx": np.asarray(gx), "backward": jax_named(gm), "train": {}}
    for train_ref in train_refs:
        loss, g = JF.fused_train_grads(jm, xj, jnp.asarray(yt), tile=tile,
                                       train_ref=train_ref, **kw)
        out["train"][train_ref] = (float(loss), jax_named(g))
    return out


def port_model(tmp_path, ref):
    return load_model(jsave_model(str(tmp_path / "m.npz"), ref["jm"]),
                      device="cpu")


def in_layout(x, layout):
    l, n = x.shape[:2]
    if layout == "[3n, l]":
        return x.reshape(l, 3 * n).T.contiguous()
    if layout == "[3, n, l]":
        return x.permute(2, 1, 0).contiguous()
    return x


def to_lnd(g, layout, n):
    if layout == "[3n, l]":
        return g.T.reshape(-1, n, 3)
    if layout == "[3, n, l]":
        return g.permute(2, 1, 0)
    return g


@pytest.mark.parametrize("layout", ["[l, n, 3]", "[3n, l]", "[3, n, l]"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_matches_jax(tmp_path, name, layout):
    """``torch.autograd.grad`` through ``fused_model_forward(mode="blocked")``
    against ``jax.vjp`` of the JAX function: gx in the layout of x, every
    weight and ``ref_x``."""
    ref = reference(name)
    tm = port_model(tmp_path, ref)
    tensors = dict(named_tensors(tm))
    for t in tensors.values():
        t.requires_grad_(True)
    n = ref["x"].shape[1]
    xin = in_layout(torch.from_numpy(ref["x"]), layout).requires_grad_(True)
    y = F.fused_model_forward(tm, xin, mode="blocked")
    np.testing.assert_allclose(y.detach().numpy(), ref["y"], atol=5e-5)
    grads = torch.autograd.grad(y, [xin, *tensors.values()],
                                torch.from_numpy(ref["gy"]),
                                allow_unused=True)
    assert grads[0].shape == xin.shape
    spec, _, _, params, _ = F._extract_model(tm)
    slack = FB.gradient_jump_slack(
        spec, params, torch.from_numpy(ref["x"]).double()).numpy()
    close_grads(to_lnd(grads[0], layout, n), ref["gx"], slack)
    for (tname, t), g in zip(tensors.items(), grads[1:]):
        want = by_suffix(ref["backward"], tname)
        if g is None:  # an alignment no feature reads: JAX gives zeros
            assert not want.any()
        else:
            close_grads(g, want)


TRAIN_CASES = [(name, train_ref) for name in sorted(CASES)
               for train_ref in CASES[name][5]]


@pytest.mark.parametrize("layout", ["[l, n, 3]", "[3n, l]", "[3, n, l]"])
@pytest.mark.parametrize("name,train_ref", TRAIN_CASES)
def test_train_grads_match_jax(tmp_path, name, train_ref, layout):
    """``fused_train_grads(mode="blocked")``: the loss and every parameter
    and ``ref_x`` gradient against the JAX blocked train kernel, on a
    ragged last tile, ``y_target`` as ``[l, d]`` and as ``[d, l]``."""
    ref = reference(name)
    tm = port_model(tmp_path, ref)
    xin = in_layout(torch.from_numpy(ref["x"]), layout)
    yt = torch.from_numpy(ref["yt"])
    if layout != "[l, n, 3]":
        yt = yt.T.contiguous()
    loss, grads = F.fused_train_grads(tm, xin, yt, mode="blocked",
                                      precision="exact", train_ref=train_ref)
    loss_ref, g_ref = ref["train"][train_ref]
    assert loss.ndim == 0
    np.testing.assert_allclose(float(loss), loss_ref, rtol=LOSS_RTOL)
    assert list(grads) == [tname for tname, _ in named_tensors(tm)]
    for tname, g in grads.items():
        close_grads(g, by_suffix(g_ref, tname))
    ref_names = [k for k in grads if k.endswith("ref_x")]
    if ref_names and not train_ref:
        assert not grads[ref_names[0]].any()
    if train_ref:
        assert grads[ref_names[0]].abs().max() > 0
    # every precision name computes in f32
    loss2, grads2 = F.fused_train_grads(tm, xin, yt, mode="blocked",
                                        train_ref=train_ref)
    assert torch.equal(loss, loss2)
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)


def test_fluid_streamed_pairs_and_c_mat(tmp_path):
    """lj_fluid_model(4): 2 x 2,016 pairs, streamed in the JAX layout, with
    its pair operand as ``c_mat``; against the JAX plain path."""
    jm, u, _ = JS.lj_fluid_model(4)
    tm = load_model(jsave_model(str(tmp_path / "f.npz"), jm), device="cpu")
    c = torch.from_numpy(F.model_chunk_matrix(tm))
    x = frames(u, 7, 32, sigma=0.8)
    rng = np.random.default_rng(33)
    yt = rng.normal(size=(7, 1)).astype(np.float32)
    gy = rng.normal(size=(7, 1)).astype(np.float32)
    xj = jnp.asarray(x)
    loss_ref, g_ref = jax.value_and_grad(
        lambda m: jnp.mean((m(xj) - jnp.asarray(yt)) ** 2))(jm)
    loss, grads = F.fused_train_grads(tm, torch.from_numpy(x),
                                      torch.from_numpy(yt), c_mat=c)
    np.testing.assert_allclose(float(loss), float(loss_ref), rtol=LOSS_RTOL)
    for tname, g in grads.items():
        close_grads(g, by_suffix(jax_named(g_ref), tname))
    _, vjp = jax.vjp(lambda m, xx: m(xx), jm, xj)
    gm, gx_ref = vjp(jnp.asarray(gy))
    xt = torch.from_numpy(x).requires_grad_(True)
    weights = list(tm.parameters())
    y = F.fused_model_forward(tm, xt, c_mat=c)
    got = torch.autograd.grad(y, [xt, *weights], torch.from_numpy(gy))
    spec, _, _, params, _ = F._extract_model(tm)
    slack = FB.gradient_jump_slack(spec, params, xt.detach().double()).numpy()
    close_grads(got[0], np.asarray(gx_ref), slack)
    for (tname, _), g in zip(tm.named_parameters(), got[1:]):
        close_grads(g, by_suffix(jax_named(gm), tname))
    with pytest.raises(ValueError, match="c_mat must be int32"):
        F.fused_train_grads(tm, torch.from_numpy(x), torch.from_numpy(yt),
                            c_mat=c[:-1])


def test_plain_versions_slice_frames(monkeypatch):
    """The plain versions give the same sums a slice of frames at a time."""
    tm, u, _ = TS.lj_fluid_model(3, device="cpu")
    parts = F._extract_model(tm)
    x = torch.from_numpy(frames(u, 7, 34, sigma=0.5))
    rng = np.random.default_rng(35)
    gy = torch.from_numpy(rng.normal(size=(7, 1)).astype(np.float32))
    whole_b = FB.blocked_backward_plain(*parts, x, gy)
    whole_t = FB.blocked_train_grads_plain(*parts, x, gy)
    monkeypatch.setattr(FB, "_PLAIN_SLICE_FLOATS", 3 * 702 * 2)
    assert FB._frame_slice(parts[0]) == 2
    sliced_b = FB.blocked_backward_plain(*parts, x, gy)
    sliced_t = FB.blocked_train_grads_plain(*parts, x, gy)
    np.testing.assert_allclose(sliced_b[0].numpy(), whole_b[0].numpy(),
                               atol=1e-6)
    for (a, b), (c, d) in zip(sliced_b[1], whole_b[1]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), d.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(sliced_t[0]), float(whole_t[0]),
                               rtol=1e-6)
    for (a, b), (c, d) in zip(sliced_t[1], whole_t[1]):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(b.numpy(), d.numpy(), rtol=1e-5, atol=1e-5)
    assert sliced_b[2] is None and sliced_t[2] is None


def test_errors_and_shapes():
    tm, u = TS.peptide_model(14, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    assert F.model_select_mode(tm) == "blocked"
    x = torch.from_numpy(frames(u, 5, 36))
    with pytest.raises(ValueError, match="MLP head"):
        F.fused_train_grads(tm.preprocessing_layer, x, torch.zeros(5, 2))
    spec, align_idx, ref_x, params, act = F._extract_model(tm)
    with pytest.raises(ValueError, match="MLP head"):
        FB.blocked_train_grads(spec, align_idx, act, (), ref_x, x,
                               torch.zeros(5, 2))
    with pytest.raises(ValueError, match="y_target must be"):
        F.fused_train_grads(tm, x, torch.zeros(5, 3))
    with pytest.raises(ValueError, match="at least one frame"):
        F.fused_train_grads(tm, x[:0], torch.zeros(0, 2))
    with pytest.raises(ValueError, match="precision"):
        F.fused_train_grads(tm, x, torch.zeros(5, 2), precision="fp8")
    with pytest.raises(ValueError, match="expected frames"):
        F.fused_train_grads(tm, x[:, :7], torch.zeros(5, 2))
    # y_target [l, d] and [d, l] are the same labels
    yt = torch.from_numpy(np.random.default_rng(37).normal(
        size=(5, 2)).astype(np.float32))
    loss, gparams, g_ref = FB.blocked_train_grads(
        spec, align_idx, act, params, ref_x, x, yt, tile=128, interpret=True)
    loss_t, gparams_t, _ = FB.blocked_train_grads(
        spec, align_idx, act, params, ref_x, x, yt.T.contiguous())
    assert torch.equal(loss, loss_t)
    assert all(torch.equal(a, b) for wa, wb in zip(gparams, gparams_t)
               for a, b in zip(wa, wb))
    # peptide_model aligns on its CA trace and has no position feature:
    # the reference gets an exactly-zero gradient, as in JAX
    assert g_ref.shape == ref_x.shape and not g_ref.any()
    for k in F.KERNEL_LAUNCHES:
        assert F.KERNEL_LAUNCHES[k] == 0


def test_trainers_lower_the_loss_and_agree():
    """``fit(fused_mse_loss)`` (forward and backward under autograd) and
    ``make_fused_train_step`` (the train op) on a blocked system: a few Adam
    steps lower the loss, and the two agree step for step within 1e-5."""
    def student():
        return TS.peptide_model(14, generator=torch.Generator().manual_seed(2),
                                device="cpu")
    teacher, u = TS.peptide_model(
        14, generator=torch.Generator().manual_seed(3), device="cpu")
    x = frames(u, 48, 38)
    with torch.no_grad():
        y = teacher(torch.from_numpy(x)).numpy()
    batches = [(x[s:s + 24], y[s:s + 24]) for s in (0, 24)] * 3
    adam = functools.partial(torch.optim.Adam, lr=1e-3)
    res = fit(student()[0], fused_mse_loss, iter(batches), optimizer=adam,
              num_steps=6)
    model = student()[0]
    opt = masked_optimizer(adam, trainable_mask(model))(model)
    step = make_fused_train_step()
    losses = []
    for batch in batches:
        model, opt, loss = step(model, opt, batch)
        losses.append(float(loss))
    assert len(res.losses) == 6 and res.losses[-1] < res.losses[0]
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, res.losses, rtol=1e-5)
    for a, b in zip(model.parameters(), res.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)
