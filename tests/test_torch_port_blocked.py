"""The port's blocked serving path against the JAX package, on the CPU.

The same numpy inputs from a seed go through the JAX function and the
port's; weights cross through the ``.npz``. Where interpret mode is quick
the JAX side runs the Pallas blocked kernels as its own tests do
(``interpret=True, mode="blocked", tile=32``, tests/test_fused_blocked.py:
44-47); elsewhere it runs ``model(x)`` and ``jax.grad``. On the CPU the
port runs the kernels' plain versions. Tolerances: values 1e-5 (5e-5 for
sums over thousands of pairs, tests/test_condensed.py:101-118); gradients
5e-5·max(1, max|g|) (tests/test_fused_blocked.py:83-95).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu import systems as JS
from molann_tpu.feature import Feature as JFeature
from molann_tpu.io import load_model as jload_model
from molann_tpu.io import save_model as jsave_model
from molann_tpu.models import ann as JA
from molann_tpu.ops import fused as JF
from molann_tpu.serve import evaluate_trajectory as jevaluate
from molann_tpu_torch import systems as TS
from molann_tpu_torch.io import load_model, save_model
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.ops import fused_blocked as FB
from molann_tpu_torch.serve import evaluate_trajectory

VAL = 1e-5
VAL_PAIRS = 5e-5
GRAD = 5e-5


def cross(tmp, jm, name="m"):
    """A JAX model as a port model on the CPU, through the .npz."""
    return load_model(jsave_model(str(tmp / f"{name}.npz"), jm), device="cpu")


def frames(u, l, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    return (u.atoms.positions[None] + sigma * rng.normal(
        size=(l, len(u.atoms), 3))).astype(np.float32)


def close_grads(g, g_ref):
    g, g_ref = np.asarray(g), np.asarray(g_ref)
    np.testing.assert_allclose(
        g, g_ref, atol=GRAD * max(1.0, float(np.abs(g_ref).max())))


def jgrad(jm, x, component=None):
    def obj(v):
        y = jm(v)
        return (y if component is None else y[:, component]).sum()
    return np.asarray(jax.grad(obj)(jnp.asarray(x)))


INTERP = dict(tile=32, interpret=True, mode="blocked")


def test_peptide_matches_interpret(tmp_path):
    jm, u = JS.peptide_model(n_residues=6)
    tm = cross(tmp_path, jm)
    assert F.model_select_mode(tm) == "unrolled"  # 30 atoms: ask for blocked
    x = frames(u, 32, 11)
    y_ref = np.asarray(JF.fused_model_forward(jm, jnp.asarray(x), bwd_tile=32,
                                              **INTERP))
    _, g_ref = JF.fused_cv_forces(jm, jnp.asarray(x), **INTERP)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        y = F.fused_model_forward(tm, xt, mode="blocked")
    y2, g = F.fused_cv_forces(tm, xt, mode="blocked")
    np.testing.assert_allclose(y.numpy(), y_ref, atol=VAL)
    np.testing.assert_allclose(y2.numpy(), y_ref, atol=VAL)
    close_grads(g, g_ref)
    np.testing.assert_allclose(y_ref, np.asarray(jm(jnp.asarray(x))), atol=VAL)


def test_peptide_auto_mode_and_model_crosses_back(tmp_path):
    """peptide_model(14) is past the envelope: auto selects blocked; and
    the port's own peptide_model gives the JAX spec, and its model loads in JAX."""
    tm, u = TS.peptide_model(14, generator=torch.Generator().manual_seed(1),
                             device="cpu")
    jm_spec = JS.peptide_model(14)[0].preprocessing_layer.feature_layer.spec
    assert tm.preprocessing_layer.feature_layer.spec == \
        type(tm.preprocessing_layer.feature_layer.spec)(**vars(jm_spec))
    assert F.model_select_mode(tm) == "blocked"
    assert F.model_chunk_matrix(tm) is None
    assert F.active_atom_indices(tm) is None
    jm = jload_model(save_model(str(tmp_path / "p.npz"), tm))
    x = frames(u, 9, 2)
    np.testing.assert_array_equal(u.atoms.positions,
                                  JS.synthetic_peptide(14).atoms.positions)
    y, g = F.fused_cv_forces(tm, torch.from_numpy(x), component=1)
    np.testing.assert_allclose(y.numpy(), np.asarray(jm(jnp.asarray(x))),
                               atol=VAL)
    close_grads(g, jgrad(jm, x, 1))


@pytest.mark.parametrize("use_angle_value", [False, True])
def test_alanine_through_blocked(tmp_path, use_angle_value):
    """Alignment and positions through mode="blocked"."""
    jm, u = JS.alanine_model(use_angle_value=use_angle_value)
    tm = cross(tmp_path, jm)
    x = frames(u, 32, 12)
    y_ref = np.asarray(JF.fused_model_forward(jm, jnp.asarray(x), bwd_tile=32,
                                              **INTERP))
    xt = torch.from_numpy(x)
    y, g = F.fused_cv_forces(tm, xt, mode="blocked")
    np.testing.assert_allclose(y.numpy(), y_ref, atol=VAL)
    close_grads(g, jgrad(jm, x))
    y_u, g_u = F.fused_cv_forces(tm, xt, mode="unrolled")
    np.testing.assert_allclose(y.numpy(), y_u.numpy(), atol=VAL)
    close_grads(g, g_u)


@pytest.mark.parametrize("component", [0, 5, 30])
def test_feature_layer_only_component(tmp_path, component):
    """No MLP: the component addresses the FINAL column."""
    u = JS.alanine_universe()
    feats = [JFeature("p1", "position", u.select_atoms("resid 2"))]
    feats += JS.alanine_histogram_features(u)
    pp = JA.PreprocessingANN(
        JA.AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms),
        JA.FeatureLayer(feats, u.atoms))
    tp = cross(tmp_path, pp)
    x = frames(u, 32, 13)
    y_b, g_b = JF.fused_cv_forces(pp, jnp.asarray(x), component=component,
                                  **INTERP)
    y, g = F.fused_cv_forces(tp, torch.from_numpy(x), component=component,
                             mode="blocked")
    np.testing.assert_allclose(y.numpy(), np.asarray(y_b), atol=VAL)
    close_grads(g, g_b)
    close_grads(g, jgrad(pp, x, component))


def test_lj_fluid_resident_pairs(tmp_path):
    """lj_fluid_model(3): 2 x 351 pairs, resident in the JAX layout, on
    frames that straddle the periodic boundary, against interpret mode."""
    jm, u, _ = JS.lj_fluid_model(3)
    tm = cross(tmp_path, jm)
    assert F.model_select_mode(tm) == "blocked"
    assert F.model_chunk_matrix(tm) is None
    x = frames(u, 8, 14, sigma=1.5)
    kw = dict(tile=8, interpret=True, mode="auto")
    y_ref = np.asarray(JF.fused_model_forward(jm, jnp.asarray(x), **kw))
    _, g_ref = JF.fused_cv_forces(jm, jnp.asarray(x), **kw)
    with torch.no_grad():
        y = F.fused_model_forward(tm, torch.from_numpy(x))
    y2, g = F.fused_cv_forces(tm, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), y_ref, atol=VAL_PAIRS)
    np.testing.assert_allclose(y2.numpy(), y_ref, atol=VAL_PAIRS)
    close_grads(g, g_ref)
    close_grads(g, jgrad(jm, x))


def test_lj_fluid_streamed_pairs_and_c_mat(tmp_path):
    """lj_fluid_model(4): 2 x 2,016 pairs, streamed in the JAX layout, so
    the model has a pair operand; against model(x) and jax.grad."""
    jm, u, _ = JS.lj_fluid_model(4)
    tm = cross(tmp_path, jm)
    c = F.model_chunk_matrix(tm)
    spec, align_idx = F._extract_model(tm)[:2]
    lay = FB.blocked_layout(spec, align_idx)
    assert lay.coord_resident == (False, False) and lay.chunked
    assert lay.coord_npairs == (2016, 2016)
    # [partner rows | where each row's owned partners end | partners]
    assert c.dtype == np.int32 and c.shape == (2 * 4032 + 2 * (2 * 64 + 1),)
    ptr = c[:130].reshape(2, 65)
    mid = c[130:258].reshape(2, 64)
    nbr = c[258:]
    for k in range(2):
        for a in (0, 17, 63):
            got = sorted(nbr[ptr[k, a]:ptr[k, a + 1]].tolist())
            assert got == [b for b in range(64) if b != a]
            owned = nbr[ptr[k, a]:mid[k, a]].tolist()
            assert owned == [b for b in range(64) if b != a
                             and (a < b) == ((a + b) % 2 == 0)]
        assert int((mid[k] - ptr[k, :-1]).sum()) == 2016  # each pair once
    x = frames(u, 6, 15, sigma=0.8)
    xt = torch.from_numpy(x)
    y, g = F.fused_cv_forces(tm, xt, c_mat=torch.from_numpy(c))
    np.testing.assert_allclose(y.numpy(), np.asarray(jm(jnp.asarray(x))),
                               atol=VAL_PAIRS)
    close_grads(g, jgrad(jm, x))
    y2, g2 = F.fused_cv_forces(tm, xt, c_mat=c)  # numpy is taken too
    np.testing.assert_allclose(y2.numpy(), y.numpy(), atol=1e-6)
    np.testing.assert_allclose(g2.numpy(), g.numpy(), atol=1e-6)
    for bad in (c[:-1], c.astype(np.int64), torch.zeros(3, 3), [1, 2]):
        with pytest.raises(ValueError, match="c_mat must be int32"):
            F.fused_cv_forces(tm, xt, c_mat=bad)
        with pytest.raises(ValueError, match="c_mat must be int32"):
            F.fused_model_forward(tm, xt, c_mat=bad)
    small = cross(tmp_path, JS.lj_fluid_model(3)[0], "small")
    with pytest.raises(ValueError, match="no chunked"):
        F.fused_cv_forces(small, torch.zeros(2, 27, 3), c_mat=c)


def test_switching_forms(tmp_path):
    """A feature with mm != 2 nn (with d_max) and one without d_max, an
    A x B feature without a box, and a bond beside them."""
    u, box = JS.lj_fluid(3)
    feats = [
        JFeature("q", "coordination", u.atoms, r0=2.0, nn=3, mm=7,
                 pbc_box=box, d_max=3.6),
        JFeature("tail", "coordination", u.atoms, r0=2.3, pbc_box=box),
        JFeature("ab", "coordination", u.select_atoms("resid 1:6"),
                 group_b=u.select_atoms("resid 10:20"), r0=3.0, nn=2, mm=5),
        JFeature("b", "bond",
                 u.select_atoms("bynum 1") + u.select_atoms("bynum 20")),
    ]
    pp = JA.PreprocessingANN(None, JA.FeatureLayer(feats, u.atoms))
    tp = cross(tmp_path, pp)
    x = frames(u, 6, 16, sigma=0.6)
    y_ref = np.asarray(pp(jnp.asarray(x)))
    for comp in (0, 1, 2):
        y, g = F.fused_cv_forces(tp, torch.from_numpy(x), component=comp)
        np.testing.assert_allclose(y.numpy(), y_ref,
                                   atol=2e-5 * np.abs(y_ref).max())
        g_ref = jgrad(pp, x, comp)
        assert np.abs(g_ref).max() > 0.05
        close_grads(g, g_ref)


def jsparse_model():
    u = JS.synthetic_peptide(40)  # 200 atoms

    def sel(name, resid):
        return u.select_atoms(f"name {name} and resid {resid}")

    feats = [
        JFeature("b1", "bond", sel("CA", 3) + sel("CA", 17)),
        JFeature("a1", "angle", sel("N", 9) + sel("CA", 9) + sel("C", 9)),
        JFeature("d1", "dihedral",
                 sel("C", 24) + sel("N", 25) + sel("CA", 25) + sel("C", 25)),
        JFeature("p1", "position", sel("CA", 30) + sel("CA", 31)),
    ]
    align = JA.AlignmentLayer(u.select_atoms("name CA and resid 1:5"), u.atoms)
    pp = JA.PreprocessingANN(align, JA.FeatureLayer(feats, u.atoms))
    return JA.MolANN(pp, JA.create_sequential_nn(
        [pp.output_dimension(), 8, 2], key=jax.random.PRNGKey(3))), u


def test_compaction_and_compact_grads(tmp_path):
    jm, u = jsparse_model()
    tm = cross(tmp_path, jm)
    n = len(u.atoms)
    active = F.active_atom_indices(tm)
    np.testing.assert_array_equal(active, JF.active_atom_indices(jm))
    assert 4 * len(active) <= n
    x = frames(u, 16, 17)
    xt = torch.from_numpy(x)
    y_ref, g_ref = JF.fused_cv_forces(jm, jnp.asarray(x), **INTERP)
    y, g = F.fused_cv_forces(tm, xt)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), atol=VAL)
    close_grads(g, g_ref)
    inactive = np.setdiff1d(np.arange(n), active)
    assert not g[:, inactive].any()
    y_c, g_c = F.fused_cv_forces(tm, xt, compact_grads=True)
    assert g_c.shape == (3, len(active), 16) and g_c.is_contiguous()
    assert torch.equal(y_c, y)
    assert torch.equal(g_c, g.permute(2, 1, 0)[:, active])
    y_t, g_t = F.fused_cv_forces(tm, xt, compact_grads=True,
                                 transposed_outputs=True)
    assert torch.equal(y_t, y.T) and torch.equal(g_t, g_c)
    # every atom active: compact rows are all the rows
    pm = TS.peptide_model(14, device="cpu")[0]
    xp = torch.from_numpy(frames(TS.synthetic_peptide(14), 4, 1))
    _, gp = F.fused_cv_forces(pm, xp)
    _, gpc = F.fused_cv_forces(pm, xp, compact_grads=True)
    assert torch.equal(gpc, gp.permute(2, 1, 0))


def test_layouts_in_and_out(tmp_path):
    """All four input layouts and the three out_layouts, as
    tests/test_fused_blocked.py:192-220, and against the JAX shapes."""
    jm, u = JS.alanine_model()
    tm = cross(tmp_path, jm)
    l, n = 32, 22
    x = frames(u, l, 18)
    xt = torch.from_numpy(x)
    kw = dict(mode="blocked")
    y0, g0 = F.fused_cv_forces(tm, xt, **kw)
    assert g0.shape == (l, n, 3)
    y1, g1 = F.fused_cv_forces(tm, xt.reshape(l, 3 * n), **kw)
    assert g1.shape == (l, 3 * n)
    y2, g2 = F.fused_cv_forces(tm, xt.reshape(l, 3 * n).T.contiguous(),
                               transposed_input=True, **kw)
    assert y2.shape == (3, l) and g2.shape == (3 * n, l)
    y3, g3 = F.fused_cv_forces(tm, xt.permute(2, 1, 0).contiguous(), **kw)
    assert y3.shape == (3, l) and g3.shape == (3, n, l)
    y4, g4 = F.fused_cv_forces(tm, xt, transposed_outputs=True, **kw)
    assert y4.shape == (3, l) and g4.shape == (3 * n, l)
    for y, g in ((y1, g1.reshape(l, n, 3)), (y2.T, g2.T.reshape(l, n, 3)),
                 (y3.T, g3.permute(2, 1, 0)), (y4.T, g4.T.reshape(l, n, 3))):
        np.testing.assert_allclose(y.numpy(), y0.numpy(), atol=1e-6)
        np.testing.assert_allclose(g.numpy(), g0.numpy(), atol=1e-6)
    jy, jg = JF.fused_cv_forces(jm, jnp.asarray(np.transpose(x, (2, 1, 0))),
                                **INTERP)
    assert jy.shape == tuple(y3.shape) and jg.shape == tuple(g3.shape)
    close_grads(g3, jg)
    spec, align_idx, ref_x, params, act = F._extract_model(tm)
    xc = xt.permute(2, 1, 0).contiguous()
    for out, ys, gs in (("standard", (l, 3), (l, n, 3)),
                        ("t", (3, l), (3 * n, l)),
                        ("cmajor", (3, l), (3, n, l))):
        y, g = FB.blocked_cv_forces(spec, align_idx, act, params, ref_x, xc,
                                    out_layout=out)
        assert y.shape == ys and g.shape == gs
    with pytest.raises(ValueError, match="out_layout"):
        FB.blocked_cv_forces(spec, align_idx, act, params, ref_x, xc,
                             out_layout="fast")
    with torch.no_grad():
        for xin in (xt, xt.reshape(l, 3 * n), xc,
                    xt.reshape(l, 3 * n).T.contiguous()):
            yf = F.fused_model_forward(tm, xin, **kw)
            np.testing.assert_allclose(yf.numpy(), y0.numpy(), atol=1e-6)
    for bad in (xt[:, :5], xt.reshape(l, 3 * n)[:, :7], xt[0]):
        with pytest.raises(ValueError, match="expected frames"):
            F.fused_cv_forces(tm, bad, **kw)
    # [3, n, l] is told from [l, n, 3] by its last axis (3 frames of a
    # 3-atom system read as [l, n, 3])
    assert FB._classify(torch.zeros(3, 3, 3), 3) == ("lnd", 3)
    assert FB._classify(torch.zeros(3, 3, 4), 3) == ("cmajor", 4)


def test_modes_precision_and_refusals(tmp_path):
    jm, u = JS.peptide_model(n_residues=30)
    tm = cross(tmp_path, jm)
    assert F.model_select_mode(tm) == JF.model_select_mode(jm) == "blocked"
    small = cross(tmp_path, JS.alanine_model()[0], "a")
    assert F.model_select_mode(small) == "unrolled"
    x = torch.from_numpy(frames(u, 3, 19))
    y0, g0 = F.fused_cv_forces(tm, x)
    for p in ("auto", "exact", "tf32", "bf16"):
        y, g = F.fused_cv_forces(tm, x, precision=p, tile=128)
        assert torch.equal(y, y0) and torch.equal(g, g0)
    with pytest.raises(ValueError, match="precision"):
        F.fused_cv_forces(tm, x, precision="fp8")
    with pytest.raises(ValueError, match="precision"):
        F.fused_model_forward(tm, x, precision="fp8")
    # training: the loss and the gradients of an MSE through the eager model
    yt = torch.from_numpy(np.random.default_rng(3).normal(
        size=(3, 2)).astype(np.float32))
    loss, grads = F.fused_train_grads(tm, x, yt)
    tm.zero_grad()
    ((tm(x) - yt) ** 2).mean().backward()
    np.testing.assert_allclose(float(loss),
                               float(((tm(x) - yt) ** 2).mean().detach()),
                               rtol=1e-5)
    for name, p in tm.named_parameters():
        close_grads(grads[name], p.grad)
    assert set(F.KERNEL_LAUNCHES) >= {"blocked_forward", "blocked_cv_forces",
                                      "blocked_backward", "blocked_train"}
    assert not any(F.KERNEL_LAUNCHES[k] for k in (
        "blocked_forward", "blocked_cv_forces", "blocked_backward",
        "blocked_train"))
    # the forward is differentiable, with respect to x and to the weights
    xg = x.clone().requires_grad_(True)
    tm.zero_grad()
    F.fused_model_forward(tm, xg).sum().backward()
    close_grads(xg.grad, g0)
    assert all(p.grad is not None and p.grad.abs().max() > 0
               for p in tm.parameters())
    with pytest.raises(ValueError, match="MLP head"):
        F.fused_train_grads(tm.preprocessing_layer, x, torch.zeros(3, 355))
    with pytest.raises(ValueError, match="y_target"):
        F.fused_train_grads(tm, x, torch.zeros(4, 2))
    with pytest.raises(ValueError, match="at most"):
        FB.check_blocked_envelope(((x, x),) * 9, "tanh")
    # every activation the reference serialises is served; a name it does
    # not know is refused
    for act in ("gelu", "elu", "celu", "softplus", "swish"):
        FB.check_blocked_envelope((), act)
    with pytest.raises(ValueError, match="activation"):
        FB.check_blocked_envelope((), "mish")


def test_frames_per_block_choice():
    kb = 1024
    assert FB.choose_frames(lambda f: f * kb) == 32
    assert FB.choose_frames(lambda f: f * 3 * kb) == 16
    assert FB.choose_frames(lambda f: f * 6 * kb) == 8
    assert FB.choose_frames(lambda f: f * 8 * kb) == 16  # 128 KB: one block
    assert FB.choose_frames(lambda f: f * 100 * kb) == 2
    with pytest.raises(ValueError, match="shared memory"):
        FB.choose_frames(lambda f: f * 300 * kb)
    # a small batch gets a smaller tile, so that more blocks share its work
    assert FB.choose_frames(lambda f: f * kb, 65536) == 32
    assert FB.choose_frames(lambda f: f * kb, 4096) == 32
    assert FB.choose_frames(lambda f: f * kb, 1024) == 8
    assert FB.choose_frames(lambda f: f * kb, 8) == 1
    assert FB.choose_frames(lambda f: f * 6 * kb, 600) == 4


def test_plain_versions_slice_frames(monkeypatch):
    """The plain versions give the same result a slice of frames at a time."""
    tm, u, _ = TS.lj_fluid_model(3, device="cpu")
    parts = F._extract_model(tm)
    x = torch.from_numpy(frames(u, 7, 20, sigma=0.5))
    y0, g0 = FB.blocked_cv_forces_plain(*parts, x)
    monkeypatch.setattr(FB, "_PLAIN_SLICE_FLOATS", 3 * 702 * 2)
    assert FB._frame_slice(parts[0]) == 2
    y1, g1 = FB.blocked_cv_forces_plain(*parts, x, None)
    yf = FB.blocked_forward_plain(*parts, x)
    for got, want in ((y1, y0), (g1, g0), (yf.detach(), y0)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    y_e, g_e = FB.blocked_cv_forces_plain(*parts, x[:0])
    assert y_e.shape == (0, 1) and g_e.shape == (0, 27, 3)


def test_lj_fluid_model_matches_jax(tmp_path):
    """The port's lj_fluid_model: the JAX spec and coordinates, a folded
    standardisation that keeps tanh unsaturated, and a model that loads in
    the JAX package."""
    tm, u, box = TS.lj_fluid_model(3, generator=torch.Generator().manual_seed(2),
                                   device="cpu")
    jm0, ju, jbox = JS.lj_fluid_model(3)
    np.testing.assert_array_equal(u.atoms.positions, ju.atoms.positions)
    np.testing.assert_array_equal(box, jbox)
    tspec = tm.preprocessing_layer.feature_layer.spec
    assert vars(tspec) == vars(jm0.preprocessing_layer.feature_layer.spec)
    jm = jload_model(save_model(str(tmp_path / "lj.npz"), tm))
    x = frames(u, 5, 21, sigma=0.3)
    y, g = F.fused_cv_forces(tm, torch.from_numpy(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jm(jnp.asarray(x))),
                               atol=VAL_PAIRS)
    close_grads(g, jgrad(jm, x))
    assert float(g.abs().max()) > 1e-3  # not saturated


@pytest.mark.parametrize("system", ["peptide", "lj"])
def test_evaluate_trajectory_matches_jax(tmp_path, system):
    """A .npy trajectory with a tail batch, with and without forces."""
    if system == "peptide":
        # the Pallas kernels in interpret mode: the JAX plain path takes
        # the gradient through the (here idle) alignment and is the
        # noisier side, 1.6e-3 off a float64 reference against 3e-5
        jm, u = JS.peptide_model(n_residues=14)
        sigma, tol, jkw = 0.05, VAL, dict(interpret=True, tile=8)
    else:
        jm, u, _ = JS.lj_fluid_model(4)
        sigma, tol, jkw = 0.8, VAL_PAIRS, {}
    tm = cross(tmp_path, jm)
    x = frames(u, 21, 22, sigma=sigma)
    path = str(tmp_path / "traj.npy")
    np.save(path, x)
    jc, jg = jevaluate(jm, path, forces=True, batch_size=8, **jkw)
    cvs, grads = evaluate_trajectory(tm, path, device="cpu", forces=True,
                                     batch_size=8)
    assert cvs.shape == jc.shape and grads.shape == jg.shape
    np.testing.assert_allclose(cvs, jc, atol=tol)
    close_grads(grads, jg)
    only = evaluate_trajectory(tm, path, device="cpu", batch_size=8,
                               mode="blocked", precision="exact", tile=None)
    np.testing.assert_allclose(only, jc, atol=tol)
    c = F.model_chunk_matrix(tm)
    cvs2 = evaluate_trajectory(tm, x, device="cpu", batch_size=16, c_mat=c)
    np.testing.assert_allclose(cvs2, cvs, atol=1e-6)


def test_entry_points_default_to_the_card(tmp_path, monkeypatch):
    """Without device= the entry points ask for the card, and say so where
    there is none; they never fall back to the host."""
    from molann_tpu_torch._device import resolve_device
    from molann_tpu_torch.io import model_from_arrays
    from molann_tpu_torch.train.checkpoint import load_training_state

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    path = jsave_model(str(tmp_path / "m.npz"), JS.alanine_model()[0])
    calls = [
        lambda: TS.alanine_model(),
        lambda: TS.peptide_model(4),
        lambda: TS.lj_fluid_model(3),
        lambda: load_model(path),
        lambda: model_from_arrays({"kind": "Identity"}, {}),
        lambda: load_training_state(str(tmp_path / "m"), None),
        lambda: evaluate_trajectory(load_model(path, device="cpu"),
                                    np.zeros((2, 22, 3), np.float32)),
        lambda: evaluate_trajectory(load_model(path, device="cpu"),
                                    np.zeros((2, 22, 3), np.float32),
                                    device="cuda"),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device is present"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")


@pytest.mark.parametrize("case", ["d_max", "half_box"])
def test_gradient_jump_slack(case):
    """A pair put 1e-6 inside and 1e-6 outside a threshold: the float64
    gradients differ on its two atoms by a jump that the slack covers, and
    by next to nothing elsewhere; the slack is 0 on every other atom and on
    frames with no pair at a threshold."""
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import (
        FeatureLayer,
        MolANN,
        PreprocessingANN,
        create_sequential_nn,
    )

    u, box = TS.lj_fluid(3)
    length = float(box[0])
    d_max = 2.4 if case == "d_max" else None
    pp = PreprocessingANN(None, FeatureLayer([Feature(
        "c", "coordination", u.atoms, r0=1.9, nn=3, mm=7, pbc_box=box,
        d_max=d_max)], u.atoms))
    model = MolANN(pp, create_sequential_nn(
        [1, 4, 2], generator=torch.Generator().manual_seed(5),
        device="cpu")).double()
    with torch.no_grad():  # the sum is in the tens: keep tanh off its flats
        model.ann_layers.layers[0].weight.mul_(0.01)
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    x = torch.from_numpy(frames(u, 3, 21, sigma=0.3).astype(np.float64))
    i, j = 4, 22
    d = x[0, j] - x[0, i]
    if case == "d_max":
        d = d - length * torch.round(d / length)
        sides = [x[0, i] + d * (d_max + e) / d.norm() for e in (-1e-6, 1e-6)]
    else:
        sides = [x[0, i] + torch.stack([d[0].new_tensor(length / 2 + e),
                                        0.3 * d[1], 0.3 * d[2]])
                 for e in (-1e-6, 1e-6)]
    grads = []
    for pos in sides:
        x[0, j] = pos
        grads.append(FB.blocked_cv_forces_plain(spec, align_idx, ref_x, params,
                                                act, x)[1])
    slack = FB.gradient_jump_slack(spec, params, x)
    assert slack.shape == (3, 27)
    assert sorted(torch.nonzero(slack[0]).flatten().tolist()) == [i, j]
    assert not slack[1:].any()
    diff = (grads[0] - grads[1]).abs().amax(dim=-1)
    assert float(diff[0, [i, j]].min()) > 1e-4  # the jump is real
    assert float((diff - slack).max()) <= 1e-5
    # float32 against float64, as the card's checks use it
    m32 = model.float()
    y, g = F.fused_cv_forces(m32, x.float(), mode="blocked")
    err = (g.double() - grads[1]).abs().amax(dim=-1)
    assert float((err - slack).max()) <= GRAD * max(
        1.0, float(grads[1].abs().max()))
