"""The port's neighbor culling (``ops/neighbor.py``) against the JAX
package's.

The host-side functions are carried over, so ``switching_cutoff``,
``neighbor_pairs`` (open, orthorhombic and triclinic boxes, within one set
and across two), ``cull_spec`` with its ``CullReport`` (the printed text
too), ``max_displacement`` and ``cull_model`` must give the JAX results
exactly. The models cross over through ``.npz``: ``lj_fluid_model(4)``
with ``d_max`` (culled exactly) and without (culled to ``tol``). A culled
model's output must stay within the report's ``error_bound`` of the
unculled one (the sum of ``n_culled × tol`` over a feature's pairs moves
each feature column by at most that, beside the float32 rounding of a
count summed over other pairs, 2e-6 of the count; the outputs are held to
the unculled model's at 1e-5 where the bound is 0). The serving ops key their
caches on the spec's identity, so a culled and an unculled model served
one after the other must each get their own blocked layout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.io import save_model as jsave_model
from molann_tpu.ops import neighbor as JN
from molann_tpu.systems import lj_fluid_model as jlj_fluid_model
from molann_tpu_torch.io import load_model
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.ops import fused_blocked as FB
from molann_tpu_torch.ops import neighbor as TN
from molann_tpu_torch.serve import evaluate_trajectory

VAL_ATOL = 1e-5
# the switching tolerance of each model's cull: the untruncated tails need
# a loose one before r_cut(tol) + skin falls inside the 6.8 A box
TOL = {"dmax": 1e-6, "tails": 5e-2}


@pytest.fixture(scope="module")
def fluids(tmp_path_factory):
    """``lj_fluid_model(4)`` with and without ``d_max``, JAX and port."""
    d = tmp_path_factory.mktemp("torch_neighbor")
    out = {}
    for name, d_max in (("dmax", True), ("tails", False)):
        jm, u, box = jlj_fluid_model(4, key=jax.random.PRNGKey(3),
                                     d_max=d_max)
        jsave_model(str(d / f"{name}.npz"), jm)
        tm = load_model(str(d / f"{name}.npz"), device="cpu")
        out[name] = (jm, tm, u, box)
    return out


def _frames(u, l, sigma, seed):
    rng = np.random.default_rng(seed)
    return (u.atoms.positions[None] + sigma * rng.normal(
        size=(l,) + u.atoms.positions.shape)).astype(np.float32)


@pytest.mark.parametrize("r0,nn,mm,tol", [(1.0, 6, 12, 1e-6),
                                          (2.3, 4, 8, 1e-4),
                                          (0.5, 6, 10, 1e-8)])
def test_switching_cutoff_matches_jax(r0, nn, mm, tol):
    assert TN.switching_cutoff(r0, nn, mm, tol) == JN.switching_cutoff(
        r0, nn, mm, tol)
    for bad in ((0.0, 6, 12, 1e-6), (1.0, 6, 12, 2.0)):
        with pytest.raises(ValueError):
            TN.switching_cutoff(*bad)


@pytest.mark.parametrize("box_kind", ["open", "orthorhombic", "triclinic",
                                      "tiny"])
@pytest.mark.parametrize("cross", [False, True])
def test_neighbor_pairs_match_jax(box_kind, cross):
    rng = np.random.default_rng(4)
    n = 70
    if box_kind == "triclinic":
        box = np.array([[8.0, 0, 0], [2.0, 7.0, 0], [1.0, 1.5, 9.0]])
        pos = rng.uniform(size=(n, 3)) @ box
    elif box_kind == "tiny":
        box = np.diag([3.0, 3.0, 3.0])
        pos = 3.0 * rng.uniform(size=(n, 3))
    else:
        box = np.diag([9.0, 9.0, 9.0]) if box_kind == "orthorhombic" else None
        pos = 9.0 * rng.uniform(size=(n, 3))
    pos = pos.astype(np.float32)
    a, b = (list(range(30)), list(range(30, n))) if cross else (
        list(range(n)), [])
    for r_cut in (1.4, 2.5):
        got = TN.neighbor_pairs(pos, a, b, r_cut=r_cut, box=box)
        assert got == JN.neighbor_pairs(pos, a, b, r_cut=r_cut, box=box)
        assert 0 < len(got)
    with pytest.raises(ValueError, match="r_cut"):
        TN.neighbor_pairs(pos, a, b)


@pytest.mark.parametrize("name", ["dmax", "tails"])
@pytest.mark.parametrize("skin", [0.5, 1.0])
def test_cull_spec_and_report_match_jax(fluids, name, skin):
    jm, tm, u, _ = fluids[name]
    ref = _frames(u, 1, 0.05, 5)[0]
    jspec, jrep = JN.cull_spec(jm.preprocessing_layer.feature_layer.spec,
                               ref, skin=skin, tol=TOL[name])
    tspec, trep = TN.cull_spec(tm.preprocessing_layer.feature_layer.spec,
                               ref, skin=skin, tol=TOL[name])
    for field in ("coord_pairs", "coord_slices", "coord_params",
                  "coord_boxes", "coord_dmax", "out_dim", "n_input_atoms"):
        assert getattr(tspec, field) == getattr(jspec, field), field
    assert (trep.n_pairs_before, trep.n_pairs_after, trep.r_cut, trep.skin,
            trep.tol, trep.exact) == (jrep.n_pairs_before,
                                      jrep.n_pairs_after, jrep.r_cut,
                                      jrep.skin, jrep.tol, jrep.exact)
    assert trep.error_bound == jrep.error_bound
    assert str(trep) == str(jrep)
    assert sum(trep.n_pairs_after) < sum(trep.n_pairs_before)
    with pytest.raises(ValueError, match="ref_positions"):
        TN.cull_spec(tspec, ref[:-1])


def test_max_displacement_matches_jax(fluids):
    _, _, u, box = fluids["dmax"]
    ref = u.atoms.positions
    x = _frames(u, 6, 0.2, 6)
    x[2, 3] += np.float32(box[0])  # a wrap across the box is no motion
    for b in (None, np.diag(box)):
        assert TN.max_displacement(ref, x, b) == JN.max_displacement(
            ref, x, b)
    assert TN.max_displacement(ref, x, np.diag(box)) < 1.5
    assert TN.max_displacement(ref, x) > float(box[0]) - 1.5
    report = TN.CullReport((), (), (), 1.0, 1e-6, ())
    assert str(report) == str(JN.CullReport((), (), (), 1.0, 1e-6, ()))


@pytest.mark.parametrize("name", ["dmax", "tails"])
def test_cull_model_matches_jax_within_its_bound(fluids, name):
    """The culled model's spec is the JAX culled model's; its features move
    by at most the report's bound from the unculled ones, and its outputs
    and forces match the JAX culled model's."""
    jm, tm, u, _ = fluids[name]
    ref = u.atoms.positions
    jc, jrep = JN.cull_model(jm, ref, tol=TOL[name])
    tc, trep = TN.cull_model(tm, ref, tol=TOL[name])
    assert str(trep) == str(jrep)
    tspec = tc.preprocessing_layer.feature_layer.spec
    assert tspec.coord_pairs == jc.preprocessing_layer.feature_layer.spec \
        .coord_pairs
    # the caller's model is left as it is
    assert tm.preprocessing_layer.feature_layer.spec is not tspec
    assert sum(n for _, n in tm.preprocessing_layer.feature_layer.spec
               .coord_slices) == sum(trep.n_pairs_before)
    x = _frames(u, 16, 0.05, 7)
    xt = torch.as_tensor(x)
    with torch.no_grad():
        f_full = tm.preprocessing_layer(xt).numpy()
        f_cull = tc.preprocessing_layer(xt).numpy()
        y_cull = tc(xt).numpy()
    # the bound, plus the float32 rounding of a sum of hundreds of contact
    # terms taken over another set of pairs (a few ulps of the count)
    bound = np.asarray(trep.error_bound) + 2e-6 * np.abs(f_full).max(axis=0)
    assert np.all(np.abs(f_cull - f_full).max(axis=0) <= bound)
    np.testing.assert_allclose(y_cull, np.asarray(jc(jnp.asarray(x))),
                               atol=VAL_ATOL)
    y, g = F.fused_cv_forces(tc, xt)
    g_ref = np.asarray(jax.grad(lambda v: jnp.sum(jc(v)))(jnp.asarray(x)))
    np.testing.assert_allclose(y.detach().numpy(), y_cull, atol=VAL_ATOL)
    np.testing.assert_allclose(g.numpy(), g_ref,
                               atol=2e-4 * max(1.0, np.abs(g_ref).max()))
    if name == "dmax":  # exact under d_max
        assert trep.error_bound == (0.0, 0.0)
        with torch.no_grad():
            np.testing.assert_allclose(y_cull, tm(xt).numpy(), atol=VAL_ATOL)


def test_cull_model_of_each_layer_and_errors(fluids):
    _, tm, u, _ = fluids["dmax"]
    ref = u.atoms.positions
    pp, rep_pp = TN.cull_model(tm.preprocessing_layer, ref)
    fl, rep_fl = TN.cull_model(tm.preprocessing_layer.feature_layer, ref)
    full, rep = TN.cull_model(tm, ref)
    assert str(rep_pp) == str(rep_fl) == str(rep)
    assert pp.feature_layer.spec == fl.spec == \
        full.preprocessing_layer.feature_layer.spec
    with pytest.raises(TypeError, match="cannot cull"):
        TN.cull_model(tm.ann_layers, ref)


def test_culled_and_unculled_served_in_turn_get_their_own_layout(fluids):
    """Serving keys its layout cache on the spec: a culled model and its
    unculled original, served one after the other in one process, each
    read their own pair table (and their own chunk matrix) every time."""
    _, tm, u, _ = fluids["tails"]
    tc, rep = TN.cull_model(tm, u.atoms.positions, tol=TOL["tails"])
    full_spec = tm.preprocessing_layer.feature_layer.spec
    cull_spec = tc.preprocessing_layer.feature_layer.spec
    x = _frames(u, 24, 0.05, 8)
    outs = []
    for model in (tc, tm, tc, tm):
        cvs, grads = evaluate_trajectory(model, x, device="cpu", forces=True,
                                         batch_size=16)
        outs.append((cvs, grads))
    for a, b in ((0, 2), (1, 3)):
        np.testing.assert_array_equal(outs[a][0], outs[b][0])
        np.testing.assert_array_equal(outs[a][1], outs[b][1])
    lay_c = FB.blocked_layout(cull_spec, None)
    lay_f = FB.blocked_layout(full_spec, None)
    assert lay_c is not lay_f
    assert list(lay_c.coord_npairs) == list(rep.n_pairs_after)
    assert list(lay_f.coord_npairs) == list(rep.n_pairs_before)
    assert FB.blocked_layout(cull_spec, None) is lay_c
    c_c, c_f = F.model_chunk_matrix(tc), F.model_chunk_matrix(tm)
    assert c_f is not None and (c_c is None or c_c.shape != c_f.shape)
    # the culled model stays within its bound of the unculled one: a
    # feature moved by e_j moves output k by at most (|W_L|···|W_1| e)_k
    # (tanh's slope is at most 1)
    chain = None
    for lin in tm.ann_layers.layers:
        a = lin.weight.detach().abs().double().numpy()
        chain = a if chain is None else a @ chain
    with torch.no_grad():
        counts = tm.preprocessing_layer(torch.as_tensor(x)).abs().amax(0)
    # the report's bound, plus the float32 rounding of each count (as above)
    f_bound = np.asarray(rep.error_bound) + 2e-6 * counts.double().numpy()
    assert max(rep.error_bound) > 0
    assert np.all(np.abs(outs[0][0] - outs[1][0]).max(axis=0)
                  <= chain @ f_bound + VAL_ATOL)
