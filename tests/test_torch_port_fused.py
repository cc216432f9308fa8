"""The port's fused serving ops against the JAX package.

On the CPU the wrappers run the kernels' plain PyTorch versions. They are
held against the Pallas kernels run in interpret mode (as
tests/test_fused.py runs them: 32 frames, tile=32) and against the JAX
plain path (``model(x)`` and ``coordinate_gradients``), over components
and layouts. Weights cross via ``save_model`` → ``load_model``.
Tolerances: values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.io import save_model
from molann_tpu.ops import fused as JF
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train.forces import coordinate_gradients as jgrad
from molann_tpu_torch.feature import Feature
from molann_tpu_torch.io import load_model
from molann_tpu_torch.models.ann import FeatureLayer, MolANN, PreprocessingANN
from molann_tpu_torch.models.ann import create_sequential_nn
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import alanine_model, alanine_universe
from molann_tpu_torch.topology import Universe

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
N = 22


def _close_grads(g, g_ref):
    g, g_ref = np.asarray(g), np.asarray(g_ref)
    scale = max(1.0, float(np.abs(g_ref).max()))
    np.testing.assert_allclose(g, g_ref, atol=GRAD_RTOL * scale)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jm, u = jalanine_model()
    path = save_model(str(tmp_path_factory.mktemp("m") / "m.npz"), jm)
    tm = load_model(path, device="cpu")
    rng = np.random.default_rng(7)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(32, N, 3))).astype(np.float32)
    xj = jnp.asarray(x)
    interp = {
        "forward": np.asarray(JF.fused_model_forward(jm, xj, tile=32,
                                                     interpret=True)),
        None: tuple(np.asarray(a) for a in JF.fused_cv_forces(
            jm, xj, tile=32, interpret=True)),
        0: tuple(np.asarray(a) for a in JF.fused_cv_forces(
            jm, xj, component=0, tile=32, interpret=True)),
    }
    return jm, tm, x, interp


def test_plain_forward_matches_interpret(setup):
    _, tm, x, interp = setup
    y = F.fused_model_forward(tm, torch.from_numpy(x))
    np.testing.assert_allclose(y.detach().numpy(), interp["forward"],
                               atol=VAL_ATOL)


@pytest.mark.parametrize("component", [None, 0])
def test_plain_cv_forces_matches_interpret(setup, component):
    _, tm, x, interp = setup
    y, g = F.fused_cv_forces(tm, torch.from_numpy(x), component=component)
    y_ref, g_ref = interp[component]
    np.testing.assert_allclose(y.numpy(), y_ref, atol=VAL_ATOL)
    _close_grads(g, g_ref)


@pytest.mark.parametrize("layout", ["frames", "packed", "transposed",
                                    "packed_to_transposed"])
@pytest.mark.parametrize("component", [None, 0, -1])
def test_cv_forces_matches_jax_plain_path(setup, layout, component):
    jm, tm, x, _ = setup
    l = x.shape[0]
    xj = jnp.asarray(x)
    y_ref = np.asarray(jm(xj))
    g_ref = np.asarray(jgrad(jm, xj, component))
    xt = torch.from_numpy(x)
    if layout == "frames":
        y, g = F.fused_cv_forces(tm, xt, component=component)
        assert g.shape == (l, N, 3)
    elif layout == "packed":
        y, g = F.fused_cv_forces(tm, xt.reshape(l, 3 * N),
                                 component=component)
        assert g.shape == (l, 3 * N)
    elif layout == "transposed":
        y, g = F.fused_cv_forces(tm, xt.reshape(l, 3 * N).T.contiguous(),
                                 component=component, transposed_input=True)
        assert y.shape == (3, l) and g.shape == (3 * N, l)
        y, g = y.T, g.T
    else:
        y, g = F.fused_cv_forces(tm, xt.reshape(l, 3 * N),
                                 component=component, transposed_outputs=True)
        assert y.shape == (3, l) and g.shape == (3 * N, l)
        y, g = y.T, g.T
    np.testing.assert_allclose(y.numpy(), y_ref, atol=VAL_ATOL)
    _close_grads(g.reshape(l, N, 3), g_ref)


@pytest.mark.parametrize("packed", [False, True])
def test_forward_matches_jax_plain_path(setup, packed):
    jm, tm, x, _ = setup
    xt = torch.from_numpy(x)
    if packed:
        xt = xt.reshape(x.shape[0], 3 * N)
    y = F.fused_model_forward(tm, xt, tile=4096, precision="auto")
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jm(jnp.asarray(x))),
                               atol=VAL_ATOL)


def _coordination_model():
    u = alanine_universe()
    feat = Feature("c1", "coordination", u.select_atoms("bynum 2 5"),
                   group_b=u.select_atoms("bynum 15 17"), r0=3.0)
    return FeatureLayer([feat], u.atoms), u


def _big_model():
    rng = np.random.default_rng(0)
    u = Universe.from_arrays(rng.normal(size=(70, 3)) * 5.0,
                             names=["C"] * 70, resids=[1] * 70,
                             resnames=["ALA"] * 70)
    return FeatureLayer([Feature("b", "bond", u.select_atoms("bynum 1 2"))],
                        u.atoms), u


def test_errors():
    model, u = alanine_model(device="cpu")
    x = torch.as_tensor(u.atoms.positions[None])
    for fn in (F.fused_model_forward, F.fused_cv_forces):
        # the blocked formulation serves any system, alanine included, and
        # has no pair operand to take for a model without coordination
        with pytest.raises(ValueError, match="c_mat"):
            fn(model, x, mode="blocked", c_mat=np.zeros((2, 2)))
        with pytest.raises(ValueError, match="c_mat"):
            fn(model, x, c_mat=np.zeros((2, 2)))
        with pytest.raises(ValueError, match="mode"):
            fn(model, x, mode="fast")
        with pytest.raises(ValueError, match="precision"):
            fn(model, x, precision="fp8")
        with pytest.raises(TypeError):
            fn(object(), x)
    with pytest.raises(ValueError, match="compact_grads"):
        F.fused_cv_forces(model, x, compact_grads=True)
    with pytest.raises(ValueError, match="frames"):
        F.fused_cv_forces(model, x[:, :5])

    # a coordination feature inside the envelope is served, past its 96
    # pairs only the blocked formulation takes it
    coord, u = _coordination_model()
    xc = torch.as_tensor(u.atoms.positions[None])
    y, g = F.fused_cv_forces(coord, xc)
    np.testing.assert_allclose(y.numpy(), coord(xc).numpy(), atol=VAL_ATOL)
    assert g.shape == xc.shape and g.abs().max() > 0
    many = FeatureLayer([Feature("c", "coordination", u.atoms, r0=3.0)],
                        u.atoms)  # 22 * 21 / 2 = 231 pairs
    assert F.model_select_mode(many) == "blocked"
    with pytest.raises(ValueError, match="coordination pairs"):
        F.fused_cv_forces(many, xc, mode="unrolled")
    big, u = _big_model()
    xb = torch.as_tensor(u.atoms.positions[None], dtype=torch.float32)
    for mode in ("auto", "blocked"):  # 70 atoms: auto selects blocked
        np.testing.assert_allclose(
            F.fused_model_forward(big, xb, mode=mode).numpy(),
            big(xb).numpy(), atol=VAL_ATOL)
    with pytest.raises(ValueError, match="envelope"):
        F.fused_model_forward(big, torch.as_tensor(u.atoms.positions[None]),
                              mode="unrolled")

    # every activation of the reference is served (tests/
    # test_torch_port_activations.py holds them against the JAX package);
    # a head past the unrolled kernels' caps goes to the blocked family
    # under "auto" and raises under "unrolled"; the blocked kernels take a
    # head of any depth
    pp = model.preprocessing_layer
    gen = torch.Generator().manual_seed(2)
    for head, auto in (
            (create_sequential_nn([38, 5, 3], "gelu", generator=gen),
             "unrolled"),
            (create_sequential_nn([38, 65, 3], generator=gen), "blocked"),
            (create_sequential_nn([38, 4, 4, 4, 4, 3], generator=gen),
             "blocked")):
        m = MolANN(pp, head)
        assert F.model_select_mode(m) == auto
        xg = x.clone().requires_grad_(True)
        y_ref = m(xg)
        (g_ref,) = torch.autograd.grad(y_ref.sum(), xg)
        y, g = F.fused_cv_forces(m, x)
        np.testing.assert_allclose(y.numpy(), y_ref.detach().numpy(),
                                   atol=VAL_ATOL)
        _close_grads(g, g_ref)
        if auto == "blocked":
            with pytest.raises(ValueError, match="mode='blocked'"):
                F.fused_cv_forces(m, x, mode="unrolled")
    deep = MolANN(pp, create_sequential_nn([38] + [4] * 9, generator=gen))
    assert F.model_select_mode(deep) == "blocked"
    xg = x.clone().requires_grad_(True)
    y_ref = deep(xg)
    (g_ref,) = torch.autograd.grad(y_ref.sum(), xg)
    for mode in ("auto", "blocked"):
        y, g = F.fused_cv_forces(deep, x, mode=mode)
        np.testing.assert_allclose(y.numpy(), y_ref.detach().numpy(),
                                   atol=VAL_ATOL)
        _close_grads(g, g_ref)
    with pytest.raises(ValueError, match="mode='blocked'"):
        F.fused_cv_forces(deep, x, mode="unrolled")


def test_launch_counters_stay_zero_on_cpu(setup):
    _, tm, x, _ = setup
    for k in F.KERNEL_LAUNCHES:
        F.KERNEL_LAUNCHES[k] = 0
    xt = torch.from_numpy(x)
    F.fused_model_forward(tm, xt)
    F.fused_cv_forces(tm, xt)
    F.fused_cv_forces(PreprocessingANN(None, tm.preprocessing_layer
                                       .feature_layer), xt)
    assert F.KERNEL_LAUNCHES == dict.fromkeys(F.KERNEL_LAUNCHES, 0)


def test_select_mode_matches_jax(setup):
    jm, tm, _, _ = setup
    spec = tm.preprocessing_layer.feature_layer.spec
    assert F.select_mode(spec, N) == JF.select_mode(spec, N) == "unrolled"
    big, _ = _big_model()
    assert F.select_mode(big.spec, 70) == "blocked"
    for p in ("auto", "exact", "tf32", "bf16"):
        for training in (False, True):
            assert F.resolve_precision(p, training=training) == \
                JF.resolve_precision(p, training=training)

