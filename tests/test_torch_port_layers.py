"""Eager layers of the PyTorch port against the JAX package.

Each JAX model is saved with ``molann_tpu.io.save_model`` and loaded into
the port with ``molann_tpu_torch.io.load_model`` (torch's RNG cannot
reproduce ``jax.random``), then both evaluate the same numpy frames.
Tolerances: values 1e-5 abs; coordinate gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52).
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.ann import MolANN as JMolANN
from molann_tpu.ann import create_sequential_nn as jcreate
from molann_tpu.io import save_model
from molann_tpu.io.serialize import ACTIVATIONS as JACTIVATIONS
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train.forces import coordinate_gradients as jgrad
from molann_tpu_torch.io import load_model, model_from_arrays
from molann_tpu_torch.models.ann import MolANN, model_dims
from molann_tpu_torch.train.forces import coordinate_gradients as tgrad
from molann_tpu_torch.train.forces import force_fn

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4


def _jax_model(case):
    if case == "alanine":
        return jalanine_model()
    if case == "no_position":
        return jalanine_model(include_position=False)
    if case == "angle_value":
        return jalanine_model(use_angle_value=True)
    if case in ("svd", "eigh"):
        return jalanine_model(method=case)
    model, u = jalanine_model()
    pp = model.preprocessing_layer
    if case == "feature_layer":
        return pp.feature_layer, u
    if case == "coordination":
        from molann_tpu.ann import FeatureLayer as JFeatureLayer
        from molann_tpu.feature import Feature as JFeature

        sel = u.select_atoms
        feats = [
            JFeature("c1", "coordination", sel("bynum 2 5"),
                     group_b=sel("bynum 15 17"), r0=3.0),
            JFeature("c2", "coordination", sel("bynum 1 2 5 6 7"), r0=2.0,
                     nn=4, mm=10, pbc_box=[6.0, 7.0, 8.0], d_max=3.5),
            JFeature("b1", "bond", sel("bynum 2 5")),
        ]
        return JFeatureLayer(feats, u.atoms), u
    import jax

    act = {"tanh": JACTIVATIONS["tanh"],
           "identity": JACTIVATIONS["identity"]}[case]
    nn = jcreate([pp.output_dimension(), 7, 4, 2], activation=act,
                 key=jax.random.PRNGKey(11))
    return JMolANN(pp, nn), u


CASES = ["alanine", "no_position", "angle_value", "feature_layer", "tanh",
         "identity", "coordination", "svd", "eigh"]


@pytest.mark.parametrize("case", CASES)
def test_eager_model_matches_jax(case, tmp_path):
    jm, u = _jax_model(case)
    path = save_model(str(tmp_path / "m.npz"), jm)
    tm = load_model(path)
    rng = np.random.default_rng(CASES.index(case))
    x = (u.atoms.positions[None]
         + 0.1 * rng.normal(size=(16, 22, 3))).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)

    y_j = np.asarray(jm(xj))
    with torch.no_grad():
        y_t = tm(xt).numpy()
    np.testing.assert_allclose(y_t, y_j, atol=VAL_ATOL)
    assert model_dims(tm) == (22, y_j.shape[1])

    for comp in (None, 0):
        g_j = np.asarray(jgrad(jm, xj, comp))
        g_t = tgrad(tm, xt, comp).numpy()
        scale = max(1.0, float(np.abs(g_j).max()))
        np.testing.assert_allclose(g_t, g_j, atol=GRAD_RTOL * scale)
    np.testing.assert_array_equal(force_fn(tm, 0)(xt).numpy(),
                                  -tgrad(tm, xt, 0).numpy())


def test_model_from_arrays_in_memory(tmp_path):
    jm, u = jalanine_model()
    path = save_model(str(tmp_path / "m.npz"), jm)
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    tm = model_from_arrays(meta["model"], arrays)
    assert isinstance(tm, MolANN)
    lin = tm.ann_layers.layers[0]
    np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                  np.asarray(jm.ann_layers.params[0][0]).T)
    np.testing.assert_array_equal(
        tm.preprocessing_layer.align_layer.ref_x.numpy(),
        np.asarray(jm.preprocessing_layer.align_layer.ref_x))
    assert [n for n, _ in tm.named_buffers()] == [
        "preprocessing_layer.align_layer.ref_x"]
