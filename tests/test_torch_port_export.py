"""Persistence and export of the port against the JAX package.

- ``export_torchscript``: the port's ``.pt`` and the JAX package's from the
  same ``.npz`` weights have the same module tree, class names and
  attributes (mirroring ``tests/test_torch_export.py``), and the same
  values and coordinate gradients through ``torch.jit.load``.
- ``load_torchscript``: the JAX package's exports and reference-layout
  fixture archives (``tests/torchscript_fixture.py``) import to the model
  the JAX import gives (the same ``.npz`` structure and arrays); port
  export -> JAX import and JAX export -> port import give back the arrays.
- ``export_artifact(fused=False)`` against ``export_stablehlo`` run
  through ``load_stablehlo`` on the CPU, with and without the gradient.
- The ``export``, ``export-torch`` and ``import-torch`` commands against
  the JAX commands' files, lines and exit codes, and ``export``'s two
  refusals.

Tolerances: values 1e-5 abs; coordinate gradients 5e-5·max(1, max|g|)
(the reference layout aligns by SVD, the port and JAX models by QCP; sums
run in each framework's order); arrays that are copied, exactly. Frames
come from numpy seeds around the fixture's positions; random models use
fixed seeds and align on at least four atoms (well-conditioned Kabsch).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torchscript_fixture as tsf
from molann_tpu.cli import main as jmain
from molann_tpu.io import load_model as jload_model
from molann_tpu.io import save_model as jsave_model
from molann_tpu.io.export import export_stablehlo, load_stablehlo
from molann_tpu.io.torch_export import export_torchscript as jexport
from molann_tpu.io.torch_import import load_torchscript as jimport
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu_torch.cli import main
from molann_tpu_torch.feature import Feature
from molann_tpu_torch.io import (
    export_artifact,
    export_torchscript,
    load_artifact,
    load_model,
    load_torchscript,
    save_model,
)
from molann_tpu_torch.io.export import artifact_info
from molann_tpu_torch.io.torch_import import _input_group
from molann_tpu_torch.models.ann import (
    AlignmentLayer,
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
)
from molann_tpu_torch.systems import alanine_universe, lj_fluid_model

VAL_TOL = 1e-5
GRAD_RTOL = 5e-5
N = 22

# attributes of each reference-layout class, as the reference keeps them
ATTRS = {
    "FeatureMap": ("type_id", "use_angle_value", "input_atom_indices",
                   "input_atom_num", "_local_atom_indices"),
    "FeatureLayer": ("input_atom_num",),
    "AlignmentLayer": ("align_atom_indices", "input_atom_indices",
                       "input_atom_num", "_local_align_atom_indices"),
}


@pytest.fixture(scope="module")
def u():
    return alanine_universe()


@pytest.fixture(scope="module")
def frames(u):
    rng = np.random.default_rng(11)
    return (u.atoms.positions[None]
            + 0.05 * rng.normal(size=(24, N, 3))).astype(np.float32)


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The JAX alanine model and the port's, from one .npz."""
    d = tmp_path_factory.mktemp("export")
    jm, _ = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(4))
    jsave_model(str(d / "model.npz"), jm)
    return d, jm, load_model(d / "model.npz", device="cpu")


def _values_and_grads(module, frames):
    x = torch.tensor(frames, requires_grad=True)
    y = module(x)
    (g,) = torch.autograd.grad(y.sum(), x)
    return y.detach().numpy(), g.numpy()


def _assert_close(y, g, y_ref, g_ref):
    np.testing.assert_allclose(y, y_ref, atol=VAL_TOL)
    tol = GRAD_RTOL * max(1.0, float(np.abs(g_ref).max()))
    np.testing.assert_allclose(g, g_ref, atol=tol)


def _tree(module, prefix=""):
    """``[(name, class, {attribute: value})]`` of a scripted module tree."""
    name = getattr(module, "original_name", type(module).__name__)
    attrs = {a: getattr(module, a) for a in ATTRS.get(name, ())}
    if name == "AlignmentLayer":
        attrs["ref_x"] = module.ref_x.numpy().tolist()
    if name == "Linear":
        attrs = {"weight": module.weight.detach().numpy().tolist(),
                 "bias": module.bias.detach().numpy().tolist()}
    out = [(prefix, name, attrs)]
    for child_name, child in module.named_children():
        out += _tree(child, f"{prefix}.{child_name}")
    return out


def _layers(model):
    pp = model.preprocessing_layer
    return {"model": model, "pp": pp, "feature_layer": pp.feature_layer,
            "align": pp.align_layer, "ann_layers": model.ann_layers}


@pytest.mark.parametrize("which", ["model", "pp", "feature_layer", "align",
                                   "ann_layers"])
def test_export_matches_the_jax_export(pair, frames, which, tmp_path):
    d, jm, pm = pair
    jexport(_layers(jm)[which], tmp_path / "jax.pt")
    export_torchscript(_layers(pm)[which], tmp_path / "port.pt")
    jt = torch.jit.load(str(tmp_path / "jax.pt"))
    pt = torch.jit.load(str(tmp_path / "port.pt"))
    assert _tree(pt) == _tree(jt)
    x = frames
    if which == "ann_layers":
        x = pm.preprocessing_layer(torch.tensor(frames)).detach().numpy()
    y, g = _values_and_grads(pt, x)
    _assert_close(y, g, *_values_and_grads(jt, x))


def test_exported_model_matches_the_port_model(pair, frames, tmp_path):
    """The reference layout's SVD alignment against the port's QCP."""
    _, _, pm = pair
    pt = export_torchscript(pm)
    xx = torch.tensor(frames, requires_grad=True)
    y = pm(xx)
    (g,) = torch.autograd.grad(y.sum(), xx)
    _assert_close(*_values_and_grads(pt, frames), y.detach().numpy(),
                  g.numpy())


def test_coordination_features_are_refused():
    model, _, _ = lj_fluid_model(3, device="cpu")
    with pytest.raises(ValueError, match="coordination"):
        export_torchscript(model)
    with pytest.raises(ValueError, match="coordination"):
        export_torchscript(model.preprocessing_layer.feature_layer
                           .feature_map_list[0])


def _npz_contents(path):
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    return meta, arrays


def _same_npz(a, b):
    ma, aa = _npz_contents(a)
    mb, ab = _npz_contents(b)
    assert ma == mb
    assert aa.keys() == ab.keys()
    for k in aa:
        np.testing.assert_array_equal(aa[k], ab[k], err_msg=k)


def _sources(u, pair, tmp_path):
    """Reference-layout archives: the JAX package's exports and the
    fixture's modules."""
    _, jm, _ = pair
    jexport(jm, tmp_path / "jax_model.pt")
    jexport(jm.preprocessing_layer.feature_layer, tmp_path / "jax_fl.pt")
    out = {"jax_model": tmp_path / "jax_model.pt",
           "jax_feature_layer": tmp_path / "jax_fl.pt"}
    ix = list(range(N))
    fixtures = {
        "molann": tsf.alanine_reference_model(u),
        "molann_angles": tsf.alanine_reference_model(u, use_angle_value=True),
        "no_alignment": tsf.alanine_reference_model(u, with_alignment=False),
        "feature_layer": tsf.FeatureLayer(
            [tsf.FeatureMap(1, [1, 4], ix), tsf.FeatureMap(3, [5, 3, 0], ix),
             tsf.FeatureMap(2, [4, 6, 8, 14], ix)], N),
        "alignment": tsf.AlignmentLayer(u.atoms.positions[[0, 1, 4]],
                                        [0, 1, 4], ix),
        "feature_map": tsf.FeatureMap(0, [19, 18, 20], ix,
                                      use_angle_value=True),
        "sequential": tsf.sequential_mlp([4, 8, 3], seed=5),
        "relu": tsf.sequential_mlp([3, 6, 2], activation=torch.nn.ReLU()),
        "subset": tsf.FeatureLayer(
            [tsf.FeatureMap(2, [0, 1, 2, 3], [4, 6, 8, 14, 1])], 5),
    }
    for name, module in fixtures.items():
        torch.jit.script(module).save(str(tmp_path / f"{name}.pt"))
        out[name] = tmp_path / f"{name}.pt"
    return out


def test_import_matches_the_jax_import(u, pair, frames, tmp_path):
    for name, path in _sources(u, pair, tmp_path).items():
        pm = load_torchscript(path, device="cpu")
        jm = jimport(str(path))
        if name == "feature_map":  # no .npz form: its feature and flags
            assert (pm.type_id, pm.use_angle_value, pm.input_atom_num) == (
                jm.type_id, jm.use_angle_value, jm.input_atom_num)
            np.testing.assert_array_equal(pm.feature.get_atom_indices(),
                                          jm.feature.get_atom_indices())
            y = pm(torch.tensor(frames)).numpy()
            np.testing.assert_allclose(y, np.asarray(jm(jnp.asarray(frames))),
                                       atol=VAL_TOL)
            continue
        save_model(tmp_path / f"{name}_port.npz", pm)
        jsave_model(str(tmp_path / f"{name}_jax.npz"), jm)
        _same_npz(tmp_path / f"{name}_port.npz", tmp_path / f"{name}_jax.npz")
        if name in ("sequential", "relu", "subset"):
            continue
        xx = torch.tensor(frames, requires_grad=True)
        y = pm(xx)
        (g,) = torch.autograd.grad(y.sum(), xx)
        xj = jnp.asarray(frames)
        _assert_close(y.detach().numpy(), g.numpy(), np.asarray(jm(xj)),
                      np.asarray(jax.grad(lambda v: jnp.sum(jm(v)))(xj)))


def test_round_trips_between_the_packages(pair, tmp_path):
    d, jm, pm = pair
    # port export -> JAX import, JAX export -> port import
    export_torchscript(pm, tmp_path / "port.pt")
    jsave_model(str(tmp_path / "via_jax.npz"), jimport(str(tmp_path /
                                                           "port.pt")))
    jexport(jm, tmp_path / "jax.pt")
    save_model(tmp_path / "via_port.npz",
               load_torchscript(tmp_path / "jax.pt", device="cpu"))
    _same_npz(tmp_path / "via_jax.npz", tmp_path / "via_port.npz")
    back = load_model(tmp_path / "via_port.npz", device="cpu")
    # the weights and index tables come back as they were; ref_x up to the
    # one float32 rounding of centring an already centred buffer
    for (name, a), (_, b) in zip(pm.named_parameters(),
                                 back.named_parameters()):
        assert torch.equal(a, b), name
    np.testing.assert_allclose(back.preprocessing_layer.align_layer.ref_x,
                               pm.preprocessing_layer.align_layer.ref_x,
                               atol=1e-6)
    assert back.preprocessing_layer.feature_layer.spec == \
        pm.preprocessing_layer.feature_layer.spec


def test_import_rules():
    class Stub:
        input_atom_num = 7

    np.testing.assert_array_equal(_input_group(Stub()).ix, np.arange(7))
    mixed = tsf.FeatureLayer(
        [tsf.FeatureMap(1, [1, 4], list(range(N)), use_angle_value=False),
         tsf.FeatureMap(0, [19, 18, 20], list(range(N)),
                        use_angle_value=True)], N)
    with pytest.raises(ValueError, match="use_angle_value"):
        load_torchscript(torch.jit.script(mixed), device="cpu")
    sub = torch.jit.script(tsf.FeatureLayer(
        [tsf.FeatureMap(2, [0, 1, 2, 3], [4, 6, 8, 14, 1])], 5))
    flayer = load_torchscript(sub, device="cpu")
    np.testing.assert_array_equal(flayer.get_feature(0).get_atom_indices(),
                                  [5, 7, 9, 15])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            load_torchscript(sub)


def _random_model(u, seed):
    """A port model with a random feature set, head and alignment of at
    least four atoms, from a numpy seed."""
    rng = np.random.default_rng(seed)

    def group(k):
        ids = rng.choice(N, size=k, replace=False) + 1
        g = u.select_atoms(f"bynum {ids[0]}")
        for i in ids[1:]:
            g = g + u.select_atoms(f"bynum {i}")
        return g

    feats = []
    for i in range(int(rng.integers(1, 5))):
        ftype = ["bond", "angle", "dihedral", "position"][rng.integers(4)]
        k = {"bond": 2, "angle": 3, "dihedral": 4}.get(
            ftype, int(rng.integers(1, 6)))
        feats.append(Feature(f"r{i}", ftype, group(k)))
    flayer = FeatureLayer(feats, u.atoms, bool(rng.integers(2)))
    align = (AlignmentLayer(group(int(rng.integers(4, 7))), u.atoms)
             if rng.integers(2) else None)
    pp = PreprocessingANN(align, flayer)
    hidden = [int(h) for h in rng.integers(2, 9, size=rng.integers(1, 4))]
    act = ["tanh", "relu", "sigmoid", "elu"][rng.integers(4)]
    return MolANN(pp, create_sequential_nn(
        [pp.output_dimension(), *hidden], act,
        generator=torch.Generator().manual_seed(seed)))


@pytest.mark.parametrize("seed", range(6))
def test_random_model_round_trips(u, seed, tmp_path):
    model = _random_model(u, seed)
    rng = np.random.default_rng(100 + seed)
    x = torch.tensor((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(8, N, 3))).astype(np.float32))
    export_torchscript(model, tmp_path / "m.pt")
    with torch.no_grad():
        want = model(x).numpy()
        got = torch.jit.load(str(tmp_path / "m.pt"))(x).numpy()
        back = load_torchscript(tmp_path / "m.pt", device="cpu")(x).numpy()
    np.testing.assert_allclose(got, want, atol=5 * VAL_TOL)
    np.testing.assert_allclose(back, want, atol=5 * VAL_TOL)


@pytest.mark.parametrize("with_gradient", [False, True])
@pytest.mark.parametrize("case", ["alanine", "fluid"])
def test_artifact_matches_export_stablehlo(pair, frames, tmp_path, case,
                                           with_gradient):
    d, jm, pm = pair
    x = frames
    if case == "fluid":
        pm, fu, _ = lj_fluid_model(3, device="cpu")
        save_model(tmp_path / "fluid.npz", pm)
        jm = jload_model(str(tmp_path / "fluid.npz"))
        rng = np.random.default_rng(12)
        x = (fu.atoms.positions[None] + 0.2 * rng.normal(
            size=(6,) + fu.atoms.positions.shape)).astype(np.float32)
    n = x.shape[1]
    want = load_stablehlo(export_stablehlo(jm, n,
                                           with_gradient=with_gradient))(
        jnp.asarray(x))
    blob = export_artifact(pm, n, tmp_path / "a.pt",
                           with_gradient=with_gradient, batch_size=len(x))
    assert (tmp_path / "a.pt").read_bytes() == blob
    assert artifact_info(blob)["mode"] is None
    art = load_artifact(tmp_path / "a.pt", device="cpu")
    got = art(torch.tensor(x))
    if with_gradient:
        _assert_close(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                      np.asarray(want[1]))
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=VAL_TOL)
    with pytest.raises(Exception, match="batch"):
        art(torch.tensor(x[:-1]))


@pytest.mark.parametrize("method,uav", [("svd", False), ("eigh", True)])
def test_artifact_of_other_rotations(tmp_path, frames, method, uav):
    from molann_tpu_torch.systems import alanine_model

    model, _ = alanine_model(method=method, use_angle_value=uav,
                             generator=torch.Generator().manual_seed(1),
                             device="cpu")
    y, g = load_artifact(export_artifact(model, N, with_gradient=True),
                         device="cpu")(torch.tensor(frames))
    xx = torch.tensor(frames, requires_grad=True)
    y_ref = model(xx)
    (g_ref,) = torch.autograd.grad(y_ref.sum(), xx)
    _assert_close(y.numpy(), g.numpy(), y_ref.detach().numpy(),
                  g_ref.numpy())


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------


def test_export_torch_command_matches_jax(pair, frames, tmp_path, capsys):
    d, _, _ = pair
    assert jmain(["export-torch", str(d / "model.npz"), "--out",
                  str(tmp_path / "j.pt")]) == 0
    jout = capsys.readouterr().out
    assert main(["export-torch", str(d / "model.npz"), "--out",
                 str(tmp_path / "p.pt"), "--device", "cpu"]) == 0
    pout = capsys.readouterr().out
    assert pout.replace("p.pt", "j.pt") == jout
    jt = torch.jit.load(str(tmp_path / "j.pt"))
    pt = torch.jit.load(str(tmp_path / "p.pt"))
    assert _tree(pt) == _tree(jt)
    _assert_close(*_values_and_grads(pt, frames),
                  *_values_and_grads(jt, frames))


def test_import_torch_command_matches_jax(u, tmp_path, capsys):
    pt = tmp_path / "ref.pt"
    torch.jit.script(tsf.alanine_reference_model(u)).save(str(pt))
    assert jmain(["import-torch", str(pt), "--out",
                  str(tmp_path / "j.npz")]) == 0
    jout = capsys.readouterr().out
    assert main(["import-torch", str(pt), "--out", str(tmp_path / "p.npz"),
                 "--device", "cpu"]) == 0
    pout = capsys.readouterr().out
    assert pout.replace("p.npz", "j.npz") == jout
    assert "imported MolANN" in pout and "dihedral" in pout
    _same_npz(tmp_path / "p.npz", tmp_path / "j.npz")


@pytest.mark.parametrize("with_gradient", [False, True])
def test_export_command_matches_jax(pair, frames, tmp_path, capsys,
                                    with_gradient):
    d, _, _ = pair
    flag = ["--with-gradient"] if with_gradient else []
    assert jmain(["export", str(d / "model.npz"), "--n-atoms", str(N),
                  "--out", str(tmp_path / "j.stablehlo"), *flag]) == 0
    jout = capsys.readouterr().out
    assert main(["export", str(d / "model.npz"), "--n-atoms", str(N),
                 "--out", str(tmp_path / "p.pt"), *flag, "--device",
                 "cpu"]) == 0
    pout = capsys.readouterr().out
    assert pout.replace("p.pt", "j.stablehlo") == jout
    want = load_stablehlo(str(tmp_path / "j.stablehlo"))(jnp.asarray(frames))
    got = load_artifact(tmp_path / "p.pt", device="cpu")(
        torch.tensor(frames))
    if with_gradient:
        _assert_close(got[0].numpy(), got[1].numpy(), np.asarray(want[0]),
                      np.asarray(want[1]))
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   atol=VAL_TOL)


def test_export_command_fused_and_refusals(pair, tmp_path, capsys):
    d, _, _ = pair
    assert main(["export", str(d / "model.npz"), "--n-atoms", str(N),
                 "--fused", "--with-gradient", "--out",
                 str(tmp_path / "f.pt"), "--device", "cpu"]) == 0
    assert capsys.readouterr().out == f"wrote {tmp_path / 'f.pt'}\n"
    info = artifact_info((tmp_path / "f.pt").read_bytes())
    assert info["fused"] and info["mode"] == "unrolled" and \
        info["batch_size"] == 0
    for flag in (["--raw-mlir"], ["--batch-sizes", "4096,1024"]):
        assert main(["export", str(d / "model.npz"), "--n-atoms", str(N),
                     *flag, "--device", "cpu"]) == 2
        err = capsys.readouterr().err
        assert err.count("\n") == 1 and "TorchScript artifact" in err
    fluid, _, _ = lj_fluid_model(5, device="cpu")
    save_model(tmp_path / "fluid.npz", fluid)
    assert main(["export", str(tmp_path / "fluid.npz"), "--n-atoms", "125",
                 "--fused", "--out", str(tmp_path / "fl.pt"), "--device",
                 "cpu"]) == 0
    assert "carries it as one buffer" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(["export", str(d / "model.npz"), "--n-atoms", str(N)])
