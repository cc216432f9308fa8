"""The port's serving over a data mesh against the JAX package.

Two gloo ranks on the CPU (``tests/torch_mesh_worker.py``, started once for
the file) run ``make_serving_fn(mesh)`` and ``evaluate_trajectory(mesh=)``
on the alanine model and on ``lj_fluid_model(4)`` with its pair operand
(``c_mat``, built on each rank from the same model): 100 and 40 noisy frames
from a numpy seed, batches that leave a padded tail, the outputs gathered
on every rank or written by each rank into shared memmaps with
``grads_transform=np.negative``. Weights are made by JAX and carried across
by ``.npz``; JAX's ``evaluate_trajectory`` on one device and on
``data_mesh(2)`` (the conftest's virtual devices, its CPU path) is the
reference. Tolerances: values 1e-5, coordinate gradients
5e-5·max(1, max|g|). Both ranks return the same bits. The commands
``evaluate``, ``forces`` and ``committee`` with ``--devices 2 --device cpu``
give ``--devices 1``'s files at the same tolerances.
"""

import jax
import numpy as np
import pytest

from molann_tpu.io import save_model as jsave_model
from molann_tpu.parallel import data_mesh as jdata_mesh
from molann_tpu.serve import evaluate_trajectory as jevaluate
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.systems import lj_fluid_model as jlj_fluid_model
from molann_tpu_torch.cli import main
from torch_mesh_worker import Ranks, load

VAL = 1e-5
GRAD = 5e-5
MODELS = ("alanine", "fluid")
FRAMES = {"alanine": 100, "fluid": 40}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("mesh_serve")
    jm, u = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(3))
    jf, fu, _ = jlj_fluid_model(4, key=jax.random.PRNGKey(1))
    rng = np.random.default_rng(12)
    models = {}
    for name, model, uu in (("alanine", jm, u), ("fluid", jf, fu)):
        jsave_model(str(d / f"{name}.npz"), model)
        x = (uu.atoms.positions[None] + 0.05 * rng.normal(
            size=(FRAMES[name], uu.atoms.n_atoms, 3))).astype(np.float32)
        np.save(d / f"{name}_traj.npy", x)
        models[name] = model
    jsave_model(str(d / "member1.npz"),
                jalanine_model(hidden_dims=(8, 2),
                               key=jax.random.PRNGKey(4))[0])
    ranks = Ranks("serve", d)
    yield dict(d=d, models=models, ranks=ranks)
    ranks.close()


def _out(s, name, rank=0):
    s["ranks"].wait()
    return load(s["d"], f"serve_{name}", rank)


@pytest.fixture(scope="module")
def jax_refs(setup):
    """JAX's values and gradients of every frame, one device and mesh."""
    out = {}
    for name, model in setup["models"].items():
        path = str(setup["d"] / f"{name}_traj.npy")
        for ref, mesh in (("one_device", None), ("data_mesh2",
                                                 jdata_mesh(2))):
            out[name, ref] = jevaluate(model, path, mesh=mesh, forces=True,
                                       batch_size=32, backend="numpy")
    return out


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=0,
                               atol=tol)


def _grad_tol(g):
    return GRAD * max(1.0, float(np.abs(g).max()))


@pytest.mark.parametrize("name", MODELS)
def test_serving_fn_gives_each_rank_its_rows(setup, jax_refs, name):
    """``make_serving_fn(mesh)`` returns each rank's contiguous rows of a
    32-frame batch, with and without forces, and no collective."""
    cvs, grads = jax_refs[name, "one_device"]
    for rank in (0, 1):
        got = _out(setup, name, rank)
        rows = slice(16 * rank, 16 * (rank + 1))
        _close(got["y_fn"], cvs[rows], VAL)
        _close(got["y_only"], cvs[rows], VAL)
        _close(got["g_fn"], grads[rows], _grad_tol(grads))


@pytest.mark.parametrize("reference", ["one_device", "data_mesh2"])
@pytest.mark.parametrize("name", MODELS)
def test_evaluate_trajectory_matches_jax(setup, jax_refs, name, reference):
    """``evaluate_trajectory(mesh=)`` on two ranks: the gathered arrays (a
    tail padded with its batch's last frame, on the rank past the end too)
    and the memmaps each rank wrote its rows of (forces by
    ``grads_transform``) are JAX's on one device and on ``data_mesh(2)``."""
    cvs, grads = jax_refs[name, reference]
    got = _out(setup, name)
    assert got["cvs"].shape == cvs.shape and got["grads"].shape == grads.shape
    for key in ("cvs", "cvs_only", "y_mm"):
        _close(got[key], cvs, VAL)
    _close(got["grads"], grads, _grad_tol(grads))
    _close(got["g_mm"], -grads, _grad_tol(grads))


@pytest.mark.parametrize("name", MODELS)
def test_ranks_return_the_same_bits(setup, name):
    """Every rank returns the whole gathered arrays, bit for bit, and sees
    the whole memmaps once the ranks have written them."""
    a, b = _out(setup, name, 0), _out(setup, name, 1)
    for key in ("cvs", "grads", "cvs_only", "y_mm", "g_mm"):
        np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def _read(paths):
    return [np.load(p) for p in paths]


@pytest.mark.parametrize("command", ["evaluate", "forces", "committee"])
def test_commands_on_two_ranks(setup, tmp_path, capfd, command):
    """``--devices 2 --device cpu`` starts two gloo ranks that write their
    rows of the same ``.npy`` files; rank 0 prints; the files are
    ``--devices 1``'s."""
    d = setup["d"]
    files = {}
    for n in (1, 2):
        outs = [tmp_path / f"{k}{n}.npy" for k in ("a", "b")]
        if command == "committee":
            argv = ["committee", str(d / "alanine.npz"),
                    str(d / "member1.npz"), str(d / "alanine_traj.npy"),
                    "--batch-size", "30", "--out", str(outs[0]),
                    "--std-out", str(outs[1])]
        else:
            argv = [command, str(d / "fluid.npz"), str(d / "fluid_traj.npy"),
                    "--batch-size", "16", "--out", str(outs[0])]
            if command == "forces":
                argv += ["--forces-out", str(outs[1])]
            else:
                outs = outs[:1]
        assert main([*argv, "--devices", str(n), "--device", "cpu"]) == 0
        printed = capfd.readouterr().out
        assert printed.count("wrote") == (1 if command == "evaluate" else
                                          1 + (command == "forces"))
        if command != "committee":
            assert f"({n} devices)" in printed
        files[n] = _read(outs)
    for one, two in zip(files[1], files[2]):
        assert one.shape == two.shape
        _close(two, one, _grad_tol(one) if one.shape[1] > 3 else VAL)
