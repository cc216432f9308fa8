"""``molann_tpu_torch.parallel`` against ``molann_tpu.parallel``.

Two gloo ranks on the CPU (``tests/torch_mesh_worker.py``) shard a batch,
slice it by process, assemble it from process-local rows, and run
``make_data_parallel_fn`` with each reduction and ``psum_mean_grads``:
held to JAX's functions on ``data_mesh(2)`` (the conftest's virtual
devices) and to the one-device values, at 1e-5 for values and
5e-5·max(1, max|g|) for gradients; the row gather is exact, signed zeros
included. A process group of one rank (gloo, so that the collectives run)
gives, for every ``mesh=`` entry point, the bits of the same call without
a mesh. Without a process group, ``data_mesh`` is a mesh of one and a mesh
of more raises, naming how to start ranks.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.io import save_model as jsave_model
from molann_tpu.parallel import data_mesh as jdata_mesh
from molann_tpu.parallel import make_data_parallel_fn as jmake_dp_fn
from molann_tpu.parallel import shard_batch as jshard_batch
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.train import mse_loss as jmse_loss
from molann_tpu_torch.parallel import (batch_sharding, data_mesh,
                                       global_batch, process_local_slice,
                                       replicated_sharding, shard_batch)
from torch_mesh_worker import REPO, Ranks, load

L = 64
VAL = 1e-5
GRAD = 5e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    jm, u = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(3))
    jsave_model(str(d / "model.npz"), jm)
    rng = np.random.default_rng(13)
    x = (u.atoms.positions[None]
         + 0.05 * rng.normal(size=(L, 22, 3))).astype(np.float32)
    y = rng.normal(size=(L, 2)).astype(np.float32)
    w = rng.uniform(0.5, 2.0, L).astype(np.float32)
    for k, v in (("x", x), ("y", y), ("w", w)):
        np.save(d / f"{k}.npy", v)
    one = d / "one"
    one.mkdir()
    for k in ("x", "y", "w"):
        (one / f"{k}.npy").write_bytes((d / f"{k}.npy").read_bytes())
    (one / "model.npz").write_bytes((d / "model.npz").read_bytes())
    s = dict(d=d, jm=jm, x=x, y=y, ranks=Ranks("parallel", d), one=one,
             ranks_one=Ranks("one", one, world=1))
    yield s
    s["ranks"].close()
    s["ranks_one"].close()


def _out(s, rank):
    s["ranks"].wait()
    return load(s["d"], "parallel", rank)


def test_shard_batch_and_process_slices(setup):
    """Each rank holds its contiguous half of every leaf, the slice
    ``process_local_slice`` names; a batch or a total that does not divide,
    and a mesh larger than the world, raise JAX's ``ValueError``s."""
    x, y = setup["x"], setup["y"]
    for rank in (0, 1):
        got = _out(setup, rank)
        lo, hi = 32 * rank, 32 * (rank + 1)
        np.testing.assert_array_equal(got["lohi"], [lo, hi])
        np.testing.assert_array_equal(got["xs"], x[lo:hi])
        np.testing.assert_array_equal(got["ys"], y[lo:hi])
        # global_batch: the process's rows on its device, as given
        np.testing.assert_array_equal(got["local_x"], x[lo:hi])
        np.testing.assert_array_equal(got["local_y"], y[lo:hi])
        slice_err, mesh_err, shard_err = got["errors"]
        assert "does not divide over 2 processes" in slice_err
        assert "requested 3 devices, only 2 available" in mesh_err
        assert "does not divide over a mesh of 2" in shard_err


def test_global_batch_is_shard_batch_on_one_process(setup):
    """With one process, ``global_batch`` is ``shard_batch`` (the property
    tests/test_multihost.py holds JAX's to), and ``process_local_slice`` is
    the whole range."""
    mesh = data_mesh(devices="cpu")
    batch = (setup["x"], setup["y"])
    for a, b in zip(global_batch(batch, mesh), shard_batch(batch, mesh)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert process_local_slice(L) == (0, L)
    np.testing.assert_array_equal(
        batch_sharding(mesh)(setup["x"]).numpy(), setup["x"])
    assert replicated_sharding(mesh) == torch.device("cpu")


@pytest.mark.parametrize("reduce", ["mean", "sum", "none"])
def test_data_parallel_fn_matches_jax(setup, reduce):
    """``make_data_parallel_fn``: the mean and the sum of the ranks' MSE
    losses, and the ranks' model outputs stacked in rank order, are JAX's
    ``shard_map`` function's on ``data_mesh(2)``; the mean is also the
    one-device loss."""
    jm, x, y = setup["jm"], jnp.asarray(setup["x"]), jnp.asarray(setup["y"])
    mesh = jdata_mesh(2)
    batch = jshard_batch((x, y), mesh)
    if reduce == "none":
        want = jmake_dp_fn(lambda m, b: m(b[0]), mesh,
                           reduce_output=None)(jm, batch)
        key = "stacked"
    else:
        want = jmake_dp_fn(jmse_loss, mesh, reduce_output=reduce)(jm, batch)
        key = "mean" if reduce == "mean" else "total"
    for rank in (0, 1):
        np.testing.assert_allclose(_out(setup, rank)[key], np.asarray(want),
                                   rtol=VAL, atol=VAL)
    if reduce == "mean":
        np.testing.assert_allclose(_out(setup, 0)["mean"],
                                   float(jmse_loss(jm, (x, y))), rtol=VAL,
                                   atol=VAL)


def test_psum_mean_grads_matches_jax(setup):
    """Per-shard MSE gradients averaged over the ranks, through
    ``make_data_parallel_fn`` and through ``psum_mean_grads`` by hand, are
    JAX's ``shard_map`` gradients on ``data_mesh(2)`` and the one-device
    gradient."""
    jm, x, y = setup["jm"], jnp.asarray(setup["x"]), jnp.asarray(setup["y"])
    mesh = jdata_mesh(2)
    g_dp = jmake_dp_fn(jax.grad(jmse_loss), mesh)(
        jm, jshard_batch((x, y), mesh))
    g_1d = jax.jit(jax.grad(jmse_loss))(jm, (x, y))
    for rank in (0, 1):
        got = _out(setup, rank)
        for want in (g_dp, g_1d):
            for i, (gw, gb) in enumerate(want.ann_layers.params):
                for pre in ("g:", "h:"):
                    gw_t = np.asarray(gw).T
                    tol = GRAD * max(1.0, float(np.abs(gw_t).max()))
                    np.testing.assert_allclose(
                        got[f"{pre}ann_layers.layers.{i}.weight"], gw_t,
                        rtol=0, atol=tol)
                    np.testing.assert_allclose(
                        got[f"{pre}ann_layers.layers.{i}.bias"],
                        np.asarray(gb).reshape(-1), rtol=0, atol=tol)


def test_row_gather_is_exact(setup):
    """The gather is an all-reduce over a buffer of ``-0.0``: signed zeros
    and infinities come through bit for bit, every rank's rows in rank
    order."""
    want = np.array([[-0.0, 0.0, np.inf]] * 2, np.float32)
    for rank in (0, 1):
        got = _out(setup, rank)["zeros"]
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))


def test_mesh_of_one_rank_takes_the_plain_call(setup):
    """A process group of one rank, whose collectives run: the
    data-parallel training step (eigenfunction), the fused step, ``fit``
    and ``evaluate_trajectory`` give the bits of the same calls without a
    mesh."""
    setup["ranks_one"].wait()
    got = load(setup["one"], "one", 0)
    keys = {k.split(":", 1)[1] for k in got}
    assert {"losses", "fit", "cvs", "grads"} <= keys
    for k in keys:
        np.testing.assert_array_equal(got[f"mesh:{k}"], got[f"plain:{k}"],
                                      err_msg=k)


def test_data_mesh_without_a_process_group():
    """No process group: a mesh of one on the asked device, with JAX's
    ``shape`` and no collectives; more devices raise, naming
    ``initialize_multihost`` and the CLI's ``--devices``; a mesh that is
    not a ``DataMesh`` is refused by the entry points."""
    from molann_tpu_torch.serve import evaluate_trajectory
    from molann_tpu_torch.train import make_train_step, mse_loss

    mesh = data_mesh(devices="cpu")
    assert (mesh.size, mesh.rank, mesh.group) == (1, 0, None)
    assert mesh.shape == {"data": 1}
    assert data_mesh(1, devices="cpu") == mesh
    with pytest.raises(ValueError, match="initialize_multihost.*--devices"):
        data_mesh(2, devices="cpu")
    with pytest.raises(ValueError, match="one axis"):
        shard_batch(np.zeros((4, 2)), mesh, axis="model")
    with pytest.raises(TypeError, match="data_mesh"):
        make_train_step(mse_loss, mesh=object())
    with pytest.raises(TypeError, match="data_mesh"):
        evaluate_trajectory(None, np.zeros((4, 22, 3), np.float32),
                            mesh=object())


def test_initialize_multihost_forms_a_world_of_one(tmp_path):
    """With no address, count or rank given, ``initialize_multihost``
    forms a world of one on a free localhost port (gloo here, NCCL on a
    card), and ``data_mesh`` spans it with collectives; torchrun's
    variables name the world."""
    code = (
        "import torch.distributed as dist\n"
        "from molann_tpu_torch.parallel import data_mesh, "
        "initialize_multihost\n"
        "initialize_multihost()\n"
        "m = data_mesh()\n"
        "print(dist.get_backend(), dist.get_world_size(), m.size, m.rank, "
        "m.device, m.group is not None)\n"
        "dist.destroy_process_group()\n")
    from molann_tpu_torch.parallel.multihost import free_port

    env_sets = ({}, {"MASTER_ADDR": "localhost",
                     "MASTER_PORT": str(free_port()), "WORLD_SIZE": "1",
                     "RANK": "0"})
    for extra in env_sets:
        env = {k: v for k, v in __import__("os").environ.items()
               if not k.startswith(("JAX_", "MASTER_", "WORLD_", "RANK"))}
        env.update(PYTHONPATH=str(REPO), **extra)
        proc = subprocess.run([sys.executable, "-c", code], env=env,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.split() == ["gloo", "1", "1", "0", "cpu", "True"]
