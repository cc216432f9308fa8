"""The port's trajectory serving on the CPU against the JAX package's.

``molann_tpu_torch.serve.evaluate_trajectory`` streams a ``.npy``
trajectory with a ragged tail into memory-mapped outputs, with
``grads_transform=np.negative``; the JAX ``evaluate_trajectory`` on its CPU
path (plain model + ``jax.grad``) is the reference. Tolerances: values
1e-5 abs; gradients 2e-4·max(1, max|g|) (tests/test_parity_torch.py:25,52).
"""

import numpy as np
import pytest
import torch

from molann_tpu.io import save_model
from molann_tpu.serve import evaluate_trajectory as jevaluate
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu_torch.io import load_model, open_frame_reader
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.serve import evaluate_trajectory

VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
N_FRAMES = 200  # three full batches of 64 and a ragged tail of 8


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    d = tmp_path_factory.mktemp("serve")
    jm, u = jalanine_model()
    tm = load_model(save_model(str(d / "m.npz"), jm))
    rng = np.random.default_rng(5)
    frames = (u.atoms.positions[None]
              + 0.05 * rng.normal(size=(N_FRAMES, 22, 3))).astype(np.float32)
    path = str(d / "traj.npy")
    np.save(path, frames)
    return jm, tm, frames, path, d


def test_forces_from_npy_into_memmaps(setup):
    jm, tm, frames, path, d = setup
    cvs_ref, forces_ref = jevaluate(jm, path, forces=True, batch_size=64,
                                    grads_transform=np.negative,
                                    backend="numpy")
    cvs_out = np.lib.format.open_memmap(str(d / "cvs.npy"), mode="w+",
                                        dtype=np.float32, shape=(N_FRAMES, 3))
    grads_out = np.lib.format.open_memmap(
        str(d / "forces.npy"), mode="w+", dtype=np.float32,
        shape=(N_FRAMES, 22, 3))
    for k in F.KERNEL_LAUNCHES:
        F.KERNEL_LAUNCHES[k] = 0
    cvs, forces = evaluate_trajectory(
        tm, path, device="cpu", forces=True, batch_size=64, cvs_out=cvs_out,
        grads_out=grads_out, grads_transform=np.negative)
    assert cvs is cvs_out and forces is grads_out
    assert F.KERNEL_LAUNCHES == {"forward": 0, "cv_forces": 0}
    np.testing.assert_allclose(np.asarray(cvs), cvs_ref, atol=VAL_ATOL)
    scale = max(1.0, float(np.abs(forces_ref).max()))
    np.testing.assert_allclose(np.asarray(forces), forces_ref,
                               atol=GRAD_RTOL * scale)
    assert tm.ann_layers.layers[0].weight.device.type == "cpu"


@pytest.mark.parametrize("n", [1, 7, 64, 129])
def test_values_only_tail_trimming(setup, n):
    jm, tm, frames, _, _ = setup
    sub = frames[:n]
    with torch.no_grad():
        y_ref = tm(torch.from_numpy(sub)).numpy()
    cvs = evaluate_trajectory(tm, sub, batch_size=64)
    assert cvs.shape == (n, 3)
    np.testing.assert_allclose(cvs, y_ref, atol=VAL_ATOL)


def test_component_and_packed_input(setup):
    jm, tm, frames, _, _ = setup
    packed = frames[:70].reshape(70, 66)
    cvs, grads = evaluate_trajectory(tm, packed, forces=True, component=-1)
    _, g_ref = jevaluate(jm, frames[:70], forces=True, component=2,
                         backend="numpy")
    assert grads.shape == (70, 22, 3)
    scale = max(1.0, float(np.abs(g_ref).max()))
    np.testing.assert_allclose(grads, g_ref, atol=GRAD_RTOL * scale)


def test_reader_formats(setup, tmp_path):
    _, _, frames, path, _ = setup
    read, n, a = open_frame_reader(path)
    assert (n, a) == (N_FRAMES, 22)
    chunk = read(190, 64)
    assert chunk.shape == (10, 22, 3) and chunk.flags.writeable
    np.testing.assert_array_equal(chunk, frames[190:])
    for ext in (".xtc", ".trr", ".dcd", ".nc"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            open_frame_reader(str(tmp_path / f"t{ext}"))
    with pytest.raises(ValueError, match="expected"):
        open_frame_reader(np.zeros((4, 5)))
