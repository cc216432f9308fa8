"""The CUDA kernels' per-frame math, run on the host.

``molann_tpu_torch/csrc/frame_math.cuh`` holds the forward and the
hand-derived adjoints (QCP alignment included) that the CUDA kernels run
per frame. Compiled here with the host C++ compiler into a small library
loaded by ctypes, it is checked against the plain PyTorch versions of the
kernels on 64 alanine frames — adjoint bugs show up before any GPU time is
spent. Tolerances: values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import alanine_model

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4

HOST_SRC = r"""
#include "frame_math.cuh"

extern "C" int host_abi(void) { return (int)sizeof(ModelArgs); }

extern "C" void host_forward(const ModelArgs* m, const float* x, float* y,
                             long long l) {
  const int n3 = 3 * m->n_atoms, d = model_out_dim(*m);
  for (long long f = 0; f < l; ++f) frame_forward(*m, x + f * n3, y + f * d);
}

extern "C" void host_cv_forces(const ModelArgs* m, const float* x, float* y,
                               float* gx, long long l, int component) {
  const int n3 = 3 * m->n_atoms, d = model_out_dim(*m);
  for (long long f = 0; f < l; ++f)
    frame_cv_forces(*m, x + f * n3, y + f * d, gx + f * n3, component);
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("frame_math")
    src, lib = d / "frame_math_host.cpp", d / "libframe_math_host.so"
    src.write_text(HOST_SRC)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-x", "c++", str(src), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(lib))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    h.host_abi.restype = ctypes.c_int
    h.host_forward.argtypes = [vp, vp, vp, i64]
    h.host_cv_forces.argtypes = [vp, vp, vp, vp, i64, ctypes.c_int]
    assert h.host_abi() == ctypes.sizeof(F.ModelArgs)
    return h


def _frames(u, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(n, u.atoms.n_atoms, 3))).astype(np.float32))


def _run(host_lib, model, x, component):
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu")
    l, n = x.shape[0], spec.n_input_atoms
    d = F._out_dim(spec, params)
    xs = x.reshape(l, 3 * n).contiguous()
    y = torch.empty(l, d)
    y1 = torch.empty(l, d)
    g = torch.empty(l, 3 * n)
    host_lib.host_forward(ctypes.addressof(args), xs.data_ptr(),
                          y1.data_ptr(), l)
    host_lib.host_cv_forces(ctypes.addressof(args), xs.data_ptr(),
                            y.data_ptr(), g.data_ptr(), l,
                            -1 if component is None else component)
    del keep
    y_ref, g_ref = F.cv_forces_plain(spec, align_idx, ref_x, params, act, x,
                                     component)
    return y1, y, g.reshape(l, n, 3), y_ref, g_ref


def _check(y1, y, g, y_ref, g_ref):
    np.testing.assert_allclose(y1.numpy(), y_ref.numpy(), atol=VAL_ATOL)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), atol=VAL_ATOL)
    scale = max(1.0, float(g_ref.abs().max()))
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(),
                               atol=GRAD_RTOL * scale)


@pytest.mark.parametrize("component", [None, 0, 2])
def test_alanine_forward_and_adjoint(host_lib, component):
    model, u = alanine_model(generator=torch.Generator().manual_seed(3))
    _check(*_run(host_lib, model, _frames(u), component))


@pytest.mark.parametrize("case", [
    dict(use_angle_value=True),
    dict(include_position=False),
    dict(activation="identity"),
    dict(activation="relu"),
    dict(activation="sigmoid"),
    dict(hidden_dims=(8, 6, 2)),
])
def test_model_variants(host_lib, case):
    model, u = alanine_model(generator=torch.Generator().manual_seed(5),
                             **case)
    _check(*_run(host_lib, model, _frames(u, seed=1), None))


def test_feature_layer_only(host_lib):
    model, u = alanine_model()
    flayer = model.preprocessing_layer.feature_layer
    _check(*_run(host_lib, flayer, _frames(u, seed=2), None))


def test_uncentred_reference(host_lib):
    """A reference that is not centred: the covariance's dependence on the
    centroid no longer cancels, so that term of the adjoint is exercised."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(9))
    align = model.preprocessing_layer.align_layer
    align.ref_x += torch.tensor([0.7, -1.3, 0.4])
    _check(*_run(host_lib, model, _frames(u, seed=5), None))


def test_qcp_adjoint_far_from_reference(host_lib):
    """Large rotations of the frames: the QCP Jacobian is exercised away
    from the near-identity rotations of thermal noise."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(7))
    x = _frames(u, seed=3).double()
    rng = np.random.default_rng(4)
    q = rng.normal(size=(x.shape[0], 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, a, b, c = q.T
    rot = np.stack([
        [1 - 2 * (b * b + c * c), 2 * (a * b - w * c), 2 * (a * c + w * b)],
        [2 * (a * b + w * c), 1 - 2 * (a * a + c * c), 2 * (b * c - w * a)],
        [2 * (a * c - w * b), 2 * (b * c + w * a), 1 - 2 * (a * a + b * b)],
    ]).transpose(2, 0, 1)
    x = torch.einsum("lni,lji->lnj", x, torch.from_numpy(rot)).float()
    _check(*_run(host_lib, model, x, None))
