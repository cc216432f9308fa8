"""The CUDA kernels' per-frame math, run on the host.

``molann_tpu_torch/csrc/frame_math.cuh`` holds the forward and the
hand-derived adjoints (QCP alignment included) that the CUDA kernels run
per frame, and the per-frame VJP whose terms the training kernels sum over
frames. Compiled here with the host C++ compiler into a small library
loaded by ctypes, it is checked against the plain PyTorch versions of the
kernels on 64 alanine frames — adjoint bugs show up before any GPU time is
spent. The host sums the VJP's terms over frames in order; the kernels sum
them by warp. Tolerances: values 1e-5 abs; gradients 2e-4·max(1, max|g|)
(tests/test_parity_torch.py:25,52); the loss 1e-6 relative.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from molann_tpu_torch.models.ann import MolANN, PreprocessingANN
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

struct HostSink {
  float* g;
  void operator()(int k, float v) const { g[k] += v; }
};

// The backward kernel's math: gx (unless null) and g [G] += each frame's
// terms, given gy [l, d].
extern "C" void host_backward(const ModelArgs* m, const float* x,
                              const float* gy, float* gx, float* g,
                              long long l, int want_ref) {
  const int n3 = 3 * m->n_atoms, d = model_out_dim(*m);
  HostSink sink{g};
  for (long long f = 0; f < l; ++f) {
    FrameFwd st;
    frame_fwd(*m, x + f * n3, gx != nullptr || want_ref, st);
    float ga[MOLANN_MAX_COLS];
    for (int j = 0; j < d; ++j) ga[j] = gy[f * d + j];
    frame_vjp(*m, x + f * n3, st, ga, gx != nullptr ? gx + f * n3 : nullptr,
              want_ref != 0, sink);
  }
}

// The train kernel's math: returns the loss and g [G] += its gradients.
extern "C" float host_train(const ModelArgs* m, const float* x,
                            const float* yt, float* g, long long l,
                            int want_ref) {
  const int n3 = 3 * m->n_atoms, d = model_out_dim(*m);
  const float inv_count = 1.0f / ((float)l * (float)d);
  HostSink sink{g};
  float loss = 0.f;
  for (long long f = 0; f < l; ++f) {
    FrameFwd st;
    const float* y = frame_fwd(*m, x + f * n3, want_ref != 0, st);
    float ga[MOLANN_MAX_COLS];
    loss += mse_cotangent(y, yt + f * d, d, inv_count, ga);
    frame_vjp(*m, x + f * n3, st, ga, nullptr, want_ref != 0, sink);
  }
  return loss;
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
    h.host_backward.argtypes = [vp, vp, vp, vp, vp, i64, ctypes.c_int]
    h.host_train.argtypes = [vp, vp, vp, vp, i64, ctypes.c_int]
    h.host_train.restype = ctypes.c_float
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
    model, u = alanine_model(generator=torch.Generator().manual_seed(3), device="cpu")
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
                             device="cpu", **case)
    _check(*_run(host_lib, model, _frames(u, seed=1), None))


def test_feature_layer_only(host_lib):
    model, u = alanine_model(device="cpu")
    flayer = model.preprocessing_layer.feature_layer
    _check(*_run(host_lib, flayer, _frames(u, seed=2), None))


def test_uncentred_reference(host_lib):
    """A reference that is not centred: the covariance's dependence on the
    centroid no longer cancels, so that term of the adjoint is exercised."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(9), device="cpu")
    align = model.preprocessing_layer.align_layer
    align.ref_x += torch.tensor([0.7, -1.3, 0.4])
    _check(*_run(host_lib, model, _frames(u, seed=5), None))


def test_qcp_adjoint_far_from_reference(host_lib):
    """Large rotations of the frames: the QCP Jacobian is exercised away
    from the near-identity rotations of thermal noise."""
    model, u = alanine_model(generator=torch.Generator().manual_seed(7), device="cpu")
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


def _close_grads(g, g_ref):
    scale = max(1.0, float(g_ref.abs().max()))
    np.testing.assert_allclose(g.numpy(), g_ref.numpy(), atol=GRAD_RTOL * scale)


def _grad_models():
    def seeded(seed, **kw):
        return alanine_model(generator=torch.Generator().manual_seed(seed),
                             device="cpu", **kw)

    def uncentred():
        model, u = seeded(9)
        model.preprocessing_layer.align_layer.ref_x += torch.tensor(
            [0.7, -1.3, 0.4])
        return model, u

    def unaligned():
        model, u = seeded(4)
        pp = PreprocessingANN(None, model.preprocessing_layer.feature_layer)
        return MolANN(pp, model.ann_layers), u

    return {
        "tanh": lambda: seeded(3),
        "uncentred_ref": uncentred,
        "relu": lambda: seeded(5, activation="relu"),
        "sigmoid": lambda: seeded(6, activation="sigmoid"),
        "no_alignment": unaligned,
        "no_position_features": lambda: seeded(8, include_position=False),
        "deep": lambda: seeded(2, hidden_dims=(8, 6, 2)),
    }


GRAD_MODELS = _grad_models()


def _host_grads(host_lib, fn, model, *arrays, want_ref, gx=None):
    """Run host_backward / host_train; returns (its result, gparams,
    g_ref) unpacked from the flat gradient vector."""
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu")
    g = torch.zeros(F._grad_width(align_idx, params))
    ptrs = [a.data_ptr() for a in arrays]
    if fn is host_lib.host_backward:
        ptrs.append(None if gx is None else gx.data_ptr())
    res = fn(ctypes.addressof(args), *ptrs, g.data_ptr(), arrays[0].shape[0],
             int(want_ref))
    del keep
    return (res, *F._unpack_grads(g, align_idx, ref_x, params))


@pytest.mark.parametrize("want_gx", [True, False])
@pytest.mark.parametrize("name", sorted(GRAD_MODELS))
def test_vjp_parameter_and_ref_grads(host_lib, name, want_gx):
    """The backward kernel's per-frame VJP, summed over frames, against
    autograd of the plain forward given a random gy."""
    model, u = GRAD_MODELS[name]()
    x = _frames(u, seed=11)
    parts = F._extract_model(model)
    d = F._out_dim(parts[0], parts[3])
    gy = torch.from_numpy(np.random.default_rng(12).normal(
        size=(x.shape[0], d)).astype(np.float32))
    gx_ref, gparams_ref, gref_ref = F.backward_plain(*parts, x, gy)
    xs = x.reshape(x.shape[0], -1).contiguous()
    gx = torch.empty_like(xs) if want_gx else None
    _, gparams, g_ref = _host_grads(host_lib, host_lib.host_backward, model,
                                    xs, gy, want_ref=True, gx=gx)
    if want_gx:
        _close_grads(gx.reshape(x.shape), gx_ref)
    for (gw, gb), (gw_r, gb_r) in zip(gparams, gparams_ref):
        _close_grads(gw, gw_r)
        _close_grads(gb, gb_r)
    assert (g_ref is None) == (gref_ref is None)
    if g_ref is not None:
        _close_grads(g_ref, gref_ref)


@pytest.mark.parametrize("train_ref", [False, True])
@pytest.mark.parametrize("name", ["tanh", "uncentred_ref", "relu",
                                  "no_alignment"])
def test_train_loss_and_grads(host_lib, name, train_ref):
    """The train kernel's per-frame math (MSE cotangent, then the VJP with
    no gx): the loss and its gradients against the plain version."""
    model, u = GRAD_MODELS[name]()
    x = _frames(u, seed=13)
    parts = F._extract_model(model)
    d = F._out_dim(parts[0], parts[3])
    yt = torch.from_numpy(np.random.default_rng(14).normal(
        size=(x.shape[0], d)).astype(np.float32))
    loss_ref, gparams_ref, gref_ref = F.train_grads_plain(*parts, x, yt,
                                                          train_ref)
    loss, gparams, g_ref = _host_grads(
        host_lib, host_lib.host_train, model,
        x.reshape(x.shape[0], -1).contiguous(), yt, want_ref=train_ref)
    np.testing.assert_allclose(loss, float(loss_ref), rtol=1e-6)
    for (gw, gb), (gw_r, gb_r) in zip(gparams, gparams_ref):
        _close_grads(gw, gw_r)
        _close_grads(gb, gb_r)
    if g_ref is not None:
        _close_grads(g_ref, gref_ref)
        if not train_ref:
            assert not g_ref.any()
