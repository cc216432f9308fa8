"""The unrolled CUDA kernels' per-frame math and block steps, run on the host.

``molann_tpu_torch/csrc/frame_math.cuh`` holds the forward and the
hand-derived adjoints (QCP alignment included) that the unrolled kernels
run per frame, and the steps a block of those kernels runs on its frames,
each a function of (thread index, thread count): staging, the per-frame
forward and MLP backward into rows of shared memory, the parameter
gradients as block products, the per-frame adjoints, the block's ref_x
sums and the gradient store. Compiled here with the host C++ compiler into
a small library loaded by ctypes, a loop walks every block and the threads
of each step, with the block's shared memory filled with NaN first so that
a read of a row nobody wrote shows, and the rows of partial sums are added
in the order of ``reduce_partials``. The results are checked against the
plain PyTorch versions of the kernels on alanine frames — adjoint bugs show
up before any GPU time is spent. Tolerances: values 1e-5 abs; gradients
2e-4·max(1, max|g|) (tests/test_parity_torch.py:25,52); the loss 1e-6
relative; against float64, gradients 5e-5·max(1, max|g|).
"""

import ctypes
import functools
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from molann_tpu_torch.models.ann import ACTIVATIONS, MolANN, PreprocessingANN
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.systems import alanine_model

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
VAL_ATOL = 1e-5
GRAD_RTOL = 2e-4
F64_RTOL = 5e-5
FRAMES = 16  # frames a block of the host walk

HOST_SRC = r"""
#include <algorithm>
#include <vector>

#include "frame_math.cuh"
#include "reduce_partials.cuh"

extern "C" int host_abi(void) { return (int)sizeof(ModelArgs); }
extern "C" int host_io_abi(void) { return (int)sizeof(UnrIO); }

extern "C" int host_pitch(const ModelArgs* m, int forces) {
  return uw_layout(*m, forces != 0).pitch;
}

extern "C" int host_frames(const ModelArgs* m, int mode, int gx, int ref) {
  if (mode < UNR_BACKWARD) return uw_frames(*m, mode == 1);  // 0: K1, 1: K4
  return unr_choose_frames(*m, mode, gx != 0, ref != 0);
}

// act_fwd and act_grad on n pre-activations.
extern "C" void host_act(int act, const float* z, float* t, float* g, int n) {
  for (int i = 0; i < n; ++i) {
    t[i] = act_fwd(act, z[i]);
    g[i] = act_grad(act, t[i], z[i]);
  }
}

// The QCP composite's vector-Jacobian product on n matrices H [n, 3, 3]
// with cotangents gR: by the reverse pass (R, gH) and by the 9-tangent
// Dual9 pass (R_d, gH_d).
extern "C" void host_qcp_vjp(const float* H, const float* gR, float* R, float* gH,
                             float* R_d, float* gH_d, int n) {
  for (int e = 0; e < n; ++e) {
    float h[3][3], g[3][3], r[3][3], gh[3][3], lam0;
    Dual9 hd[3][3], rd[3][3];
    for (int k = 0; k < 9; ++k) {
      h[k / 3][k % 3] = H[9 * e + k];
      g[k / 3][k % 3] = gR[9 * e + k];
      hd[k / 3][k % 3] = Dual9(H[9 * e + k]);
      hd[k / 3][k % 3].d[k] = 1.0f;
    }
    int best;
    qcp_rotation(h, r, &lam0, &best);
    qcp_rotation_vjp(h, g, lam0, r, gh);
    float r_b[3][3], gh_b[3][3];
    qcp_rotation_vjp<true>(h, g, lam0, r_b, gh_b, best);  // the forward's column
    bool same = true;
    for (int k = 0; k < 9; ++k)
      same = same && r_b[k / 3][k % 3] == r[k / 3][k % 3] && gh_b[k / 3][k % 3] == gh[k / 3][k % 3];
    qcp_rotation(hd, rd);
    for (int k = 0; k < 9; ++k) {
      R[9 * e + k] = same ? r[k / 3][k % 3] : NAN;
      gH[9 * e + k] = gh[k / 3][k % 3];
      R_d[9 * e + k] = rd[k / 3][k % 3].v;
      float acc = 0.f;
      for (int ij = 0; ij < 9; ++ij) acc += g[ij / 3][ij % 3] * rd[ij / 3][ij % 3].d[k];
      gH_d[9 * e + k] = acc;
    }
  }
}

// One launch walked on the host: every block, the threads of each step in
// a loop, nt = 2 io.frames threads (two a frame) as the kernels run them.
template <int kMode, bool kGx>
static void walk(const ModelArgs& m, const UnrIO& io, bool want_ref) {
  const UnrSmem so = unr_smem(m, kMode, kGx, want_ref, io.pitch);
  const long long blocks = (io.l + io.frames - 1) / io.frames;
  const int F = io.frames, nt = 2 * F;
  std::vector<float> sm(so.total);
  std::vector<UnrAlignAdj> a(nt);
  for (long long b = 0; b < blocks; ++b) {
    std::fill(sm.begin(), sm.end(), NAN);  // a row read before it is written shows
    float* s = sm.data();
    for (int t = 0; t < nt; ++t) unr_load<kGx>(m, io, s, so, b, t, nt);
    for (int t = 0; t < nt; ++t) unr_feat<kGx>(m, io, s, so, t % F, t / F);
    for (int L = 0; L < m.n_layers; ++L)
      for (int t = 0; t < nt; ++t) unr_mlp<kMode>(m, io, s, so, L, t % F, t / F);
    for (int t = 0; t < nt; ++t) unr_seed<kMode>(m, io, s, so, b, t % F, t / F);
    for (int L = m.n_layers - 1; L > 0; --L)
      for (int t = 0; t < nt; ++t) unr_bwd(m, io, s, so, L, t % F, t / F);
    for (int t = 0; t < nt; ++t) unr_param_sums(m, io, s, so, b, kMode, want_ref, t, nt);
    if (!kGx && !want_ref) continue;
    for (int t = 0; t < nt; ++t) unr_dcol(m, io, s, so, t % F, t / F);
    for (int t = 0; t < nt; ++t) unr_adj_a<kGx>(m, io, s, so, t % F, t / F, want_ref, a[t]);
    for (int t = 0; t < nt; ++t) unr_adj_b<kGx>(m, io, s, so, t % F, t / F, a[t]);
    for (int t = 0; t < nt; ++t) unr_finish<kGx>(m, io, s, so, b, want_ref, t, nt);
  }
}

// The forward (K1) or cv+forces (K4) kernel walked on the host: every tile
// of 32 frames, the lanes of each step in a loop, the warp's state filled
// with NaN first.
template <bool kForces>
static void walk_tiles(const ModelArgs& m, const UnrIO& io) {
  const UwLayout o = uw_layout(m, kForces);
  const long long tiles = (io.l + MOLANN_UW_FRAMES - 1) / MOLANN_UW_FRAMES;
  std::vector<float> ws(MOLANN_UW_FRAMES * o.pitch);
  const bool with_z = act_needs_z(m.activation);
  for (long long t = 0; t < tiles; ++t) {
    std::fill(ws.begin(), ws.end(), NAN);
    for (int lane = 0; lane < MOLANN_UW_FRAMES; ++lane) uw_load(m, io, ws.data(), o, t, lane);
    for (int lane = 0; lane < MOLANN_UW_FRAMES; ++lane) {
      float* st = ws.data() + lane * o.pitch;
      const long long fr = t * MOLANN_UW_FRAMES + lane;
      UwAlign al;
      uw_feat(m, st, o, al);
      uw_mlp(m, io, st, o, fr, kForces && with_z);
      if (!kForces) continue;
      uw_bwd(m, io, st, o);
      uw_adj_feat(m, io, st, o);
      uw_adj_align(m, io, st, o, al);
    }
    if (kForces)
      for (int lane = 0; lane < MOLANN_UW_FRAMES; ++lane) uw_store(m, io, ws.data(), o, t, lane);
  }
}

static UnrIO io_of(const float* x, long long l, int frames) {
  UnrIO io{};
  io.x = x;
  io.l = l;
  io.component = -1;
  io.frames = frames;
  io.pitch = frames + 1;
  return io;
}

// K1 (gx null) or K4 on x [l, 3n] (in_t: [3n, l]), outputs [l, .] (out_t:
// [., l]); m in the slot form.
extern "C" void host_tiles(const ModelArgs* m, const float* x, float* y, float* gx,
                           long long l, int component, int in_t, int out_t) {
  UnrIO io = io_of(x, l, MOLANN_UW_FRAMES);
  io.y = y;
  io.gx = gx;
  io.component = component;
  io.in_t = in_t;
  io.out_t = out_t;
  if (gx) walk_tiles<true>(*m, io);
  else walk_tiles<false>(*m, io);
}

extern "C" void host_forward(const ModelArgs* m, const float* x, float* y,
                             long long l) {
  host_tiles(m, x, y, nullptr, l, -1, 0, 0);
}

extern "C" void host_cv_forces(const ModelArgs* m, const float* x, float* y,
                               float* gx, long long l, int component) {
  host_tiles(m, x, y, gx, l, component, 0, 0);
}

// The backward (train = 0; gx where given) or train kernel on `frames`
// frames a block, then the rows summed by column in reduce_partials'
// order: out [1 + G] = [loss | G].
extern "C" void host_grads(const ModelArgs* m, const float* x, const float* aux,
                           float* gx, float* out, long long l, int train, int in_t,
                           int want_ref, int frames) {
  UnrIO io = io_of(x, l, frames);
  const int width = 1 + model_grad_size(*m);
  const long long rows = (l + frames - 1) / frames;
  std::vector<float> partials(rows * width, NAN);
  io.aux = aux;
  io.gx = gx;
  io.partials = partials.data();
  io.in_t = in_t;
  io.want_ref = want_ref;
  io.inv_count = 1.0f / ((float)l * (float)model_out_dim(*m));
  const bool ref = want_ref && needs_alignment(*m);
  if (train) walk<UNR_TRAIN, false>(*m, io, ref);
  else if (gx) walk<UNR_BACKWARD, true>(*m, io, ref);
  else walk<UNR_BACKWARD, false>(*m, io, ref);
  for (int c = 0; c < width; ++c) {
    float tot = reduce_rows(partials.data(), rows, width, c, 0);
    for (int y = 1; y < MOLANN_REDUCE_LANES; ++y)
      tot += reduce_rows(partials.data(), rows, width, c, y);
    out[c] = tot;
  }
}

// The backward kernel's math: gx (unless null) and g [G] += the sums over
// frames, given gy [l, d].
extern "C" void host_backward(const ModelArgs* m, const float* x,
                              const float* gy, float* gx, float* g,
                              long long l, int want_ref) {
  std::vector<float> out(1 + model_grad_size(*m));
  host_grads(m, x, gy, gx, out.data(), l, 0, 0, want_ref, FRAMES);
  for (size_t c = 1; c < out.size(); ++c) g[c - 1] += out[c];
}

// The train kernel's math: returns the loss and g [G] += its gradients.
extern "C" float host_train(const ModelArgs* m, const float* x,
                            const float* yt, float* g, long long l,
                            int want_ref) {
  std::vector<float> out(1 + model_grad_size(*m));
  host_grads(m, x, yt, nullptr, out.data(), l, 1, 0, want_ref, FRAMES);
  for (size_t c = 1; c < out.size(); ++c) g[c - 1] += out[c];
  return out[0];
}
"""
HOST_SRC = re.sub(r"\bFRAMES\b", str(FRAMES), HOST_SRC)


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
    i32 = ctypes.c_int
    h.host_grads.argtypes = [vp, vp, vp, vp, vp, i64, i32, i32, i32, i32]
    h.host_act.argtypes = [i32, vp, vp, vp, i32]
    h.host_qcp_vjp.argtypes = [vp, vp, vp, vp, vp, vp, i32]
    h.host_frames.argtypes = [vp, i32, i32, i32]
    h.host_tiles.argtypes = [vp, vp, vp, vp, i64, i32, i32, i32]
    h.host_pitch.argtypes = [vp, i32]
    assert h.host_abi() == ctypes.sizeof(F.ModelArgs)
    assert h.host_io_abi() == ctypes.sizeof(F.UnrIO)
    return h


def _frames(u, n=64, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((u.atoms.positions[None] + 0.05 * rng.normal(
        size=(n, u.atoms.n_atoms, 3))).astype(np.float32))


def _run(host_lib, model, x, component):
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              "cv_forces")
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
    dict(activation="gelu"),
    dict(activation="elu"),
    dict(activation="celu"),
    dict(activation="softplus"),
    dict(activation="swish"),
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


# The activations the kernels took in PR 6; gelu and swish take their
# derivative from the pre-activation.
NEW_ACTIVATIONS = ("gelu", "elu", "celu", "softplus", "swish")


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
        **{act: functools.partial(seeded, 10 + i, activation=act,
                                  hidden_dims=(8, 6, 3))
           for i, act in enumerate(NEW_ACTIVATIONS)},
    }


GRAD_MODELS = _grad_models()


def _host_grads(host_lib, fn, model, *arrays, want_ref, gx=None):
    """Run host_backward / host_train; returns (its result, gparams,
    g_ref) unpacked from the flat gradient vector."""
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              "backward")
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
                                  "no_alignment", "gelu", "swish"])
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


@pytest.mark.parametrize("activation", sorted(F.KERNEL_ACTIVATIONS))
def test_activation_forms(host_lib, activation):
    """act_fwd and act_grad (from the output, or from the pre-activation
    for gelu and swish) against the eager model's activation and its
    derivative by torch.autograd in float64."""
    z = np.concatenate([np.linspace(-12.0, 12.0, 481),
                        [0.0, 1e-7, -1e-7, 30.0, -30.0]]).astype(np.float32)
    t = np.empty_like(z)
    g = np.empty_like(z)
    code = F.KERNEL_ACTIVATIONS[activation]
    host_lib.host_act(code, z.ctypes.data, t.ctypes.data, g.ctypes.data,
                      z.size)
    zz = torch.from_numpy(z).double().requires_grad_(True)
    tt = ACTIVATIONS[activation](zz)
    (gg,) = torch.autograd.grad(tt.sum(), zz)
    np.testing.assert_allclose(t, tt.detach().numpy(), rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(g, gg.numpy(), rtol=2e-5, atol=2e-6)


def _walk(host_lib, model, x, aux, frames, *, train, in_t=False,
          want_gx=True, want_ref=True):
    """One host walk of the backward (gy = aux) or train (y_target = aux)
    kernel on ``frames`` frames a block: ``(out [1 + G], gx or None)``."""
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              "train" if train else "backward")
    l = x.shape[0]
    xs = x.reshape(l, -1).contiguous()
    if in_t:
        xs, aux = xs.T.contiguous(), aux.T.contiguous()
    gx = torch.empty(l, xs.numel() // l) if want_gx and not train else None
    out = torch.empty(1 + F._grad_width(align_idx, params))
    host_lib.host_grads(ctypes.addressof(args), xs.data_ptr(), aux.data_ptr(),
                        None if gx is None else gx.data_ptr(), out.data_ptr(),
                        l, int(train), int(in_t), int(want_ref), frames)
    del keep
    return out, gx


def _f64(parts):
    spec, align_idx, ref_x, params, act = parts
    return (spec, align_idx, None if ref_x is None else ref_x.double(),
            tuple((w.double(), b.double()) for w, b in params), act)


def _close64(g, g_ref):
    scale = max(1.0, float(g_ref.abs().max()))
    np.testing.assert_allclose(g.double().numpy(), g_ref.numpy(),
                               atol=F64_RTOL * scale)


def _features_only():
    model, u = GRAD_MODELS["tanh"]()
    return model.preprocessing_layer, u


@pytest.mark.parametrize("frames", [1, 4, 32, 64])
@pytest.mark.parametrize("name", ["tanh", "gelu", "no_alignment",
                                  "features_only"])
def test_block_walk_backward(host_lib, name, frames):
    """The backward kernel's block steps over a grid of blocks with a ragged
    last one (37 frames): gx, the parameter block products and the ref_x
    sums against a float64 plain version; a second walk gives the same
    bits, and asking for the parameter sums alone gives the same sums."""
    model, u = (_features_only if name == "features_only"
                else GRAD_MODELS[name])()
    x = _frames(u, n=37, seed=21)
    parts = F._extract_model(model)
    d = F._out_dim(parts[0], parts[3])
    gy = torch.from_numpy(np.random.default_rng(22).normal(
        size=(x.shape[0], d)).astype(np.float32))
    out, gx = _walk(host_lib, model, x, gy, frames, train=False)
    out2, gx2 = _walk(host_lib, model, x, gy, frames, train=False)
    assert torch.equal(out, out2) and torch.equal(gx, gx2)
    alone, _ = _walk(host_lib, model, x, gy, frames, train=False,
                     want_gx=False)
    assert torch.equal(alone, out)
    gx_ref, gp_ref, gref_ref = F.backward_plain(*_f64(parts), x.double(),
                                                gy.double())
    _close64(gx.reshape(x.shape), gx_ref)
    gparams, g_ref = F._unpack_grads(out[1:], parts[1], parts[2], parts[3])
    for (gw, gb), (gw_r, gb_r) in zip(gparams, gp_ref):
        _close64(gw, gw_r)
        _close64(gb, gb_r)
    if g_ref is not None:
        _close64(g_ref, gref_ref)
    assert out[0] == 0


@pytest.mark.parametrize("frames", [1, 8, 64])
@pytest.mark.parametrize("in_t", [False, True])
@pytest.mark.parametrize("train_ref", [False, True])
def test_block_walk_train(host_lib, train_ref, in_t, frames):
    """The train kernel's block steps on 37 frames in both layouts: the
    loss and its gradients against float64, the same bits on a repeat."""
    model, u = GRAD_MODELS["swish"]()
    x = _frames(u, n=37, seed=23)
    parts = F._extract_model(model)
    d = F._out_dim(parts[0], parts[3])
    yt = torch.from_numpy(np.random.default_rng(24).normal(
        size=(x.shape[0], d)).astype(np.float32))
    out, _ = _walk(host_lib, model, x, yt, frames, train=True, in_t=in_t,
                   want_ref=train_ref)
    out2, _ = _walk(host_lib, model, x, yt, frames, train=True, in_t=in_t,
                    want_ref=train_ref)
    assert torch.equal(out, out2)
    loss_r, gp_ref, gref_ref = F.train_grads_plain(
        *_f64(parts), x.double(), yt.double(), train_ref)
    np.testing.assert_allclose(float(out[0]), float(loss_r), rtol=1e-5)
    gparams, g_ref = F._unpack_grads(out[1:], parts[1], parts[2], parts[3])
    for (gw, gb), (gw_r, gb_r) in zip(gparams, gp_ref):
        _close64(gw, gw_r)
        _close64(gb, gb_r)
    _close64(g_ref, gref_ref)
    if not train_ref:
        assert not g_ref.any()


@pytest.mark.parametrize("kind", ["near_identity", "random", "reflection"])
def test_qcp_reverse_pass(host_lib, kind):
    """qcp_rotation_vjp, the reverse pass the unrolled adjoint runs, against
    the 9-tangent Dual9 pass of the same composite: R to the bit, gH to
    float rounding; given the forward's adjugate column (as K4 gives it) it
    returns the same bits. Covariances near a rotation's (thermal frames), random
    ones, and ones with a negative determinant."""
    rng = np.random.default_rng({"near_identity": 1, "random": 2,
                                 "reflection": 3}[kind])
    n = 256
    H = rng.normal(size=(n, 3, 3))
    if kind == "near_identity":
        H = 20.0 * np.eye(3) + 0.5 * H
    elif kind == "reflection":
        H[:, 0] *= -1.0
        H = H * 4.0
    H = H.astype(np.float32)
    gR = rng.normal(size=(n, 3, 3)).astype(np.float32)
    out = [np.empty((n, 3, 3), np.float32) for _ in range(4)]
    host_lib.host_qcp_vjp(H.ctypes.data, gR.ctypes.data,
                          *(o.ctypes.data for o in out), n)
    R, gH, R_d, gH_d = out
    np.testing.assert_array_equal(R, R_d)
    scale = np.maximum(1.0, np.abs(gH_d).max(axis=(1, 2), keepdims=True))
    np.testing.assert_allclose(gH / scale, gH_d / scale, atol=2e-5)


def test_tile_choice(host_lib):
    """The forward and cv+forces kernels take warp tiles of 32 frames, the
    backward and train kernels 64 frames a block while two blocks fit an
    SM's shared memory (every kernel on alanine), fewer for a model at the
    envelope's edge (64 atoms, 96 columns, four layers of 64): 32, two
    blocks of its forward and one of its backward on an SM. A frame of the
    cv+forces kernel on alanine keeps 113 floats (18 atoms read: 54, then
    the gradient over the 38 columns: 54, a hidden layer of 5), one of the
    forward 97: 16 warps of the first fit an SM's 228 KB in blocks of 8."""
    def frames(model, *modes):
        spec, align_idx, ref_x, params, act = F._extract_model(model)
        got = []
        for mode in modes:  # host_frames' mode: K1, K4, backward, train
            kernel = ("forward", "cv_forces", "backward", "train")[mode[0]]
            args, keep = F.model_args(spec, align_idx, ref_x, params, act,
                                      "cpu", kernel)
            got.append(host_lib.host_frames(ctypes.addressof(args), *mode))
            del keep
        return got

    every = [(0, 0, 0), (1, 1, 0), (2, 1, 1), (2, 0, 1), (3, 0, 0), (3, 0, 1)]
    model, _ = alanine_model(device="cpu")
    assert frames(model, *every) == [32, 32, 64, 64, 64, 64]
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              "cv_forces")
    assert args.n_slots == 18
    pitch = [host_lib.host_pitch(ctypes.addressof(args), forces)
             for forces in (1, 0)]
    del keep
    assert pitch == [113, 97]
    assert 2 * (8 * 32 * 113 * 4 + 1024) <= 228 * 1024
    from molann_tpu_torch.feature import Feature
    from molann_tpu_torch.models.ann import (
        AlignmentLayer,
        FeatureLayer,
        create_sequential_nn,
    )
    from molann_tpu_torch.topology import Universe

    u = Universe.from_arrays(np.random.default_rng(0).normal(size=(64, 3)),
                             names=["C"] * 64, resids=[1] * 64,
                             resnames=["ALA"] * 64)
    pp = PreprocessingANN(
        AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms),
        FeatureLayer([Feature("p", "position", u.select_atoms("bynum 1:32"))],
                     u.atoms))
    edge = MolANN(pp, create_sequential_nn([96, 64, 64, 64, 64]))
    assert F.model_select_mode(edge) == "unrolled"
    assert frames(edge, (0, 0, 0), (1, 1, 0), (2, 1, 1), (2, 1, 0)) == [
        32, 32, 32, 32]


def _tiles(host_lib, model, x, component, in_t, out_t, forces=True):
    """One host walk of K4 (or K1) on ``x [l, n, 3]`` in the given layouts:
    ``(y [l, d], g [l, n, 3] or None)``."""
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              "cv_forces" if forces else "forward")
    l, n = x.shape[0], spec.n_input_atoms
    d = F._out_dim(spec, params)
    xs = x.reshape(l, 3 * n).contiguous()
    if in_t:
        xs = xs.T.contiguous()
    y = torch.full((d, l) if out_t else (l, d), float("nan"))
    g = torch.full((3 * n, l) if out_t else (l, 3 * n), float("nan"))
    host_lib.host_tiles(ctypes.addressof(args), xs.data_ptr(), y.data_ptr(),
                        g.data_ptr() if forces else None, l,
                        -1 if component is None else component, int(in_t),
                        int(out_t))
    del keep
    if out_t:
        y, g = y.T, g.T
    return y, (g.reshape(l, n, 3) if forces else None)


@pytest.mark.parametrize("layout", ["[l, 3n]", "[3n, l]", "[l, 3n] -> t"])
@pytest.mark.parametrize("l", [1, 37, 96])
@pytest.mark.parametrize("name", ["tanh", "gelu", "no_alignment",
                                  "features_only", "deep"])
def test_warp_tiles(host_lib, name, l, layout):
    """K4's and K1's warp steps over several tiles of 32 frames with a
    ragged last one, on both input layouts and transposed outputs: values
    and gradients against the plain version and float64, components None
    and 1, the same bits on a repeat, the atoms nothing reads exactly 0, and
    K1's values equal to K4's bit for bit."""
    model, u = (_features_only if name == "features_only"
                else GRAD_MODELS[name])()
    x = _frames(u, n=l, seed=31)
    in_t, out_t = layout == "[3n, l]", layout != "[l, 3n]"
    parts = F._extract_model(model)
    y1, _ = _tiles(host_lib, model, x, None, in_t, out_t, forces=False)
    for component in (None, 1):
        y, g = _tiles(host_lib, model, x, component, in_t, out_t)
        y2, g2 = _tiles(host_lib, model, x, component, in_t, out_t)
        assert torch.equal(y, y2) and torch.equal(g, g2)
        assert torch.equal(y1, y)
        y_ref, g_ref = F.cv_forces_plain(*parts, x, component)
        _check(y1, y, g, y_ref, g_ref)
        y64, g64 = F.cv_forces_plain(*_f64(parts), x.double(), component)
        np.testing.assert_allclose(y.double().numpy(), y64.numpy(),
                                   atol=VAL_ATOL)
        _close64(g, g64)
        args, keep = F.model_args(*parts[:4], parts[4], "cpu", "cv_forces")
        col_slot = list((ctypes.c_int * (3 * x.shape[1])).from_address(
            args.col_slot))
        del keep
        unread = [c for c, q in enumerate(col_slot) if q < 0]
        assert not g.reshape(l, -1)[:, unread].any()
