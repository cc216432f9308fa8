"""The blocked CUDA kernels' per-block phases, run on the host.

``molann_tpu_torch/csrc/blocked_math.cuh`` holds every phase a thread block
of the blocked kernels runs on its tile of frames (the gathers, feature
math, switching sums, QCP alignment, the MLP and the hand-derived
adjoints), each a function of (thread index, thread count). Compiled here
with the host C++ compiler, a loop walks the blocks, the phases and the
threads of each phase in loops, with the shared memory of a block filled
with NaN first so that a read of a row nobody wrote shows. The outputs are
held against the plain PyTorch versions over the models, layouts, tile
sizes and options the kernels take, so index-table, stride and adjoint
faults show before any GPU time is spent. Tolerances: values 1e-5 abs
(5e-5 for sums over thousands of pairs); gradients 5e-5·max(1, max|g|)
(tests/test_fused_blocked.py:83-95, tests/test_condensed.py:101-118).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from molann_tpu_torch.feature import Feature
from molann_tpu_torch.models.ann import (
    AlignmentLayer,
    FeatureLayer,
    MolANN,
    PreprocessingANN,
    create_sequential_nn,
)
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.ops import fused_blocked as FB
from molann_tpu_torch.systems import (
    alanine_model,
    lj_fluid,
    lj_fluid_model,
    peptide_model,
    synthetic_peptide,
)

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"

HOST_SRC = r"""
#include <cmath>
#include <vector>

#include "blocked_math.cuh"

extern "C" void host_blk_caps(int* out) {
  out[0] = MOLANN_BLK_MAX_LAYERS;
  out[1] = MOLANN_BLK_COORD_FLOATS;
  out[2] = MOLANN_BLK_THREADS;
  out[3] = (int)sizeof(BlockedArgs);
  out[4] = (int)sizeof(BlockedIO);
}

extern "C" long long host_blk_smem_bytes(const BlockedArgs* m, int nt, int forces) {
  return (long long)blk_smem(*m, nt, forces != 0).total * (long long)sizeof(float);
}

extern "C" void host_blk_run(const BlockedArgs* m, const BlockedIO* io, int nt,
                             int forces) {
  std::vector<float> sm(blk_smem(*m, nt, forces != 0).total);
  const long long blocks = (io->l + m->frames - 1) / m->frames;
  const int n_phases = blk_n_phases(*m, forces != 0);
  for (long long b = 0; b < blocks; ++b) {
    for (float& v : sm) v = NAN;
    for (int ph = 0; ph < n_phases; ++ph)
      for (int tid = 0; tid < nt; ++tid) {
        const bool al = blk_aligned(*m);
        if (forces && al) blk_phase<true, true>(*m, *io, sm.data(), b, ph, tid, nt);
        else if (forces) blk_phase<true, false>(*m, *io, sm.data(), b, ph, tid, nt);
        else if (al) blk_phase<false, true>(*m, *io, sm.data(), b, ph, tid, nt);
        else blk_phase<false, false>(*m, *io, sm.data(), b, ph, tid, nt);
      }
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("blocked_math")
    src, lib = d / "blocked_math_host.cpp", d / "libblocked_math_host.so"
    src.write_text(HOST_SRC)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-x", "c++", str(src), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    h.host_blk_caps.argtypes = [vp]
    h.host_blk_smem_bytes.argtypes = [vp, i32, i32]
    h.host_blk_smem_bytes.restype = ctypes.c_longlong
    h.host_blk_run.argtypes = [vp, vp, i32, i32]
    caps = (ctypes.c_int * 5)()
    h.host_blk_caps(caps)
    assert list(caps) == [FB.BLK_MAX_LAYERS, FB.BLK_COORD_FLOATS,
                          FB.BLK_THREADS, ctypes.sizeof(FB.BlockedArgs),
                          ctypes.sizeof(FB.BlockedIO)]
    return h


def host_launch(host, frames, threads):
    """A stand-in for ``fused_blocked._launch`` that runs the phases on the
    host with ``frames`` frames a block and ``threads`` threads."""
    def launch(kind, lay, ref_x, params, activation, x, tag, l, y, y_strides,
               gx, g_strides, component, pair_op, compact_out):
        args, keep = FB.blocked_args(lay, ref_x, params, activation, pair_op,
                                     "cpu", compact_out=compact_out)
        args.frames, args.pitch = frames, frames | 1
        forces = int(kind == "blocked_cv_forces")
        assert host.host_blk_smem_bytes(ctypes.addressof(args), threads,
                                        forces) > 0
        io = FB.blocked_io(x, FB._strides(tag, lay.n_atoms, l), l, y,
                           y_strides, gx, g_strides, component)
        host.host_blk_run(ctypes.addressof(args), ctypes.addressof(io),
                          threads, forces)
        del keep
    return launch


def run_host(host, model, x, *, forces=True, component=None, out_layout=None,
             compact=False, frames=16, threads=64):
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    lay = FB.blocked_layout(spec, align_idx)
    tag, l = FB._classify(x, lay.n_atoms)
    pair_op = (torch.from_numpy(lay.pair_operand()) if lay.coord_npairs
               else None)
    x = x.contiguous()
    d_out = F._out_dim(spec, params)
    with mock.patch.object(FB, "_launch", host_launch(host, frames, threads)):
        if not forces:
            return FB._kernel_forward(lay, ref_x, params, act, x, tag, l,
                                      pair_op)
        return FB._kernel_cv_forces(
            lay, ref_x, params, act, x, tag, l,
            FB._resolve_out_layout(out_layout, tag),
            None if component is None else component % d_out, compact,
            pair_op)


def frames_of(u, l, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((u.atoms.positions[None] + sigma * rng.normal(
        size=(l, u.atoms.n_atoms, 3))).astype(np.float32))


def check(host, model, x, *, val_atol=1e-5, component=None, **kw):
    """K6 and K8 on the host against the plain versions, [l, n, 3] input."""
    parts = F._extract_model(model)
    y_ref, g_ref = FB.blocked_cv_forces_plain(*parts, x, component)
    y6 = run_host(host, model, x, forces=False, **kw)
    y8, g8 = run_host(host, model, x, component=component, **kw)
    np.testing.assert_allclose(y6.numpy(), y_ref.numpy(), atol=val_atol)
    np.testing.assert_allclose(y8.numpy(), y_ref.numpy(), atol=val_atol)
    scale = max(1.0, float(g_ref.abs().max()))
    assert float(g_ref.abs().max()) > 0
    np.testing.assert_allclose(g8.numpy(), g_ref.numpy(), atol=5e-5 * scale)


def gen(seed):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("frames,threads", [(32, 64), (16, 256), (4, 32),
                                            (1, 32)])
@pytest.mark.parametrize("component", [None, 0])
def test_peptide(host, component, frames, threads):
    """Angles, bonds and dihedrals at every tile size, ragged last block."""
    model, u = peptide_model(6, generator=gen(1), device="cpu")
    check(host, model, frames_of(u, 37, 0), component=component,
          frames=frames, threads=threads)


@pytest.mark.parametrize("case", [
    dict(), dict(use_angle_value=True), dict(activation="relu"),
    dict(activation="sigmoid"), dict(hidden_dims=(8, 6, 2)),
    dict(include_position=False),
])
def test_alanine_alignment_and_positions(host, case):
    """QCP alignment, aligned positions and their adjoint through dR/dH."""
    model, u = alanine_model(generator=gen(3), device="cpu", **case)
    check(host, model, frames_of(u, 21, 1))
    check(host, model, frames_of(u, 21, 1), component=1)


def test_uncentred_reference(host):
    model, u = alanine_model(generator=gen(9), device="cpu")
    model.preprocessing_layer.align_layer.ref_x += torch.tensor(
        [0.7, -1.3, 0.4])
    check(host, model, frames_of(u, 21, 5))


@pytest.mark.parametrize("component", [None, 0, 5, 30, -1])
@pytest.mark.parametrize("aligned", [True, False])
def test_feature_layer_only(host, component, aligned):
    """No MLP: the output is the feature columns in final order, and the
    component addresses the final column."""
    model, u = alanine_model(device="cpu")
    pp = model.preprocessing_layer
    if not aligned:
        pp = PreprocessingANN(None, pp.feature_layer)
    check(host, pp, frames_of(u, 19, 2), component=component)


@pytest.mark.parametrize("n_side", [3, 4])
def test_lj_fluid(host, n_side):
    """Minimum-image pairs with d_max truncation, mm == 2 nn, on frames
    that straddle the periodic boundary."""
    model, u, _ = lj_fluid_model(n_side, generator=gen(2), device="cpu")
    check(host, model, frames_of(u, 9, 3, sigma=1.5), val_atol=5e-5,
          frames=4, threads=32)


def mixed_coordination_model():
    """Every switching form in one model: mm != 2 nn with and without
    d_max, no d_max with a box, an A x B feature without a box, and a bond."""
    u, box = lj_fluid(3)
    feats = [
        Feature("q", "coordination", u.atoms, r0=2.0, nn=3, mm=7,
                pbc_box=box, d_max=3.6),
        Feature("tail", "coordination", u.atoms, r0=2.3, pbc_box=box),
        Feature("ab", "coordination", u.select_atoms("resid 1:6"),
                group_b=u.select_atoms("resid 10:20"), r0=3.0, nn=2, mm=5),
        Feature("b", "bond",
                u.select_atoms("bynum 1") + u.select_atoms("bynum 20")),
        Feature("one", "coordination", u.select_atoms("resid 3:9"), r0=2.5,
                nn=1, mm=2),
    ]
    pp = PreprocessingANN(None, FeatureLayer(feats, u.atoms))
    head = create_sequential_nn([pp.output_dimension(), 6, 2],
                                generator=gen(4))
    with torch.no_grad():
        head.layers[0].weight.mul_(1e-2)  # keep tanh away from saturation
    return MolANN(pp, head), pp, u


@pytest.mark.parametrize("component", [None, 1])
def test_switching_forms(host, component):
    model, pp, u = mixed_coordination_model()
    x = frames_of(u, 7, 6, sigma=0.6)
    check(host, model, x, val_atol=5e-5, component=component, frames=4,
          threads=32)
    for comp in (0, 1, 2, 4):
        check(host, pp, x, val_atol=5e-5, component=comp, frames=4,
              threads=32)


def sparse_model(n_residues=40):
    """A large universe with a small feature set: compaction engages."""
    u = synthetic_peptide(n_residues)

    def sel(name, resid):
        return u.select_atoms(f"name {name} and resid {resid}")

    feats = [
        Feature("b1", "bond", sel("CA", 3) + sel("CA", 17)),
        Feature("a1", "angle", sel("N", 9) + sel("CA", 9) + sel("C", 9)),
        Feature("d1", "dihedral",
                sel("C", 24) + sel("N", 25) + sel("CA", 25) + sel("C", 25)),
        Feature("p1", "position", sel("CA", 30) + sel("CA", 31)),
    ]
    align = AlignmentLayer(u.select_atoms("name CA and resid 1:5"), u.atoms)
    pp = PreprocessingANN(align, FeatureLayer(feats, u.atoms))
    head = create_sequential_nn([pp.output_dimension(), 8, 2],
                                generator=gen(3))
    return MolANN(pp, head), u


def test_compaction(host):
    model, u = sparse_model()
    x = frames_of(u, 11, 7)
    active = F.active_atom_indices(model)
    assert active is not None and 4 * len(active) <= u.atoms.n_atoms
    check(host, model, x)
    _, g = run_host(host, model, x)
    inactive = np.setdiff1d(np.arange(u.atoms.n_atoms), active)
    assert not g[:, inactive].any()
    y_c, g_c = run_host(host, model, x, compact=True)
    assert g_c.shape == (3, len(active), 11)
    np.testing.assert_array_equal(
        g_c.numpy(), g.permute(2, 1, 0)[:, active].numpy())


@pytest.mark.parametrize("layout", ["packed", "t", "cmajor"])
@pytest.mark.parametrize("out_layout", [None, "standard", "t", "cmajor"])
def test_layouts(host, layout, out_layout):
    """Every input layout and out_layout is read and written in place
    through strides, with the same bits as [l, n, 3]."""
    model, u = peptide_model(4, generator=gen(5), device="cpu")
    n, l = u.atoms.n_atoms, 13
    x = frames_of(u, l, 8)
    y0, g0 = run_host(host, model, x)
    xin = {"packed": x.reshape(l, 3 * n),
           "t": x.reshape(l, 3 * n).T.contiguous(),
           "cmajor": x.permute(2, 1, 0).contiguous()}[layout]
    y, g = run_host(host, model, xin, out_layout=out_layout)
    y6 = run_host(host, model, xin, forces=False)
    np.testing.assert_array_equal(y6.numpy(), y0.numpy())
    out = out_layout or {"packed": "standard", "t": "t",
                         "cmajor": "cmajor"}[layout]
    if out == "standard":
        assert g.shape == ((l, 3 * n) if layout == "packed" else (l, n, 3))
        y_std, g_std = y, g.reshape(l, n, 3)
    elif out == "t":
        assert y.shape == (2, l) and g.shape == (3 * n, l)
        y_std, g_std = y.T, g.T.reshape(l, n, 3)
    else:
        assert y.shape == (2, l) and g.shape == (3, n, l)
        y_std, g_std = y.T, g.permute(2, 1, 0)
    np.testing.assert_array_equal(y_std.numpy(), y0.numpy())
    np.testing.assert_array_equal(g_std.numpy(), g0.numpy())
