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
faults show before any GPU time is spent: the pair walk in each of its
compiled forms, forward only and with the pair gradient (same switching
sums, bit for bit), the batches of bonds, angles and dihedrals and their
per-atom accumulators, the register-tiled MLP layers forwards and backwards.
The backward and train kernels
are walked the same way: a grid of a few blocks, each over its tiles in
order with its running sums, then the column-wise reduction in the
kernel's order, twice, with equal bits, with a large layer's parameter step
in rectangles and a small one's entry by entry, the sums in shared memory
and in the block's row. Tolerances: values 1e-5 abs
(5e-5 for sums over thousands of pairs); gradients 5e-5·max(1, max|g|)
(tests/test_fused_blocked.py:83-95, tests/test_condensed.py:101-118); the
loss 1e-5 relative.
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
    ACTIVATIONS,
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
#include "reduce_partials.cuh"

// act_fwd and act_grad on n pre-activations, as the MLP steps call them.
extern "C" void host_act(int act, const float* z, float* t, float* g, int n) {
  for (int i = 0; i < n; ++i) {
    t[i] = act_fwd(act, z[i]);
    g[i] = act_grad(act, t[i], z[i]);
  }
}

extern "C" void host_blk_caps(int* out) {
  out[0] = MOLANN_BLK_MAX_LAYERS;
  out[1] = MOLANN_COORD_FLOATS;
  out[2] = MOLANN_BLK_THREADS;
  out[3] = (int)sizeof(BlockedArgs);
  out[4] = (int)sizeof(BlockedIO);
  out[5] = MOLANN_BLK_GRAD_BLOCKS;
}

extern "C" long long host_blk_smem_bytes(const BlockedArgs* m, int nt, int forces) {
  return (long long)blk_smem(*m, nt, forces != 0).total * (long long)sizeof(float);
}

extern "C" int host_blk_pair_form(const float* par) {
  return blk_pair_form(coord_load(par));
}

extern "C" void host_blk_run(const BlockedArgs* m, const BlockedIO* io, int nt,
                             int forces) {
  std::vector<float> sm(blk_smem(*m, nt, forces != 0).total);
  const long long blocks = (io->l + m->frames - 1) / m->frames;
  int* steps = reinterpret_cast<int*>(sm.data());
  for (long long b = 0; b < blocks; ++b) {
    for (float& v : sm) v = NAN;
    const int n_steps = blk_build_steps(*m, forces ? BLK_MODE_FORCES : BLK_MODE_FORWARD,
                                        forces != 0, forces != 0, nt, steps);
    for (int i = 0; i < n_steps; ++i) {
      const BlkStep st = blk_step_of(steps[i]);
      const int reps = st.kind == BLK_SCATTER ? m->n_batches : 1;
      for (int r = 0; r < reps; ++r) {
        const BlkStep ph = {st.kind, reps > 1 ? r : st.arg};
        for (int tid = 0; tid < nt; ++tid) {
          const bool al = blk_aligned(*m);
          if (forces && al) blk_phase<true, true>(*m, *io, sm.data(), b, ph, tid, nt);
          else if (forces) blk_phase<true, false>(*m, *io, sm.data(), b, ph, tid, nt);
          else if (al) blk_phase<false, true>(*m, *io, sm.data(), b, ph, tid, nt);
          else blk_phase<false, false>(*m, *io, sm.data(), b, ph, tid, nt);
        }
      }
    }
  }
}

extern "C" long long host_blk_grad_smem_bytes(const BlockedArgs* m, int nt, int gx,
                                              int acc_global) {
  return (long long)blk_grad_smem(*m, nt, gx != 0, acc_global).total *
         (long long)sizeof(float);
}

// How many layers' parameter steps run in rectangles of 4 x 6 entries.
extern "C" int host_blk_rect_layers(const BlockedArgs* m, int nt) {
  int n = 0;
  for (int L = 0; L < m->n_layers; ++L) n += blk_rect_layer(m->dims[L], m->dims[L + 1], nt);
  return n;
}

extern "C" long long host_blk_grad_rows(const BlockedArgs* m, long long l) {
  return blk_grad_blocks(*m, l);
}

template <bool kTrain, bool kGx, bool kAligned>
static void run_grads(const BlockedArgs& m, const BlockedIO& io, float* out, int nt,
                      int n_blocks) {
  const int width = 1 + blk_grad_size(m);
  const BlkSmem so = blk_grad_smem(m, nt, kGx, io.acc_global);
  const int rect_floats = MOLANN_BLK_RSUM_J * MOLANN_BLK_RSUM_K * nt;
  std::vector<float> sm(so.total);
  const long long tiles = (io.l + m.frames - 1) / m.frames;
  int* steps = reinterpret_cast<int*>(sm.data());
  for (int b = 0; b < n_blocks; ++b) {
    for (float& v : sm) v = NAN;
    float* row = io.partials + (long long)b * width;
    float* acc = io.acc_global == BLK_SUMS_ROW ? row : sm.data() + so.acc;
    float* rect = io.acc_global == BLK_SUMS_RECT
        ? io.partials + (long long)n_blocks * width + (long long)b * rect_floats : nullptr;
    for (int tid = 0; tid < nt; ++tid) blk_grad_begin(m, io, acc, rect, tid, nt);
    const int n_steps = blk_build_steps(m, kTrain ? BLK_MODE_TRAIN : BLK_MODE_BACKWARD,
                                        blk_grad_adjoint<kGx, kAligned>(io), kGx, nt, steps);
    for (long long tile = b; tile < tiles; tile += n_blocks)
      for (int i = 0; i < n_steps; ++i) {
        const BlkStep st = blk_step_of(steps[i]);
        const int reps = st.kind == BLK_SCATTER ? m.n_batches : 1;
        for (int r = 0; r < reps; ++r)
          for (int tid = 0; tid < nt; ++tid)
            blk_grad_phase<kTrain, kGx, kAligned>(m, io, sm.data(), so, acc, rect, tile,
                                                  BlkStep{st.kind, reps > 1 ? r : st.arg},
                                                  tid, nt);
      }
    for (int tid = 0; tid < nt; ++tid) blk_grad_end(m, io, acc, rect, row, tid, nt);
  }
  for (int c = 0; c < width; ++c) {  // reduce_partials, in its order
    float tot = reduce_rows(io.partials, n_blocks, width, c, 0);
    for (int y = 1; y < MOLANN_REDUCE_LANES; ++y)
      tot += reduce_rows(io.partials, n_blocks, width, c, y);
    out[c] = tot;
  }
}

// The backward (train = 0) or train kernel as a grid of n_blocks blocks.
extern "C" void host_blk_grads(const BlockedArgs* m, const BlockedIO* io, float* out, int nt,
                               int train, int n_blocks) {
  const bool al = blk_aligned(*m);
  const bool gx = !train && io->gx != nullptr;  // the kernels' three kinds
  if (train && al) run_grads<true, false, true>(*m, *io, out, nt, n_blocks);
  else if (train) run_grads<true, false, false>(*m, *io, out, nt, n_blocks);
  else if (gx && al) run_grads<false, true, true>(*m, *io, out, nt, n_blocks);
  else if (gx) run_grads<false, true, false>(*m, *io, out, nt, n_blocks);
  else if (al) run_grads<false, false, true>(*m, *io, out, nt, n_blocks);
  else run_grads<false, false, false>(*m, *io, out, nt, n_blocks);
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
    h.host_act.argtypes = [i32, vp, vp, vp, i32]
    h.host_blk_smem_bytes.argtypes = [vp, i32, i32]
    h.host_blk_smem_bytes.restype = ctypes.c_longlong
    h.host_blk_run.argtypes = [vp, vp, i32, i32]
    h.host_blk_grad_smem_bytes.argtypes = [vp, i32, i32, i32]
    h.host_blk_grad_smem_bytes.restype = ctypes.c_longlong
    h.host_blk_rect_layers.argtypes = [vp, i32]
    h.host_blk_pair_form.argtypes = [vp]
    h.host_blk_grad_rows.argtypes = [vp, ctypes.c_longlong]
    h.host_blk_grad_rows.restype = ctypes.c_longlong
    h.host_blk_grads.argtypes = [vp, vp, vp, i32, i32, i32]
    caps = (ctypes.c_int * 6)()
    h.host_blk_caps(caps)
    assert list(caps) == [FB.BLK_MAX_LAYERS, FB.BLK_COORD_FLOATS,
                          FB.BLK_THREADS, ctypes.sizeof(FB.BlockedArgs),
                          ctypes.sizeof(FB.BlockedIO), FB.BLK_GRAD_BLOCKS]
    return h


def host_launch(host, frames, threads):
    """A stand-in for ``fused_blocked._launch`` that runs the phases on the
    host with ``frames`` frames a block and ``threads`` threads."""
    def launch(kind, lay, ref_x, params, activation, x, tag, l, y, y_strides,
               gx, g_strides, component, pair_op, compact_out):
        args, keep = FB.blocked_args(lay, ref_x, params, activation, pair_op,
                                     "cpu", compact_out=compact_out)
        keep += (FB.set_tile(args, lay, frames, "cpu", threads),)
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


# nn, mm, d_max, box ("ortho", "triclinic" or None) and the instance of the
# pair loop it must get (blk_pair_form): 1 + 2 i + has_box for nn = 4, 6, 8,
# and 0, the generic body, for everything else
PAIR_FORMS = [
    (4, 8, None, None, 1), (4, 8, None, "ortho", 2), (4, 8, 3.6, None, 1),
    (4, 8, 3.6, "ortho", 2), (6, 12, None, None, 3), (6, 12, None, "ortho", 4),
    (6, 12, 3.6, None, 3), (6, 12, 3.6, "ortho", 4), (8, 16, None, None, 5),
    (8, 16, None, "ortho", 6), (8, 16, 3.6, None, 5),
    (8, 16, 3.6, "ortho", 6),
    (3, 7, 3.6, "ortho", 0), (5, 10, None, "ortho", 0),
    (6, 12, 3.6, "triclinic", 0), (6, 10, None, None, 0),
]


def pair_form_model(nn, mm, d_max, box_kind):
    u, box = lj_fluid(3)
    if box_kind == "triclinic":
        box = np.diag(box)
        box[1, 0], box[2, 1] = 0.4, -0.3
    elif box_kind is None:
        box = None
    feats = [Feature("q", "coordination", u.atoms, r0=2.0, nn=nn, mm=mm,
                     pbc_box=box, d_max=d_max)]
    pp = PreprocessingANN(None, FeatureLayer(feats, u.atoms))
    head = create_sequential_nn([1, 4, 2], generator=gen(4))
    with torch.no_grad():
        head.layers[0].weight.mul_(1e-2)
    return MolANN(pp, head), u


@pytest.mark.parametrize("nn,mm,d_max,box_kind,form", PAIR_FORMS)
def test_pair_forms(host, nn, mm, d_max, box_kind, form):
    """One case per compiled instance of the pair loop and four that fall
    to the generic body: values, gx and the training kernels."""
    model, u = pair_form_model(nn, mm, d_max, box_kind)
    lay = FB.blocked_layout(*F._extract_model(model)[:2])
    par = np.ascontiguousarray(lay.coord_par, dtype=np.float32)
    assert host.host_blk_pair_form(par.ctypes.data) == form
    x = frames_of(u, 6, 6, sigma=0.6)
    check(host, model, x, val_atol=5e-5, frames=4, threads=32)
    check_backward(host, model, x)
    check_train(host, model, x)


@pytest.mark.parametrize("build", ["fluid", "mixed"])
@pytest.mark.parametrize("frames,threads", [(4, 32), (1, 32), (8, 256)])
def test_walks_give_the_same_sums(host, build, frames, threads):
    """The forward-only walk (each pair once, from its owner) and the walk
    that also forms D_k (each pair from both atoms) sum s over the owned
    partners in the same order into the same two accumulators: the values of
    the forward and of the cv+forces kernel agree to the last bit."""
    if build == "fluid":
        model, u, _ = lj_fluid_model(3, generator=gen(2), device="cpu")
    else:
        model, _, u = mixed_coordination_model()
    x = frames_of(u, 9, 3, sigma=1.0)
    y6 = run_host(host, model, x, forces=False, frames=frames,
                  threads=threads)
    y8, _ = run_host(host, model, x, frames=frames, threads=threads)
    assert torch.equal(y6, y8)


@pytest.mark.parametrize("n_side", [3, 5])
def test_pair_operand_owners(n_side):
    """Every pair sits once among its owner's partners and once among the
    other atom's; the owned partners come first in a row; an all-pairs
    feature's pairs are shared evenly."""
    model, u, _ = lj_fluid_model(n_side, generator=gen(2), device="cpu")
    lay = FB.blocked_layout(*F._extract_model(model)[:2])
    op = lay.pair_operand()
    assert op.shape == (lay.pair_operand_size,) and op.dtype == np.int32
    n, n_coord = lay.n_active, len(lay.coord_npairs)
    ptr = op[:n_coord * (n + 1)].reshape(n_coord, n + 1)
    mid = op[n_coord * (n + 1):n_coord * (2 * n + 1)].reshape(n_coord, n)
    nbr = op[n_coord * (2 * n + 1):]
    pairs = np.asarray(lay.spec.coord_pairs).reshape(-1, 2)
    start = 0
    for k, npairs in enumerate(lay.coord_npairs):
        want = {tuple(sorted(p)) for p in pairs[start:start + npairs]}
        start += npairs
        owned, others = [], []
        for a in range(n):
            assert ptr[k, a] <= mid[k, a] <= ptr[k, a + 1]
            owned += [tuple(sorted((a, int(j))))
                      for j in nbr[ptr[k, a]:mid[k, a]]]
            others += [tuple(sorted((a, int(j))))
                       for j in nbr[mid[k, a]:ptr[k, a + 1]]]
        assert len(owned) == npairs and set(owned) == want
        assert len(others) == npairs and set(others) == want
        share = mid[k] - ptr[k, :-1]
        assert share.max() - share.min() <= 1 + n % 2


@pytest.mark.parametrize("group", [1, 8, 32, 256])
@pytest.mark.parametrize("n_residues", [6, 60])
def test_feature_batches(n_residues, group):
    """No two features of a batch share an atom, a batch has at most
    ``group`` features, and every bond, angle and dihedral is in exactly
    one batch."""
    model, _ = peptide_model(n_residues, generator=gen(1), device="cpu")
    spec, align_idx = F._extract_model(model)[:2]
    lay = FB.blocked_layout(spec, align_idx)
    ptr, ent = lay.feature_batches(group)
    tables = (lay.tables["angle_idx"].reshape(-1, 3),
              lay.tables["bond_idx"].reshape(-1, 2),
              lay.tables["dihedral_idx"].reshape(-1, 4))
    assert ptr[0] == 0 and ptr[-1] == len(ent) == sum(map(len, tables))
    assert sorted(ent.tolist()) == sorted(
        kind << 28 | item for kind, t in enumerate(tables)
        for item in range(len(t)))
    for b in range(len(ptr) - 1):
        atoms = [int(a) for e in ent[ptr[b]:ptr[b + 1]]
                 for a in tables[e >> 28][e & ((1 << 28) - 1)]]
        assert 0 < ptr[b + 1] - ptr[b] <= group
        assert len(atoms) == len(set(atoms))
    if group >= 32:  # a backbone's features meet few others: few batches
        assert len(ptr) - 1 <= -(-len(ent) // group) + 8


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


# ---------------------------------------------------------------------------
# The backward and train kernels
# ---------------------------------------------------------------------------


def host_launch_grads(host, frames, threads, n_blocks, acc_global):
    """A stand-in for ``fused_blocked._launch_grads`` that walks a grid of
    ``n_blocks`` blocks on the host, then the reduction."""
    def launch(kind, lay, ref_x, params, activation, x, tag, l, aux,
               aux_strides, gx, g_strides, want_ref, inv_count, pair_op):
        args, keep = FB.blocked_args(lay, ref_x, params, activation, pair_op,
                                     "cpu")
        keep += (FB.set_tile(args, lay, frames, "cpu", threads),)
        assert host.host_blk_grad_smem_bytes(
            ctypes.addressof(args), threads, int(gx is not None),
            int(acc_global)) > 0
        assert host.host_blk_grad_rows(ctypes.addressof(args), l) == min(
            -(-l // frames), FB.BLK_GRAD_BLOCKS)
        width = 1 + F._grad_width(lay.align_idx if lay.has_align else None,
                                  params)
        partials = torch.full((n_blocks * (width + FB.RECT_FLOATS * threads),),
                              float("nan"))
        out = torch.full((width,), float("nan"))
        io = FB.blocked_grads_io(kind, x, FB._strides(tag, lay.n_atoms, l), l,
                                 aux, aux_strides, gx, g_strides, want_ref,
                                 inv_count, acc_global, partials)
        host.host_blk_grads(ctypes.addressof(args), ctypes.addressof(io),
                            out.data_ptr(), threads,
                            int(kind == "blocked_train"), n_blocks)
        del keep
        return out
    return launch


def _host_setup(model, x):
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    lay = FB.blocked_layout(spec, align_idx)
    tag, l = FB._classify(x, lay.n_atoms)
    pair_op = (torch.from_numpy(lay.pair_operand()) if lay.coord_npairs
               else None)
    return lay, ref_x, params, act, tag, l, pair_op


def run_host_backward(host, model, x, gy, *, want_gx=True, want_ref=True,
                      frames=4, threads=32, n_blocks=3, acc_global=False):
    lay, ref_x, params, act, tag, l, pair_op = _host_setup(model, x)
    with mock.patch.object(FB, "_launch_grads", host_launch_grads(
            host, frames, threads, n_blocks, acc_global)):
        return FB._kernel_backward(lay, ref_x, params, act, x.contiguous(),
                                   tag, l, gy, want_gx,
                                   want_ref and lay.has_align, pair_op)


def run_host_train(host, model, x, yt, *, train_ref=False, frames=4,
                   threads=32, n_blocks=3, acc_global=False):
    lay, ref_x, params, act, tag, l, pair_op = _host_setup(model, x)
    d = F._out_dim(lay.spec, params)
    strides = (d, 1) if tuple(yt.shape) == (l, d) else (1, l)
    with mock.patch.object(FB, "_launch_grads", host_launch_grads(
            host, frames, threads, n_blocks, acc_global)):
        return FB._kernel_train(lay, ref_x, params, act, x.contiguous(), tag,
                                l, yt.contiguous(), strides,
                                train_ref and lay.has_align, pair_op)


def f64(parts):
    spec, align_idx, ref_x, params, act = parts
    return (spec, align_idx, None if ref_x is None else ref_x.double(),
            tuple((w.double(), b.double()) for w, b in params), act)


def close(got, want, slack=None):
    """Within 5e-5·max(1, max|want|) of the float64 reference."""
    want = want.detach()
    err = (got.double() - want).abs()
    if slack is not None:
        err = err.amax(dim=-1) - slack
    assert float(err.max()) <= 5e-5 * max(1.0, float(want.abs().max()))


def random_like(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32))


def check_backward(host, model, x, *, seed=20, **kw):
    """K7 on the host against the float64 plain version, [l, n, 3] input;
    twice, with equal bits; without gx the sums keep theirs."""
    parts = F._extract_model(model)
    d = F._out_dim(parts[0], parts[3])
    gy = random_like((x.shape[0], d), seed)
    gx_r, gp_r, gref_r = FB.blocked_backward_plain(*f64(parts), x.double(),
                                                   gy.double())
    gx, gp, g_ref = run_host_backward(host, model, x, gy, **kw)
    slack = FB.gradient_jump_slack(parts[0], parts[3], x.double())
    assert float(gx_r.abs().max()) > 0
    close(gx, gx_r, slack)
    for (gw, gb), (gw_r, gb_r) in zip(gp, gp_r):
        close(gw, gw_r)
        close(gb, gb_r)
    has_ref = FB.blocked_layout(parts[0], parts[1]).has_align
    assert (g_ref is not None) == has_ref
    if has_ref:
        assert float(gref_r.abs().max()) > 0
        close(g_ref, gref_r)
    gx2, gp2, g_ref2 = run_host_backward(host, model, x, gy, **kw)
    _, gp3, _ = run_host_backward(host, model, x, gy, want_gx=False,
                                  **{k: v for k, v in kw.items()
                                     if k != "want_gx"})
    assert torch.equal(gx, gx2)
    for a, b, c in zip(_flat(gp), _flat(gp2), _flat(gp3)):
        assert torch.equal(a, b) and torch.equal(a, c)
    if has_ref:
        assert torch.equal(g_ref, g_ref2)
    return gx, gp, g_ref


def _flat(gparams):
    return [t for wb in gparams for t in wb]


def check_train(host, model, x, *, train_ref=False, seed=21, t_layout=False,
                **kw):
    """K5 on the host against the float64 plain version; twice, equal bits."""
    parts = F._extract_model(model)
    d = F._out_dim(parts[0], parts[3])
    yt = random_like((x.shape[0], d), seed)
    loss_r, gp_r, gref_r = FB.blocked_train_grads_plain(
        *f64(parts), x.double(), yt.double(), train_ref)
    yin = yt.T.contiguous() if t_layout else yt
    loss, gp, g_ref = run_host_train(host, model, x, yin, train_ref=train_ref,
                                     **kw)
    np.testing.assert_allclose(float(loss), float(loss_r), rtol=1e-5)
    for (gw, gb), (gw_r, gb_r) in zip(gp, gp_r):
        assert float(gw_r.abs().max()) > 0
        close(gw, gw_r)
        close(gb, gb_r)
    if g_ref is not None:
        close(g_ref, gref_r)
        assert bool(g_ref.any()) == bool(train_ref)
    loss2, gp2, g_ref2 = run_host_train(host, model, x, yin,
                                        train_ref=train_ref, **kw)
    assert torch.equal(loss, loss2)
    for a, b in zip(_flat(gp), _flat(gp2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("frames,threads,n_blocks,acc_global", [
    (4, 32, 3, False), (16, 256, 2, False), (1, 32, 5, True),
    (8, 64, 1, False), (32, 64, 4, True), (8, 64, 3, 2), (2, 256, 2, 2)])
def test_backward_peptide(host, frames, threads, n_blocks, acc_global):
    """gx and the parameter sums over several blocks, each over several
    tiles, the last one ragged; sums in shared memory and in the row."""
    model, u = peptide_model(6, generator=gen(1), device="cpu")
    check_backward(host, model, frames_of(u, 37, 0), frames=frames,
                   threads=threads, n_blocks=n_blocks, acc_global=acc_global)


@pytest.mark.parametrize("train_ref", [False, True])
@pytest.mark.parametrize("frames,threads,n_blocks,acc_global", [
    (4, 32, 3, False), (16, 256, 2, True), (1, 32, 5, False)])
def test_train_peptide(host, frames, threads, n_blocks, acc_global,
                       train_ref):
    model, u = peptide_model(6, generator=gen(1), device="cpu")
    check_train(host, model, frames_of(u, 37, 0), train_ref=train_ref,
                frames=frames, threads=threads, n_blocks=n_blocks,
                acc_global=acc_global)


@pytest.mark.parametrize("hidden_dims", [(32, 2), (6, 3), (9, 70, 2)])
@pytest.mark.parametrize("frames,threads,n_blocks", [
    (8, 256, 2), (2, 64, 3), (1, 32, 4), (32, 64, 1)])
def test_tiled_layers(host, hidden_dims, frames, threads, n_blocks):
    """Layers of 64 inputs and more run register-tiled, forwards (slices of
    the inputs, their partial sums added in order) and backwards, with
    output counts that are and are not multiples of four and a tiled layer
    above the first; the first layer's parameter step runs in rectangles
    where they fit the thread count."""
    model, u = peptide_model(12, hidden_dims=hidden_dims, generator=gen(1),
                             device="cpu")
    assert model.preprocessing_layer.output_dimension() >= 64
    x = frames_of(u, 19, 0)
    check(host, model, x, frames=frames, threads=threads)
    check_backward(host, model, x, frames=frames, threads=threads,
                   n_blocks=n_blocks)
    check_train(host, model, x, frames=frames, threads=threads,
                n_blocks=n_blocks)


def test_tiled_layer_with_alignment(host):
    """A tiled layer above the first in a model with alignment: the
    activation's slope in the tiled backward step, sums in shared memory."""
    model, u = alanine_model(hidden_dims=(70, 3), generator=gen(3),
                             device="cpu")
    x = frames_of(u, 21, 1)
    check(host, model, x, frames=8, threads=64)
    check_backward(host, model, x, frames=8, threads=64)
    check_train(host, model, x, train_ref=True, frames=8, threads=64)


@pytest.mark.parametrize("acc_global", [FB.SUMS_SHARED, FB.SUMS_ROW,
                                        FB.SUMS_RECT])
@pytest.mark.parametrize("build,threads,rectangles", [
    ("peptide", 64, 1), ("peptide", 256, 0), ("peptide12", 256, 1),
    ("peptide12", 32, 0), ("fluid", 32, 0), ("alanine", 32, 1),
    ("alanine", 256, 0)])
def test_sum_routes(host, build, threads, rectangles, acc_global):
    """The routes of the running sums: a large layer's weight gradient
    formed in rectangles of 4 x 6 entries a thread where they fit the
    thread count (not for a layer too small to matter, not when there are
    more rectangles than threads), else entry by entry; the sums in shared
    memory, in the block's row of partials, or in shared memory but for the
    largest rectangle layer's weight gradient, which lives behind the rows
    strided by the thread count."""
    if build == "fluid":
        model, u, _ = lj_fluid_model(3, generator=gen(2), device="cpu")
    elif build == "alanine":
        model, u = alanine_model(generator=gen(3), device="cpu")
    else:
        model, u = peptide_model(12 if build == "peptide12" else 6,
                                 generator=gen(1), device="cpu")
    x = (frames_of(u, 9, 3, sigma=1.5) if build == "fluid"
         else frames_of(u, 13, 0))
    lay, ref_x, params, act, _, _, pair_op = _host_setup(model, x)
    args, keep = FB.blocked_args(lay, ref_x, params, act, pair_op, "cpu")
    keep += (FB.set_tile(args, lay, 4, "cpu", threads),)
    assert host.host_blk_rect_layers(ctypes.addressof(args),
                                     threads) == rectangles
    check_backward(host, model, x, threads=threads, acc_global=acc_global)
    check_train(host, model, x, threads=threads, acc_global=acc_global)


@pytest.mark.parametrize("want_gx", [True, False])
@pytest.mark.parametrize("want_ref", [True, False])
def test_backward_asks(host, want_gx, want_ref):
    """Only what was asked for: without gx no pair gradient and no
    accumulators (and the shared memory they would take), without the
    ref_x gradient no sum for it; the parameter sums keep their bits."""
    model, u = alanine_model(generator=gen(3), device="cpu")
    x = frames_of(u, 21, 1)
    gy = random_like((21, 3), 20)
    gx0, gp0, gref0 = run_host_backward(host, model, x, gy)
    gx, gp, g_ref = run_host_backward(host, model, x, gy, want_gx=want_gx,
                                      want_ref=want_ref)
    assert (gx is not None) == want_gx and (g_ref is not None) == want_ref
    if want_gx:
        assert torch.equal(gx, gx0)
    if want_ref:
        assert torch.equal(g_ref, gref0)
    for a, b in zip(_flat(gp), _flat(gp0)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", [
    dict(), dict(use_angle_value=True), dict(activation="relu"),
    dict(activation="sigmoid"), dict(hidden_dims=(8, 6, 2)),
    dict(include_position=False),
])
def test_backward_and_train_alanine(host, case):
    """Alignment: gx through dR/dH, the ref_x gradient, and the train
    kernel with and without it."""
    model, u = alanine_model(generator=gen(3), device="cpu", **case)
    x = frames_of(u, 21, 1)
    check_backward(host, model, x)
    check_train(host, model, x, train_ref=False)
    check_train(host, model, x, train_ref=True, t_layout=True)


def test_backward_uncentred_reference(host):
    model, u = alanine_model(generator=gen(9), device="cpu")
    model.preprocessing_layer.align_layer.ref_x += torch.tensor(
        [0.7, -1.3, 0.4])
    x = frames_of(u, 21, 5)
    check_backward(host, model, x)
    check_train(host, model, x, train_ref=True)


@pytest.mark.parametrize("aligned", [True, False])
def test_backward_feature_layer_only(host, aligned):
    """No MLP: gy is over the feature columns in final order; there are no
    parameter sums, only gx and (with alignment) the ref_x gradient."""
    model, u = alanine_model(device="cpu")
    pp = model.preprocessing_layer
    if not aligned:
        pp = PreprocessingANN(None, pp.feature_layer)
    _, gp, g_ref = check_backward(host, pp, frames_of(u, 19, 2))
    assert gp == () and (g_ref is not None) == aligned


@pytest.mark.parametrize("n_side", [3, 4])
def test_backward_and_train_lj_fluid(host, n_side):
    model, u, _ = lj_fluid_model(n_side, generator=gen(2), device="cpu")
    x = frames_of(u, 9, 3, sigma=1.5)
    check_backward(host, model, x)
    check_train(host, model, x)


def test_backward_switching_forms(host):
    model, pp, u = mixed_coordination_model()
    x = frames_of(u, 7, 6, sigma=0.6)
    check_backward(host, model, x)
    check_backward(host, pp, x)
    check_train(host, model, x)


def test_backward_compaction(host):
    model, u = sparse_model()
    x = frames_of(u, 11, 7)
    gx, _, _ = check_backward(host, model, x)
    active = F.active_atom_indices(model)
    inactive = np.setdiff1d(np.arange(u.atoms.n_atoms), active)
    assert not gx[:, inactive].any()
    check_train(host, model, x, train_ref=True)


@pytest.mark.parametrize("layout", ["packed", "t", "cmajor"])
def test_backward_layouts(host, layout):
    """gx comes back in the layout of x, with the bits of [l, n, 3]; the
    parameter sums do not depend on the layout."""
    model, u = peptide_model(4, generator=gen(5), device="cpu")
    n, l = u.atoms.n_atoms, 13
    x = frames_of(u, l, 8)
    gy = random_like((l, 2), 22)
    gx0, gp0, _ = run_host_backward(host, model, x, gy)
    xin = {"packed": x.reshape(l, 3 * n),
           "t": x.reshape(l, 3 * n).T.contiguous(),
           "cmajor": x.permute(2, 1, 0).contiguous()}[layout]
    gx, gp, _ = run_host_backward(host, model, xin, gy)
    assert gx.shape == xin.shape
    back = {"packed": lambda g: g.reshape(l, n, 3),
            "t": lambda g: g.T.reshape(l, n, 3),
            "cmajor": lambda g: g.permute(2, 1, 0)}[layout]
    np.testing.assert_array_equal(back(gx).numpy(), gx0.numpy())
    for a, b in zip(_flat(gp), _flat(gp0)):
        assert torch.equal(a, b)
    yt = random_like((l, 2), 23)
    loss0, gt0, _ = run_host_train(host, model, x, yt)
    loss, gt, _ = run_host_train(host, model, xin, yt.T.contiguous())
    assert torch.equal(loss, loss0)
    for a, b in zip(_flat(gt), _flat(gt0)):
        assert torch.equal(a, b)


def test_choose_frames_backward():
    """The backward case: where the running sums push four blocks off an
    SM, two blocks at 8 to 32 frames come before one block's 227 KB."""
    fixed = 46 * 1024

    def smem(frames):
        return fixed + 1289 * (frames | 1) * 4

    assert FB.choose_frames(smem) == 32            # one block, as before
    assert FB.choose_frames(smem, backward=True) == 8
    assert FB.choose_frames(lambda f: 1289 * (f | 1) * 4, backward=True) == 8
    assert FB.choose_frames(lambda f: 100 * (f | 1) * 4, 64,
                            backward=True) == 1
    # a model that is its pair walk: two blocks at the largest tile first
    rows = 636 * 4  # the 125-atom contact model's forward rows, in bytes
    assert FB.choose_frames(lambda f: rows * (f | 1)) == 16
    assert FB.choose_frames(lambda f: rows * (f | 1), pairs=True) == 32
    assert FB.choose_frames(lambda f: 1386 * 4 * (f | 1), backward=True,
                            pairs=True) == 16
    assert FB.choose_frames(lambda f: rows * (f | 1), 1024, pairs=True) == 8
    fluid, _, _ = lj_fluid_model(3, generator=gen(2), device="cpu")
    peptide, _ = peptide_model(6, generator=gen(1), device="cpu")
    assert FB.pair_heavy(FB.blocked_layout(*F._extract_model(fluid)[:2]))
    assert not FB.pair_heavy(FB.blocked_layout(*F._extract_model(peptide)[:2]))


@pytest.mark.parametrize("activation", ["gelu", "elu", "celu", "softplus",
                                        "swish"])
def test_activation_forms(host, activation):
    """act_fwd and act_grad as the blocked steps call them, against the
    eager model's activation and its derivative by torch.autograd."""
    z = np.linspace(-12.0, 12.0, 241).astype(np.float32)
    t, g = np.empty_like(z), np.empty_like(z)
    host.host_act(F.KERNEL_ACTIVATIONS[activation], z.ctypes.data,
                  t.ctypes.data, g.ctypes.data, z.size)
    zz = torch.from_numpy(z).double().requires_grad_(True)
    tt = ACTIVATIONS[activation](zz)
    (gg,) = torch.autograd.grad(tt.sum(), zz)
    np.testing.assert_allclose(t, tt.detach().numpy(), rtol=2e-6, atol=2e-7)
    np.testing.assert_allclose(g, gg.numpy(), rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("activation", ["gelu", "elu", "celu", "softplus",
                                        "swish"])
def test_activations_through_the_steps(host, activation):
    """Each activation through K6, K8, K7 and K5 on the host: a tiled first
    layer (70 outputs, slices whose sums meet in the scratch) above a
    small one, so that gelu and swish read their kept pre-activations in
    both backward bodies; and alanine with alignment."""
    model, u = peptide_model(12, hidden_dims=(70, 6, 2), activation=activation,
                             generator=gen(4), device="cpu")
    x = frames_of(u, 19, 2)
    check(host, model, x, frames=8, threads=64)
    check_backward(host, model, x, frames=8, threads=64)
    check_train(host, model, x, frames=8, threads=64)
    model, u = alanine_model(hidden_dims=(8, 6, 3), activation=activation,
                             generator=gen(5), device="cpu")
    x = frames_of(u, 21, 3)
    check(host, model, x)
    check_backward(host, model, x)
    check_train(host, model, x, train_ref=True)
