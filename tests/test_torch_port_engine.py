"""The engine artifact's C++ side on the CPU: the torch custom ops'
schemas, the launches they make, and the serving container.

- The op schemas (``csrc/torch_ops.cpp``) build with g++ against PyTorch
  alone; a fused artifact scripted against them names each op it calls
  (the analogue of ``tests/test_export.py``'s ``tpu_custom_call`` check),
  carries the pair operand as one buffer, and refuses CPU tensors.
- The CUDA ops hand their tables to ``csrc/torch_ops_launch.cpp``, which
  rebuilds ``ModelArgs``/``BlockedArgs`` and chooses the launch. Here it is
  built with a stub of the kernel library that records what it is given,
  and each struct is held, field by field and table by table, to the one
  the Python route (``ops/fused.py``, ``ops/fused_blocked.py``) builds for
  the same model and batch: the same kernel then reads the same bytes.
- ``serve_torch`` (``csrc/serve_torch.cpp``) runs eager artifacts with
  ``--device cpu`` from ``.npy`` and ``.dcd``, against
  ``evaluate_trajectory(device="cpu")`` and the JAX model on the same
  weights: values 1e-5, gradients 5e-5·max(1, max|g|) (the artifact aligns
  every atom, the plain serving route only the positions' atoms, JAX sums
  in its own order).

Frames come from numpy seeds; every model is small.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from molann_tpu_torch.io import export_artifact, load_artifact, save_model
from molann_tpu_torch.io.export import artifact_info
from molann_tpu_torch.ops import _build
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.ops import fused_blocked as FB
from molann_tpu_torch.serve import evaluate_trajectory
from molann_tpu_torch.systems import (
    alanine_model,
    lj_fluid_model,
    peptide_model,
)

VAL_TOL = 1e-5
GRAD_RTOL = 5e-5


@pytest.fixture(autouse=True)
def gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed")


def _frames(u, l, seed, sigma=0.05):
    rng = np.random.default_rng(seed)
    return (u.atoms.positions[None]
            + sigma * rng.normal(size=(l,) + u.atoms.positions.shape)
            ).astype(np.float32)


def _models():
    gen = torch.Generator().manual_seed(3)
    return {
        "alanine": alanine_model(generator=gen, device="cpu")[:2],
        "alanine_deep": alanine_model(hidden_dims=(8,) * 5 + (2,),
                                      generator=gen, device="cpu")[:2],
        "peptide": peptide_model(16, generator=gen, device="cpu")[:2],
        "fluid": lj_fluid_model(3, generator=gen, device="cpu")[:2],
    }


@pytest.fixture(scope="module")
def models():
    return _models()


# ---------------------------------------------------------------------------
# schemas and fused artifacts
# ---------------------------------------------------------------------------


def test_op_schemas_build_without_nvcc():
    path = _build.load_op_library(cuda=False)
    assert path.endswith(".so")
    ops = torch.ops.molann_tpu_torch
    ops.reset_launch_counts()
    counts = ops.launch_counts()
    assert counts.dtype == torch.int64 and counts.tolist() == [0, 0, 0, 0]


@pytest.mark.parametrize("name,mode,op", [
    ("alanine", "unrolled", "unrolled"),
    ("alanine_deep", "blocked", "blocked"),
    ("peptide", "blocked", "blocked"),
    ("fluid", "blocked", "blocked"),
])
@pytest.mark.parametrize("with_gradient", [False, True])
def test_fused_artifact_names_its_op(models, name, mode, op, with_gradient):
    model, u = models[name]
    n = u.atoms.n_atoms
    assert F.model_select_mode(model) == mode
    blob = export_artifact(model, n, fused=True, with_gradient=with_gradient,
                           batch_size=16)
    info = artifact_info(blob)
    assert info == {"format": 1, "fused": True, "mode": mode,
                    "with_gradient": with_gradient, "n_atoms": n,
                    "d_out": int(model.ann_layers.layer_dims[-1]),
                    "batch_size": 16}
    art = load_artifact(blob, device="cpu")
    want = f"ops.molann_tpu_torch.{op}_{'cv_forces' if with_gradient else 'forward'}"
    assert want in art.code
    assert "molann_tpu_torch" in art.code and art.batch_size == 16
    if name == "fluid":
        # the pair operand is one buffer of the artifact
        lay = FB.blocked_layout(*F._extract_model(model)[:2])
        np.testing.assert_array_equal(art.pairs.numpy(), lay.pair_operand())
    x = torch.as_tensor(_frames(u, 16, 0))
    with pytest.raises((NotImplementedError, RuntimeError),
                       match="CPU|molann_tpu_torch"):
        art(x)
    with pytest.raises(Exception, match="batch"):
        art(x[:8])


def test_fused_export_checks_its_arguments(models):
    model, u = models["alanine"]
    with pytest.raises(ValueError, match="22 atoms"):
        export_artifact(model, 21, fused=True)
    with pytest.raises(ValueError, match="tile"):
        export_artifact(model, 22, fused=True, tile=0)
    with pytest.raises(ValueError, match="batch_size"):
        export_artifact(model, 22, batch_size=0)
    fluid, fu = models["fluid"]
    with pytest.raises(ValueError, match="c_mat"):
        export_artifact(fluid, fu.atoms.n_atoms, fused=True,
                        c_mat=np.zeros(3, np.int32))


def test_load_artifact_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    model, _ = alanine_model(device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_artifact(export_artifact(model, 22))


# ---------------------------------------------------------------------------
# the launches, held to the Python route's through a stub kernel library
# ---------------------------------------------------------------------------

STUB = r"""
#include <string.h>
#include "blocked_math.cuh"

static ModelArgs g_m;
static UnrIO g_io;
static BlockedArgs g_b;
static BlockedIO g_bio;
static int g_last[4];  // forces, warps, blocks, grid queries
static int g_head[256];  // the head table the call's host copy held

extern "C" {
int molann_caps(int* out) {
  out[0] = MOLANN_MAX_ATOMS; out[1] = MOLANN_MAX_COLS; out[2] = MOLANN_MAX_WIDTH;
  out[3] = MOLANN_MAX_LAYERS; out[4] = (int)sizeof(ModelArgs); out[5] = (int)sizeof(UnrIO);
  return 0;
}
int molann_blocked_caps(int* out) {
  out[0] = MOLANN_COORD_FLOATS; out[1] = MOLANN_BLK_THREADS; out[2] = (int)sizeof(BlockedArgs);
  out[3] = (int)sizeof(BlockedIO); out[4] = MOLANN_BLK_GRAD_BLOCKS;
  return 0;
}
int molann_fused_grid(const ModelArgs*, int, int, int* out) {
  out[0] = 4; out[1] = 3; out[2] = 132; g_last[3] += 1;
  return 0;
}
int molann_fused_forward(const ModelArgs* m, const UnrIO* io, int forces, int warps, int blocks,
                         int, void*) {
  g_m = *m; g_io = *io; g_last[0] = forces; g_last[1] = warps; g_last[2] = blocks;
  return 0;
}
static void keep_blocked(const BlockedArgs* m, const BlockedIO* io, int forces) {
  g_b = *m; g_bio = *io; g_last[0] = forces;
  memcpy(g_head, m->head_host, sizeof(int) * 8 * (m->n_layers > 1 ? m->n_layers : 1));
  g_b.head_host = g_head;
}
int molann_blocked_forward(const BlockedArgs* m, const BlockedIO* io, int, void*) {
  keep_blocked(m, io, 0);
  return 0;
}
int molann_blocked_cv_forces(const BlockedArgs* m, const BlockedIO* io, int, void*) {
  keep_blocked(m, io, 1);
  return 0;
}
// the kernel library's sizing of a forward or cv+forces block (fused_blocked.cu)
int stub_blocked_threads(const BlockedArgs* m, int kind) { return blk_threads(*m, kind != 0); }
long long stub_blocked_smem_bytes(const BlockedArgs* m, int kind) {
  return (long long)blk_smem(*m, blk_threads(*m, kind != 0), kind != 0).total * 4;
}
void stub_last(void* m, void* io, void* b, void* bio, int* last) {
  memcpy(m, &g_m, sizeof g_m); memcpy(io, &g_io, sizeof g_io);
  memcpy(b, &g_b, sizeof g_b); memcpy(bio, &g_bio, sizeof g_bio);
  memcpy(last, g_last, sizeof g_last);
}
}
"""


@pytest.fixture(scope="module")
def stub(tmp_path_factory):
    d = tmp_path_factory.mktemp("stub")
    (d / "stub.cpp").write_text(STUB)
    so = d / "libstub.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{_build.SRC_DIR}",
                    str(d / "stub.cpp"), str(_build.SRC_DIR /
                                             "torch_ops_launch.cpp"),
                    "-o", str(so)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i64 = ctypes.c_void_p, ctypes.c_longlong
    for fn in (lib.molann_op_unrolled, lib.molann_op_blocked):
        fn.restype = ctypes.c_int
    lib.molann_op_unrolled.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp,
                                       i64, ctypes.c_int, ctypes.c_int, vp]
    lib.molann_op_blocked.argtypes = [vp, ctypes.c_int, vp, vp, vp, vp, vp,
                                      vp, i64, ctypes.c_int, ctypes.c_int, vp]
    lib.molann_op_shape.argtypes = [vp, ctypes.c_int, ctypes.c_int, vp, vp,
                                    vp]
    lib.stub_blocked_threads.argtypes = [vp, ctypes.c_int]
    lib.stub_blocked_smem_bytes.argtypes = [vp, ctypes.c_int]
    lib.stub_blocked_smem_bytes.restype = i64
    lib.stub_last.argtypes = [vp, vp, vp, vp, vp]
    return lib


def _read(ptr, n, ctype):
    """n values at address ptr (None for a null pointer)."""
    if not ptr:
        return None
    return list((ctype * n).from_address(ptr)) if n else []


def _same_tables(got, want, sizes):
    """Every pointer field of two ctypes structs reads the same values."""
    for field, (n, ctype) in sizes.items():
        g = _read(getattr(got, field), n, ctype)
        w = _read(getattr(want, field), n, ctype)
        assert g == w, field


def _call(stub, fn, tables, l, forces, *pairs):
    meta = np.asarray(tables["meta"], np.int64)
    x = np.zeros(1, np.float32)
    rc = fn(meta.ctypes.data, meta.size, tables["ints"].data_ptr(),
            tables["floats"].data_ptr(), *pairs, x.ctypes.data,
            x.ctypes.data + 4, x.ctypes.data + 8, l, int(forces), 0, None)
    assert rc == 0
    m, io = F.ModelArgs(), F.UnrIO()
    b, bio = FB.BlockedArgs(), FB.BlockedIO()
    last = (ctypes.c_int * 4)()
    stub.stub_last(ctypes.addressof(m), ctypes.addressof(io),
                   ctypes.addressof(b), ctypes.addressof(bio), last)
    return (m, io, b, bio, list(last)), x.ctypes.data


@pytest.mark.parametrize("l", [1, 100, 70000])
@pytest.mark.parametrize("forces", [False, True])
def test_unrolled_launch_matches_the_python_route(stub, models, l, forces):
    model, u = models["alanine"]
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    tables = F.artifact_tables(model)
    (m, io, _, _, last), xp = _call(stub, stub.molann_op_unrolled, tables, l,
                                    forces)
    want, _keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                               "cv_forces" if forces else "forward")
    ints = ("n_atoms", "n_angles", "n_bonds", "n_dihedrals", "n_pos",
            "n_align", "n_coord", "use_angle_value", "n_feat", "n_layers",
            "activation", "n_slots")
    assert [getattr(m, f) for f in ints] == [getattr(want, f) for f in ints]
    assert list(m.dims) == list(want.dims)
    dims = list(want.dims)
    i32, f32 = ctypes.c_int, ctypes.c_float
    sizes = {"angle_idx": (3 * m.n_angles, i32),
             "bond_idx": (2 * m.n_bonds, i32),
             "dihedral_idx": (4 * m.n_dihedrals, i32),
             "pos_idx": (m.n_pos, i32), "align_idx": (m.n_align, i32),
             "col_of": (m.n_feat, i32), "coord_start": (m.n_coord + 1, i32),
             "coord_pairs": (2 * len(spec.coord_pairs), i32),
             "coord_par": (F.COORD_FLOATS * m.n_coord, f32),
             "ref_x": (3 * m.n_align, f32),
             "slot_col": (3 * m.n_slots, i32),
             "col_slot": (3 * m.n_atoms, i32)}
    _same_tables(m, want, sizes)
    for i in range(F.KERNEL_MAX_LAYERS):
        n_w = dims[i + 1] * dims[i] if i < m.n_layers else 0
        assert _read(m.w[i], n_w, f32) == _read(want.w[i], n_w, f32)
        assert _read(m.b[i], dims[i + 1], f32) == _read(want.b[i],
                                                        dims[i + 1], f32)
    # the frames and outputs as passed, [l, n, 3] in and out, sum of y
    assert (io.x, io.y, io.gx) == (xp, xp + 4, xp + 8 if forces else None)
    assert (io.l, io.in_t, io.out_t, io.component) == (l, 0, 0, -1)
    assert last[:3] == [int(forces), 4, 3 * 132]


def _blocked_want(stub, model, l, forces):
    """The Python route's BlockedArgs for a launch of l frames."""
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    lay = FB.blocked_layout(spec, align_idx)
    pair_op = (torch.from_numpy(lay.pair_operand()) if lay.coord_npairs
               else None)
    args, keep = FB.blocked_args(lay, ref_x, params, act, pair_op, "cpu")

    def smem(frames):
        args.frames, args.pitch = frames, frames | 1
        return stub.stub_blocked_smem_bytes(ctypes.addressof(args),
                                            int(forces))

    frames = FB.choose_frames(smem, l, backward=forces,
                              pairs=FB.pair_heavy(lay))
    args.frames, args.pitch = frames, frames | 1
    keep += (FB.set_tile(args, lay, frames, "cpu", stub.stub_blocked_threads(
        ctypes.addressof(args), int(forces))),)
    return args, keep, lay


@pytest.mark.parametrize("name", ["alanine_deep", "peptide", "fluid"])
@pytest.mark.parametrize("l", [1, 300, 5000, 70000])
@pytest.mark.parametrize("forces", [False, True])
def test_blocked_launch_matches_the_python_route(stub, models, name, l,
                                                 forces):
    model, u = models[name]
    tables = FB.artifact_tables(model)
    pairs = tables["pairs"]
    (_, _, b, bio, last), xp = _call(
        stub, stub.molann_op_blocked, tables, l, forces,
        pairs.data_ptr() if pairs.numel() else None)
    want, _keep, lay = _blocked_want(stub, model, l, forces)
    ints = [f for f, t in FB.BlockedArgs._fields_ if t is ctypes.c_int]
    assert [getattr(b, f) for f in ints] == [getattr(want, f) for f in ints]
    i32, f32 = ctypes.c_int, ctypes.c_float
    n_items = (b.n_angles + b.n_bonds + b.n_dihedrals + b.n_coord + b.n_pos)
    n_ent = _read(want.atom_ptr, b.n_act + 1, i32)[-1]
    n_bent = _read(want.batch_ptr, b.n_batches + 1, i32)[-1]
    n_params = sum(-(-t.numel() // 4) * 4 for w, bb in
                   F._extract_model(model)[3] for t in (w, bb))
    sizes = {"active_idx": (b.n_act, i32), "out_map": (b.n_out, i32),
             "angle_idx": (3 * b.n_angles, i32),
             "bond_idx": (2 * b.n_bonds, i32),
             "dihedral_idx": (4 * b.n_dihedrals, i32),
             "pos_idx": (b.n_pos, i32), "align_idx": (b.n_align, i32),
             "item_col": (n_items, i32), "atom_ptr": (b.n_act + 1, i32),
             "atom_ent": (n_ent, i32), "coord_range": (2 * b.n_coord, i32),
             "batch_ptr": (b.n_batches + 1, i32),
             "batch_ent": (n_bent, i32),
             "head": (8 * max(1, b.n_layers), i32),
             "head_host": (8 * max(1, b.n_layers), i32),
             "nbr_ptr": (b.n_coord * (b.n_act + 1), i32),
             "nbr_mid": (b.n_coord * b.n_act, i32),
             "nbr": (2 * lay.n_pairs, i32),
             "coord_par": (FB.BLK_COORD_FLOATS * b.n_coord, f32),
             "ref_x": (3 * b.n_align, f32), "params": (n_params, f32)}
    _same_tables(b, want, sizes)
    strides = ("x_sf", "x_sa", "x_sc", "y_sf", "y_sj", "g_sf", "g_sa", "g_sc")
    n3 = 3 * lay.n_atoms
    d_out = int(model.ann_layers.layer_dims[-1])
    assert [getattr(bio, f) for f in strides] == [
        n3, 3, 1, d_out, 1, *((n3, 3, 1) if forces else (0, 0, 0))]
    assert (bio.x, bio.y, bio.gx, bio.l, bio.component) == (
        xp, xp + 4, xp + 8 if forces else None, l, -1)
    assert last[0] == int(forces)


def test_meta_of_another_format_is_refused(stub, models):
    model, _ = models["alanine"]
    tables = F.artifact_tables(model)
    bad = dict(tables, meta=[2, *tables["meta"][1:]])
    meta = np.asarray(bad["meta"], np.int64)
    rc = stub.molann_op_unrolled(meta.ctypes.data, meta.size,
                                 tables["ints"].data_ptr(),
                                 tables["floats"].data_ptr(), None, None,
                                 None, 1, 0, 0, None)
    assert rc == -1
    meta = np.asarray(tables["meta"][:-1], np.int64)
    out = (ctypes.c_int64 * 3)()
    assert stub.molann_op_shape(meta.ctypes.data, meta.size, 0, out,
                                ctypes.addressof(out) + 8,
                                ctypes.addressof(out) + 16) == -1


# ---------------------------------------------------------------------------
# the serving container
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve_bin():
    return _build.build_serve_torch()


@pytest.fixture(scope="module")
def served(tmp_path_factory, models):
    """An alanine trajectory as .npy and .dcd, and the model's .npz."""
    from molann_tpu_torch.io import write_dcd

    d = tmp_path_factory.mktemp("serve")
    model, u = models["alanine"]
    x = _frames(u, 203, 7)
    np.save(d / "traj.npy", x)
    write_dcd(str(d / "traj.dcd"), x)
    save_model(d / "model.npz", model)
    return d, model, x


def _serve(serve_bin, *args):
    return subprocess.run([serve_bin, *map(str, args)], capture_output=True,
                          text=True, timeout=300)


@pytest.mark.parametrize("ext", ["npy", "dcd"])
@pytest.mark.parametrize("with_gradient", [False, True])
def test_serve_torch_on_cpu_matches_evaluate_and_jax(serve_bin, served, ext,
                                                     with_gradient):
    from molann_tpu.io import load_model as jax_load_model

    d, model, x = served
    art = d / f"eager_{int(with_gradient)}.pt"
    export_artifact(model, 22, art, with_gradient=with_gradient)
    out = d / f"out_{ext}_{int(with_gradient)}.npy"
    proc = _serve(serve_bin, art, d / f"traj.{ext}", out, 64, "--device",
                  "cpu", "--verbose")
    assert proc.returncode == 0, proc.stderr
    assert "served 203 frames" in proc.stderr and "timing: read" in \
        proc.stderr
    y = np.load(out)
    jmodel = jax_load_model(d / "model.npz")
    xj = jnp.asarray(x)
    y_jax = np.asarray(jmodel(xj))
    if with_gradient:
        cvs, grads = evaluate_trajectory(model, d / f"traj.{ext}",
                                         device="cpu", forces=True,
                                         batch_size=64)
        g = np.load(d / f"out_{ext}_{int(with_gradient)}.grad.npy")
        assert g.shape == (203, 66)
        g_jax = np.asarray(jax.grad(lambda v: jnp.sum(jmodel(v)))(xj))
        for ref in (grads, g_jax):
            tol = GRAD_RTOL * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(g, ref.reshape(203, 66), atol=tol)
    else:
        cvs = evaluate_trajectory(model, d / f"traj.{ext}", device="cpu",
                                  batch_size=64)
    assert y.shape == (203, 3)
    np.testing.assert_allclose(y, cvs, atol=VAL_TOL)
    np.testing.assert_allclose(y, y_jax, atol=VAL_TOL)


def test_serve_torch_refusals(serve_bin, served):
    d, model, _ = served
    eager = d / "eager_refusals.pt"
    export_artifact(model, 22, eager, batch_size=32)
    fused = d / "fused_refusals.pt"
    export_artifact(model, 22, fused, fused=True, with_gradient=True)
    traj, out = d / "traj.npy", d / "refused.npy"
    if not torch.cuda.is_available():
        proc = _serve(serve_bin, eager, traj, out)  # --device cuda
        assert proc.returncode == 1 and "no CUDA device" in proc.stderr
    proc = _serve(serve_bin, eager, traj, out, 64, "--device", "cpu")
    assert proc.returncode == 1 and "batches of 32" in proc.stderr
    proc = _serve(serve_bin, eager, traj, out, "--device", "cpu")
    assert proc.returncode == 0 and "batch 32" in proc.stderr
    # a fused artifact: without its op library it does not load, and with
    # the schemas alone it has no CPU kernel
    proc = _serve(serve_bin, fused, traj, out, "--device", "cpu")
    assert proc.returncode == 1 and "--ops" in proc.stderr
    schemas = _build.load_op_library(cuda=False)
    proc = _serve(serve_bin, fused, traj, out, "--device", "cpu", "--ops",
                  schemas, "--verbose")
    assert proc.returncode == 1 and "CPU" in proc.stderr
    proc = _serve(serve_bin, eager, traj)
    assert proc.returncode == 2 and "usage" in proc.stderr
    proc = _serve(serve_bin, eager, d / "missing.npy", out, "--device",
                  "cpu")
    assert proc.returncode == 1 and "open trajectory" in proc.stderr


def test_serve_torch_in_flight_flag(serve_bin, served):
    """``--in-flight K`` sets the batches in flight on each card; it must
    be positive, and the host's serial path gives the same bits whatever
    it is."""
    d, model, _ = served
    art = d / "eager_in_flight.pt"
    export_artifact(model, 22, art)
    outs = []
    for k in ("1", "3"):
        out = d / f"in_flight_{k}.npy"
        proc = _serve(serve_bin, art, d / "traj.npy", out, 64, "--device",
                      "cpu", "--in-flight", k)
        assert proc.returncode == 0, proc.stderr
        assert "batch 64 on cpu" in proc.stderr
        outs.append(np.load(out))
    np.testing.assert_array_equal(outs[0], outs[1])
    proc = _serve(serve_bin, art, d / "traj.npy", d / "x.npy", "--device",
                  "cpu", "--in-flight", "0")
    assert proc.returncode == 1 and "--in-flight" in proc.stderr
