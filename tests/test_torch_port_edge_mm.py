"""The edge-product probe's plain versions, on the CPU.

``molann_tpu_torch.probes.edge_mm_probe.edge_mm`` computes ``D [M, K] @ x
[K, N]`` (D 0/±1) in seven bodies; on the CPU it runs ``edge_mm_plain``,
the plain PyTorch version of each body's arithmetic. Each is held against
float64 numpy within the error its scheme allows, as a fraction of
``max|truth|`` (the measure of scripts/int8_mm_probe.py:196-207):

- ``f32``, ``gather``, ``split3``, ``fixed4``: a few f32 roundings, 3e-7;
- ``bf16``: one bf16 rounding of x, 2^-9 of |x| ≤ 30 per term: 4e-3;
- ``fixed2``: x to the nearest 2^-9 Å, at most 2^-10 off per term and
  a dozen terms a row: 2e-4;
- ``int8``: the timing unit of the TPU probe; it multiplies
  ``clip(round(x / 256))`` and is exact in that, so it is held to its own
  definition.

``split3`` is also held against the JAX package's ``_split3_mm``
(molann_tpu/ops/fused_blocked.py:112) on the same D and x.

The kernels' host-side pieces are held here too: ``prepare_edge_matrix``'s
forms of D (the tensor-core image, whose bytes read as ``64·D`` in s8 and
``2·D`` widened to bf16, D transposed, the gather's table), the image's
index map against the PTX ISA's fragment layouts, each body's bound from
the bytes of the form it reads, and, compiled with ``g++`` from
``csrc/edge_mm_maps.cuh``, the maps the kernels load and store by: each
tile product emulated lane by lane through the PTX layouts must give
``64·D @ x`` (s8) and ``2·D @ x`` (bf16) exactly.
The gather's and the f32 body's thread maps are mirrored and must cover
every output once.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu.ops.fused_blocked import _split3_mm
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.probes import edge_mm_probe as EP

TOL = {"f32": 3e-7, "gather": 3e-7, "split3": 3e-7, "fixed4": 3e-7,
       "bf16": 4e-3, "fixed2": 2e-4}


@pytest.fixture(scope="module")
def inputs():
    D, x = EP.probe_inputs(T=8, seed=0, tiles=4)
    truth = D.astype(np.float64) @ x.astype(np.float64)
    return D, x, truth


def test_probe_inputs_are_the_probes_shapes(inputs):
    D, x, _ = inputs
    assert D.shape == (552, 304) and x.shape == (304, 32)
    assert D.dtype == np.float32 and x.dtype == np.float32
    assert set(np.unique(D)) == {-1.0, 0.0, 1.0}
    assert 0.005 < np.mean(D != 0) < 0.015 and np.abs(x).max() <= 30.0
    D2, x2 = EP.probe_inputs(T=8, seed=0, tiles=4)
    np.testing.assert_array_equal(D, D2)
    np.testing.assert_array_equal(x, x2)
    assert EP.probe_inputs(512)[1].shape == (304, 64 * 512)


@pytest.mark.parametrize("variant", sorted(TOL))
def test_plain_against_float64(inputs, variant):
    D, x, truth = inputs
    got = EP.edge_mm(torch.from_numpy(D), torch.from_numpy(x), variant)
    assert got.dtype == torch.float32 and got.shape == truth.shape
    err = np.abs(got.numpy() - truth).max() / np.abs(truth).max()
    assert err <= TOL[variant]
    if variant in ("bf16", "fixed2"):  # a reduced form really is reduced
        assert err > 1e-6


def test_int8_pass_is_exact_in_its_own_terms(inputs):
    D, x, _ = inputs
    x = x * 100.0  # past 128, where x / 256 rounds to something
    q = np.clip(np.round(x.astype(np.float64) / 256.0), -127, 127)
    got = EP.edge_mm(torch.from_numpy(D), torch.from_numpy(x), "int8")
    assert np.abs(q).max() >= 10
    np.testing.assert_array_equal(got.numpy(), D.astype(np.float64) @ q)


def test_split3_matches_the_jax_package(inputs):
    D, x, truth = inputs
    ref = np.asarray(_split3_mm(jnp.asarray(D, dtype=jnp.bfloat16),
                                jnp.asarray(x)))
    got = EP.edge_mm_plain(torch.from_numpy(D), torch.from_numpy(x), "split3")
    np.testing.assert_allclose(got.numpy(), ref,
                               atol=2e-7 * np.abs(truth).max())


def test_fixed_point_digits_recombine():
    xi = torch.tensor([0, 1, -1, 127, 128, -128, -129, 30 * 2 ** 19,
                       -30 * 2 ** 19, 2 ** 24 + 3], dtype=torch.int32)
    for count in (4, 2):
        digits = EP._signed_digits(xi, count)
        assert all(int(d.min()) >= -128 and int(d.max()) <= 127
                   for d in digits)
        if count == 4:
            back = sum(d.to(torch.int64) * 256 ** k
                       for k, d in enumerate(digits))
            assert torch.equal(back, xi.to(torch.int64))


def test_gather_table(inputs):
    D, x, _ = inputs
    row_ptr, ent = EP.gather_table(D)
    assert row_ptr.dtype == np.int32 and ent.dtype == np.int32
    assert row_ptr[0] == 0 and row_ptr[-1] == len(ent) == int((D != 0).sum())
    out = np.zeros((D.shape[0], x.shape[1]), np.float64)
    for m in range(D.shape[0]):
        for e in ent[row_ptr[m]:row_ptr[m + 1]]:
            out[m] += np.sign(e) * x[abs(e) - 1]
    np.testing.assert_allclose(out, D.astype(np.float64) @ x, atol=1e-9)
    with pytest.raises(ValueError, match="0 and ±1"):
        EP.gather_table(D * 0.5)


def test_errors_and_counters(inputs):
    D, x, _ = inputs
    Dt, xt = torch.from_numpy(D), torch.from_numpy(x)
    with pytest.raises(ValueError, match="variant"):
        EP.edge_mm(Dt, xt, "fp8")
    with pytest.raises(ValueError, match="variant"):
        EP.edge_mm_plain(Dt, xt, "fp8")
    with pytest.raises(ValueError, match="expected D"):
        EP.edge_mm(Dt, xt[:-1], "f32")
    assert F.KERNEL_LAUNCHES["edge_mm"] == 0
    with pytest.raises(RuntimeError, match="CUDA device"):
        EP.run_probe(8, 1)
    res = EP.run_probe(8, 1, device="cpu")
    assert set(res) == set(EP.VARIANTS) | {"library", "prepare_ms"}
    assert all(res[v]["rel_err"] <= TOL.get(v, 1.0) for v in EP.VARIANTS)
    # one call to check, one to warm up, one timed: every call counted
    assert all(res[v]["launches"] == 3 for v in EP.VARIANTS)
    assert res["gather"]["bound_by"] == "bytes"
    assert res["f32"]["bound_by"] == "operations"


def test_bound_counts_the_form_each_body_reads():
    """Each body's byte bound moves x and out once and D's prepared form
    it reads, not D in float32: the image (a byte an entry, padded to whole
    tiles), the table or D transposed."""
    m, k, n = EP.M, EP.K, 64 * 512
    d = _edge(m, k, density=0.01, seed=0)
    prep = EP.prepare_edge_matrix(torch.from_numpy(d))
    nnz = int((d != 0).sum())
    mt, kc = EP.image_tiles(m, k)
    form = {v: EP.form_bytes(prep, v) for v in EP.VARIANTS}
    assert form["gather"] == 4 * (m + 1 + nnz)
    assert form["f32"] == 4 * k * (-(-m // EP.F32_ROWS) * EP.F32_ROWS)
    assert all(form[v] == 512 * mt * kc == 184320 for v in EP.TENSOR_CORE)
    xo = 4 * (k * n + m * n)
    for v in EP.VARIANTS:
        ms, by, _ = EP.body_bound(v, m, k, n, nnz, form[v])
        if v == "f32":
            assert by == "operations"
            assert ms == pytest.approx(1e3 * 2.0 * m * k * n / 67e12)
        else:
            assert by == "bytes"
            assert ms == pytest.approx(1e3 * (xo + form[v]) / 3.35e12)
    # the gather's bound is under the tensor-core bodies', both under the
    # bound that counted D as dense float32
    dense = 1e3 * (xo + 4 * m * k) / 3.35e12
    assert (EP.body_bound("gather", m, k, n, nnz, form["gather"])[0]
            < EP.body_bound("int8", m, k, n, nnz, form["int8"])[0] < dense)


def test_cold_rotation_gives_equal_copies_in_turn():
    x = torch.arange(12.0).reshape(3, 4)
    nxt = EP.rotation(x)
    got = [nxt() for _ in range(2 * EP.COLD_BUFFERS)]
    assert got[0] is x and EP.COLD_BUFFERS >= 3
    ptrs = [g.data_ptr() for g in got]
    assert len(set(ptrs[:EP.COLD_BUFFERS])) == EP.COLD_BUFFERS
    assert ptrs[EP.COLD_BUFFERS:] == ptrs[:EP.COLD_BUFFERS]
    assert all(torch.equal(g, x) for g in got)


# ---------------------------------------------------------------------------
# D's prepared forms and the kernels' maps
# ---------------------------------------------------------------------------

CSRC = Path(F.__file__).resolve().parent.parent / "csrc"
SHAPES = [(552, 304), (37, 50), (16, 16), (1, 1), (33, 320)]


def _edge(m, k, density=0.05, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, 2, size=(m, k))
            * (rng.random((m, k)) < density)).astype(np.float32)


def ptx_s8_a(lane):
    """PTX ISA, mma.m16n8k32 .s8 A: element i (register i // 4, byte i % 4)
    of lane at row groupID (+ 8 for i in 4-7 and 12-15), column
    threadID_in_group * 4 + (i & 3) (+ 16 for i >= 8)."""
    g, t = lane >> 2, lane & 3
    return [(g + 8 * ((i // 4) % 2), 4 * t + (i & 3) + 16 * (i >= 8))
            for i in range(16)]


def ptx_s8_b(lane):
    """mma.m16n8k32 .s8 B: element i (register i // 4) at row
    threadID_in_group * 4 + (i & 3) (+ 16 for i >= 4), column groupID."""
    g, t = lane >> 2, lane & 3
    return [(4 * t + (i & 3) + 16 * (i >= 4), g) for i in range(8)]


def ptx_bf16_a(lane):
    """mma.m16n8k16 .bf16 A: element i (register i // 2, half i % 2) at row
    groupID (+ 8 for i in 2, 3, 6, 7), column threadID_in_group * 2 + (i &
    1) (+ 8 for i >= 4)."""
    g, t = lane >> 2, lane & 3
    return [(g + 8 * ((i // 2) % 2), 2 * t + (i & 1) + 8 * (i >= 4))
            for i in range(8)]


def ptx_bf16_b(lane):
    """mma.m16n8k16 .bf16 B: element i at row threadID_in_group * 2 + (i &
    1) (+ 8 for i >= 2), column groupID."""
    g, t = lane >> 2, lane & 3
    return [(2 * t + (i & 1) + 8 * (i >= 2), g) for i in range(4)]


def ptx_c(lane):
    """The accumulator: element e at row groupID (+ 8 for e >= 2), column
    threadID_in_group * 2 + (e & 1)."""
    g, t = lane >> 2, lane & 3
    return [(g + 8 * (e >= 2), 2 * t + (e & 1)) for e in range(4)]


@pytest.mark.parametrize("shape", SHAPES)
def test_image_index_is_the_ptx_layout_and_a_bijection(shape):
    m, k = shape
    mt, kc = EP.image_tiles(m, k)
    assert mt % EP.MT_MULTIPLE == 0 and 16 * mt >= m and 32 * kc >= k
    rows, cols = EP.image_index(m, k)
    assert rows.shape == cols.shape == (mt, kc, 32, 16)
    flat = rows.astype(np.int64) * (32 * kc) + cols
    assert len(np.unique(flat)) == flat.size == 16 * mt * 32 * kc
    for lane in range(32):
        want = np.array(ptx_s8_a(lane))
        np.testing.assert_array_equal(rows[1 % mt, kc - 1, lane] - 16 * (1 % mt),
                                      want[:, 0])
        np.testing.assert_array_equal(cols[1 % mt, kc - 1, lane] - 32 * (kc - 1),
                                      want[:, 1])


@pytest.mark.parametrize("shape", SHAPES)
def test_prepared_forms(shape):
    m, k = shape
    d = _edge(m, k, density=0.3)
    prep = EP.prepare_edge_matrix(torch.from_numpy(d))
    image = prep.image.numpy()
    assert prep.image.dtype == torch.uint8
    rows, cols = EP.image_index(m, k)
    inside = (rows < m) & (cols < k)
    v = np.where(inside, d[np.minimum(rows, m - 1), np.minimum(cols, k - 1)], 0)
    # one byte an entry: 64·d as a signed byte (the int8 bodies' operand)
    np.testing.assert_array_equal(image.view(np.int8), 64 * v.astype(np.int8))
    # and, as the high byte of a bf16 (bits code << 8), exactly 2·d
    widened = (image.astype(np.uint32) << 24).view(np.float32)
    np.testing.assert_array_equal(widened, 2.0 * v)
    assert prep.dt.shape == (k, -(-m // EP.F32_ROWS) * EP.F32_ROWS)
    np.testing.assert_array_equal(prep.dt.numpy()[:, :m], d.T)
    assert not prep.dt.numpy()[:, m:].any()
    row_ptr, ent = EP.gather_table(d)
    np.testing.assert_array_equal(prep.row_ptr.numpy(), row_ptr)
    np.testing.assert_array_equal(prep.ent.numpy(), ent)
    with pytest.raises(ValueError, match="0 and ±1"):
        EP.prepare_edge_matrix(torch.from_numpy(d + 0.5))
    # the prepared form runs the plain versions on the CPU
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(k, 8)).astype(
        np.float32))
    np.testing.assert_array_equal(EP.edge_mm(prep, x, "split3").numpy(),
                                  EP.edge_mm_plain(prep.D, x, "split3").numpy())


HOST_SRC = r"""
#include "edge_mm_maps.cuh"

extern "C" void host_image(const float* d, int m, int k, int mt, int kc, unsigned char* image) {
  for (int t = 0; t < mt; ++t)
    for (int c = 0; c < kc; ++c)
      for (int lane = 0; lane < 32; ++lane)
        for (int r = 0; r < 4; ++r)
          for (int i = 0; i < 4; ++i) {
            const int row = 16 * t + emm_a_row(lane, r), col = 32 * c + emm_a_col(lane, r, i);
            const float v = (row < m && col < k) ? d[row * k + col] : 0.f;
            const long long at = emm_image_at(t, c, kc, lane) * 16 + 4 * r + i;
            image[at] = v > 0 ? kEmmPlus : v < 0 ? kEmmMinus : 0;
          }
}

extern "C" int host_tile_col(int c, int j, int nt) { return emm_tile_col(c, j, nt); }

extern "C" const int host_s8_one = kEmmS8One;

extern "C" void host_widen(const unsigned* w, int h, unsigned* a) { emm_widen(w, h, a); }

// b_row [32][2][4], b_col [32], c [32][4][2]
extern "C" void host_maps(int* b_row, int* b_col, int* c) {
  for (int lane = 0; lane < 32; ++lane) {
    for (int h = 0; h < 2; ++h)
      for (int i = 0; i < 4; ++i) b_row[(lane * 2 + h) * 4 + i] = emm_b_row(lane, h, i);
    b_col[lane] = emm_b_col(lane);
    for (int e = 0; e < 4; ++e) {
      c[(lane * 4 + e) * 2] = emm_c_row(lane, e);
      c[(lane * 4 + e) * 2 + 1] = emm_c_col(lane, e);
    }
  }
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    d = tmp_path_factory.mktemp("edge_mm_maps")
    src, lib = d / "edge_mm_host.cpp", d / "libedge_mm_host.so"
    src.write_text(HOST_SRC)
    subprocess.run([gxx, "-std=c++17", "-O2", "-shared", "-fPIC",
                    f"-I{CSRC}", "-x", "c++", str(src), "-o", str(lib)],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(str(lib))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    h.host_image.argtypes = [vp, i32, i32, i32, i32, vp]
    h.host_s8_one = ctypes.c_int.in_dll(h, "host_s8_one").value
    h.host_widen.argtypes = [vp, i32, vp]
    h.host_maps.argtypes = [vp, vp, vp]
    h.host_tile_col.argtypes = [i32, i32, i32]
    b_row = np.zeros((32, 2, 4), np.int32)
    b_col = np.zeros(32, np.int32)
    c = np.zeros((32, 4, 2), np.int32)
    h.host_maps(b_row.ctypes.data, b_col.ctypes.data, c.ctypes.data)
    h.maps = b_row, b_col, c
    return h


def _host_image(host, d):
    m, k = d.shape
    mt, kc = EP.image_tiles(m, k)
    image = np.zeros((mt, kc, 32, 16), np.uint8)
    d = np.ascontiguousarray(d, np.float32)
    host.host_image(d.ctypes.data, m, k, mt, kc, image.ctypes.data)
    return image


@pytest.mark.parametrize("shape", SHAPES)
def test_host_image_matches_prepare(host, shape):
    d = _edge(*shape, density=0.4, seed=5)
    np.testing.assert_array_equal(_host_image(host, d), EP.edge_image(d))
    # the kernels' scale of an s8 sum is the image's code for +1
    assert host.host_s8_one == np.int8(EP.CODE_PLUS) == 64


def test_maps_against_the_ptx_layouts(host):
    b_row, b_col, c = host.maps
    for lane in range(32):
        # register h, byte i of x's s8 operand is the PTX B element 4h + i
        ptx = ptx_s8_b(lane)
        for h in range(2):
            for i in range(4):
                assert (b_row[lane, h, i], b_col[lane]) == ptx[4 * h + i]
        assert [tuple(p) for p in c[lane]] == ptx_c(lane)
    # every position of a B tile and a C tile is one lane's, once
    assert len({(b_row[ln, h, i], b_col[ln]) for ln in range(32)
                for h in range(2) for i in range(4)}) == 256
    assert len({tuple(c[ln, e]) for ln in range(32) for e in range(4)}) == 128


@pytest.mark.parametrize("nt", [1, 2])
def test_tile_columns(host, nt):
    """A warp's 8·nt columns: each (column c, tile j) of the operands one
    column, once; with two tiles a lane's B columns side by side (one
    8-byte load a row) and its four accumulator columns a row consecutive
    (one 16-byte store)."""
    b_row, b_col, c = host.maps
    cols = [host.host_tile_col(cc, j, nt) for j in range(nt) for cc in range(8)]
    assert sorted(cols) == list(range(8 * nt))
    if nt == 2:
        for lane in range(32):
            g = b_col[lane]
            assert host.host_tile_col(g, 1, 2) == host.host_tile_col(g, 0, 2) + 1
            row0 = sorted(host.host_tile_col(c[lane, e, 1], j, 2)
                          for j in range(2) for e in range(2))
            assert row0 == list(range(row0[0], row0[0] + 4))
            assert row0[0] == host.host_tile_col(c[lane, 0, 1], 0, 2)
            assert row0[0] % 4 == 0


def _bf16_values(words):
    """The 2·len(words) bf16 values of 32-bit words, low half first."""
    w = np.asarray(words, np.uint32)
    halves = np.stack([w & 0xFFFF, w >> 16], axis=-1).reshape(-1)
    return (halves.astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("shape", [(552, 304), (37, 50), (33, 320)])
def test_tile_products_emulated_lane_by_lane(host, shape):
    """Each 16 x 32 tile of D times a 32 x 8 tile of x, with the registers
    each lane holds (the image for A; x's rows by the kernels' map for B)
    placed where the PTX ISA says the instruction reads them: the image
    read as s8 gives 64 times the tile product, read as bf16 (two 16-deep
    halves, A widened from the same bytes) twice it, over a permuted k."""
    m, k = shape
    d = _edge(m, k, density=0.3, seed=7)
    mt, kc = EP.image_tiles(m, k)
    dp = np.zeros((16 * mt, 32 * kc))
    dp[:m, :k] = d
    x = np.random.default_rng(8).integers(-9, 10, size=(32 * kc, 8)).astype(
        np.float64)
    image = _host_image(host, d)
    s8 = image.view(np.int8)
    b_row, b_col, _ = host.maps
    for t in {0, mt - 1}:
        for c in {0, kc - 1}:
            want = dp[16 * t:16 * t + 16, 32 * c:32 * c + 32] @ x[32 * c:32 * c + 32]
            a_s8 = np.full((16, 32), np.nan)
            b_s8 = np.full((32, 8), np.nan)
            a_bf = np.full((2, 16, 16), np.nan)
            b_bf = np.full((2, 16, 8), np.nan)
            for lane in range(32):
                for i, (r, col) in enumerate(ptx_s8_a(lane)):
                    assert np.isnan(a_s8[r, col])
                    a_s8[r, col] = s8[t, c, lane, i]
                for i, (r, col) in enumerate(ptx_s8_b(lane)):
                    assert np.isnan(b_s8[r, col])
                    b_s8[r, col] = x[32 * c + b_row[lane, i // 4, i % 4],
                                     b_col[lane]]
                words = image[t, c, lane].view(np.uint32)
                for h in range(2):
                    a = np.zeros(4, np.uint32)
                    host.host_widen(np.ascontiguousarray(words).ctypes.data,
                                    h, a.ctypes.data)
                    for i, (r, col) in enumerate(ptx_bf16_a(lane)):
                        assert np.isnan(a_bf[h, r, col])
                        a_bf[h, r, col] = _bf16_values(a)[i]
                    # register 2h + e holds elements 2e, 2e + 1 of half h
                    for i, (r, col) in enumerate(ptx_bf16_b(lane)):
                        assert np.isnan(b_bf[h, r, col])
                        b_bf[h, r, col] = x[32 * c + b_row[lane, h, i],
                                            b_col[lane]]
            np.testing.assert_array_equal(a_s8 @ b_s8, 64 * want)
            np.testing.assert_array_equal(a_bf[0] @ b_bf[0] + a_bf[1] @ b_bf[1],
                                          2 * want)


def test_gather_staging_covers_each_output_once():
    """The gather kernel's shared memory (x's strip [K][32], row_ptr [M +
    1], ent [nnz], 4 bytes each, back to back; the table stays in device
    memory where it does not fit) and its thread map (thread tid: row tid //
    8 + 32 i, columns 4 (tid % 8) .. + 3 of the strip)."""
    m, k = EP.M, EP.K
    d = _edge(m, k, density=0.01, seed=0)
    row_ptr, ent = EP.gather_table(d)
    cols, threads = EP.GATHER_COLS, 256
    xs, rp = 0, k * cols
    en = rp + m + 1
    end = en + len(ent)
    assert 4 * end <= EP.SMEM_BYTES and xs < rp < en <= end
    seen = np.zeros((m, cols), np.int32)
    for tid in range(threads):
        q = tid % (cols // 4)
        for row in range(tid // (cols // 4), m, threads // (cols // 4)):
            seen[row, 4 * q:4 * q + 4] += 1
    assert (seen == 1).all()
    # a row's entries, read from the staged table, sum to the row of D @ x
    x = np.random.default_rng(3).normal(size=(k, cols))
    out = np.zeros((m, cols))
    for row in range(m):
        for e in ent[row_ptr[row]:row_ptr[row + 1]]:
            out[row] += np.sign(e) * x[abs(e) - 1]
    np.testing.assert_allclose(out, d.astype(np.float64) @ x, atol=1e-12)


def test_f32_tile_covers_each_output_once():
    """The f32 body's thread map: warp w of 2·(F32_ROWS / 32) takes the 32 x
    64 warp tile at rows 32 (w // 2), columns 64 (w % 2); its lane (r, c) =
    (lane // 8, lane % 8) rows 4r + i and 16 + 4r + i, columns 4c + j and
    32 + 4c + j (i, j < 4) of it, in a F32_ROWS x 128 block tile."""
    seen = np.zeros((EP.F32_ROWS, 128), np.int32)
    for tid in range(64 * (EP.F32_ROWS // 32)):
        warp, lane = divmod(tid, 32)
        wm, wn = 32 * (warp // 2), 64 * (warp % 2)
        r, c = divmod(lane, 8)
        for r0 in (wm + 4 * r, wm + 16 + 4 * r):
            for c0 in (wn + 4 * c, wn + 32 + 4 * c):
                seen[r0:r0 + 4, c0:c0 + 4] += 1
    assert (seen == 1).all()
    assert -(-EP.M // EP.F32_ROWS) * EP.F32_ROWS - EP.M < 0.05 * EP.M


@pytest.mark.parametrize("group,name", [
    (g, n) for g, edits in (("knockouts", EP.KNOCKOUTS),
                            ("alternatives", EP.ALTERNATIVES))
    for n in sorted(edits)])
def test_probe_edit_applies(group, name):
    """Each knockout and alternative the probe builds edits text the tree's
    kernel source holds, and changes it."""
    text = (CSRC / "edge_mm.cu").read_text()
    for old, new in {**EP.KNOCKOUTS, **EP.ALTERNATIVES}[name]:
        assert old in text and old != new
        text = text.replace(old, new)
