"""The unrolled probe's host-side parts: its source patches still apply to
the tree's kernels, its clock-read build finds every step, and the bytes a
frame that its bounds and ``chip_smoke.py``'s take are those of the atoms
the model reads. Also the table form each unrolled kernel is given."""

import pytest

from molann_tpu_torch.ops import _build
from molann_tpu_torch.ops import fused as F
from molann_tpu_torch.probes import unrolled_probe as P
from molann_tpu_torch.systems import alanine_model

PATCHES = [(kind, i) for group in (P.KNOCKOUTS, P.ALTERNATIVES)
           for kind, edits in group.items() for i in range(len(edits))]


@pytest.mark.parametrize("kind,i", PATCHES)
def test_probe_patch_applies(kind, i):
    """Each knockout and alternative replaces text the tree holds once."""
    name, old, new = {**P.KNOCKOUTS, **P.ALTERNATIVES}[kind][i]
    text = (_build.SRC_DIR / name).read_text()
    assert text.count(old) == 1 and old != new


def test_phases_instruments_every_step():
    """The clock-read build marks each warp step of K1 and K4 once by name,
    in the kernel's order."""
    text = (_build.SRC_DIR / "fused_unrolled.cu").read_text()
    out, names = P.instrument(text)
    assert names == ["load", "wait", "feat", "mlp", "bwd", "adj_feat",
                     "adj_align", "store"]
    assert out.count("PROBE_MARK(") == len(names) + 2


@pytest.mark.parametrize("transposed,gx,want", [
    (True, True, 492), (False, True, 540), (True, False, 228),
    (False, False, 276)])
def test_frame_bytes(transposed, gx, want):
    """Alanine's 18 read atoms are 216 B of a [3n, l] frame; on [l, n, 3]
    every 32-byte sector of a frame holds a read atom, so all 264 B count;
    gx adds 264 B and y (or gy, a target) 12 B."""
    model, _ = alanine_model(device="cpu")
    got = P.frame_bytes(F, model, transposed, gx, 3)
    assert got == want


@pytest.mark.parametrize("kernel,slots", [
    ("forward", True), ("cv_forces", True), ("backward", False),
    ("train", False)])
def test_table_form_follows_the_kernel(kernel, slots):
    """K1 and K4 are given the slot form of the tables (18 slots on
    alanine, the slot tables set), K2 and K3 the atom form (none set)."""
    model, _ = alanine_model(device="cpu")
    spec, align_idx, ref_x, params, act = F._extract_model(model)
    args, keep = F.model_args(spec, align_idx, ref_x, params, act, "cpu",
                              kernel)
    del keep
    assert (args.n_slots, bool(args.slot_col), bool(args.col_slot)) == (
        (18, True, True) if slots else (0, False, False))


@pytest.mark.parametrize("variant", ["f32", "bf16", "int8", "split3",
                                     "fixed4", "fixed2", "gather"])
def test_edge_bounds_cold_keeps_x_warm_leaves_it_out(variant):
    """Phase 9's gates: the cold bound moves x, out and D's form over HBM;
    the warm bound moves out and D's form only (a warm x may stay in the
    50 MB L2), and either is the operations' time where that is larger."""
    from molann_tpu_torch.probes import edge_mm_probe as EP

    m, k, n, nnz, d_bytes = EP.M, EP.K, 64 * 512, 1700, 184320
    b = EP.body_bound(variant, m, k, n, nnz, d_bytes)
    rate = EP.HBM_BYTES_PER_S
    cold = 1e3 * (4 * k * n + 4 * m * n + d_bytes) / rate
    warm = 1e3 * (4 * m * n + d_bytes) / rate
    if variant == "gather":
        ops = 1e3 * nnz * n / 67e12
    else:
        passes, peak = EP.OPS[variant]
        ops = 1e3 * passes * 2.0 * m * k * n / peak
    assert b.ms == pytest.approx(max(cold, ops), rel=1e-12)
    assert b.warm_ms == pytest.approx(max(warm, ops), rel=1e-12)
    assert b.by == ("bytes" if cold >= ops else "operations")
    assert b.warm_ms <= b.ms
    # x's 39.8 MB are the whole difference where bytes bound both
    if warm >= ops:
        assert (b.ms - b.warm_ms) * 1e-3 * rate == pytest.approx(4 * k * n)
