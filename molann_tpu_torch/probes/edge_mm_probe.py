"""The edge product ``D @ x`` on Hopper's tensor cores, against a direct gather.

    python -m molann_tpu_torch.probes.edge_mm_probe [T=512] [reps=8]

The blocked TPU kernels compute every feature's edge vectors as a product
with a 0/±1 matrix, ``D [552, 304] @ x [304, T]`` per tile for
``peptide_model(60)``, and ``scripts/int8_mm_probe.py`` asked on the TPU
whether int8 passes of that product beat the 3-pass bf16 split. The port's
blocked kernels gather ``x[a]`` through index tables instead, so on this
card the question becomes: does any tensor-core form of the edge product
beat the gather? :func:`edge_mm` computes the product with the CUDA kernel of
``csrc/edge_mm.cu`` in one of seven bodies (:data:`VARIANTS`): the six of
the TPU probe (``f32``, one ``bf16`` pass, one ``int8`` pass, the 3-pass
bf16 ``split3``, the 4-digit and 2-digit int8 fixed point ``fixed4`` and
``fixed2``), with the products on the tensor cores and the quantisation and
digit split inside the kernel, and ``gather``, which adds ``±x[col]`` for
each nonzero of a row. :func:`edge_mm_plain` is the plain PyTorch version of
each body's arithmetic, which :func:`edge_mm` takes for a CPU tensor only.

Run as a script it times every body on ``D [552, 304]`` at 1% density and
``x [304, 64·T]`` in ±30 Å (both from a seeded numpy generator), prints the
time and the TFLOP/s of the dense operation count of each, the time of
``torch.matmul`` on the same inputs as a library yardstick, and each
body's error against float64.
"""

import subprocess
import sys
import time

import numpy as np
import torch

from ..ops import fused as F

__all__ = ["VARIANTS", "edge_mm", "edge_mm_plain", "gather_table",
           "probe_inputs", "run_probe"]

VARIANTS = ("f32", "bf16", "int8", "split3", "fixed4", "fixed2", "gather")
M, K = 552, 304  # peptide_model(60): edge rows, atoms padded to a multiple of 8
N_TILES = 64     # columns of x = N_TILES * T
# x * 2^s as an int32: |x| < 64 leaves 24 significant bits at s = 19, 14 at s = 9
SCALE4 = float(2 ** 19)
SCALE2 = float(2 ** 9)
STRIP = 64       # the kernel's strip of columns


def probe_inputs(T=512, seed=0, tiles=N_TILES):
    """``(D [552, 304], x [304, tiles·T])`` as float32 numpy arrays: D with
    entries 0/±1 at 1% density, x uniform in ±30 (coordinates in Å)."""
    rng = np.random.default_rng(seed)
    D = (rng.integers(-1, 2, size=(M, K))
         * (rng.random((M, K)) < 0.01)).astype(np.float32)
    x = (rng.random((K, T * tiles)) * 60 - 30).astype(np.float32)
    return D, x


def _signed_digits(xi, count):
    """``xi = Σ d_k 256^k`` with every ``d_k`` a signed int8 digit."""
    digits = []
    for _ in range(count):
        d_k = ((xi + 128) & 0xFF) - 128
        digits.append(d_k)
        xi = (xi - d_k) >> 8
    return digits


def edge_mm_plain(D, x, variant):
    """The plain PyTorch version of :func:`edge_mm`: the arithmetic of body
    ``variant`` on float32 ``D [M, K]`` and ``x [K, N]`` → float32 ``[M,
    N]``. Each product of a pass is exact in float32 (D is 0/±1 and the
    other operand has at most 8 significant bits), so a float32 matmul
    stands in for the tensor cores' bf16 and int8 products."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: choose from {VARIANTS}")
    if variant in ("f32", "gather"):
        return D @ x
    bf16 = torch.bfloat16
    if variant == "bf16":
        return D.to(bf16).float() @ x.to(bf16).float()
    if variant == "int8":
        q = torch.clamp(torch.round(x * (1.0 / 256.0)), -127, 127)
        return D @ q
    if variant == "split3":
        hi = x.to(bf16).float()
        r = x - hi
        mid = r.to(bf16).float()
        lo = (r - mid).to(bf16).float()
        db = D.to(bf16).float()
        return (db @ lo + db @ mid) + db @ hi
    count, scale = (4, SCALE4) if variant == "fixed4" else (2, SCALE2)
    xi = torch.round(x * scale).to(torch.int32)
    acc = None
    for k, digit in enumerate(_signed_digits(xi, count)):
        term = (D @ digit.float()) * float(2 ** (8 * k))
        acc = term if acc is None else acc + term
    return acc * (1.0 / scale)


def gather_table(D):
    """The ``gather`` body's int32 table of a 0/±1 matrix: ``(row_ptr [M +
    1], ent)`` with ``ent`` holding, row after row in column order, ``(col +
    1) · sign`` of every nonzero. Raises for any other entry."""
    d = np.asarray(D.detach().cpu() if torch.is_tensor(D) else D)
    if not np.isin(d, (-1.0, 0.0, 1.0)).all():
        raise ValueError("the gather body needs a matrix of 0 and ±1")
    rows, cols = np.nonzero(d)
    row_ptr = np.zeros(d.shape[0] + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=d.shape[0]))
    ent = (cols + 1) * d[rows, cols].astype(np.int64)
    return row_ptr.astype(np.int32), ent.astype(np.int32)


def edge_mm(D, x, variant, table=None):
    """``D [M, K] @ x [K, N]`` by body ``variant`` (:data:`VARIANTS`), float32
    in and out. On CUDA tensors this launches the kernel of
    ``csrc/edge_mm.cu`` (N a multiple of 64) and counts it under
    ``KERNEL_LAUNCHES["edge_mm"]``; on CPU tensors it runs
    :func:`edge_mm_plain`. ``table``: the :func:`gather_table` of ``D`` as
    two int32 tensors on the device, for the ``gather`` body; built from
    ``D`` (a device-to-host copy) when not given."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: choose from {VARIANTS}")
    if D.ndim != 2 or x.ndim != 2 or D.shape[1] != x.shape[0]:
        raise ValueError(f"expected D [M, K] and x [K, N], got "
                         f"{tuple(D.shape)} and {tuple(x.shape)}")
    if D.device != x.device:
        raise ValueError(f"D is on {D.device}, x on {x.device}")
    F._check_device(x)
    if x.device.type == "cpu":
        return edge_mm_plain(D, x, variant)
    F._check_cuda_input(D)
    F._check_cuda_input(x)
    m, k = D.shape
    n = x.shape[1]
    if n % STRIP:
        raise ValueError(f"the edge_mm kernel takes a multiple of {STRIP} "
                         f"columns, got {n}")
    lib = F._library()
    dev = x.device
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    scratch = lib.molann_edge_mm_scratch(m, k)
    d_bf16 = torch.empty(scratch, dtype=torch.bfloat16, device=dev)
    d_int8 = torch.empty(scratch, dtype=torch.int8, device=dev)
    row_ptr = ent = None
    if variant == "gather":
        if table is None:
            table = tuple(torch.from_numpy(t).to(dev) for t in gather_table(D))
        row_ptr, ent = table
        if (row_ptr.dtype != torch.int32 or ent.dtype != torch.int32
                or row_ptr.numel() != m + 1 or row_ptr.device != dev):
            raise ValueError("table must be gather_table(D) as int32 tensors "
                             "on the device of D")
    rc = lib.molann_edge_mm(
        VARIANTS.index(variant), D.data_ptr(), x.data_ptr(), out.data_ptr(),
        m, k, n, d_bf16.data_ptr(), d_int8.data_ptr(),
        None if row_ptr is None else row_ptr.data_ptr(),
        None if ent is None else ent.data_ptr(), dev.index,
        torch.cuda.current_stream(dev).cuda_stream)
    del d_bf16, d_int8  # the caching allocator orders reuse on this stream
    if rc != 0:
        raise RuntimeError(f"CUDA edge_mm kernel launch failed: cudaError {rc}")
    F.KERNEL_LAUNCHES["edge_mm"] += 1
    return out


def cuda_ms(fn, reps):
    """Mean CUDA-event time of one call of fn, after two warm-up calls."""
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def run_probe(T=512, reps=8, device=None):
    """Time every body and hold it against float64 on the probe's inputs.
    Returns ``{variant: {"ms", "tflops", "rel_err"}}`` plus ``"library"``
    (``torch.matmul`` in float32: its ``ms`` and ``tflops``). Needs a CUDA
    card unless ``device="cpu"`` (then the plain versions run, and the times
    are the host's)."""
    from .._device import resolve_device

    dev = resolve_device(device)
    D_host, x_host = probe_inputs(T)
    D = torch.from_numpy(D_host).to(dev)
    x = torch.from_numpy(x_host).to(dev)
    truth = D.double() @ x.double()
    scale = float(truth.abs().max()) + 1e-30
    table = tuple(torch.from_numpy(t).to(dev) for t in gather_table(D_host))
    flops = 2.0 * M * K * x.shape[1]
    timer = cuda_ms if dev.type == "cuda" else _host_ms
    out = {}
    for variant in VARIANTS:
        got = edge_mm(D, x, variant, table=table)
        ms = timer(lambda: edge_mm(D, x, variant, table=table), reps)
        out[variant] = {
            "ms": ms, "tflops": flops / (ms * 1e-3) / 1e12,
            "rel_err": float((got.double() - truth).abs().max()) / scale}
        del got
    ms = timer(lambda: torch.matmul(D, x), reps)
    out["library"] = {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12}
    return out


def _host_ms(fn, reps):
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


LABELS = {
    "f32": "f32 multiply-adds",
    "bf16": "1x bf16 pass (split unit)",
    "int8": "1x int8 pass (quantize + s8s8s32)",
    "split3": "3x bf16 split ('exact' on the TPU)",
    "fixed4": "int8 fixed-point 4-digit (exact)",
    "fixed2": "int8 fixed-point 2-digit (tf32-grade)",
    "gather": "gather through an int32 table",
    "library": "torch.matmul, float32 (library yardstick)",
}


def main(argv):
    T = int(argv[0]) if argv else 512
    reps = int(argv[1]) if len(argv) > 1 else 8
    if not torch.cuda.is_available():
        raise SystemExit("edge_mm_probe: no CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}")
    print(f"shapes: D [{M}, {K}] x [{K}, {T}] x {N_TILES} tiles")
    res = run_probe(T, reps)
    for name, r in res.items():
        err = f"   rel err vs f64 {r['rel_err']:.3g}" if "rel_err" in r else ""
        print(f"{LABELS[name]:44s} {r['ms']:8.4f} ms   "
              f"{r['tflops']:7.2f} TFLOP/s{err}")


if __name__ == "__main__":
    main(sys.argv[1:])
