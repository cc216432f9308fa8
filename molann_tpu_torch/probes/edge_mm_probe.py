"""The edge product ``D @ x`` on Hopper's tensor cores, against a direct gather.

    python -m molann_tpu_torch.probes.edge_mm_probe [T=512] [reps=8]
    python -m molann_tpu_torch.probes.edge_mm_probe turns PARENT_ROOT [T]
    python -m molann_tpu_torch.probes.edge_mm_probe knockouts [T]
    python -m molann_tpu_torch.probes.edge_mm_probe alternatives [T]
    python -m molann_tpu_torch.probes.edge_mm_probe mma_rate
    python -m molann_tpu_torch.probes.edge_mm_probe readings [ROUNDS] [OUT]
    python -m molann_tpu_torch.probes.edge_mm_probe residue [TRACES]

The blocked TPU kernels compute every feature's edge vectors as a product
with a 0/±1 matrix, ``D [552, 304] @ x [304, T]`` per tile for
``peptide_model(60)``, and ``scripts/int8_mm_probe.py`` asked on the TPU
whether int8 passes of that product beat the 3-pass bf16 split. The port's
blocked kernels gather ``x[a]`` through index tables instead, so on this
card the question becomes: does any tensor-core form of the edge product
beat the gather? :func:`edge_mm` computes the product with the CUDA kernels
of ``csrc/edge_mm.cu`` in one of seven bodies (:data:`VARIANTS`): the six of
the TPU probe (``f32``, one ``bf16`` pass, one ``int8`` pass, the 3-pass
bf16 ``split3``, the 4-digit and 2-digit int8 fixed point ``fixed4`` and
``fixed2``), with the products on the tensor cores and the quantisation and
digit split inside the kernel, and ``gather``, which adds ``±x[col]`` for
each nonzero of a row. :func:`prepare_edge_matrix` builds D's operand forms
once (the tensor-core bodies' image, D transposed for ``f32``, the
gather's table); :func:`edge_mm` takes them in place of D.
:func:`edge_mm_plain` is the plain PyTorch version of each body's
arithmetic, which :func:`edge_mm` takes for a CPU tensor only.

Run as a script it times every body on ``D [552, 304]`` at 1% density and
``x [304, 64·T]`` in ±30 Å (both from a seeded numpy generator): each
kernel alone (``torch.profiler``) on one x, whose 39.8 MB the 50 MB L2 may
keep between calls, and on x rotated over :data:`COLD_BUFFERS` copies, so
that no call finds its x in L2; with its wrapper (CUDA events); its bound,
the library call that computes the same function (on both x)
(``torch.matmul`` in float32 beside ``f32``, ``torch.sparse.mm`` on D as
CSR beside ``gather``; beside ``bf16`` and ``int8`` two calls each, x's
conversion and ``torch.mm(..., out_dtype=torch.float32)`` or
``torch._int_mm``), registers, shared memory and blocks an SM, each body's
error against float64, and the time ``prepare_edge_matrix`` takes. ``turns``
builds ``csrc/edge_mm.cu`` of another tree (a ``git archive`` of the parent
commit unpacked under ``PARENT_ROOT``), binds the C entry it exports (D
prepared, or converted on every call as before the preparation) and times
its bodies and this tree's in turns in one process, on one x and on the
rotated copies: parent, change, change, parent. ``knockouts``
times each tensor-core body built again with one of its steps taken out,
``alternatives`` every body built with what was tried in place of the
tree's choices; ``mma_rate`` the cycles an ``mma.sync`` takes with nothing
else to do. ``readings`` takes every body's warm reading ``ROUNDS`` times
in the order of a probe run and keeps each trace's kernel events one by
one, with a spin timed by CUDA events at each end of the trace (written
to ``OUT``, a JSON file). ``residue [TRACES]`` times a loop of small
kernels before and after that many profiler traces in one process.
"""

import ctypes
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from ..ops import fused as F

__all__ = ["VARIANTS", "EdgeMatrix", "edge_mm", "edge_mm_plain", "edge_image",
           "gather_table", "image_index", "prepare_edge_matrix",
           "probe_inputs", "run_probe"]

VARIANTS = ("f32", "bf16", "int8", "split3", "fixed4", "fixed2", "gather")
M, K = 552, 304  # peptide_model(60): edge rows, atoms padded to a multiple of 8
N_TILES = 64     # columns of x = N_TILES * T
# x * 2^s as an int32: |x| < 64 leaves 24 significant bits at s = 19, 14 at s = 9
SCALE4 = float(2 ** 19)
SCALE2 = float(2 ** 9)
STRIP = 64       # the kernels take a multiple of this many columns
# csrc/edge_mm.cu's constants (checked against molann_edge_mm_caps at load):
# 32-deep chunks of K a warp holds, 16-row tiles of the image a multiple of,
# rows of the f32 body's tile, columns of the gather's strip
MAX_CHUNKS, MT_MULTIPLE, F32_ROWS, GATHER_COLS = 10, 6, 64, 32
SMEM_BYTES = 232448  # shared memory a block can have on an H100
TENSOR_CORE = ("bf16", "int8", "split3", "fixed4", "fixed2")
PROFILED_CALLS = 20
# the image's byte for +1 and -1: 64·d as a signed byte, the high byte of
# bf16(2·d) (csrc/edge_mm_maps.cuh)
CODE_PLUS, CODE_MINUS = 0x40, 0xC0
# copies of x a cold reading rotates over: 4 x 39.8 MB, against a 50 MB L2
COLD_BUFFERS = 4


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


def _edge_values(D):
    d = np.asarray(D.detach().cpu() if torch.is_tensor(D) else D)
    if d.ndim != 2 or not np.isin(d, (-1.0, 0.0, 1.0)).all():
        raise ValueError("the edge product's kernels need a matrix of 0 and ±1")
    return d


def gather_table(D):
    """The ``gather`` body's int32 table of a 0/±1 matrix: ``(row_ptr [M +
    1], ent)`` with ``ent`` holding, row after row in column order, ``(col +
    1) · sign`` of every nonzero. Raises for any other entry."""
    d = _edge_values(D)
    rows, cols = np.nonzero(d)
    row_ptr = np.zeros(d.shape[0] + 1, dtype=np.int64)
    row_ptr[1:] = np.cumsum(np.bincount(rows, minlength=d.shape[0]))
    ent = (cols + 1) * d[rows, cols].astype(np.int64)
    return row_ptr.astype(np.int32), ent.astype(np.int32)


def image_tiles(m, k):
    """``(Mt, Kc)``: 16-row tiles (a multiple of :data:`MT_MULTIPLE`) and
    32-column chunks of the tensor-core image of a ``[m, k]`` D."""
    mt = -(-m // 16)
    return -(-mt // MT_MULTIPLE) * MT_MULTIPLE, -(-k // 32)


def image_index(m, k):
    """``(rows, cols)``, each ``[Mt, Kc, 32, 16]``: the entry of D whose code byte
    ``b`` of lane ``L``'s 16 bytes of tile ``(mt, c)`` holds, the s8 A
    operand of ``mma.m16n8k32`` (``csrc/edge_mm_maps.cuh``: register ``b //
    4``, byte ``b % 4``). Positions past ``m`` or ``k`` are padding."""
    mt, kc = image_tiles(m, k)
    lane = np.arange(32)[:, None]
    b = np.arange(16)[None, :]
    r, i = b // 4, b % 4
    row = (lane >> 2) + 8 * (r & 1)
    col = 4 * (lane & 3) + i + 16 * (r >> 1)
    rows = 16 * np.arange(mt)[:, None, None, None] + row[None, None]
    cols = 32 * np.arange(kc)[None, :, None, None] + col[None, None]
    return (np.broadcast_to(rows, (mt, kc, 32, 16)),
            np.broadcast_to(cols, (mt, kc, 32, 16)))


def edge_image(D):
    """The tensor-core bodies' image of a 0/±1 ``D [m, k]``: ``uint8 [Mt,
    Kc, 32, 16]`` laid out by :func:`image_index`, a byte an entry,
    :data:`CODE_PLUS` for +1 and :data:`CODE_MINUS` for -1. As a signed
    byte that is 64·d (the int8 bodies scale their sums by 1/64); as the
    high byte of a bf16 it is 2·d (the bf16 bodies widen two with one byte
    permute and halve their sums). Both scales are exact."""
    d = _edge_values(D)
    m, k = d.shape
    mt, kc = image_tiles(m, k)
    padded = np.zeros((16 * mt, 32 * kc), np.float32)
    padded[:m, :k] = d
    rows, cols = image_index(m, k)
    v = padded[rows, cols]
    return np.where(v > 0, CODE_PLUS, np.where(v < 0, CODE_MINUS, 0)).astype(
        np.uint8)


class EdgeMatrix(NamedTuple):
    """``D [M, K]`` (0/±1) in the forms the kernels read, built once by
    :func:`prepare_edge_matrix` on D's device: ``image``, the tensor-core
    bodies' (:func:`edge_image`); ``dt``, D transposed
    ``[K, mpad]`` in float32 with zero columns past M (``mpad`` a multiple
    of :data:`F32_ROWS`), for ``f32``; ``row_ptr`` and ``ent``, the
    :func:`gather_table`."""
    D: torch.Tensor
    image: torch.Tensor
    dt: torch.Tensor
    row_ptr: torch.Tensor
    ent: torch.Tensor


def prepare_edge_matrix(D):
    """The :class:`EdgeMatrix` of a float32 0/±1 ``D [M, K]`` on D's device.
    One host round trip: call it once for a D and pass the result to
    :func:`edge_mm` for every x. Raises for any entry but 0 and ±1."""
    if D.ndim != 2:
        raise ValueError(f"expected D [M, K], got {tuple(D.shape)}")
    d = _edge_values(D)
    m, k = d.shape
    image = edge_image(d)
    mpad = -(-m // F32_ROWS) * F32_ROWS
    dt = np.zeros((k, mpad), np.float32)
    dt[:, :m] = d.T
    row_ptr, ent = gather_table(d)
    dev = D.device

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    return EdgeMatrix(D, put(image), put(dt), put(row_ptr), put(ent))


_CAPS_CHECKED = False


def _library():
    global _CAPS_CHECKED
    lib = F._library()
    if not _CAPS_CHECKED:
        caps = (ctypes.c_int * 4)()
        lib.molann_edge_mm_caps(caps)
        want = [MAX_CHUNKS, MT_MULTIPLE, F32_ROWS, GATHER_COLS]
        if list(caps) != want:
            raise RuntimeError(f"edge_mm library caps {list(caps)} do not "
                               f"match the probe's {want}")
        _CAPS_CHECKED = True
    return lib


def _check_fits(variant, prep, m, k):
    """Raise for what the kernels of ``variant`` cannot hold."""
    if variant in TENSOR_CORE:
        mt, kc = image_tiles(m, k)
        if kc > MAX_CHUNKS or 512 * mt * kc > SMEM_BYTES:
            raise ValueError(
                f"the tensor-core bodies hold x for all of K in registers and "
                f"D in shared memory: K <= {32 * MAX_CHUNKS} and "
                f"{mt} x {kc} tiles of 512 bytes <= {SMEM_BYTES} bytes")
    if variant == "gather" and 4 * k * GATHER_COLS > SMEM_BYTES:
        raise ValueError(f"the gather stages {4 * k * GATHER_COLS} bytes of x "
                         f"a block, more than {SMEM_BYTES}")


def edge_mm(D, x, variant):
    """``D [M, K] @ x [K, N]`` by body ``variant`` (:data:`VARIANTS`), float32
    in and out. ``D``: the :class:`EdgeMatrix` of :func:`prepare_edge_matrix`
    (a tensor is prepared on the spot, with a host round trip). On CUDA
    tensors this launches one kernel of ``csrc/edge_mm.cu`` (N a multiple of
    64) and counts it under ``KERNEL_LAUNCHES["edge_mm"]``; on CPU tensors it
    runs :func:`edge_mm_plain`."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}: choose from {VARIANTS}")
    prep = D if isinstance(D, EdgeMatrix) else None
    d = D.D if prep is not None else D
    if d.ndim != 2 or x.ndim != 2 or d.shape[1] != x.shape[0]:
        raise ValueError(f"expected D [M, K] and x [K, N], got "
                         f"{tuple(d.shape)} and {tuple(x.shape)}")
    if d.device != x.device:
        raise ValueError(f"D is on {d.device}, x on {x.device}")
    F._check_device(x)
    if x.device.type == "cpu":
        return edge_mm_plain(d, x, variant)
    F._check_cuda_input(d)
    F._check_cuda_input(x)
    m, k = d.shape
    n = x.shape[1]
    if n % STRIP:
        raise ValueError(f"the edge_mm kernel takes a multiple of {STRIP} "
                         f"columns, got {n}")
    if x.data_ptr() % 16:
        raise ValueError("the edge_mm kernels take x 16-byte aligned")
    if prep is None:
        prep = prepare_edge_matrix(d)
    _check_fits(variant, prep, m, k)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0 or n == 0:
        return out
    _launch(_library(), prep, x, variant, out)
    F.KERNEL_LAUNCHES["edge_mm"] += 1
    return out


def _launch(lib, prep, x, variant, out):
    """Launch body ``variant`` of ``lib``'s ``molann_edge_mm`` into out."""
    m, k = prep.D.shape
    rc = lib.molann_edge_mm(
        VARIANTS.index(variant), prep.image.data_ptr(), prep.dt.data_ptr(),
        prep.dt.shape[1], prep.row_ptr.data_ptr(), prep.ent.data_ptr(),
        prep.ent.numel(), x.data_ptr(), out.data_ptr(), m, k, x.shape[1],
        x.device.index, torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"CUDA edge_mm kernel launch failed: cudaError {rc}")


def resources(variant, m=M, k=K, nnz=0, device=0):
    """``{"registers", "smem", "blocks_per_sm", "threads"}`` of body
    ``variant``'s kernel at D ``[m, k]`` with ``nnz`` nonzeros."""
    out = (ctypes.c_int * 4)()
    rc = _library().molann_edge_mm_resources(VARIANTS.index(variant), m, k,
                                             nnz, device, out)
    if rc != 0:
        raise RuntimeError(f"molann_edge_mm_resources failed: cudaError {rc}")
    return dict(zip(("registers", "smem", "blocks_per_sm", "threads"), out))


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


# a spin of the card that closes every trace of :func:`device_ms`: about a
# millisecond, timed by CUDA events too
SPIN_CYCLES = 1 << 21
# how far a trace's spin may differ from its events before the trace's
# clock is taken to be off: in the traces ``readings`` kept, a right clock
# kept the spin within 5% of its events, and a trace that was off read all
# its kernels at 0.45 to 1.35 of their time; 10% stays well inside phase
# 9's 25% margin
CLOCK_SLACK = 0.10
# traces :func:`device_ms` took again, by reason, since the process began,
# and the spin's traced time over its events' in each taken again for its
# clock (None: the trace lost its spin)
RETAKES = {"clock": 0, "dropped": 0}
CLOCK_RATIOS = []
# short spins that open a trace of :func:`clocked_trace`: a trace that
# loses launches loses its first ones (2 to 10 of 20 launches of 40-90 us
# after chip_smoke.py's phases 1-8), so one that still holds an opening
# spin lost none of the calls' launches; about 70 us each
OPENING_SPINS = 16
OPENING_SPIN_CYCLES = 1 << 17


def _spin_events():
    """A spin of :data:`SPIN_CYCLES` cycles queued on the card between two
    CUDA events: ``(start, end)``."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(SPIN_CYCLES)
    end.record()
    return start, end


def _one_trace(fn, calls, opening, retakes, ratios):
    """``(launches, whole)`` of one trace of ``calls`` calls of fn that
    closes (and with ``opening`` opens with :data:`OPENING_SPINS` short
    spins) with a spin timed by CUDA events: :func:`kernel_events` with
    the spins left out, and whether an opening spin was caught (a trace
    loses its first launches, so while one of them is caught no call lost
    a launch; without ``opening``, None). None where the closing spin is
    missing or more than :data:`CLOCK_SLACK` off its events, counted in
    ``retakes["clock"]``, its ratio appended to ``ratios``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(OPENING_SPINS if opening else 0):
            torch.cuda._sleep(OPENING_SPIN_CYCLES)
        for _ in range(calls):
            fn()
        start, end = _spin_events()
        torch.cuda.synchronize()
    launches = kernel_events(prof)
    spins = [k for k, e in enumerate(launches) if "spin_kernel" in e[0]]
    ratio = (launches[spins[-1]][2] / (start.elapsed_time(end) * 1e3)
             if spins else None)
    if ratio is None or abs(ratio - 1) > CLOCK_SLACK:
        retakes["clock"] += 1
        ratios.append(ratio)
        return None
    whole = len(spins) > 1 and spins[0] == 0 if opening else None
    return [e for e in launches if "spin_kernel" not in e[0]], whole


def clocked_trace(fn, calls=1, attempts=5, retakes=None, ratios=None,
                  retake_start=False):
    """``[(name, start_us, duration_us)]`` of every device kernel of
    ``calls`` calls of fn, one entry a launch, from a ``torch.profiler``
    trace whose clock is right: it opens with :data:`OPENING_SPINS` short
    spins and closes with a spin timed by CUDA events too, and is taken
    again where its closing spin is missing or more than
    :data:`CLOCK_SLACK` off its events (:func:`device_ms` says why),
    ``attempts`` traces at most, then it raises. A trace that lost every
    opening spin lost the calls' first launches and is counted in
    ``retakes["start_lost"]``; with ``retake_start`` it is taken again
    within the same attempts, the last such trace kept where none caught
    its start. The off spins' ratios are appended to ``ratios``."""
    retakes = {"clock": 0, "start_lost": 0} if retakes is None else retakes
    ratios = [] if ratios is None else ratios
    torch.cuda.synchronize()
    kept = None
    for _ in range(attempts):
        got = _one_trace(fn, calls, True, retakes, ratios)
        if got is None:
            continue
        kept, caught_start = got
        if caught_start:
            return kept
        retakes["start_lost"] += 1
        if not retake_start:
            return kept
    if kept is not None:
        return kept
    raise RuntimeError(f"torch.profiler gave no trace with its clock right "
                       f"in {attempts} attempts ({retakes})")


def _by_name(launches, pattern):
    """``{name: [duration_us]}`` of the launches whose name matches the
    regular expression ``pattern`` (every launch without one)."""
    out = {}
    for name, _, d in launches:
        if pattern is None or re.search(pattern, name):
            out.setdefault(name, []).append(d)
    return out


def per_call_ms(launches, calls, pattern=None):
    """ms a call of the kernels whose name matches ``pattern`` among
    ``launches`` of ``calls`` calls: each kernel's mean over its launches
    the trace caught, times its launches a call, summed (a trace that lost
    some launches still reads each kernel's time)."""
    return sum(statistics.fmean(d) * max(1, round(len(d) / calls))
               for d in _by_name(launches, pattern).values()) / 1e3


def device_ms(fn, calls=PROFILED_CALLS, pattern=None, attempts=5):
    """Device ms of one call of fn by ``torch.profiler``: the mean time of
    each kernel whose name has ``pattern`` in it (every kernel without
    one), over its launches the trace caught one by one
    (:func:`kernel_events`), times its launches a call, summed; after one
    warm-up call.

    In a process that has taken many traces, a whole trace's device times
    are now and then off by one factor (0.45 to 1.35 in the traces
    ``readings`` kept after ``chip_smoke.py``'s phases 1-8): the kernels'
    durations and the spacing of their starts alike, while CUDA events
    and the other traces agree, so a kernel reads at about half its time.
    The card's timestamps are put on the trace's clock by a conversion, and
    that conversion is what is off. Each trace therefore closes with a
    spin of :data:`SPIN_CYCLES` cycles, timed by CUDA events as well (at
    the close: a trace that loses launches loses its first ones): a trace
    whose spin is missing or more than :data:`CLOCK_SLACK` off its events,
    or that caught fewer than half of a kernel's launches, is taken again
    (counted in :data:`RETAKES`), ``attempts`` traces at most, then it
    raises."""
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        got = _one_trace(fn, calls, False, RETAKES, CLOCK_RATIOS)
        if got is None:
            continue
        launches, _ = got
        by_name = _by_name(launches, pattern)
        if not by_name or any(len(d) < calls / 2 for d in by_name.values()):
            RETAKES["dropped"] += 1
            continue
        return per_call_ms(launches, calls, pattern)
    raise RuntimeError(f"torch.profiler gave no trace with its clock right "
                       f"and the kernels matching {pattern!r} caught in "
                       f"{attempts} attempts ({RETAKES})")


def bare_ms(prep, x, variant, launches=PROFILED_CALLS):
    """CUDA-event ms a launch of body ``variant`` on ``x``, over ``launches``
    back-to-back bare launches (no wrapper, one preallocated out, counted
    nowhere), after one warm-up: the event cross-check of a warm profiler
    reading on the same x.

    A launch through ctypes costs the host tens of microseconds, as long
    as the kernel itself, so the launches are queued behind a spin of the
    card (``torch.cuda._sleep``) and the events time the card alone, not
    the host's launch rate. If the start event has already run once every
    launch is queued, the spin was too short: it is made longer and the
    launches are timed again."""
    lib = _library()
    m, k = prep.D.shape
    _check_fits(variant, prep, m, k)
    out = torch.empty((m, x.shape[1]), dtype=torch.float32, device=x.device)
    _launch(lib, prep, x, variant, out)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 1 << 22  # about 2 ms of the card's clock
    for _ in range(4):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(launches):
            _launch(lib, prep, x, variant, out)
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / launches
        cycles *= 4
    raise RuntimeError(f"edge_mm {variant}: the host did not queue "
                       f"{launches} launches within a spin of {cycles // 4} "
                       f"cycles of the card")


# the dense operations of each body, and the peak rate of their unit
OPS = {"f32": (1, 67e12), "bf16": (1, 989e12), "split3": (3, 989e12),
       "int8": (1, 1979e12), "fixed4": (4, 1979e12), "fixed2": (2, 1979e12)}
HBM_BYTES_PER_S = 3.35e12


def form_bytes(prep, variant):
    """Bytes of D's prepared form that body ``variant`` reads: the image
    (tensor-core bodies), the table (``gather``) or D transposed (``f32``)."""
    if variant == "gather":
        return 4 * (prep.row_ptr.numel() + prep.ent.numel())
    if variant == "f32":
        return 4 * prep.dt.numel()
    return prep.image.numel()


class Bound(NamedTuple):
    """A body's least time: ``ms`` and what sets it (``by``, "bytes" or
    "operations") on a cold x, and ``warm_ms``, the floor of a reading on
    an x that the 50 MB L2 may keep between calls."""

    ms: float
    by: str
    warm_ms: float


def body_bound(variant, m, k, n, nnz, d_bytes):
    """The least time of body ``variant`` as a :class:`Bound`. ``ms``: x
    and out (float32) and the ``d_bytes`` of D's form it reads
    (:func:`form_bytes`), each moved once at 3.35 TB/s, against its
    operations at its unit's peak (the gather: one f32 add a nonzero and
    column), whichever is larger. ``warm_ms``: the same with x's bytes left
    out, since a warm x (39.8 MB at the probe's shape) can stay in the L2
    between calls; out (72.4 MB) and D's form must still cross HBM."""
    t_bytes = 1e3 * (4 * (k * n + m * n) + d_bytes) / HBM_BYTES_PER_S
    t_warm = 1e3 * (4 * m * n + d_bytes) / HBM_BYTES_PER_S
    if variant == "gather":
        t_ops = 1e3 * nnz * n / 67e12
    else:
        passes, rate = OPS[variant]
        t_ops = 1e3 * passes * 2.0 * m * k * n / rate
    return Bound(max(t_bytes, t_ops),
                 "bytes" if t_bytes >= t_ops else "operations",
                 max(t_warm, t_ops))


def library_calls(D):
    """``{body: (label, fn)}``: ``fn(x)`` is one library call (or two, where
    x must be converted first) computing the body's function, for the
    yardstick."""
    bf16 = torch.bfloat16
    d_csr = D.to_sparse_csr()
    d_bf16 = D.to(bf16)
    d_int8 = D.to(torch.int8)

    def int_mm(x):
        q = torch.clamp(torch.round(x * (1.0 / 256.0)), -127, 127)
        return torch._int_mm(d_int8, q.to(torch.int8)).float()

    return {
        "f32": ("torch.matmul, float32 (allow_tf32 False)",
                lambda x: torch.matmul(D, x)),
        "gather": ("torch.sparse.mm, D as CSR float32",
                   lambda x: torch.sparse.mm(d_csr, x)),
        "bf16": ("two calls: x.to(bfloat16), torch.mm(..., out_dtype="
                 "float32)", lambda x: torch.mm(d_bf16, x.to(bf16),
                                                out_dtype=torch.float32)),
        "int8": ("two calls: x quantised (round, clamp, to int8), "
                 "torch._int_mm (then .float())", int_mm),
    }


def card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def rotation(x, copies=COLD_BUFFERS):
    """A function giving x and ``copies - 1`` copies of it in turn, so that
    a call reads the x its predecessors read least recently."""
    return itertools.cycle([x] + [x.clone() for _ in range(copies - 1)]).__next__


def run_probe(T=512, reps=8, device=None):
    """Time every body and hold it against float64 on the probe's inputs.
    Returns ``{variant: {...}}`` with, per body, ``ms`` (the kernel alone,
    ``torch.profiler``, on one x) and ``cold_ms`` (on x rotated over
    :data:`COLD_BUFFERS` copies), ``call_ms`` (with its wrapper, CUDA
    events), ``bare_ms`` (20 bare launches on the same x, CUDA events:
    :func:`bare_ms`), ``launches`` (calls of :func:`edge_mm` made),
    ``tflops`` of the dense count at ``ms``, ``rel_err`` against float64 as
    a fraction of max|truth|, ``bound_ms``, ``bound_by`` and
    ``warm_bound_ms`` (:func:`body_bound`), ``library``,
    ``library_ms`` and ``library_cold_ms`` (None where no library call
    computes the body's function; a library call that fails raises) and
    ``resources``; ``"library"``, ``torch.matmul`` in float32;
    ``"prepare_ms"``, :func:`prepare_edge_matrix` on the host's clock.
    Needs a CUDA card unless ``device="cpu"`` (then the plain versions run,
    the times are the host's, and no library, cold reading or resource is
    read)."""
    from .._device import resolve_device

    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False  # the f32 yardstick
    D_host, x_host = probe_inputs(T)
    D = torch.from_numpy(D_host).to(dev)
    x = torch.from_numpy(x_host).to(dev)
    truth = D.double() @ x.double()
    scale = float(truth.abs().max()) + 1e-30
    prep_times = []
    for _ in range(3):
        t0 = time.perf_counter()
        prep = prepare_edge_matrix(D)
        if cuda:
            torch.cuda.synchronize()
        prep_times.append((time.perf_counter() - t0) * 1e3)
    m, k = D.shape
    n = x.shape[1]
    nnz = prep.ent.numel()
    flops = 2.0 * m * k * n
    libs = library_calls(D) if cuda else {}
    cold = rotation(x) if cuda else None
    out = {}
    for variant in VARIANTS:
        launches = 0

        def call(xv=None):
            nonlocal launches
            launches += 1
            return edge_mm(prep, x if xv is None else xv, variant)

        got = call()
        row = {"rel_err": float((got.double() - truth).abs().max()) / scale}
        del got
        if cuda:
            row["call_ms"] = cuda_ms(call, reps)
            row["ms"] = device_ms(call, pattern="edge_mm")
            row["bare_ms"] = bare_ms(prep, x, variant)
            row["cold_ms"] = device_ms(lambda: call(cold()), pattern="edge_mm")
            row["resources"] = resources(variant, m, k, nnz, x.device.index)
        else:
            row["ms"] = row["call_ms"] = _host_ms(call, reps)
        row["launches"] = launches
        row["tflops"] = flops / (row["ms"] * 1e-3) / 1e12
        row["bound_ms"], row["bound_by"], row["warm_bound_ms"] = body_bound(
            variant, m, k, n, nnz, form_bytes(prep, variant))
        row["library"] = row["library_ms"] = row["library_cold_ms"] = None
        if variant in libs:
            row["library"], fn = libs[variant]
            row["library_ms"] = device_ms(lambda: fn(x))
            row["library_cold_ms"] = device_ms(lambda: fn(cold()))
        out[variant] = row
    ms = (device_ms(lambda: torch.matmul(D, x)) if cuda
          else _host_ms(lambda: torch.matmul(D, x), reps))
    out["library"] = {"ms": ms, "tflops": flops / (ms * 1e-3) / 1e12}
    out["prepare_ms"] = statistics.median(prep_times)
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


def _build_alone(src, out, flags=()):
    """Start ``nvcc`` on one ``.cu`` into the shared library ``out``."""
    from ..ops import _build

    out.parent.mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([_build.nvcc_path(), *_build.NVCC_FLAGS, *flags,
                             "-shared", "-o", str(out), str(src)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)


def _finish(proc):
    text = proc.communicate()[0]
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}): {text}")
    return text


def _bind(lib):
    """Bind ``lib``'s ``molann_edge_mm``, the C entry of D prepared once
    (:func:`_launch`)."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.molann_edge_mm.argtypes = [i32, vp, vp, i32, vp, vp, i32, vp, vp,
                                   i32, i32, i64, i32, vp]
    lib.molann_edge_mm.restype = i32
    return lib


def _parent_library(root):
    """Build ``csrc/edge_mm.cu`` of the tree at ``root`` alone with this
    tree's nvcc flags, and ``(library, prepared)``: where it exports
    ``molann_edge_mm_caps`` (D prepared once), its entry bound as this
    tree's, its caps checked against this probe's; else the entry it had
    before, ``molann_edge_mm(variant, D, x, out, M, K, N, Db, Di, row_ptr,
    ent, device, stream)``, with its scratch size function."""
    src = Path(root).resolve() / "molann_tpu_torch" / "csrc" / "edge_mm.cu"
    out = src.parent.parent / "_build" / "edge_mm_parent.so"
    _finish(_build_alone(src, out))
    lib = ctypes.CDLL(str(out))
    if hasattr(lib, "molann_edge_mm_caps"):
        caps = (ctypes.c_int * 4)()
        lib.molann_edge_mm_caps(caps)
        if list(caps) != [MAX_CHUNKS, MT_MULTIPLE, F32_ROWS, GATHER_COLS]:
            raise RuntimeError(f"the parent's caps {list(caps)} are not this "
                               f"probe's: prepare D for it by its own code")
        return _bind(lib), True
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.molann_edge_mm_scratch.argtypes = [i32, i32]
    lib.molann_edge_mm_scratch.restype = i64
    lib.molann_edge_mm.argtypes = [i32, vp, vp, vp, i32, i32, i64, vp, vp, vp,
                                   vp, i32, vp]
    lib.molann_edge_mm.restype = i32
    return lib, False


def turns(root, T=512):
    """Every body of the parent tree at ``root`` and of this tree, each
    kernel alone by ``torch.profiler``, in turns: parent, change, change,
    parent; ``ms`` on one x, ``cold_ms`` on x rotated over
    :data:`COLD_BUFFERS` copies. A parent that converts D on every call
    launches two kernels a call: its ``ms`` holds both, ``body_ms`` the
    body's kernel alone."""
    dev = torch.device("cuda", torch.cuda.current_device())
    parent, prepared = _parent_library(root)
    D_host, x_host = probe_inputs(T)
    D = torch.from_numpy(D_host).to(dev)
    x = torch.from_numpy(x_host).to(dev)
    cold = rotation(x)
    m, k = D.shape
    n = x.shape[1]
    prep = prepare_edge_matrix(D)
    out_p = torch.empty((m, n), dtype=torch.float32, device=dev)
    if not prepared:
        size = parent.molann_edge_mm_scratch(m, k)
        db = torch.empty(size, dtype=torch.bfloat16, device=dev)
        di = torch.empty(size, dtype=torch.int8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def parent_call(variant, xv):
        if prepared:
            _launch(parent, prep, xv, variant, out_p)
            return
        rc = parent.molann_edge_mm(
            VARIANTS.index(variant), D.data_ptr(), xv.data_ptr(),
            out_p.data_ptr(), m, k, n, db.data_ptr(), di.data_ptr(),
            prep.row_ptr.data_ptr(), prep.ent.data_ptr(), dev.index, stream)
        if rc != 0:
            raise RuntimeError(f"parent edge_mm failed: cudaError {rc}")

    result = {"mode": "turns", "card": card(), "parent": str(root),
              "parent_prepares_d": prepared, "shape": [m, k, n], "rounds": []}
    for who in ("parent", "change", "change", "parent"):
        row = {"who": who}
        for variant in VARIANTS:
            if who == "parent":
                def call(xv):
                    parent_call(variant, xv)
            else:
                def call(xv):
                    edge_mm(prep, xv, variant)
            row[variant] = {
                "ms": device_ms(lambda: call(x), pattern="edge_mm"),
                "cold_ms": device_ms(lambda: call(cold()), pattern="edge_mm")}
            if who == "parent" and not prepared:
                row[variant]["body_ms"] = device_ms(lambda: call(x),
                                                    pattern="_kernel")
            if who == "parent":
                call(x)
                if not torch.allclose(out_p, edge_mm(prep, x, variant),
                                      rtol=0, atol=1e-3 * float(
                                          out_p.abs().max())):
                    raise RuntimeError(f"parent and change disagree on "
                                       f"{variant}")
        result["rounds"].append(row)
    return result


# each step of a tensor-core body, taken out by an edit of csrc/edge_mm.cu
# (the time the step costs is the difference; the outputs are then wrong)
KNOCKOUTS = {
    "no products": [(
        """  if constexpr (Tc<kBody>::kBf16) {
    mma_bf16(c, *reinterpret_cast<const unsigned(*)[4]>(a), b0, b1);
  } else {
    mma_s8(c, make_uint4(a[0], a[1], a[2], a[3]), b0, b1);
  }""",
        """  reinterpret_cast<unsigned&>(c[0]) ^= a[0] ^ b0;
  reinterpret_cast<unsigned&>(c[1]) ^= a[1] ^ b1;""")],
    "no stores": [(
        "          float* row = o + ",
        "          if (__float_as_uint(v[0][0]) != (unsigned)N) continue;\n"
        "          float* row = o + ")],
    "no x loads": [
        ("__ldcs(reinterpret_cast<const float2*>(col + (long long)k * N))",
         "make_float2(__uint_as_float(k ^ lane), __uint_as_float(k + lane))"),
        ("__ldcs(col + (long long)k * N)", "__uint_as_float(k ^ lane)")],
    "no D in shared memory": [(
        "  for (int e = tid; e < image_n; e += blockDim.x) cp_async16(ds + e, image + e, 16);\n",
        "")],
    "no L2 prefetch": [(
        'asm volatile("prefetch.global.L2 [%0];\\n" ::"l"(nx + (long long)k * N + 8 * j));',
        ";")],
}

_PRODUCTS_NOW = """        if constexpr (S::kBf16) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            unsigned ab[S::kMT][4];
#pragma unroll
            for (int i = 0; i < S::kMT; ++i) emm_widen(a[i], h, ab[i]);
#pragma unroll
            for (int i = 0; i < S::kMT; ++i)
#pragma unroll
              for (int j = 0; j < S::kNT; ++j)
#pragma unroll
                for (int p = 0; p < S::kPasses; ++p)
                  product<kBody>(acc[i][j][p], ab[i], xq[c][j][p][2 * h], xq[c][j][p][2 * h + 1]);
          }
        } else {"""
_PRODUCTS_BY_TILE = """        if constexpr (S::kBf16) {
#pragma unroll
          for (int i = 0; i < S::kMT; ++i)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              unsigned ab[4];
              emm_widen(a[i], h, ab);
#pragma unroll
              for (int j = 0; j < S::kNT; ++j)
#pragma unroll
                for (int p = 0; p < S::kPasses; ++p)
                  product<kBody>(acc[i][j][p], ab, xq[c][j][p][2 * h], xq[c][j][p][2 * h + 1]);
            }
        } else {"""
_A_NOW = """#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c >= Kc) break;
        unsigned a[S::kMT][4];
#pragma unroll
        for (int i = 0; i < S::kMT; ++i) {
          const uint4 w = ds[emm_image_at(mt0 + i, c, Kc, lane)];"""
_A_AHEAD = """      uint4 nxt[S::kMT];
#pragma unroll
      for (int i = 0; i < S::kMT; ++i) nxt[i] = ds[emm_image_at(mt0 + i, 0, Kc, lane)];
#pragma unroll
      for (int c = 0; c < kMaxChunks; ++c) {
        if (c >= Kc) break;
        uint4 nw[S::kMT];
#pragma unroll
        for (int i = 0; i < S::kMT; ++i) nw[i] = nxt[i];
        if (c + 1 < Kc)
#pragma unroll
          for (int i = 0; i < S::kMT; ++i) nxt[i] = ds[emm_image_at(mt0 + i, c + 1, Kc, lane)];
        unsigned a[S::kMT][4];
#pragma unroll
        for (int i = 0; i < S::kMT; ++i) {
          const uint4 w = nw[i];"""
_WARPS = "  static constexpr int kWarps = kBody == EMM_SPLIT3 ? 8 : 16;"
_TILES = "  static constexpr int kMT = kBody == EMM_SPLIT3 ? 3 : 2;"
_F32_BOUNDS = "__launch_bounds__(kF32Threads, 4)"

# what the tree's choices were measured against: edits of csrc/edge_mm.cu,
# each (text, its replacement), every occurrence
ALTERNATIVES = {
    "8 warps a block for every body": [
        (_WARPS, "  static constexpr int kWarps = 8;")],
    "fixed4 at 12 warps": [
        (_WARPS, "  static constexpr int kWarps = kBody == EMM_SPLIT3 ? 8 : "
                 "kBody == EMM_FIXED4 ? 12 : 16;")],
    "split3 two tiles of D at once": [
        (_TILES, "  static constexpr int kMT = 2;")],
    "split3 at 12 warps, two tiles of D at once": [
        (_TILES, "  static constexpr int kMT = 2;"),
        (_WARPS, "  static constexpr int kWarps = kBody == EMM_SPLIT3 ? 12 : 16;")],
    "a tile's products before the next tile's": [
        (_PRODUCTS_NOW, _PRODUCTS_BY_TILE)],
    "D's fragments read a chunk ahead": [(_A_NOW, _A_AHEAD)],
    "the bf16 half past K skipped": [
        ("            unsigned ab[S::kMT][4];\n",
         "            if (32 * c + 16 * h >= K) break;\n"
         "            unsigned ab[S::kMT][4];\n")],
    "x through the read-only cache (__ldg)": [("__ldcs(", "__ldg(")],
    "stores that allocate in L1 (__stwb)": [("__stcs(", "__stwb(")],
    "f32: three blocks an SM": [
        (_F32_BOUNDS, "__launch_bounds__(kF32Threads, 3)")],
    "f32: two buffers": [("kF32Stages = 3;", "kF32Stages = 2;")],
    "f32: 96-row tiles, three blocks an SM": [
        ("kF32WarpsM = 2,", "kF32WarpsM = 3,"),
        (_F32_BOUNDS, "__launch_bounds__(kF32Threads, 3)")],
    "f32: 8-deep steps, four buffers": [
        ("kF32BK = 16,", "kF32BK = 8,"), ("kF32Stages = 3;", "kF32Stages = 4;")],
}


def _variant_libraries(variants):
    """``{name: library}``: ``csrc/edge_mm.cu`` built once per variant, all
    ``nvcc`` at once; a variant is ``(extra nvcc flags, [(text,
    replacement)])``, every occurrence replaced. Each gets a directory of
    its own under ``_build``."""
    from ..ops import _build

    text = (_build.SRC_DIR / "edge_mm.cu").read_text()
    procs = {}
    for i, (name, (flags, edits)) in enumerate(variants.items()):
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"variant {name!r}: its text is not in "
                                   f"csrc/edge_mm.cu any more")
            src = src.replace(old, new)
        d = _build.BUILD_DIR / f"edge_variant{i}"
        d.mkdir(parents=True, exist_ok=True)
        (d / "edge_mm.cu").write_text(src)
        (d / "edge_mm_maps.cuh").write_text(
            (_build.SRC_DIR / "edge_mm_maps.cuh").read_text())
        procs[name] = (d / "edge_mm.so",
                       _build_alone(d / "edge_mm.cu", d / "edge_mm.so", flags))
    libs = {}
    for name, (path, proc) in procs.items():
        _finish(proc)
        libs[name] = _bind(ctypes.CDLL(str(path)))
    return libs


def _time_variants(variants, bodies, mode, T=512, check=True):
    """Every body of ``bodies`` of each variant alone (``torch.profiler``),
    the tree's build first and last; with ``check``, each output against
    the tree's kernel (5e-7 of max|out|) first."""
    dev = torch.device("cuda", torch.cuda.current_device())
    libs = _variant_libraries({"tree": ([], []), **variants})
    D_host, x_host = probe_inputs(T)
    prep = prepare_edge_matrix(torch.from_numpy(D_host).to(dev))
    x = torch.from_numpy(x_host).to(dev)
    out = torch.empty((M, x.shape[1]), dtype=torch.float32, device=dev)
    want = {v: edge_mm(prep, x, v) for v in bodies}
    result = {"mode": mode, "card": card(), "ms": {}}
    for name in [*libs, "tree again"]:
        lib = libs[name.replace(" again", "")]
        row = {}
        for v in bodies:
            if check:
                _launch(lib, prep, x, v, out)
                err = float((out - want[v]).abs().max())
                if err > 5e-7 * float(want[v].abs().max()):
                    raise RuntimeError(f"{name}: {v} off the tree's by {err}")
            row[v] = device_ms(lambda: _launch(lib, prep, x, v, out),
                               pattern="edge_mm")
        result["ms"][name] = row
    return result


def knockouts(T=512):
    """Each tensor-core body alone, built again with each step of
    :data:`KNOCKOUTS` taken out in turn, beside the tree's build; the time a
    step costs is the difference (a knockout's outputs are not the
    function's)."""
    return _time_variants({name: ([], edits)
                           for name, edits in KNOCKOUTS.items()},
                          TENSOR_CORE, "knockouts", T, check=False)


def alternatives(T=512):
    """Every body alone, built again with each of :data:`ALTERNATIVES` in
    place of the tree's choice, beside the tree's build."""
    return _time_variants({name: ([], edits)
                           for name, edits in ALTERNATIVES.items()},
                          VARIANTS, "alternatives", T)


MMA_RATE_SRC = r"""
// mma.sync alone: each warp runs `iters` rounds of `kChains` independent
// products on registers and reports its cycles (clock64).
template <bool kBf16, int kChains>
__global__ void mma_rate(long long* cycles, int iters, unsigned seed) {
  float f[kChains][4] = {};
  int s[kChains][4] = {};
  const unsigned a0 = seed ^ threadIdx.x, a1 = a0 * 3u, a2 = a0 * 5u, a3 = a0 * 7u;
  const unsigned b0 = a0 * 11u, b1 = a0 * 13u;
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int c = 0; c < kChains; ++c) {
      if (kBf16)
        asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+f"(f[c][0]), "+f"(f[c][1]), "+f"(f[c][2]), "+f"(f[c][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
      else
        asm volatile("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
                     "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"
                     : "+r"(s[c][0]), "+r"(s[c][1]), "+r"(s[c][2]), "+r"(s[c][3])
                     : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
    }
  }
  const long long t1 = clock64();
  float sum = 0.f;
  for (int c = 0; c < kChains; ++c) sum += f[c][0] + (float)s[c][0];
  if ((threadIdx.x & 31) == 0) cycles[blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32] =
      sum == 1.2345f ? 0 : t1 - t0;
}

extern "C" int mma_rate_run(int bf16, int chains, int blocks, int warps, int iters,
                            long long* cycles) {
  if (bf16) {
    if (chains == 4) mma_rate<true, 4><<<blocks, 32 * warps>>>(cycles, iters, 1u);
    else mma_rate<true, 8><<<blocks, 32 * warps>>>(cycles, iters, 1u);
  } else {
    if (chains == 4) mma_rate<false, 4><<<blocks, 32 * warps>>>(cycles, iters, 1u);
    else mma_rate<false, 8><<<blocks, 32 * warps>>>(cycles, iters, 1u);
  }
  return (int)cudaDeviceSynchronize();
}
"""


def mma_rate():
    """Cycles a ``mma.sync`` (bf16 m16n8k16, s8 m16n8k32) takes on one of an
    SM's four schedulers with nothing else to do: one block an SM, 2 to 16
    warps, 4 or 8 independent products a warp (the rate the tensor-core
    bodies are held to)."""
    from ..ops import _build

    src = _build.BUILD_DIR / "mma_rate.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(MMA_RATE_SRC)
    lib_path = _build.BUILD_DIR / "mma_rate.so"
    _finish(_build_alone(src, lib_path))
    lib = ctypes.CDLL(str(lib_path))
    i32 = ctypes.c_int
    lib.mma_rate_run.argtypes = [i32, i32, i32, i32, i32, ctypes.c_void_p]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    out = {"mode": "mma_rate", "card": card(), "cycles_per_mma": {}}
    for bf16 in (1, 0):
        for warps in (4, 8, 16):
            for chains in (4, 8):
                cyc = torch.zeros(sms * warps, dtype=torch.int64, device="cuda")
                for _ in range(2):  # the first launch warms the card up
                    if lib.mma_rate_run(bf16, chains, sms, warps, iters,
                                        cyc.data_ptr()) != 0:
                        raise RuntimeError("mma_rate launch failed")
                # a scheduler holds warps / 4 warps of iters x chains products
                per = float(cyc.double().mean()) / (iters * chains * warps / 4)
                key = f"{'bf16 m16n8k16' if bf16 else 's8 m16n8k32'}, {warps} warps, {chains} chains"
                out["cycles_per_mma"][key] = per
    return out


def kernel_events(prof, pattern=None):
    """``[(name, start_us, duration_us)]``: every device kernel of the trace
    whose name has ``pattern`` in it, one entry a launch, in start order."""
    from torch.autograd import DeviceType

    out = [(e.name, e.time_range.start, e.time_range.elapsed_us())
           for e in prof.events()
           if e.device_type == DeviceType.CUDA
           and (pattern is None or pattern in e.name)]
    return sorted(out, key=lambda t: t[1])


def _keys_ms(prof, calls, pattern):
    """The reading of ``key_averages()`` as :func:`device_ms` took it before
    the per-launch reading: each kernel's mean over the launches caught,
    times its launches a call."""
    per_call = 0.0
    for event in prof.key_averages():
        if pattern is not None and pattern not in event.key:
            continue
        t = getattr(event, "device_time_total", None)
        t = event.cuda_time_total if t is None else t
        if t <= 0 or event.count <= 0:
            continue
        per_call += t / event.count * max(1, round(event.count / calls))
    return per_call / 1e3


def readings(T=512, rounds=24):
    """Every body's warm reading, ``rounds`` times, in the order
    :func:`run_probe` takes them (the wrapper by CUDA events, the profiler,
    the bare launches, the cold profiler reading): per round and body the
    reading of ``key_averages()`` (``keys_ms``, and ``cold_keys_ms`` on the
    rotated x: :func:`device_ms`'s reading before it read the trace's
    clock), the kernel's events one by one (``launches``: start and
    duration, us), a spin before and a spin after the traced calls over
    their CUDA-event times (``open_spin_ratio``, ``spin_ratio``: 1 where the
    trace's clock is right, None where the trace lost the spin), and
    :func:`bare_ms`. Returns ``{"rounds": [...], "summary": {...}}``;
    ``summary`` counts the readings under 0.75 of the bare launches', the
    traces whose closing spin is missing or more than :data:`CLOCK_SLACK`
    off, and the low readings among those."""
    from torch.profiler import ProfilerActivity, profile

    D_host, x_host = probe_inputs(T)
    D = torch.from_numpy(D_host).cuda()
    x = torch.from_numpy(x_host).cuda()
    prep = prepare_edge_matrix(D)
    cold = rotation(x)
    rows = []
    for r in range(rounds):
        for variant in VARIANTS:
            def call(xv=None, variant=variant):
                return edge_mm(prep, x if xv is None else xv, variant)

            cuda_ms(call, 8)
            call()
            torch.cuda.synchronize()
            marks = [torch.cuda.Event(enable_timing=True)
                     for _ in range(4)]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                marks[0].record()
                torch.cuda._sleep(SPIN_CYCLES)
                marks[1].record()
                for _ in range(PROFILED_CALLS):
                    call()
                marks[2].record()
                torch.cuda._sleep(SPIN_CYCLES)
                marks[3].record()
                torch.cuda.synchronize()
            launches = kernel_events(prof, "edge_mm")
            spins = kernel_events(prof, "spin_kernel")
            first = spins[0][1] < launches[0][1] if spins and launches \
                else False
            timed = [marks[0].elapsed_time(marks[1]) * 1e3,
                     marks[2].elapsed_time(marks[3]) * 1e3]
            ratios = [None, None]
            if len(spins) == 2:
                ratios = [spins[0][2] / timed[0], spins[1][2] / timed[1]]
            elif len(spins) == 1:  # which end it is, by its start
                ratios[0 if first else 1] = spins[0][2] / timed[0 if first
                                                                 else 1]
            row = {"round": r, "variant": variant,
                   "spin_ratio": ratios[1], "open_spin_ratio": ratios[0],
                   "keys_ms": _keys_ms(prof, PROFILED_CALLS, "edge_mm"),
                   "launches": [(round(s, 3), round(d, 3))
                                for _, s, d in launches],
                   "names": sorted({n for n, _, _ in launches})}
            row["bare_ms"] = bare_ms(prep, x, variant)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(PROFILED_CALLS):
                    call(cold())
                torch.cuda.synchronize()
            row["cold_keys_ms"] = _keys_ms(prof, PROFILED_CALLS, "edge_mm")
            rows.append(row)
    summary = {}
    for variant in VARIANTS:
        mine = [w for w in rows if w["variant"] == variant]
        low = [w for w in mine if w["keys_ms"] < 0.75 * w["bare_ms"]]
        summary[variant] = {
            "readings": len(mine), "under_0.75_bare": len(low),
            "keys_ms_median": statistics.median(w["keys_ms"] for w in mine),
            "bare_ms_median": statistics.median(w["bare_ms"] for w in mine),
            "launches_caught": sorted({len(w["launches"]) for w in mine}),
            "clock_off": sum(w["spin_ratio"] is None
                             or abs(w["spin_ratio"] - 1) > CLOCK_SLACK
                             for w in mine),
            "under_0.75_bare_with_clock_off": sum(
                w["spin_ratio"] is not None
                and abs(w["spin_ratio"] - 1) > CLOCK_SLACK for w in low)}
    return {"card": card(), "torch": torch.__version__, "rounds": rows,
            "summary": summary}


def residue(traces=300, steps=3000):
    """Whether ``torch.profiler`` traces slow a process's later launches:
    the host's microseconds a step of a loop of five small elementwise
    kernels (three timings), before and after ``traces`` traces of
    :func:`clocked_trace` in this process. ``chip_smoke.py`` runs phase 16
    in a process of its own by it."""
    dev = torch.device("cuda")

    def loop():
        x = torch.randn(64, 66, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            x = (x * 1.0001).sin_().add_(0.1).cos_() * 0.5 + x * 0.5
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e6

    before = [loop() for _ in range(3)]
    x = torch.randn(4096, device=dev)
    t0 = time.perf_counter()
    for _ in range(traces):
        clocked_trace(lambda: [x.sum() for _ in range(20)])
    seconds = time.perf_counter() - t0
    return {"card": card(), "torch": torch.__version__, "traces": traces,
            "traces_s": seconds, "us_a_step_before": before,
            "us_a_step_after": [loop() for _ in range(3)]}


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("edge_mm_probe: no CUDA card")
    if argv and argv[0] == "residue":
        print(json.dumps(residue(int(argv[1]) if len(argv) > 1 else 300)))
        return
    if argv and argv[0] == "mma_rate":
        print(json.dumps(mma_rate()))
        return
    if argv and argv[0] in ("knockouts", "alternatives"):
        fn = knockouts if argv[0] == "knockouts" else alternatives
        print(json.dumps(fn(int(argv[1]) if len(argv) > 1 else 512)))
        return
    if argv and argv[0] == "readings":
        res = readings(rounds=int(argv[1]) if len(argv) > 1 else 24)
        if len(argv) > 2:
            Path(argv[2]).parent.mkdir(parents=True, exist_ok=True)
            Path(argv[2]).write_text(json.dumps(res))
        print(json.dumps({"card": res["card"], "summary": res["summary"]}))
        return
    if argv and argv[0] == "turns":
        if len(argv) < 2:
            raise SystemExit("usage: edge_mm_probe turns PARENT_ROOT [T]")
        print(json.dumps(turns(argv[1], int(argv[2]) if len(argv) > 2
                               else 512)))
        return
    T = int(argv[0]) if argv else 512
    reps = int(argv[1]) if len(argv) > 1 else 8
    print(f"card: {card()}; torch {torch.__version__}")
    print(f"shapes: D [{M}, {K}] x [{K}, {T}] x {N_TILES} tiles")
    res = run_probe(T, reps)
    print(f"prepare_edge_matrix {res['prepare_ms']:.3f} ms (host clock)")
    for name in VARIANTS:
        r = res[name]
        lib = ("" if r["library"] is None else
               f"; library {r['library_ms']:.4f} ms, cold "
               f"{r['library_cold_ms']:.4f} ({r['library']})")
        print(f"{LABELS[name]:40s} {r['ms']:8.4f} ms alone (bare "
              f"launches {r['bare_ms']:.4f}), cold {r['cold_ms']:.4f}, "
              f"{r['call_ms']:.4f} with its wrapper, "
              f"{r['tflops']:6.2f} TFLOP/s, bound {r['bound_ms']:.4f} "
              f"({r['bound_by']}; warm {r['warm_bound_ms']:.4f}), rel err "
              f"vs f64 {r['rel_err']:.3g}, "
              f"{json.dumps(r['resources'])}{lib}")
    r = res["library"]
    print(f"{LABELS['library']:40s} {r['ms']:8.4f} ms, {r['tflops']:.2f} TFLOP/s")


if __name__ == "__main__":
    main(sys.argv[1:])
