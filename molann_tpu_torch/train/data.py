"""Trajectory data: memory-mapped frame storage and batch iteration.

The port of ``save_trajectory``, ``TrajectoryDataset`` and
``batch_iterator`` of ``molann_tpu/train/data.py:31-110``, carried over
rather than imported: they use numpy only, and importing any ``molann_tpu``
module imports JAX. The same seed gives the same batches as the JAX
package. Frames are ``.npy`` arrays ``[n_frames, n_atoms, 3]`` (float32),
memory-mapped, so a trajectory larger than host memory streams batch by
batch. ``lagged_pair_iterator`` (``data.py:113``) yields the JAX package's
pairs and weights for the same seed, and ``packed_batch_iterator``
(``data.py:172``) the same packed batches from any trajectory format,
through the native loader or the numpy decoders.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "TrajectoryDataset",
    "batch_iterator",
    "lagged_pair_iterator",
    "packed_batch_iterator",
    "save_trajectory",
]


def save_trajectory(path, frames):
    """Save ``[n_frames, n_atoms, 3]`` float32 frames as .npy."""
    arr = np.ascontiguousarray(frames, dtype=np.float32)
    if arr.ndim != 3 or arr.shape[-1] != 3:
        raise ValueError(f"expected [n_frames, n_atoms, 3], got {arr.shape}")
    np.save(path, arr)
    return path


class TrajectoryDataset:
    """Memory-mapped trajectory of coordinate frames."""

    def __init__(self, path):
        self.path = str(path)
        self.frames = np.load(self.path, mmap_mode="r")
        if self.frames.ndim != 3 or self.frames.shape[-1] != 3:
            raise ValueError(
                f"expected [n_frames, n_atoms, 3], got {self.frames.shape}")

    @property
    def n_frames(self):
        return self.frames.shape[0]

    @property
    def n_atoms(self):
        return self.frames.shape[1]

    def __len__(self):
        return self.n_frames

    def __getitem__(self, item):
        return np.asarray(self.frames[item], dtype=np.float32)


def _effective_batch(batch_size, n, multiple_of, what="samples"):
    """Round batch_size down to a multiple of ``multiple_of`` and clamp it
    to the dataset size, so short trajectories train on whole-dataset
    batches instead of the epoch loop silently yielding nothing."""
    batch_size = max(multiple_of, (batch_size // multiple_of) * multiple_of)
    if batch_size > n:
        batch_size = (n // multiple_of) * multiple_of
        if batch_size < 1:
            raise ValueError(
                f"dataset has only {n} {what}, fewer than "
                f"multiple_of={multiple_of}; cannot form any batch")
    return batch_size


def batch_iterator(dataset, batch_size, *, shuffle=True, seed=0,
                   epochs=None, drop_remainder=True, multiple_of=1,
                   return_indices=False):
    """Yield float32 frame batches ``[batch_size, n_atoms, 3]`` (numpy).

    batch_size is rounded down to a multiple of ``multiple_of`` and
    clamped to the dataset size. ``epochs=None`` iterates forever. With
    ``return_indices``, yields ``(batch, idx)`` so per-frame side arrays
    (targets, weights) can be gathered in step.
    """
    n = len(dataset)
    batch_size = _effective_batch(batch_size, n, multiple_of, "frames")
    rng = np.random.default_rng(seed)
    epoch = 0

    def emit(idx):
        batch = dataset[idx]
        return (batch, idx) if return_indices else batch

    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        for start in range(0, n - batch_size + 1, batch_size):
            yield emit(np.sort(order[start:start + batch_size]))
        rem = (n % batch_size) // multiple_of * multiple_of
        if not drop_remainder and rem:
            # the tail is trimmed to multiple_of as well
            yield emit(np.sort(order[n - n % batch_size:][:rem]))
        epoch += 1


def lagged_pair_iterator(dataset, batch_size, lag, *, shuffle=True,
                         seed=0, epochs=None, multiple_of=1,
                         weights=None):
    """Yield time-lagged pairs ``(x_t [b, n, 3], x_{t+lag} [b, n, 3])``
    (numpy) for VAMP and TICA training (:mod:`.timelagged`).

    Start frames are drawn from ``[0, n_frames - lag)``: the trajectory must
    be one contiguous time series. With per-frame ``weights [n_frames]``,
    yields ``(x_t, x_tau, w_t)`` weighted at the pair's start frame.
    ``epochs=None`` iterates forever.
    """
    n = len(dataset)
    lag = int(lag)
    if lag < 1 or lag >= n:
        raise ValueError(f"lag must be in [1, n_frames) = [1, {n}), "
                         f"got {lag}")
    n_pairs = n - lag
    batch_size = _effective_batch(batch_size, n_pairs, multiple_of,
                                  "lagged pairs")
    if weights is not None:
        weights = np.asarray(weights, dtype=np.float32)
        if weights.shape != (n,):
            raise ValueError(
                f"weights must be [n_frames]={n}, got {weights.shape}")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n_pairs) if shuffle else np.arange(n_pairs)
        for start in range(0, n_pairs - batch_size + 1, batch_size):
            idx = np.sort(order[start:start + batch_size])
            x_t = dataset[idx]
            x_tau = dataset[idx + lag]
            if weights is not None:
                yield x_t, x_tau, weights[idx]
            else:
                yield x_t, x_tau
        epoch += 1


class _LazyNetCDFFrames:
    """Array-like lazy view over a NetCDFReader: ``.shape`` plus fancy
    indexing by a frame-index array, reading frames on demand from the
    mmap instead of materializing the whole trajectory in RAM."""

    def __init__(self, reader):
        self._r = reader
        self.shape = (reader.n_frames, reader.n_atoms, 3)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            idx = np.arange(*idx.indices(self.shape[0]))
        return self._r.frames_at(np.atleast_1d(idx))


def packed_batch_iterator(path, batch_size, *, shuffle=True, seed=0,
                          epochs=None, multiple_of=1, backend="auto",
                          drop_remainder=True, n_threads=None):
    """Yield packed ``[batch, 3n]`` float32 batches from a trajectory
    (``.npy``/``.dcd``/``.trr``/``.xtc``/``.nc``).

    ``backend="native"`` uses the C++ loader (mmap + threaded gather; while
    a batch is consumed, the next batch's pages are prefetched);
    ``"numpy"`` the numpy decoders; ``"auto"`` prefers the native loader.
    The same seed gives the same batches as the JAX package's iterator.
    """
    loader = None
    if backend in ("auto", "native"):
        try:
            from ..io.native_loader import NativeTrajLoader

            loader = NativeTrajLoader(path, n_threads=n_threads)
        except (OSError, RuntimeError):
            if backend == "native":
                raise
    if loader is None:
        low = str(path).lower()
        if low.endswith(".dcd"):
            from ..io.dcd import read_dcd

            mm = read_dcd(path)[0]  # numpy fallback (in memory)
        elif low.endswith(".trr"):
            from ..io.xdr import read_trr

            mm = read_trr(path)[0]
        elif low.endswith(".xtc"):
            from ..io.xdr import read_xtc

            mm = read_xtc(path)[0]
        elif low.endswith(".nc") or low.endswith(".ncdf"):
            from ..io.netcdf import NetCDFReader

            # lazy mmap-backed view; the reader stays open for the
            # iterator's lifetime, like the .npy map
            mm = _LazyNetCDFFrames(NetCDFReader(path))
        else:
            mm = np.load(path, mmap_mode="r")
        n = mm.shape[0]
        fpf = int(np.prod(mm.shape[1:]))
    else:
        n = loader.n_frames
        fpf = loader.floats_per_frame

    def fetch(idx):
        if loader is not None:
            return loader.read_batch(idx)
        return np.asarray(mm[idx], dtype=np.float32).reshape(len(idx), fpf)

    batch_size = _effective_batch(batch_size, n, multiple_of, "frames")
    rng = np.random.default_rng(seed)
    epoch = 0
    while epochs is None or epoch < epochs:
        order = rng.permutation(n) if shuffle else np.arange(n)
        starts = list(range(0, n - batch_size + 1, batch_size))
        for bi, start in enumerate(starts):
            idx = np.sort(order[start:start + batch_size])
            if loader is not None and bi + 1 < len(starts):
                nxt = starts[bi + 1]  # overlap the reads with consumption
                loader.prefetch(np.sort(order[nxt:nxt + batch_size]))
            yield fetch(idx)
        rem = (n % batch_size) // multiple_of * multiple_of
        if not drop_remainder and rem:
            # the tail is trimmed to multiple_of as well
            yield fetch(np.sort(order[n - n % batch_size:][:rem]))
        epoch += 1
