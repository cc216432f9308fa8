"""The port's trajectory IO against the JAX package's.

The codecs (``io/dcd.py``, ``io/xdr.py``, ``io/netcdf.py``) are carried
over, so the port's writers must write the JAX writers' bytes for the same
arguments (title included), and its readers must read the JAX-written files
to the same arrays, boxes included. The port's native loader is its own
copy of the C++ source, built with ``g++`` at first use: it must read
every format it takes bit for bit as the numpy decoders do. The readers'
dispatch (``open_frame_reader``, ``read_traj_boxes``) and
``packed_batch_iterator`` are held to the JAX functions for every format,
backend, shuffle, seed and ``drop_remainder``. The golden XTC/TRR byte
fixtures of ``tests/test_xdr_golden.py`` (committed under ``tests/data``)
are decoded through the port against their literally stated values.
Inputs come from numpy seeds; every comparison is exact.
"""

import os

import numpy as np
import pytest

from molann_tpu import io as jio
from molann_tpu.io.reader import open_frame_reader as jopen
from molann_tpu.io.reader import read_traj_boxes as jboxes
from molann_tpu.pbc import box_to_dcd_cell as jbox_to_cell
from molann_tpu.train.data import packed_batch_iterator as jpacked
from molann_tpu_torch import io as tio
from molann_tpu_torch.io import native_loader
from molann_tpu_torch.io.reader import open_frame_reader, read_traj_boxes
from molann_tpu_torch.pbc import box_to_dcd_cell
from molann_tpu_torch.train.data import packed_batch_iterator

L, N = 37, 11
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
FORMATS = ("npy", "dcd", "trr", "xtc", "nc")


def _frames(seed=0, l=L, n=N):
    rng = np.random.default_rng(seed)
    return (5.0 + 3.0 * rng.normal(size=(l, n, 3))).astype(np.float32)


def _boxes(seed=1, l=L):
    rng = np.random.default_rng(seed)
    lengths = rng.uniform(20.0, 30.0, size=(l, 3))
    boxes = np.zeros((l, 3, 3), np.float32)
    for i in range(3):
        boxes[:, i, i] = lengths[:, i]
    boxes[:, 1, 0] = 2.0  # triclinic: a lower-triangular off-diagonal
    return boxes


def _write(mod, fmt, path, frames, boxes=None, title="a title"):
    """Write with module ``mod`` (the JAX package's io or the port's)."""
    if fmt == "npy":
        np.save(path, frames)
    elif fmt == "dcd":
        mod.write_dcd(path, frames, title=title,
                      cell=None if boxes is None else box_to_dcd_cell(boxes))
    elif fmt == "trr":
        mod.write_trr(path, frames, box=boxes)
    elif fmt == "xtc":
        mod.write_xtc(path, frames, box=boxes)
    else:
        mod.write_netcdf(path, frames, box=boxes, title=title)
    return path


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Each format written by the JAX package, with and without boxes."""
    d = tmp_path_factory.mktemp("torch_io")
    frames, boxes = _frames(), _boxes()
    out = {}
    for fmt in FORMATS:
        for boxed in (False, True):
            if fmt == "npy" and boxed:
                continue
            path = str(d / f"j{'_box' if boxed else ''}.{fmt}")
            out[(fmt, boxed)] = _write(jio, fmt, path, frames,
                                       boxes if boxed else None)
    return frames, boxes, out


def test_native_loader_builds_from_the_port_source():
    assert native_loader.available()
    so = native_loader.build()
    assert os.path.basename(so).startswith("libtrajloader_")
    assert os.sep + "molann_tpu_torch" + os.sep + "_build" in so


@pytest.mark.parametrize("fmt", ["dcd", "trr", "xtc", "nc"])
@pytest.mark.parametrize("boxed", [False, True])
def test_writers_write_the_jax_bytes(tmp_path, fmt, boxed):
    frames = _frames(2)
    boxes = _boxes(3) if boxed else None
    j = _write(jio, fmt, str(tmp_path / f"j.{fmt}"), frames, boxes)
    t = _write(tio, fmt, str(tmp_path / f"t.{fmt}"), frames, boxes)
    with open(j, "rb") as a, open(t, "rb") as b:
        assert a.read() == b.read()


def test_writers_defaults_and_incremental_writers(tmp_path):
    """Default titles and options, and the incremental writers fed in
    chunks, give the JAX writers' bytes."""
    frames, boxes = _frames(4), _boxes(5)
    for name, jw, tw, kw in (
            ("dcd", jio.DCDWriter, tio.DCDWriter, {"has_cell": True}),
            ("trr", jio.TRRWriter, tio.TRRWriter, {"dt": 0.5}),
            ("xtc", jio.XTCWriter, tio.XTCWriter, {"precision": 100.0}),
            ("nc", jio.NetCDFWriter, tio.NetCDFWriter, {"with_box": True})):
        for who, cls in (("j", jw), ("t", tw)):
            with cls(str(tmp_path / f"{who}.{name}"), **kw) as w:
                for s in (0, 10, 30):
                    chunk = frames[s:s + (10 if s < 30 else L)]
                    bx = boxes[s:s + len(chunk)]
                    if name == "dcd":
                        w.append(chunk, cell=box_to_dcd_cell(bx))
                    else:
                        w.append(chunk, box=bx)
        with open(tmp_path / f"j.{name}", "rb") as a, \
                open(tmp_path / f"t.{name}", "rb") as b:
            assert a.read() == b.read(), name
    for fmt in ("dcd", "nc"):
        jio_fn = getattr(jio, "write_dcd" if fmt == "dcd" else "write_netcdf")
        tio_fn = getattr(tio, "write_dcd" if fmt == "dcd" else "write_netcdf")
        jio_fn(str(tmp_path / f"jd.{fmt}"), frames)
        tio_fn(str(tmp_path / f"td.{fmt}"), frames)
        with open(tmp_path / f"jd.{fmt}", "rb") as a, \
                open(tmp_path / f"td.{fmt}", "rb") as b:
            assert a.read() == b.read(), fmt
    rng = np.random.default_rng(6)
    v, f = (rng.normal(size=frames.shape).astype(np.float32)
            for _ in range(2))
    jio.write_trr(str(tmp_path / "jv.trr"), frames, velocities=v, forces=f)
    tio.write_trr(str(tmp_path / "tv.trr"), frames, velocities=v, forces=f)
    with open(tmp_path / "jv.trr", "rb") as a, \
            open(tmp_path / "tv.trr", "rb") as b:
        assert a.read() == b.read()
    got = tio.read_trr(str(tmp_path / "jv.trr"), velocities=True,
                       forces=True)
    want = jio.read_trr(str(tmp_path / "jv.trr"), velocities=True,
                        forces=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("fmt", ["dcd", "trr", "xtc", "nc"])
@pytest.mark.parametrize("boxed", [False, True])
def test_readers_read_jax_files(files, fmt, boxed):
    _, _, paths = files
    path = paths[(fmt, boxed)]
    reader = {"dcd": "read_dcd", "trr": "read_trr", "xtc": "read_xtc",
              "nc": "read_netcdf"}[fmt]
    got = getattr(tio, reader)(path)
    want = getattr(jio, reader)(path)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(read_traj_boxes(path) is None,
                                  jboxes(path) is None)
    if jboxes(path) is not None:
        np.testing.assert_array_equal(read_traj_boxes(path), jboxes(path))
    assert (read_traj_boxes(path) is not None) == (boxed and fmt != "npy")


def test_netcdf_reader_and_box_records(files):
    _, boxes, paths = files
    with tio.NetCDFReader(paths[("nc", True)]) as r, \
            jio.NetCDFReader(paths[("nc", True)]) as jr:
        assert (r.n_frames, r.n_atoms) == (jr.n_frames, jr.n_atoms)
        idx = np.array([3, 0, 36, 7])
        np.testing.assert_array_equal(r.frames_at(idx), jr.frames_at(idx))
        np.testing.assert_array_equal(r.boxes(), jr.boxes())
    np.testing.assert_array_equal(box_to_dcd_cell(boxes),
                                  jbox_to_cell(boxes))
    assert read_traj_boxes(paths[("npy", False)]) is None


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("backend", ["auto", "native", "numpy"])
def test_open_frame_reader_matches_jax(files, fmt, backend):
    """Every format under every backend reads the JAX reader's arrays; the
    native loader and the numpy decoders agree bit for bit."""
    _, _, paths = files
    path = paths[(fmt, fmt != "npy")]
    read, n, a = open_frame_reader(path, backend=backend)
    jread, jn, ja = jopen(path, backend=backend)
    assert (n, a) == (jn, ja) == (L, N)
    for s, c in ((0, L), (5, 9), (30, 7)):
        got = read(s, c)
        assert got.dtype == np.float32 and got.flags.writeable
        np.testing.assert_array_equal(got, jread(s, c))
    read.close()
    jread.close()
    other, _, _ = open_frame_reader(path, backend="numpy")
    np.testing.assert_array_equal(open_frame_reader(path,
                                                    backend=backend)[0](0, L),
                                  other(0, L))


def test_reader_errors_follow_jax(tmp_path):
    bad = tmp_path / "missing.dcd"
    with pytest.raises(OSError):
        open_frame_reader(str(bad), backend="native")
    with pytest.raises(OSError):
        jopen(str(bad), backend="native")
    with pytest.raises(ValueError, match="auto/native/numpy"):
        open_frame_reader(str(bad), backend="mmap")
    np.save(tmp_path / "flat.npy", np.zeros((4, 5), np.float32))
    with pytest.raises(ValueError, match="expected"):
        open_frame_reader(str(tmp_path / "flat.npy"), backend="numpy")
    arr = _frames(7, 4, 3)
    read, n, a = open_frame_reader(arr.reshape(4, 9), backend="native")
    np.testing.assert_array_equal(read(0, 4), arr)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("backend", ["native", "numpy"])
@pytest.mark.parametrize("shuffle,seed,drop,multiple_of", [
    (False, 0, False, 1), (True, 3, True, 1), (True, 5, False, 4)])
def test_packed_batch_iterator_matches_jax(files, fmt, backend, shuffle,
                                           seed, drop, multiple_of):
    _, _, paths = files
    path = paths[(fmt, fmt != "npy")]
    kw = dict(shuffle=shuffle, seed=seed, epochs=2, multiple_of=multiple_of,
              backend=backend, drop_remainder=drop)
    got = list(packed_batch_iterator(path, 10, **kw))
    want = list(jpacked(path, 10, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_array_equal(g, w)


# The golden fixtures' values, stated as tests/test_xdr_golden.py states
# them: ten absolute atoms; seven absolute atoms then a run of two small
# deltas (the first interchanged with the preceding atom); a float32 TRR
# frame with a 2.5 box.
GOLDEN_A_INTS = [(100 * k, 50 * k, 25 * k) for k in range(10)]
GOLDEN_B_EXPECTED = [(100 * k, 50 * k, 25 * k) for k in range(7)] + [
    (308, 193, 88), (300, 200, 100), (308, 205, 77)]
GOLDEN_TRR_COORDS = np.array([[0.5, -1.25, 2.0], [3.5, 0.125, -0.75]],
                             dtype=np.float32)


def _scaled(ints, precision=1000.0):
    inv = np.float32(1.0) / np.float32(precision)
    return np.asarray(ints, np.float32) * inv


@pytest.mark.parametrize("name,expected", [
    ("golden_abs.xtc", _scaled(GOLDEN_A_INTS)),
    ("golden_run.xtc", _scaled(GOLDEN_B_EXPECTED)),
    ("golden.trr", GOLDEN_TRR_COORDS)])
def test_golden_fixtures_through_the_port(name, expected):
    """The spec-walk byte fixtures decode to their stated values through
    the port's numpy decoders and its native loader."""
    path = os.path.join(DATA, name)
    if name.endswith(".xtc"):
        frames = tio.read_xtc(path)[0]
    else:
        frames, times, box = tio.read_trr(path)
        np.testing.assert_allclose(times, [0.004], atol=1e-9)
        np.testing.assert_array_equal(box[0],
                                      np.eye(3, dtype=np.float32) * 2.5)
    np.testing.assert_array_equal(frames.reshape(-1, 3), expected)
    ldr = native_loader.NativeTrajLoader(path)
    try:
        got = ldr.read_range(0, ldr.n_frames)
    finally:
        ldr.close()
    np.testing.assert_array_equal(got.reshape(-1, 3), expected)
