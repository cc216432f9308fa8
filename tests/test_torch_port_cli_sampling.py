"""``python -m molann_tpu_torch sample|fes|reweight|mep|pmf|msm|build``
against the JAX package's commands, in process, with ``--device cpu``.

Both commands read the same files (the model is built by the JAX
``build``). ``sample`` at kT > 0 replays the JAX command's noise (the key
of ``--seed``, split as its integrator splits it) through the port's noise
helper, as ``tests/test_torch_port_sampling.py`` does. Tolerances: frames
and bias arrays 1e-4; FES, weights, paths and PMFs 1e-4 (float32 on both
sides); the MSM outputs 1e-10 (the same numpy code); printed lines equal
word for word, each number within 1e-4 relative or one unit of its last
printed digit. ``build`` writes the JAX file but for the MLP's weights,
which come from a torch generator where JAX's come from ``PRNGKey(0)``.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from molann_tpu.cli import main as jmain
from molann_tpu.systems import alanine_pdb_text, alanine_universe
from molann_tpu_torch.cli import NOT_PORTED, main
from test_torch_port_sampling import (jax_baoab_normals, jax_normals,  # noqa
                                      replay)

CPU = ["--device", "cpu"]
TOL = 1e-4
NUMBER = re.compile(r"[-+]?(?:\d+\.?\d*|\.\d+)(?:e[-+]?\d+)?|inf|nan")
STEPS, W = 100, 2


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_sampling")
    (d / "system.pdb").write_text(alanine_pdb_text())
    (d / "features.txt").write_text(
        "[Output]\n"
        "d1, dihedral, bynum 5, bynum 7, bynum 9, bynum 15\n"
        "b1, bond, bynum 2 5\n"
        "[End]\n")
    assert jmain(["build", str(d / "system.pdb"), str(d / "features.txt"),
                  "--section", "Output", "--align", "bynum 1 2 5", "--mlp",
                  "5", "2", "--out", str(d / "model.npz")]) == 0
    return d


def same_text(got, want):
    """The same words, and each number within 1e-4 relative or one unit of
    the last digit printed."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want), (got, want)
    for a, b in zip(NUMBER.findall(got), NUMBER.findall(want)):
        if b in ("inf", "nan"):
            assert a == b
            continue
        mant = b.lower().split("e")[0]
        places = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(b.lower().split("e")[1]) if "e" in b.lower() else 0
        unit = 10.0 ** (exp - places)
        assert abs(float(a) - float(b)) <= max(TOL * abs(float(b)),
                                               unit * (1 + 1e-9)), (got, want)


def both(capsys, argv, outs=(), port_extra=CPU):
    """Runs the JAX command and the port's on ``argv``, whose output files
    (the names in ``outs``, as the paths given) get a ``j_`` / ``p_``
    prefix. Returns ``(rc, printed)`` of each."""
    res = []
    for fn, tag, extra in ((jmain, "j_", []), (main, "p_", port_extra)):
        a = [str(x) for x in argv]
        renamed = [(str(o), str(o.parent / (tag + o.name))) for o in outs]
        for o, t in renamed:
            a = [x.replace(o, t) for x in a]
        capsys.readouterr()
        rc = fn(a + extra)
        out = capsys.readouterr().out
        for o, t in renamed:
            out = out.replace(t, o)
        res.append((rc, out))
    (rj, oj), (rp, op) = res
    assert rj == rp == 0
    same_text(op, oj)
    return oj, op


def same_csv(got, want):
    """Two ``.csv`` outputs: the same header, and each value within 1e-4
    (``inf`` where the other has ``inf``)."""
    g, w = got.read_text().splitlines(), want.read_text().splitlines()
    assert g[0] == w[0] and len(g) == len(w)
    a = np.asarray([[float(v) for v in row.split(",")] for row in g[1:]])
    b = np.asarray([[float(v) for v in row.split(",")] for row in w[1:]])
    np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
    np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)],
                               atol=TOL, rtol=0)


def pair(path):
    return (path.parent / ("j_" + path.name), path.parent / ("p_" + path.name))


def same_npz(a, b, atol=TOL):
    with np.load(a) as x, np.load(b) as y:
        assert sorted(x.keys()) == sorted(y.keys())
        for k in x:
            assert x[k].shape == y[k].shape, k
            np.testing.assert_allclose(y[k], x[k], atol=atol, rtol=atol,
                                       err_msg=k)


# --- sample -------------------------------------------------------------------

def _noise(kind, steps, stride, thin, walkers, seed=0):
    key = jax.random.PRNGKey(seed)
    shape = (walkers, 22, 3)
    if kind == "baoab":
        return jax_baoab_normals(key, steps // thin, thin, shape)
    per = stride if kind in ("metad", "opes") else thin
    return jax_normals(key, steps // per, per, shape)


SAMPLE_CASES = {
    "metad": ("metad", ["--bias", "metad"]),
    "metad_wt": ("metad", ["--bias", "metad", "--well-tempered-gamma", "10"]),
    "opes": ("opes", ["--bias", "opes", "--sigma", "0.1"]),
    "opes_adaptive": ("opes", ["--bias", "opes", "--opes-adaptive",
                               "--opes-max-kernels", "3", "--sigma",
                               "0.05"]),
    "steered": ("steered", ["--bias", "steered", "--s0=-0.9,0.1",
                            "--s1=-0.5,0.4"]),
    "none": ("none", ["--bias", "none"]),
    "baoab": ("baoab", ["--bias", "none", "--integrator", "baoab", "--dt",
                        "5e-3"]),
    "path": ("metad", ["--bias", "metad", "--path", "{path}", "--tube-k",
                       "5", "--tube-max", "0.1", "--sigma", "0.1"]),
}


@pytest.mark.parametrize("case", list(SAMPLE_CASES))
def test_sample_matches_jax_command(workdir, capsys, replay, case):
    """Every bias, the BAOAB integrator and ``--path --tube-k``, with the
    JAX command's noise replayed: frames, the bias file and the printed
    lines. Trajectories go to ``.npy`` (``.xtc`` for the unbiased run)."""
    d = workdir
    kind, flags = SAMPLE_CASES[case]
    if case == "path":
        t = np.linspace(0.0, 1.0, 6)[:, None]
        a, b = np.asarray([-0.9, 0.1]), np.asarray([-0.2, 0.6])
        np.save(d / "path.npy", np.concatenate(
            [a * (1 - t) + b * t, np.zeros((6, 1))], axis=1).astype(
                np.float32))
        flags = [f.format(path=d / "path.npy") for f in flags]
    ext = ".xtc" if case == "none" else ".npy"
    out, bias = d / f"s_{case}{ext}", d / f"b_{case}.npz"
    argv = ["sample", d / "model.npz", d / "system.pdb", *flags, "--steps",
            str(STEPS), "--walkers", str(W), "--stride", "25", "--thin",
            "25", "--out", out, "--bias-out", bias]
    noise = _noise(kind, STEPS, 25, 25, W)
    r = replay(noise)  # the port's run draws it; the JAX run its own
    both(capsys, argv, outs=(out, bias))
    assert r.done()
    jo, po = pair(out)
    if ext == ".xtc":
        from molann_tpu_torch.io.xdr import read_xtc

        fj, fp = read_xtc(str(jo))[0], read_xtc(str(po))[0]
        atol = 2e-3  # the codec's 1e-3 precision, either side of a rounding
    else:
        fj, fp = np.load(jo), np.load(po)
        atol = TOL
    assert fp.shape == fj.shape == (STEPS // 25 * W, 22, 3)
    np.testing.assert_allclose(fp, fj, atol=atol, rtol=0)
    if kind in ("metad", "opes"):
        same_npz(*pair(bias))


def test_sample_errors_match_jax(workdir, capsys):
    """The usage errors of ``sample`` and the port's device rule."""
    d = workdir
    base = ["sample", str(d / "model.npz"), str(d / "system.pdb"),
            "--steps", "50", "--out", str(d / "x.npy")]
    for extra, msg in ((["--bias", "steered"], "--s0 and --s1"),
                       (["--bias", "metad", "--integrator", "baoab"],
                        "baoab"),
                       (["--free-torsion", "5,7,9"], "4 comma-separated")):
        for fn, dev in ((jmain, []), (main, CPU)):
            with pytest.raises(SystemExit, match=msg):
                fn(base + extra + dev)
    if not torch.cuda.is_available():
        for cmd in (base, ["fes", str(d / "b_metad.npz")],
                    ["pmf", str(d / "x.npy"), "--centers=0",
                     "--k-spring", "1"],
                    ["build", str(d / "system.pdb"), str(d / "features.txt"),
                     "--section", "Output"]):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                main(cmd)


# --- fes, reweight ------------------------------------------------------------

def _bias_files(d):
    from molann_tpu_torch.sampling import MetadBias, OpesBias

    rng = np.random.default_rng(3)
    c1 = rng.normal(scale=0.5, size=(12, 1)).astype(np.float32)
    c2 = rng.normal(scale=0.5, size=(12, 2)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 12).astype(np.float32)
    MetadBias(c1, 0.5, 0.2).save(str(d / "h1.npz"))
    MetadBias(c2, 0.5, 0.3, weights=w, gamma=5.0).save(str(d / "h2wt.npz"))
    OpesBias(c2, w * 3, sigma=0.2, sigmas=rng.uniform(0.1, 0.3, 12),
             gamma=8.0, kT=0.5, barrier=4.0).save(str(d / "k2.npz"))
    return {"h1": 1, "h2wt": 2, "k2": 2}


@pytest.mark.parametrize("ext", [".npy", ".csv"])
def test_fes_matches_jax(workdir, capsys, ext):
    """Standard, well-tempered and OPES files, 1-D and 2-D grids (a single
    spec broadcast), ``.npy`` and ``.csv`` outputs."""
    d = workdir
    for name, dim in _bias_files(d).items():
        out = d / f"fes_{name}{ext}"
        grid = "--grid=-1.5:1.5:41" if dim == 1 else "--grid=-1:1:15"
        both(capsys, ["fes", d / f"{name}.npz", grid, "--out", out],
             outs=(out,))
        jo, po = pair(out)
        if ext == ".npy":
            np.testing.assert_allclose(np.load(po), np.load(jo), atol=TOL)
        else:
            same_csv(po, jo)
    for fn, dev in ((jmain, []), (main, CPU)):
        with pytest.raises(SystemExit, match="1 or 2 lo:hi:n"):
            fn(["fes", str(d / "k2.npz"), "--grid=-1:1:5,0:1:3,0:1:2", *dev])


def test_reweight_matches_jax(workdir, capsys):
    """Weights from hills (``--kT`` required) and OPES kernels (their own
    kT), 1-D CVs given as ``[T]``; the errors."""
    d = workdir
    _bias_files(d)
    rng = np.random.default_rng(4)
    np.save(d / "cv1.npy", rng.normal(size=200).astype(np.float32))
    np.save(d / "cv2.npy", rng.normal(size=(200, 2)).astype(np.float32))
    for name, cv, extra in (("h1", "cv1", ["--kT", "0.25"]),
                            ("h2wt", "cv2", ["--kT", "0.5"]),
                            ("k2", "cv2", []), ("k2", "cv2", ["--kT", "1"])):
        out = d / f"w_{name}.npy"
        both(capsys, ["reweight", d / f"{name}.npz", d / f"{cv}.npy",
                      "--out", out, *extra], outs=(out,))
        jo, po = pair(out)
        np.testing.assert_allclose(np.load(po), np.load(jo), rtol=TOL)
    for fn, dev in ((jmain, []), (main, CPU)):
        with pytest.raises(SystemExit, match="pass --kT"):
            fn(["reweight", str(d / "h1.npz"), str(d / "cv1.npy"), *dev])
        with pytest.raises(SystemExit, match="1-d CV"):
            fn(["reweight", str(d / "h1.npz"), str(d / "cv2.npy"),
                "--kT", "1", *dev])


# --- mep, pmf -------------------------------------------------------------------

def test_mep_matches_jax(workdir, capsys):
    """The string on a ``pmf`` file ([2, n]), a 2-D FES grid with
    ``--grid`` (``.csv`` out, pinned ends), a hills file and an OPES file;
    the errors."""
    d = workdir
    _bias_files(d)
    s = np.linspace(-1.55, 1.45, 101)
    np.save(d / "pmf1d.npy", np.stack([s, (s ** 2 - 1.0) ** 2]))
    xs, ys = np.linspace(-1.55, 1.45, 61), np.linspace(-1.05, 0.95, 41)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    np.save(d / "fes2d.npy", (gx ** 2 - 1.0) ** 2 + 2.0 * gy ** 2)
    cases = [
        ("pmf1d.npy", ["--start=-1.2", "--end", "1.1", "--images", "12",
                       "--iterations", "300", "--step", "2e-2"], ".npy"),
        ("fes2d.npy", ["--grid=-1.55:1.45:61,-1.05:0.95:41",
                       "--start=-1.1,0.3", "--end", "1.1,-0.2", "--images",
                       "10", "--iterations", "300", "--step", "2e-2",
                       "--pin-ends"], ".csv"),
        ("h1.npz", ["--start=-0.9", "--end", "0.9", "--images", "8",
                    "--iterations", "200", "--step", "5e-2"], ".npy"),
        ("k2.npz", ["--start=-0.5,0", "--end", "0.5,0.2", "--images", "8",
                    "--iterations", "100", "--step", "1e-2"], ".npy"),
    ]
    for src, flags, ext in cases:
        out = d / f"mep_{src.split('.')[0]}{ext}"
        both(capsys, ["mep", d / src, *flags, "--out", out], outs=(out,))
        jo, po = pair(out)
        if ext == ".npy":
            np.testing.assert_allclose(np.load(po), np.load(jo), atol=TOL)
        else:
            same_csv(po, jo)
    for fn, dev in ((jmain, []), (main, CPU)):
        with pytest.raises(SystemExit, match="--grid"):
            fn(["mep", str(d / "fes2d.npy"), "--start=-1,0", "--end", "1,0",
                *dev])
        with pytest.raises(SystemExit, match="dimensions differ"):
            fn(["mep", str(d / "h1.npz"), "--start=-1,0", "--end", "1",
                *dev])
        with pytest.raises(SystemExit, match="hills are 1-dimensional"):
            fn(["mep", str(d / "h1.npz"), "--start=-1,0", "--end", "1,0",
                *dev])


@pytest.mark.parametrize("ext", [".npy", ".csv"])
def test_pmf_matches_jax(workdir, capsys, ext):
    """MBAR over umbrella windows: the window free energies and the
    profile, ``.npy`` and ``.csv``; the errors."""
    d = workdir
    rng = np.random.default_rng(5)
    centers = np.linspace(-0.8, 0.8, 5)
    cvs = (centers[:, None] + rng.normal(size=(5, 300)) / np.sqrt(30.0)
           ).astype(np.float32)
    np.save(d / "umb.npy", cvs)
    out = d / f"pmf{ext}"
    both(capsys, ["pmf", d / "umb.npy", "--centers=" + ",".join(
        f"{c:g}" for c in centers), "--k-spring", "20", "--kT", "0.5",
        "--grid=-1.2:1.2:24", "--out", out], outs=(out,))
    jo, po = pair(out)
    if ext == ".npy":
        a, b = np.load(po), np.load(jo)
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        np.testing.assert_allclose(a[np.isfinite(b)], b[np.isfinite(b)],
                                   atol=TOL)
    else:
        same_csv(po, jo)
    for fn, dev in ((jmain, []), (main, CPU)):
        with pytest.raises(SystemExit, match="2 centers for 5 windows"):
            fn(["pmf", str(d / "umb.npy"), "--centers=0,1", "--k-spring",
                "1", *dev])


# --- msm ------------------------------------------------------------------------

def test_msm_matches_jax(workdir, capsys):
    """One AR(1) series and two interleaved walkers, with the bootstrap,
    PCCA+, MFPT, TPT and the non-reversible estimator: the printed lines
    and every array of the ``.npz`` (1e-10). ``msm`` is host work and takes
    no ``--device``."""
    d = workdir
    rng = np.random.default_rng(11)
    z = np.empty(6000, np.float32)
    z[0] = 0.0
    for t in range(1, len(z)):
        z[t] = 0.9 * z[t - 1] + np.float32(0.44 * rng.normal())
    np.save(d / "cv_series.npy", z)
    np.save(d / "cv_walkers.npy", np.stack([z[:3000], z[3000:]], 1))
    runs = [
        ["cv_series.npy", "--lag", "5", "--grid=-2:2:8"],
        ["cv_series.npy", "--lag", "3", "--grid=-2:2:8", "--bootstrap", "6",
         "--coarse", "2", "--mfpt-to", "0,1", "--tpt", "0,1:6,7"],
        ["cv_walkers.npy", "--lag", "2", "--grid=-2:2:6,-2:2:6",
         "--nonreversible"],
        ["cv_series.npy", "--lag", "2", "--grid=-2:2:6", "--walkers", "2",
         "--bootstrap", "4", "--bootstrap-seed", "3"],
    ]
    for i, run in enumerate(runs):
        out = d / f"msm{i}.npz"
        both(capsys, ["msm", d / run[0], *run[1:], "--out", out],
             outs=(out,), port_extra=[])
        same_npz(*pair(out), atol=1e-10)
    for fn in (jmain, main):
        with pytest.raises(SystemExit, match="walkers"):
            fn(["msm", str(d / "cv_series.npy"), "--walkers", "7"])
        with pytest.raises(SystemExit, match="--tpt wants"):
            fn(["msm", str(d / "cv_series.npy"), "--tpt", "0,1"])


# --- build ----------------------------------------------------------------------

def test_build_matches_jax(workdir, capsys):
    """The model file of ``build``: with alignment and an MLP the same
    structure and arrays but for the MLP's weights (drawn by another
    generator, within the same bounds); without an MLP bit for bit; a
    section without features exits 1."""
    d = workdir
    for flags in (["--align", "bynum 1 2 5", "--mlp", "5", "2"],
                  ["--use-angle-value"]):
        out = d / f"built{len(flags)}.npz"
        both(capsys, ["build", d / "system.pdb", d / "features.txt",
                      "--section", "Output", *flags, "--out", out],
             outs=(out,))
        jo, po = pair(out)
        with np.load(jo) as a, np.load(po) as b:
            assert sorted(a.keys()) == sorted(b.keys())
            meta = json.loads(bytes(a["__meta__"]).decode())
            bound = {}  # the MLP's arrays: 1/sqrt(fan_in) of their layer
            for w, bb in meta["model"].get("ann_layers", {}).get(
                    "params", []):
                bound[w] = bound[bb] = 1.0 / np.sqrt(a[w].shape[0])
            assert len(bound) == (4 if "--mlp" in flags else 0)
            for k in a:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                if k in bound:
                    assert 0 < np.abs(b[k]).max() <= bound[k]
                else:  # the metadata and every other array
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    (d / "empty.txt").write_text("[Output]\n[End]\n")
    for fn, dev in ((jmain, []), (main, CPU)):
        capsys.readouterr()
        assert fn(["build", str(d / "system.pdb"), str(d / "empty.txt"),
                   "--section", "Output", *dev]) == 1
        assert "no features in section [Output]" in capsys.readouterr().err


def test_help_lists_the_jax_commands_in_order(capsys):
    """The port's commands are the JAX package's, all of them, in its
    ``--help`` order."""
    names = {}
    for fn, tag in ((jmain, "j"), (main, "p")):
        capsys.readouterr()
        with pytest.raises(SystemExit):
            fn(["--help"])
        text = capsys.readouterr().out
        names[tag] = re.search(r"\{([^}]*)\}", text).group(1).split(",")
    assert names["p"] == [c for c in names["j"] if c not in NOT_PORTED]
    assert NOT_PORTED == ()
    u = alanine_universe()
    assert u.atoms.n_atoms == 22
