"""The port's serving commands against ``python -m molann_tpu``.

``info``, ``evaluate``, ``forces``, ``committee`` (plain and
``--calibrate``), ``convert`` and ``unwrap`` run in process through both
packages' ``cli.main`` on the same files: an ``.npz`` model from the JAX
package (alanine, ``[38, 8, 2]`` head) and trajectories made from numpy
seeds, written by the JAX package's writers. The port runs with
``--device cpu`` (its plain versions), the JAX package on its CPU path.
Tolerances: values 1e-5 abs; forces 5e-5·max(1, max|g|); the files
``convert`` writes byte for byte; the printed diagnostics 1e-4 relative
plus one unit of the last digit printed (the rule of
``tests/test_torch_port_cli.py``). The compact-gradient route and
``--cull`` run on the cases of ``tests/test_cli.py`` (a 200-atom peptide
with six active atoms; ``lj_fluid_model(4)``), and the error paths exit
as the JAX commands do.
"""

import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from molann_tpu.cli import main as jmain
from molann_tpu.io import save_model as jsave_model
from molann_tpu.io import write_dcd as jwrite_dcd
from molann_tpu.io import write_trr as jwrite_trr
from molann_tpu.io import write_xtc as jwrite_xtc
from molann_tpu.pbc import box_to_dcd_cell
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.systems import alanine_pdb_text
from molann_tpu_torch.cli import NOT_PORTED, main

REPO = Path(__file__).resolve().parents[1]
N = 22
L = 300
VAL_ATOL = 1e-5
FORCE_RTOL = 5e-5
DIAG_RTOL = 1e-4
NUMBER = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?")
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_serve")
    jm, u = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(5))
    jsave_model(str(d / "model.npz"), jm)
    for k in range(3):
        m, _ = jalanine_model(hidden_dims=(8, 2),
                              key=jax.random.PRNGKey(10 + k))
        jsave_model(str(d / f"member{k}.npz"), m)
    rng = np.random.default_rng(21)
    frames = (u.atoms.positions[None]
              + 0.05 * rng.normal(size=(L, N, 3))).astype(np.float32)
    np.save(d / "traj.npy", frames)
    jwrite_xtc(str(d / "traj.xtc"), frames)
    jwrite_trr(str(d / "traj.trr"), frames)
    box = np.diag([14.0, 15.0, 16.0]).astype(np.float32)
    drift = np.cumsum(rng.normal(scale=0.5, size=(L, 1, 3)), axis=0)
    wrapped = np.mod(frames + drift, np.diag(box)).astype(np.float32)
    boxes = np.broadcast_to(box, (L, 3, 3))
    jwrite_dcd(str(d / "wrapped.dcd"), wrapped,
               cell=box_to_dcd_cell(boxes))
    np.save(d / "wrapped.npy", wrapped)
    (d / "system.pdb").write_text(alanine_pdb_text())
    return d


def _numbers(line):
    """The numbers of a printed line, each with the unit of its last
    printed digit."""
    out = []
    for tok in NUMBER.findall(line):
        mant = tok.split("e")[0]
        places = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(tok.split("e")[1]) if "e" in tok else 0
        out.append((float(tok), 10.0 ** (exp - places)))
    return out


def _same_diagnostics(got, want):
    """Two printed lines agree word for word, and number for number within
    1e-4 relative plus one unit of the last digit printed."""
    assert NUMBER.sub("#", got) == NUMBER.sub("#", want)
    for (g, ug), (w, uw) in zip(_numbers(got), _numbers(want)):
        assert abs(g - w) <= DIAG_RTOL * abs(w) + max(ug, uw), (got, want)


def _last_line(capsys):
    return capsys.readouterr().out.strip().splitlines()[-1]


def _run_both(d, capsys, argv_j, argv_t):
    """Run the JAX command and the port's; returns their last lines."""
    assert jmain(argv_j) == 0
    jline = _last_line(capsys)
    assert main(argv_t) == 0
    tline = _last_line(capsys)
    return jline, tline


def _force_close(got, want):
    np.testing.assert_allclose(
        got, want, atol=FORCE_RTOL * max(1.0, float(np.abs(want).max())))


def test_info_matches_jax(workdir, capsys):
    d = workdir
    assert jmain(["info", str(d / "model.npz")]) == 0
    jout = capsys.readouterr().out
    assert main(["info", str(d / "model.npz")]) == 0
    out = capsys.readouterr().out
    assert out == jout
    assert "features:" in out and "alignment: 3 atoms, method=qcp" in out


# one batch shape for every case: the JAX command compiles its gradient
# once a shape (about 13 s on the CPU)
@pytest.mark.parametrize("traj,backend", [
    ("traj.npy", "auto"), ("traj.xtc", "native"), ("traj.trr", "numpy")])
def test_evaluate_and_forces_match_jax(workdir, capsys, traj, backend):
    d = workdir
    common = [str(d / "model.npz"), str(d / traj), "--batch-size",
              str(L // 2), "--backend", backend]
    jl, tl = _run_both(
        d, capsys,
        ["forces", *common, "--component", "1", "--out", str(d / "jy.npy"),
         "--forces-out", str(d / "jf.npy")],
        ["forces", *common, "--component", "1", "--out", str(d / "ty.npy"),
         "--forces-out", str(d / "tf.npy"), "--tile", "64", "--interpret",
         *CPU])
    assert tl == jl.replace("jf.npy", "tf.npy")
    np.testing.assert_allclose(np.load(d / "ty.npy"), np.load(d / "jy.npy"),
                               atol=VAL_ATOL)
    _force_close(np.load(d / "tf.npy"), np.load(d / "jf.npy"))
    jl, tl = _run_both(
        d, capsys, ["evaluate", *common, "--out", str(d / "je.npy")],
        ["evaluate", *common, "--out", str(d / "te.npy"), *CPU])
    assert tl == jl.replace("je.npy", "te.npy")
    np.testing.assert_allclose(np.load(d / "te.npy"), np.load(d / "je.npy"),
                               atol=VAL_ATOL)
    np.testing.assert_allclose(np.load(d / "te.npy"), np.load(d / "ty.npy"),
                               atol=VAL_ATOL)


def test_verbose_prints_the_time_split(workdir, capsys):
    d = workdir
    assert main(["evaluate", str(d / "model.npz"), str(d / "traj.npy"),
                 "--batch-size", "100", "--verbose", "--out",
                 str(d / "v.npy"), *CPU]) == 0
    err = capsys.readouterr().err
    assert f"{L}/{L} frames" in err
    line = [ln for ln in err.splitlines() if ln.startswith("timing:")]
    assert len(line) == 1 and f"{L} frames in" in line[0]
    for part in ("read", "store", "device"):
        assert f"{part} " in line[0]


@pytest.mark.parametrize("calibrate", [False, True])
def test_committee_matches_jax(workdir, capsys, calibrate):
    d = workdir
    members = [str(d / f"member{k}.npz") for k in range(3)]
    extra = (["--calibrate", str(d / "traj.npy"), "--calibrate-frames",
              "200"] if calibrate else [])
    common = [*members, str(d / "traj.xtc"), "--batch-size", str(L),
              *extra]
    jl, tl = _run_both(
        d, capsys,
        ["committee", *common, "--out", str(d / "jm.npy"), "--std-out",
         str(d / "js.npy")],
        ["committee", *common, "--out", str(d / "tm.npy"), "--std-out",
         str(d / "ts.npy"), *CPU])
    _same_diagnostics(tl.replace("tm.npy", "jm.npy").replace("ts.npy",
                                                              "js.npy"), jl)
    assert ("calibrated" in tl) == calibrate
    for a, b in (("tm", "jm"), ("ts", "js")):
        want = np.load(d / f"{b}.npy")
        # calibrated outputs are z-scores: 1e-5 of their scale
        tol = VAL_ATOL * (max(1.0, float(np.abs(want).max())) if calibrate
                          else 1.0)
        np.testing.assert_allclose(np.load(d / f"{a}.npy"), want, atol=tol)


@pytest.mark.parametrize("src,dst,extra", [
    ("wrapped.dcd", "xtc", []),
    ("wrapped.dcd", "trr", ["--scale", "0.1"]),
    ("traj.xtc", "nc", ["--box", "20,21,22"]),
    ("traj.trr", "dcd", ["--chunk", "64"]),
    ("wrapped.dcd", "npy", ["--packed"]),
    ("traj.xtc", "npy", []),
])
def test_convert_writes_the_jax_bytes(workdir, capsys, src, dst, extra):
    d = workdir
    jl, tl = _run_both(d, capsys,
                       ["convert", str(d / src), str(d / f"j.{dst}"), *extra],
                       ["convert", str(d / src), str(d / f"t.{dst}"), *extra])
    assert tl == jl.replace(f"j.{dst}", f"t.{dst}")
    assert (d / f"t.{dst}").read_bytes() == (d / f"j.{dst}").read_bytes()


@pytest.mark.parametrize("traj,mode,extra", [
    ("wrapped.dcd", "whole+nojump", []),
    ("wrapped.npy", "whole", ["--box", "14,15,16"]),
    ("wrapped.dcd", "nojump", []),
])
def test_unwrap_matches_jax(workdir, capsys, traj, mode, extra):
    d = workdir
    out = "xtc" if mode == "nojump" else "npy"
    jl, tl = _run_both(
        d, capsys,
        ["unwrap", str(d / traj), str(d / "system.pdb"),
         str(d / f"ju.{out}"), "--mode", mode, *extra],
        ["unwrap", str(d / traj), str(d / "system.pdb"),
         str(d / f"tu.{out}"), "--mode", mode, *extra, *CPU])
    _same_diagnostics(tl.replace(f"tu.{out}", f"ju.{out}"), jl)
    if out == "npy":
        np.testing.assert_allclose(np.load(d / "tu.npy"),
                                   np.load(d / "ju.npy"), atol=VAL_ATOL)
    else:  # XTC rounds both to the same 1/1000 nm lattice
        from molann_tpu_torch.io import read_xtc

        got, want = read_xtc(d / "tu.xtc"), read_xtc(d / "ju.xtc")
        np.testing.assert_allclose(got[0], want[0], atol=1.001e-3)
        np.testing.assert_array_equal(got[2], want[2])


def test_forces_compact_route_matches_jax(tmp_path, capsys):
    """A 200-atom peptide whose CVs read six atoms (tests/test_cli.py's
    case): the port takes the blocked kernels' compact gradients, writes
    exact zeros on the other atoms, and matches the JAX command."""
    from molann_tpu.feature import Feature
    from molann_tpu.models.ann import (FeatureLayer, MolANN,
                                       PreprocessingANN, create_sequential_nn)
    from molann_tpu.systems import synthetic_peptide
    from molann_tpu_torch.io import load_model
    from molann_tpu_torch.ops.fused import (active_atom_indices,
                                            model_select_mode)

    u = synthetic_peptide(40)
    n = len(u.atoms)

    def sel(nm, r):
        return u.select_atoms(f"name {nm} and resid {r}")

    feats = [Feature("b", "bond", sel("CA", 3) + sel("CA", 30)),
             Feature("d", "dihedral",
                     sel("C", 10) + sel("N", 11) + sel("CA", 11)
                     + sel("C", 11))]
    pp = PreprocessingANN(None, FeatureLayer(feats, u.atoms))
    jm = MolANN(pp, create_sequential_nn([pp.output_dimension(), 6, 2],
                                         key=jax.random.PRNGKey(1)))
    jsave_model(str(tmp_path / "m.npz"), jm)
    tm = load_model(str(tmp_path / "m.npz"), device="cpu")
    assert model_select_mode(tm) == "blocked"
    active = active_atom_indices(tm)
    assert active is not None and len(active) == 6
    rng = np.random.default_rng(2)
    np.save(tmp_path / "traj.npy", (u.atoms.positions[None] + 0.05 * rng.normal(
        size=(24, n, 3))).astype(np.float32))
    common = [str(tmp_path / "m.npz"), str(tmp_path / "traj.npy"),
              "--batch-size", "10"]
    _run_both(tmp_path, capsys,
              ["forces", *common, "--out", str(tmp_path / "jy.npy"),
               "--forces-out", str(tmp_path / "jf.npy")],
              ["forces", *common, "--out", str(tmp_path / "ty.npy"),
               "--forces-out", str(tmp_path / "tf.npy"), *CPU])
    f = np.load(tmp_path / "tf.npy").reshape(24, n, 3)
    inactive = np.setdiff1d(np.arange(n), active)
    assert np.all(f[:, inactive] == 0.0)
    _force_close(np.load(tmp_path / "tf.npy"), np.load(tmp_path / "jf.npy"))
    np.testing.assert_allclose(np.load(tmp_path / "ty.npy"),
                               np.load(tmp_path / "jy.npy"), atol=VAL_ATOL)


def test_forces_cull_condensed_system_matches_jax(tmp_path, capsys):
    """``forces --cull`` on ``lj_fluid_model(4)`` (tests/test_cli.py's
    case): the same CullReport printed, and the JAX culled command's
    values and forces."""
    from molann_tpu.systems import lj_fluid_model

    jm, u, _ = lj_fluid_model(4)
    n = len(u.atoms)
    jsave_model(str(tmp_path / "lj.npz"), jm)
    rng = np.random.default_rng(5)
    np.save(tmp_path / "traj.npy", (u.atoms.positions[None] + 0.02 * rng.normal(
        size=(8, n, 3))).astype(np.float32))
    common = [str(tmp_path / "lj.npz"), str(tmp_path / "traj.npy"),
              "--batch-size", "8", "--cull", "--skin", "1.0"]
    assert jmain(["forces", *common, "--out", str(tmp_path / "jy.npy"),
                  "--forces-out", str(tmp_path / "jf.npy")]) == 0
    jout = capsys.readouterr().out
    assert main(["forces", *common, "--out", str(tmp_path / "ty.npy"),
                 "--forces-out", str(tmp_path / "tf.npy"), *CPU]) == 0
    out = capsys.readouterr().out
    report = [ln for ln in out.splitlines() if ln.startswith("CullReport[")]
    assert report and report == [ln for ln in jout.splitlines()
                                 if ln.startswith("CullReport[")]
    np.testing.assert_allclose(np.load(tmp_path / "ty.npy"),
                               np.load(tmp_path / "jy.npy"), atol=VAL_ATOL)
    _force_close(np.load(tmp_path / "tf.npy"), np.load(tmp_path / "jf.npy"))


def test_error_paths_match_jax(workdir, capsys):
    d = workdir
    np.save(d / "short.npy", np.zeros((4, N - 1, 3), np.float32))
    for fn, dev in ((jmain, []), (main, CPU)):
        with pytest.raises(SystemExit, match="21 atoms per frame"):
            fn(["evaluate", str(d / "model.npz"), str(d / "short.npy"),
                "--out", str(d / "x.npy"), *dev])
        assert fn(["committee", str(d / "member0.npz"), str(d / "traj.npy"),
                   *dev]) == 1
        assert "at least 2 member models" in capsys.readouterr().err
        with pytest.raises(SystemExit, match="no box vectors"):
            fn(["unwrap", str(d / "traj.npy"), str(d / "system.pdb"),
                str(d / "x.npy"), "--mode", "nojump", *dev])
        with pytest.raises(SystemExit, match="zero/degenerate"):
            fn(["unwrap", str(d / "traj.xtc"), str(d / "system.pdb"),
                str(d / "x.npy"), "--mode", "nojump", *dev])
    # on two ranks (gloo processes) the ranks' error is the exit code
    assert main(["forces", str(d / "model.npz"), str(d / "short.npy"),
                 "--devices", "2", *CPU]) == 1
    with pytest.raises(ValueError, match="tile must be"):
        main(["evaluate", str(d / "model.npz"), str(d / "traj.npy"),
              "--tile", "0", "--out", str(d / "x.npy"), *CPU])
    assert NOT_PORTED == ()  # every JAX command is ported
    for flag in (["--raw-mlir"], ["--batch-sizes", "8"]):
        assert main(["export", str(d / "model.npz"), "--n-atoms", str(N),
                     *flag, *CPU]) == 2
        assert "TorchScript artifact" in capsys.readouterr().err
    if not torch.cuda.is_available():
        for argv in (["evaluate", str(d / "model.npz"), str(d / "traj.npy")],
                     ["unwrap", str(d / "wrapped.dcd"), str(d / "system.pdb"),
                      str(d / "x.npy")],
                     ["committee", str(d / "member0.npz"),
                      str(d / "member1.npz"), str(d / "traj.npy")]):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                main(argv)


def test_module_entry_point(workdir):
    """``python -m molann_tpu_torch info`` in its own process."""
    out = subprocess.run(
        [sys.executable, "-m", "molann_tpu_torch", "info",
         str(workdir / "model.npz")], capture_output=True, text=True,
        cwd=REPO, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("model: MolANN")
