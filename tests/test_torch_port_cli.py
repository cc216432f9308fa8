"""``python -m molann_tpu_torch train`` against ``python -m molann_tpu train``.

Both commands run in process on the same ``.npz`` (alanine, ``[38, 8, 2]``
head, JAX key 3) and ``.npy`` (256 noisy frames from a numpy seed), with
``--device cpu`` for the port. Tolerances: the written models' weights 1e-5;
the printed diagnostics 1e-4 relative, plus one unit of the last digit
printed (two values a hair apart may print either side of a rounding
boundary). An output bias that the loss cannot see (the eigenfunction and
VAMP objectives centre the outputs) is held to Adam's bound instead.
``_make_optimizer``: every update rule and schedule, with and without the
global-norm clip, against optax over five steps of a fixed gradient
stream, within 1e-6, at a rate of 1e-2: optax's Adam forms its bias
correction ``1 − 0.999^t`` in float32, 1.3e-5 off at t = 1, and at larger
rates that rounding of the reference alone reaches 1e-6.
"""

import argparse
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch

from molann_tpu.cli import main as jmain
from molann_tpu.cli.train import _make_optimizer as _jmake_optimizer
from molann_tpu.io import load_model as jload_model
from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu_torch.cli import main
from molann_tpu_torch.cli.train import _make_optimizer
from molann_tpu_torch.io import load_model, save_model
from molann_tpu_torch.utils import ThroughputMeter, annotate, capture_trace

REPO = Path(__file__).resolve().parents[1]
N = 22
L = 256
TOL = 1e-5
DIAG_RTOL = 1e-4
OPT_TOL = 1e-6
NUMBER = re.compile(r"-?\d+\.?\d*(?:e[-+]?\d+)?|inf")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    jm, u = jalanine_model(hidden_dims=(8, 2), key=jax.random.PRNGKey(3))
    jsave_model(str(d / "model.npz"), jm)
    jsave_model(str(d / "pp.npz"), jm.preprocessing_layer)
    rng = np.random.default_rng(13)
    frames = (u.atoms.positions[None]
              + 0.05 * rng.normal(size=(L, N, 3))).astype(np.float32)
    np.save(d / "traj.npy", frames)
    np.save(d / "weights.npy", rng.uniform(0.5, 2.0, L).astype(np.float32))
    np.save(d / "labels.npy", rng.permutation(np.repeat(
        [1, 0, 2], [80, 96, 80])).astype(np.int32))
    np.save(d / "targets.npy", rng.normal(size=(L, 2)).astype(np.float32))
    return d


def _train(fn, d, out, *extra):
    return fn(["train", str(d / "model.npz"), str(d / "traj.npy"),
               "--steps", "5", "--batch-size", "64", "--log-every", "0",
               "--out", str(d / out), *extra])


def _numbers(text):
    """The numbers of the diagnostics line (the last line printed), with
    the unit of each one's last printed digit."""
    line = text.strip().splitlines()[-1]
    out = []
    for tok in NUMBER.findall(line.split(":", 1)[1]):
        if tok == "inf":
            out.append((np.inf, 0.0))
            continue
        mant = tok.split("e")[0]
        places = len(mant.split(".")[1]) if "." in mant else 0
        exp = int(tok.split("e")[1]) if "e" in tok else 0
        out.append((float(tok), 10.0 ** (exp - places)))
    return line, out


def _check_mlp(lins, jparams, skip_last_bias=False, start=None):
    for i, (lin, (w, b)) in enumerate(zip(lins, jparams)):
        np.testing.assert_allclose(lin.weight.detach().numpy(),
                                   np.asarray(w).T, atol=TOL)
        if skip_last_bias and i == len(lins) - 1:
            b0 = np.asarray(start[i][1])
            for bb in (lin.bias.detach().numpy(), np.asarray(b)):
                assert np.abs(bb - b0).max() <= 5 * 1e-3 * (1 + 1e-6)
            continue
        np.testing.assert_allclose(lin.bias.detach().numpy(),
                                   np.asarray(b), atol=TOL)


@pytest.mark.parametrize("loss,extra,diag", [
    ("mse", ["--targets", "{d}/targets.npy"], None),
    ("eigenfunction", ["--weights", "{d}/weights.npy", "--beta", "2"],
     "estimated generator eigenvalues"),
    ("committor", ["--labels", "{d}/labels.npy", "--weights",
                   "{d}/weights.npy"], "committor diagnostics"),
    ("vamp", ["--lag", "4"], "VAMP-2 score"),
])
def test_train_matches_jax_command(workdir, capsys, loss, extra, diag):
    d = workdir
    extra = ["--loss", loss, *(e.format(d=d) for e in extra)]
    assert _train(jmain, d, f"j_{loss}.npz", *extra) == 0
    jout = capsys.readouterr().out
    assert _train(main, d, f"t_{loss}.npz", *extra, "--device", "cpu") == 0
    out = capsys.readouterr().out
    assert "trained 5 steps" in out and "trained 5 steps" in jout

    jm = jload_model(str(d / f"j_{loss}.npz"))
    m = load_model(str(d / f"t_{loss}.npz"), device="cpu")
    start = jload_model(str(d / "model.npz")).ann_layers.params
    _check_mlp(m.ann_layers.layers, jm.ann_layers.params,
               skip_last_bias=loss in ("eigenfunction", "vamp"), start=start)
    if diag is None:
        return
    line, got = _numbers(out)
    jline, want = _numbers(jout)
    assert diag in line and diag in jline
    assert len(got) == len(want) > 0
    for (g, unit), (w, _) in zip(got, want):
        if np.isinf(w):
            assert np.isinf(g)
            continue
        assert abs(g - w) <= DIAG_RTOL * abs(w) + unit, (line, jline)


@pytest.mark.parametrize("loss", ["autoencoder", "tae"])
def test_autoencoders_train_and_write_the_decoder(workdir, capsys, loss):
    d = workdir
    rc = main(["train", str(d / "model.npz"), str(d / "traj.npy"),
               "--loss", loss, "--lag", "3", "--decoder-hidden", "8",
               "--steps", "40", "--batch-size", "64", "--lr", "5e-3",
               "--log-every", "0", "--device", "cpu",
               "--out", str(d / f"{loss}.npz"),
               "--decoder-out", str(d / f"{loss}_dec.npz")])
    assert rc == 0
    out = capsys.readouterr().out
    first, last = out.split("loss ")[1].split(";")[0].split(" -> ")
    assert float(last) < float(first)
    enc = load_model(str(d / f"{loss}.npz"), device="cpu")
    dec = load_model(str(d / f"{loss}_dec.npz"), device="cpu")
    assert dec.layer_dims == (2, 8, 38)
    x = torch.as_tensor(np.load(d / "traj.npy")[:64])
    with torch.no_grad():
        rec = dec(enc(x))
    assert rec.shape == (64, 38) and torch.isfinite(rec).all()
    if loss == "tae":
        assert "TAE CV lag-3 autocorrelations" in out


@pytest.mark.parametrize("rule", ["adam", "adamw", "sgd", "rmsprop"])
@pytest.mark.parametrize("schedule", ["constant", "cosine", "warmup-cosine",
                                      "exponential"])
@pytest.mark.parametrize("clip", [0.0, 3.0])
def test_make_optimizer_matches_optax(rule, schedule, clip):
    args = argparse.Namespace(
        lr=0.01, lr_schedule=schedule, steps=5, warmup_steps=2,
        final_lr_scale=0.1, optimizer=rule, weight_decay=0.01,
        momentum=0.9, grad_clip=clip)
    rng = np.random.default_rng(17)
    p0 = {"a": rng.normal(size=(3, 4)).astype(np.float32),
          "b": rng.normal(size=(4,)).astype(np.float32)}
    # gradient norms from about 0.4 to 12: some under the clip, some over
    grads = [{k: (s * rng.normal(size=v.shape)).astype(np.float32)
              for k, v in p0.items()} for s in (0.1, 1.0, 3.0, 0.5, 2.0)]
    jopt = _jmake_optimizer(args)
    jp = {k: jax.numpy.asarray(v) for k, v in p0.items()}
    state = jopt.init(jp)
    tensors = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = _make_optimizer(args)(list(tensors.values()))
    for g in grads:
        updates, state = jopt.update(
            {k: jax.numpy.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tensors.items():
            t.grad = torch.as_tensor(g[k])
        opt.step()
        for k, t in tensors.items():
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                       atol=OPT_TOL, rtol=0)
    # the groups keep the base rate between steps; the count is state
    assert opt.param_groups[0]["lr"] == 0.01
    assert int(opt.state[tensors["a"]]["step"]) == 5


def test_warmup_longer_than_the_run_raises_as_in_jax():
    args = argparse.Namespace(
        lr=0.05, lr_schedule="warmup-cosine", steps=5, warmup_steps=100,
        final_lr_scale=0.1, optimizer="adam", weight_decay=0.0,
        momentum=0.9, grad_clip=0.0)
    with pytest.raises(ValueError, match="positive decay_steps"):
        _jmake_optimizer(args)
    with pytest.raises(ValueError, match="positive decay_steps"):
        _make_optimizer(args)


def test_train_error_paths(workdir, capsys):
    """The JAX command's messages and exit codes
    (``tests/test_cli.py::test_train_cli_errors`` and the checks of
    ``cmd_train``)."""
    d = workdir
    np.save(d / "short.npy", np.ones(3, np.float32))
    np.save(d / "one_basin.npy", np.ones(L, np.int32))
    cases = [
        ([], "requires --targets"),
        (["--loss", "eigenfunction", "--weights", str(d / "short.npy")],
         "weights shape"),
        (["--targets", str(d / "short.npy")], "targets rows"),
        (["--loss", "committor"], "requires --labels"),
        (["--loss", "committor", "--labels", str(d / "short.npy")],
         "labels shape"),
        (["--loss", "committor", "--labels", str(d / "one_basin.npy")],
         "at least one frame in each"),
        (["--loss", "vamp", "--lag", str(L)], "--lag"),
        (["--loss", "tae", "--lag", "0"], "--lag"),
        (["--loss", "eigenfunction", "--bagging"], "requires --ensemble"),
        (["--loss", "eigenfunction", "--ensemble", "1"], "at least 2"),
        (["--loss", "eigenfunction", "--ensemble", "2",
          "--checkpoint-dir", str(d / "ck")], "not supported with"),
        (["--loss", "autoencoder", "--ensemble", "2",
          "--decoder-out", str(d / "x.npz")], "not supported with"),
    ]
    for extra, msg in cases:
        for fn, dev in ((jmain, []), (main, ["--device", "cpu"])):
            rc = fn(["train", str(d / "model.npz"), str(d / "traj.npy"),
                     "--steps", "1", "--log-every", "0", *extra, *dev])
            assert rc == 1, (extra, fn)
            assert msg in capsys.readouterr().err, (extra, fn)
    for fn, dev in ((jmain, []), (main, ["--device", "cpu"])):
        rc = fn(["train", str(d / "pp.npz"), str(d / "traj.npy"),
                 "--loss", "autoencoder", *dev])
        assert rc == 1
        assert "needs a MolANN" in capsys.readouterr().err
    # on two ranks (gloo processes) the ranks' error is the exit code
    assert main(["train", str(d / "model.npz"), str(d / "traj.npy"),
                 "--devices", "2", "--device", "cpu"]) == 1
    # the three artifact commands are ported; export refuses the two
    # StableHLO framings with exit 2
    for flag in (["--raw-mlir"], ["--batch-sizes", "4,2"]):
        assert main(["export", str(d / "model.npz"), "--n-atoms", "22",
                     *flag, "--device", "cpu"]) == 2
        assert "TorchScript artifact" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["nope"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["train", str(d / "model.npz"), str(d / "traj.npy"),
                  "--loss", "eigenfunction", "--steps", "1"])


@pytest.mark.parametrize("bagging", [False, True])
def test_ensemble_writes_members(workdir, capsys, bagging):
    d = workdir
    rc = main(["train", str(d / "model.npz"), str(d / "traj.npy"),
               "--loss", "eigenfunction", "--ensemble", "3", "--steps", "3",
               "--batch-size", "64", "--log-every", "0", "--device", "cpu",
               *(["--bagging"] if bagging else []),
               "--out", str(d / f"committee{int(bagging)}.npz")])
    assert rc == 0
    assert "trained committee of 3 for 3 steps" in capsys.readouterr().out
    w = []
    for i in range(3):
        m = load_model(str(d / f"committee{int(bagging)}.member{i}.npz"),
                       device="cpu")
        w.append(m.ann_layers.layers[0].weight)
    assert not torch.equal(w[0], w[1]) and not torch.equal(w[1], w[2])


def test_checkpoint_resumes_to_the_same_bits(workdir, tmp_path, capsys):
    """A run stopped after its step-3 checkpoint and resumed repeats the
    uninterrupted run, schedule and clip included (the update count is
    saved with the optimizer's state)."""
    d = workdir
    ckpt = tmp_path / "ckpt"
    common = ["--loss", "committor", "--labels", str(d / "labels.npy"),
              "--optimizer", "rmsprop", "--lr-schedule", "cosine",
              "--grad-clip", "0.5", "--steps", "6", "--device", "cpu",
              "--checkpoint-dir", str(ckpt), "--checkpoint-every", "3"]
    assert _train(main, d, "full.npz", *common[:-4]) == 0
    assert _train(main, d, "first.npz", *common) == 0
    for f in ckpt.glob("ckpt_0000000006.*"):
        f.unlink()
    assert _train(main, d, "resumed.npz", *common) == 0
    capsys.readouterr()
    full = load_model(str(d / "full.npz"), device="cpu")
    resumed = load_model(str(d / "resumed.npz"), device="cpu")
    for a, b in zip(full.parameters(), resumed.parameters()):
        assert torch.equal(a, b)


def test_module_entry_point(workdir):
    """``python -m molann_tpu_torch``: trains with ``--device cpu``, and
    without it fails with the device rule's RuntimeError on a host with no
    card."""
    d = workdir
    cmd = [sys.executable, "-m", "molann_tpu_torch", "train",
           str(d / "model.npz"), str(d / "traj.npy"), "--loss", "vamp",
           "--lag", "2", "--steps", "2", "--batch-size", "64",
           "--out", str(d / "module.npz")]
    proc = subprocess.run([*cmd, "--device", "cpu"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "VAMP-2 score" in proc.stdout
    if not torch.cuda.is_available():
        proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                              timeout=300)
        assert proc.returncode != 0
        assert "RuntimeError" in proc.stderr and "no CUDA device" in \
            proc.stderr


def test_profiling(tmp_path):
    meter = ThroughputMeter()
    assert meter.mean_rate == 0.0
    for _ in range(3):
        meter.update(100)
    assert meter.rate > 0 and meter.mean_rate > 0
    with capture_trace(str(tmp_path / "trace")):
        with annotate("port_region"):
            torch.ones(8).sum()
    trace = (tmp_path / "trace" / "trace.json").read_text()
    assert "port_region" in trace


def test_saved_pair_loads_in_jax(workdir, tmp_path):
    """A ``(model, decoder)`` pair saved by the port loads in the JAX
    package as a tuple."""
    m = load_model(str(workdir / "model.npz"), device="cpu")
    dec = load_model(str(workdir / "model.npz"), device="cpu").ann_layers
    path = save_model(str(tmp_path / "pair.npz"), (m, dec))
    jpair = jload_model(path)
    assert isinstance(jpair, tuple) and len(jpair) == 2
    x = np.load(workdir / "traj.npy")[:8]
    with torch.no_grad():
        y = m(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(np.asarray(jpair[0](jax.numpy.asarray(x))),
                               y, atol=1e-6)
