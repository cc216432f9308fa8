"""The port's serving examples against their JAX twins, on the CPU:
``serve_biased_md``, ``train_autoencoder_cv`` and ``condensed_phase_cv``.

Outcome tests run each port example at the JAX example's own size
(``quick=True`` where it has one) on the CPU. ``serve_biased_md`` and
``train_autoencoder_cv`` have no JAX test: their assertions are taken from
what the example prints as expected and are applied to the JAX example in
the same test. Parity tests feed both packages the same numpy inputs, the
weights crossing through ``molann_tpu.io.save_model`` ->
``molann_tpu_torch.io.load_model``. Tolerances: values 1e-5 absolute,
coordinate gradients 2e-4·max(1, max|g|) (``tests/test_parity_torch.py``),
features and the HLDA CV 1e-5 relative to their scale.

The replay tests run the first 20 steps of a dynamics stage (one period
where the stage's stride or thinning is longer) under the JAX run's own
noise (the ``replay`` fixture of ``tests/test_torch_port_sampling.py``),
called as the port example and as the JAX example call it, from the
example modules' constants and stage functions: coordinates, deposits and
weights within 1e-4. A CV model that the example trains is the JAX
package's at its initial weights, loaded by the port.
"""

import math
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from example_twins import (STEPS, gen, jax_example, port_example,
                           run_printing, torch_threads, walkers)
from molann_tpu import Feature as JFeature
from molann_tpu import FeatureLayer as JFeatureLayer
from molann_tpu import sampling as JS
from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu.systems import lj_fluid as jlj_fluid
from molann_tpu.train import hlda as jhlda
from molann_tpu.train import packed_batch_iterator as jpacked_batch_iterator
from molann_tpu_torch import sampling as S
from molann_tpu_torch.io import load_artifact, load_model, write_dcd
from molann_tpu_torch.models.ann import FeatureLayer
from molann_tpu_torch.sampling import langevin as L
from molann_tpu_torch.train import force_fn, hlda, packed_batch_iterator
from molann_tpu_torch.systems import lj_fluid
from test_torch_port_sampling import (Replay, close, jax_normals,  # noqa: F401
                                      replay)

VAL_TOL = 1e-5
GRAD_RTOL = 2e-4

BATCH_LINE = re.compile(r"batch done: (\d+) frames, CV\[0\] mean (\S+), "
                        r"\|F\|max (\S+)")


def _served(text):
    """``(frames per batch, CV[0] means, |F| maxima, n served)`` from what
    a serving example printed."""
    rows = BATCH_LINE.findall(text)
    served = re.search(r"served (\d+) frames from", text)
    return ([int(r[0]) for r in rows], [float(r[1]) for r in rows],
            [float(r[2]) for r in rows], int(served.group(1)))


def _check_served(sizes, means, fmax, n_done):
    """What the serving example prints as expected: every frame of the
    4096 served, in batches of 1024, finite CVs and finite non-zero
    biasing forces."""
    assert n_done == 4096 and sizes == [1024] * 4
    assert np.isfinite(means).all()
    assert np.isfinite(fmax).all() and min(fmax) > 0


def test_serve_biased_md_outcome_both_packages():
    ex = port_example("serve_biased_md")
    out, text = run_printing(ex.main, device="cpu")
    _check_served(*_served(text))
    assert out["n_done"] == 4096
    # on the CPU the wrapper runs K4's plain version: nothing launched
    assert out["launches"] == 0
    assert out["cvs"].shape == (1024, 3) and out["forces"].shape == (1024, 66)
    assert out["cvs"].device.type == "cpu"
    _, jtext = run_printing(jax_example("serve_biased_md").main)
    _check_served(*_served(jtext))


def test_serve_biased_md_matches_jax_serve(tmp_path):
    """The served CVs and forces of the 4096 frames against the JAX
    example's XLA ``serve`` (``m(x3)`` and ``grad(m(v)[:, 0].sum())``) on
    the same ``.npz`` and ``.dcd``."""
    ex = port_example("serve_biased_md")
    jm, ju = jalanine_model()
    path = jsave_model(str(tmp_path / "model.npz"), jm)
    model = load_model(path, device="cpu")
    frames = ex.noisy_frames(ju)
    rng = np.random.default_rng(0)  # the JAX example's own construction
    want = (ju.atoms.positions[None]
            + 0.05 * rng.normal(size=(4096, 22, 3))).astype(np.float32)
    np.testing.assert_array_equal(frames, want)
    traj = str(tmp_path / "traj.dcd")
    write_dcd(traj, frames)

    @jax.jit
    def jserve(m, xb):
        x3 = xb.reshape(xb.shape[0], 22, 3)
        return m(x3), jax.grad(lambda v: m(v)[:, 0].sum())(x3).reshape(
            xb.shape)

    n = 0
    for xb, jxb in zip(
            packed_batch_iterator(traj, ex.BATCH, shuffle=False, epochs=1,
                                  drop_remainder=False),
            jpacked_batch_iterator(traj, ex.BATCH, shuffle=False, epochs=1,
                                   drop_remainder=False)):
        np.testing.assert_array_equal(xb, np.asarray(jxb))
        cvs, grads = ex.serve(model, torch.as_tensor(xb))
        jy, jg = (np.asarray(a) for a in jserve(jm, jnp.asarray(jxb)))
        np.testing.assert_allclose(cvs.detach().numpy(), jy, atol=VAL_TOL,
                                   rtol=0)
        tol = GRAD_RTOL * max(1.0, float(np.abs(jg).max()))
        np.testing.assert_allclose(grads.detach().numpy(), jg, atol=tol,
                                   rtol=0)
        n += xb.shape[0]
    assert n == 4096


def _autoencoder_printed(text):
    loss = re.search(r"reconstruction loss: (\S+) -> (\S+)", text)
    norms = re.search(r"force norm per frame: \[([^\]]*)\]", text)
    where = re.search(r"artifacts in: (\S+)", text)
    return (float(loss.group(1)), float(loss.group(2)),
            np.array(norms.group(1).split(), dtype=float), where.group(1))


def _check_autoencoder(loss0, loss1, norms, workdir, artifact):
    """What the autoencoder example prints as expected: the
    reconstruction loss falls at least tenfold, eight finite non-zero
    force norms, and the model and the exported artifact on disk."""
    assert loss1 < 0.1 * loss0
    assert norms.shape == (8,) and np.isfinite(norms).all()
    assert norms.min() > 0
    assert os.path.exists(os.path.join(workdir, "cv_model.npz"))
    assert os.path.exists(os.path.join(workdir, artifact))


def test_train_autoencoder_cv_outcome_both_packages():
    ex = port_example("train_autoencoder_cv")
    with torch_threads(1):
        out, text = run_printing(ex.main, device="cpu")
    loss0, loss1, norms, workdir = _autoencoder_printed(text)
    _check_autoencoder(loss0, loss1, norms, workdir, "cv_model.pt")
    # (as printed, to four decimals)
    assert abs(loss0 - out["losses"][0]) <= 5e-5 * max(1.0, loss0)
    assert abs(loss1 - out["losses"][-1]) <= 5e-5 * max(1.0, loss1)
    assert len(out["losses"]) == 300
    for step in (100, 200, 300):  # checkpoints every 100 steps
        assert any(str(step) in f
                   for f in os.listdir(os.path.join(workdir, "ckpts")))
    # the artifact gives the CVs and the gradient of their sum, that is
    # the forces of force_fn summed over the two components (1e-5 on
    # values, 2e-4·scale on gradients)
    cv_model, x = out["cv_model"], out["x"]
    y, g = load_artifact(out["artifact"], device="cpu")(x)
    with torch.no_grad():
        np.testing.assert_allclose(y.numpy(), cv_model(x).numpy(),
                                   atol=VAL_TOL, rtol=0)
    f = force_fn(cv_model, 0)(x) + force_fn(cv_model, 1)(x)
    tol = GRAD_RTOL * max(1.0, float(f.abs().max()))
    np.testing.assert_allclose(-g.numpy(), f.detach().numpy(), atol=tol,
                               rtol=0)
    np.testing.assert_allclose(
        out["forces"].detach().numpy(),
        force_fn(cv_model, 0)(x).detach().numpy(), atol=0, rtol=0)
    _, jtext = run_printing(jax_example("train_autoencoder_cv").main)
    jl0, jl1, jnorms, jdir = _autoencoder_printed(jtext)
    _check_autoencoder(jl0, jl1, jnorms, jdir, "cv_model.stablehlo")


def test_train_autoencoder_cv_frames_match_jax():
    """``make_synthetic_trajectory`` draws the JAX example's frames."""
    from molann_tpu.systems import alanine_universe as jalanine_universe

    ex, jex = (port_example("train_autoencoder_cv"),
               jax_example("train_autoencoder_cv"))
    u = jalanine_universe()
    np.testing.assert_array_equal(ex.make_synthetic_trajectory(u, 64, 3),
                                  jex.make_synthetic_trajectory(u, 64, 3))


def test_condensed_phase_cv_outcome():
    """``tests/test_condensed.py::test_condensed_example_quick``'s
    assertions on the port but one, with their thresholds.

    The hot phase runs at half the JAX example's step
    (``condensed_phase_cv.HOT_SPLIT``): at the JAX example's step it blows
    up (the next test), and the JAX test's ``cv_gap > 3 * cv_spread``
    passes on the coordinates of 1e13 that the blow-up leaves. A hot phase
    that stays in the box melts but does not separate from the solid by
    three spreads along these long-tailed shells: the ratio is 1.9 at this
    seed and 1.9-3.0 over five (``tests/example_seeds.py``, CHANGES.md).
    That assertion is the JAX example's fault, recorded there and not made
    here; the shells' loss of neighbours holds at every seed. In its place
    the CV must classify the held-out frames, from the midpoint of the
    training halves, better than 0.8: 0.89-0.99 over the five seeds."""
    with torch_threads(1):
        res = port_example("condensed_phase_cv").main(quick=True,
                                                      device="cpu")
    assert res["fused_mode"] == "blocked"
    assert res["fused_rel_err"] < 1e-4
    assert np.isfinite([res["cv_gap"], res["cv_spread"]]).all()
    assert res["cv_accuracy"] > 0.8
    # melting loses first-shell neighbors
    assert res["shell1_fluid"] < res["shell1_solid"] - 1.0


def test_condensed_hot_phase_leaves_the_box_in_both_packages(monkeypatch):
    """At the JAX example's hot settings (kT 3, dt 5e-4, key 1) the walkers
    blow up: under the JAX run's own noise both packages throw the atoms
    past 1e6 at the same recorded frame, from frames that agree to 1e-3
    until then. At the port example's split step they stay in the box."""
    ex, jex = (port_example("condensed_phase_cv"),
               jax_example("condensed_phase_cv"))
    assert (ex.EPSILON, ex.SPACING) == (jex.EPSILON, jex.SPACING)
    u, box = jlj_fluid(3, ex.SPACING)
    sigma = ex.SPACING / 2 ** (1 / 6)
    jpot = JS.LennardJonesPotential(27, box, epsilon=1.0, sigma=sigma)
    pot = S.LennardJonesPotential(27, box, epsilon=1.0, sigma=sigma)
    x0 = np.repeat(u.atoms.positions[None], 2, 0).astype(np.float32)
    key = jax.random.PRNGKey(1)
    n_periods, thin = 16, 50
    jt = np.asarray(jex.sample_phase(jpot, jnp.asarray(x0), 3.0,
                                     n_steps=n_periods * thin, key=key,
                                     thin=thin))
    r = Replay(jax_normals(key, n_periods, thin, (2, 27, 3)))
    monkeypatch.setattr(L, "_normal", r.normal)
    pt = ex.sample_phase(pot, torch.as_tensor(x0), 3.0,
                         n_steps=n_periods * thin, generator=torch.Generator(),
                         thin=thin).numpy()
    assert r.done()
    j_out = np.abs(jt).max(axis=(1, 2, 3)) > 1e6
    p_out = np.abs(pt).max(axis=(1, 2, 3)) > 1e6
    assert j_out.any() and (j_out == p_out).all()
    first = int(np.argmax(j_out))
    np.testing.assert_allclose(pt[:first], jt[:first], atol=1e-3, rtol=0)
    monkeypatch.undo()
    with torch_threads(1):
        pt = ex.sample_phase(
            pot, torch.as_tensor(x0), 3.0, n_steps=n_periods * thin * 2,
            generator=torch.Generator().manual_seed(1), thin=thin * 2,
            dt=ex.DT / ex.HOT_SPLIT).numpy()
    assert np.abs(pt).max() < 3 * box.max()


def test_condensed_shells_and_hlda_cv_match_jax():
    """The shells and the HLDA CV on the same cold (lattice + 0.05) and hot
    (lattice + 0.4) frames, fed to both packages."""
    ex = port_example("condensed_phase_cv")
    ju, box = jlj_fluid(3, ex.SPACING)
    u, _ = lj_fluid(3, ex.SPACING)
    rng = np.random.default_rng(5)
    cold = (ju.atoms.positions[None]
            + 0.05 * rng.normal(size=(40, 27, 3))).astype(np.float32)
    hot = (ju.atoms.positions[None]
           + 0.4 * rng.normal(size=(40, 27, 3))).astype(np.float32)
    jfeats = [
        JFeature("shell1", "coordination", ju.atoms, r0=1.35 * ex.SPACING,
                 pbc_box=box),
        JFeature("shell2", "coordination", ju.atoms, r0=2.2 * ex.SPACING,
                 nn=4, mm=8, pbc_box=box),
    ]
    jfl = JFeatureLayer(jfeats, ju.atoms)
    flayer = FeatureLayer(ex.shell_features(u, box), u.atoms)
    fj = [np.asarray(jfl(jnp.asarray(x))) for x in (cold, hot)]
    fp = [flayer(torch.as_tensor(x)).numpy() for x in (cold, hot)]
    for a, b in zip(fp, fj):
        np.testing.assert_allclose(a, b, rtol=1e-5 * 1, atol=1e-5 * np.abs(
            b).max())
    labels = np.repeat([0, 1], 40)
    jres = jhlda(np.concatenate(fj), labels)
    res = hlda(np.concatenate(fj), labels)
    np.testing.assert_allclose(res.directions, jres.directions, atol=1e-5)
    model = ex.hlda_model(flayer, res, "cpu")
    w = jnp.asarray(jres.directions[:, :1], jnp.float32)
    b = jnp.asarray(-(jres.mean @ jres.directions[:, :1]), jnp.float32)
    from molann_tpu import MolANN as JMolANN
    from molann_tpu import PreprocessingANN as JPP
    from molann_tpu import SequentialNN as JSeq
    jmodel = JMolANN(JPP(None, jfl), JSeq(((w, b),), (2, 1)))
    x = np.concatenate([cold, hot])
    want = np.asarray(jmodel(jnp.asarray(x)))
    with torch.no_grad():
        got = model(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * max(1.0, np.abs(want).max()))
    assert math.isfinite(float(np.abs(got).max()))


@pytest.mark.parametrize("name", ["serve_biased_md", "train_autoencoder_cv"])
def test_examples_take_the_device_rule(name):
    """``device=None`` means the card: without one the example raises
    before it does any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None runs there")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_example(name).main()


def test_condensed_cold_phase(replay):
    ex, jex = (port_example("condensed_phase_cv"),
               jax_example("condensed_phase_cv"))
    ju, box = jlj_fluid(3, jex.SPACING)
    u, _ = lj_fluid(3, ex.SPACING)
    sigma = ex.SPACING / 2 ** (1 / 6)
    jpot = JS.LennardJonesPotential(27, box, epsilon=jex.EPSILON,
                                    sigma=sigma)
    pot = S.LennardJonesPotential(27, box, epsilon=ex.EPSILON, sigma=sigma)
    key = jax.random.PRNGKey(0)
    r = replay(jax_normals(key, 1, STEPS, (2, 27, 3)))
    jt = jex.sample_phase(jpot, jnp.asarray(walkers(ju, 2)), 0.3,
                          n_steps=STEPS, key=key, thin=STEPS)
    pt = ex.sample_phase(pot, torch.as_tensor(walkers(u, 2)), 0.3,
                         n_steps=STEPS, generator=gen(), thin=STEPS)
    assert r.done()
    close(pt, jt)
