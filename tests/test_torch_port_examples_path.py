"""The port's ``path_kinetics`` example on the CPU at the JAX example's
quick size, and its deterministic stages against the JAX example's.

The JAX example has no test: the outcome assertions are what the example
prints as expected, applied to the JAX example in the same test: the
string's barrier 1.000 at (0, 0.5); the cold unbiased run trapped while
the path metadynamics crosses; a Markovian MSM (CK error < 0.1); a
monotone dominant pathway; empirical, MSM and 1/TPT-rate first-passage
times of the same order. Parity tolerances: the string's images 1e-4 after
the quick run's 2000 iterations, the potentials 1e-6 relative.

The port example runs on the JAX example's random numbers
(``example_twins.jax_randomness``), with which its dynamics are the JAX
example's step for step (``tests/example_seeds.py``, CHANGES.md). The
own-noise tests run its cold and warm particles on each package's own
generator, 64 at a time, hold their statistics to agree within
``example_twins.K`` standard errors, and hold every cold port particle in
the left well.

The replay tests run the first 20 steps of a dynamics stage (one period
where the stage's stride or thinning is longer) under the JAX run's own
noise (the ``replay`` fixture of ``tests/test_torch_port_sampling.py``),
called as the port example and as the JAX example call it, from the
example modules' constants and stage functions: coordinates, deposits and
weights within 1e-4. A CV model that the example trains is the JAX
package's at its initial weights, loaded by the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from example_twins import (STEPS, agree, check, gen, jax_example,
                           jax_randomness, port_example, run_both, seed,
                           torch_threads)
from molann_tpu import sampling as JS
from molann_tpu_torch import sampling as S
from test_torch_port_sampling import jax_normals, replay  # noqa: F401


def _check_outcome(res):
    assert abs(res["barrier"] - 1.0) < 0.01
    x, y = res["barrier_xy"]
    assert abs(x) < 0.02 and abs(y - 0.5) < 0.02
    assert res["cold_unbiased_max_x"] < 0.0      # trapped in A
    assert res["cold_biased_max_x"] > 0.5        # crossed into B
    assert res["ck_max"] < 0.1                   # Markovian
    assert res["pathway_monotone"]
    assert res["n_events"] > 10
    assert 0.1 < res["mfpt_msm"] / res["mfpt_empirical"] < 10.0
    assert 0.1 < res["mfpt_msm"] * res["rate"] < 10.0


def test_path_kinetics_outcome_both_packages():
    ex = port_example("path_kinetics")
    with torch_threads(1), jax_randomness(ex):
        res = ex.main(quick=True, device="cpu")
    _check_outcome(res)
    _check_outcome(jax_example("path_kinetics").main(quick=True))


def test_string_images_match_jax():
    """``string_method`` on ``valley_potential`` from the same straight
    string, the quick run's 2000 iterations, in both packages."""
    from molann_tpu.sampling import linear_path as jlinear_path
    from molann_tpu.sampling import string_method as jstring_method
    from molann_tpu_torch.sampling import linear_path, string_method

    ex, jex = port_example("path_kinetics"), jax_example("path_kinetics")
    assert ex.DT == jex.DT
    jimgs, je = jstring_method(
        jex.valley_potential, jlinear_path([-1.0, 0.0], [1.0, 0.0], 41),
        n_iterations=2000, step=2e-3)
    with torch_threads(1):
        imgs, e = string_method(
            ex.valley_potential,
            linear_path(torch.tensor([-1.0, 0.0]), [1.0, 0.0], 41),
            n_iterations=2000, step=2e-3)
    np.testing.assert_allclose(imgs.numpy(), np.asarray(jimgs), atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(e.numpy(), np.asarray(je), atol=1e-4, rtol=0)


def test_valley_particle_functions_match_jax():
    ex, jex = port_example("path_kinetics"), jax_example("path_kinetics")
    rng = np.random.default_rng(3)
    z = rng.uniform(-1.5, 1.5, size=(64, 2)).astype(np.float32)
    x = rng.uniform(-1.5, 1.5, size=(64, 1, 3)).astype(np.float32)
    for got, want in (
            (ex.valley_potential(torch.as_tensor(z)),
             jex.valley_potential(jnp.asarray(z))),
            (ex.particle_energy(torch.as_tensor(x)),
             jex.particle_energy(jnp.asarray(x))),
            (ex.particle_cv(torch.as_tensor(x)),
             jex.particle_cv(jnp.asarray(x)))):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())


def test_empirical_first_passage_matches_jax():
    ex, jex = port_example("path_kinetics"), jax_example("path_kinetics")
    rng = np.random.default_rng(8)
    s = np.cumsum(rng.normal(scale=0.05, size=20000))
    s = np.abs(((s + 1.0) % 2.0) - 1.0)  # reflected into [0, 1]
    got = ex.empirical_first_passage(s, 0.15, 0.85, 0.01)
    want = jex.empirical_first_passage(s, 0.15, 0.85, 0.01)
    assert got == want and got[1] > 5
    assert ex.empirical_first_passage(np.full(50, 0.5), 0.1, 0.9, 1.0) == (
        np.inf, 0)


@pytest.mark.parametrize("stage", ["cold", "path_metad", "warm"])
def test_path_kinetics_particle_runs(replay, stage):
    ex, jex = port_example("path_kinetics"), jax_example("path_kinetics")
    x0 = np.asarray([[[-1.0, 0.0, 0.0]]], np.float32)
    seed, kT = {"cold": (0, 0.12), "path_metad": (0, 0.12),
                "warm": (1, 0.35)}[stage]
    key = jax.random.PRNGKey(seed)
    r = replay(jax_normals(key, 1, STEPS, (1, 1, 3)))
    if stage == "path_metad":
        imgs = np.stack([np.linspace(-1.0, 1.0, 41),
                         0.5 * (1.0 - np.linspace(-1.0, 1.0, 41) ** 2)], 1)
        jpath, path = JS.PathCV(imgs), S.PathCV(imgs)
        jwall = jpath.wall(jex.particle_cv, k_wall=50.0, t_max=0.05)
        wall = path.wall(ex.particle_cv, k_wall=50.0, t_max=0.05)
        kw = dict(n_steps=STEPS, kT=kT, height=0.08, sigma=0.08,
                  stride=STEPS)
        want = JS.metadynamics_langevin(
            lambda x: jex.particle_energy(x) + jwall(x),
            jpath.along(jex.particle_cv), jnp.asarray(x0), dt=jex.DT,
            key=key, **kw)
        got = S.metadynamics_langevin(
            lambda x: ex.particle_energy(x) + wall(x),
            path.along(ex.particle_cv), torch.as_tensor(x0), dt=ex.DT,
            generator=gen(), **kw)
    else:
        want = JS.overdamped_langevin(jex.particle_energy, jnp.asarray(x0),
                                      n_steps=STEPS, dt=jex.DT, kT=kT,
                                      key=key, thin=STEPS)
        got = S.overdamped_langevin(ex.particle_energy, torch.as_tensor(x0),
                                    n_steps=STEPS, dt=ex.DT, kT=kT,
                                    generator=gen(), thin=STEPS)
    assert r.done()
    check(got, want, metad=stage == "path_metad")


def own_noise_particles(stage):
    """The particle in the curved valley on each package's own generator, 64
    particles from the left well for 4,000 steps: at kT 0.12
    (``cold_runs``) the rightmost x each reaches; at kT 0.35
    (``warm_run``) the share of frames right of the barrier and the
    crossings of x = 0 a particle."""
    ex, jex = port_example("path_kinetics"), jax_example("path_kinetics")
    kT, i, thin = {"cold": (ex.KT_COLD, 0, 20),
                   "warm": (ex.KT_WARM, 1, ex.THIN_WARM)}[stage]
    x0 = np.tile(np.float32([-1.0, 0.0, 0.0]), (64, 1, 1))
    kw = dict(n_steps=4000, dt=ex.DT, kT=kT, thin=thin)
    (tp, _), (tj, _) = run_both(
        lambda: S.overdamped_langevin(
            ex.particle_energy, torch.as_tensor(x0),
            generator=torch.Generator().manual_seed(seed(i)), **kw),
        lambda: JS.overdamped_langevin(
            jex.particle_energy, jnp.asarray(x0),
            key=jax.random.PRNGKey(seed(i)), **kw))
    xs = (tp[..., 0, 0], tj[..., 0, 0])
    if stage == "cold":
        return {"rightmost x": tuple(x.max(0) for x in xs)}
    return {"share right of the barrier": tuple((x > 0).mean(0)
                                                for x in xs),
            "crossings": tuple(np.abs(np.diff(np.sign(x), axis=0)).sum(0)
                               / 2 for x in xs)}


@pytest.fixture(scope="module")
def particles():
    return {stage: own_noise_particles(stage) for stage in ("cold", "warm")}


@pytest.mark.parametrize("stage, statistic", [
    ("cold", "rightmost x"), ("warm", "share right of the barrier"),
    ("warm", "crossings")])
def test_path_kinetics_own_noise(particles, stage, statistic):
    agree(*particles[stage][statistic], f"{stage}: {statistic}")


def test_path_kinetics_own_noise_cold_trapped(particles):
    """Every cold port particle stays left of the barrier."""
    assert (particles["cold"]["rightmost x"][0] < 0).all()
