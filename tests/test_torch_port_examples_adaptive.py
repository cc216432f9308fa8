"""The port's ``adaptive_cv_loop`` example at the JAX example's quick size
on the CPU, held to ``tests/test_sampling.py::
test_adaptive_cv_loop_example_escapes``'s assertions with their
thresholds: with no prior knowledge of basin B, rounds of well-tempered
metadynamics along the current CV and retraining discover it.

The port example runs on the JAX example's random numbers
(``example_twins.jax_randomness``, over the example and the
``biased_dynamics.train_cv`` it trains with), with which it is the JAX
example step for step (``tests/example_seeds.py``, CHANGES.md). The
own-noise tests run its unbiased run on each package's own generator
with more walkers, hold its statistics to agree within
``example_twins.K`` standard errors, and hold it trapped at every port
walker.

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

from example_twins import (STEPS, ae_cv_pair, agree, alanine_pair, check,
                           gen, jax_example, jax_randomness, port_example,
                           torch_threads, trapped_run_stats, walkers)
from molann_tpu import sampling as JS
from molann_tpu_torch import sampling as S
from test_torch_port_sampling import jax_normals, replay  # noqa: F401

KT = 0.25


def test_adaptive_cv_loop_example_escapes():
    ex, jex = port_example("adaptive_cv_loop"), jax_example("adaptive_cv_loop")
    assert (ex.KT, ex.DT) == (jex.KT, jex.DT) == (KT, 2e-4)
    with torch_threads(1), jax_randomness(ex,
                                          port_example("biased_dynamics")):
        res = ex.main(quick=True, device="cpu")
    assert res["escaped"] and res["escaped_round"] <= 3
    assert res["cos_unbiased_max"] < -0.5 < res["cos_biased_max"]
    # the final CV still separates the basins on held-out frames
    assert res["sep1"] > 2.0
    # hills-based FES sees a substantial barrier along the biasing CV
    assert res["fes_barrier"] > 4 * KT
    # reweighting knows basin B is rare in the unbiased ensemble even
    # though the biased trajectory visits it heavily
    assert res["pop_b_reweighted"] < 0.5 * res["pop_b_biased"]
    assert np.isfinite(res["sep0"])


@pytest.fixture(scope="module")
def ae_cv(tmp_path_factory):
    return ae_cv_pair(tmp_path_factory.mktemp("ae"))


@pytest.mark.parametrize("name, barrier, n_walkers, seed", [
    ("adaptive_cv_loop", 5.0, 4, 0),      # the trapped unbiased data
])
def test_unbiased_alanine_runs(replay, name, barrier, n_walkers, seed):
    ex, jex = port_example(name), jax_example(name)
    assert (ex.KT, ex.DT) == (jex.KT, jex.DT)
    ju, u, jpot, pot = alanine_pair(barrier)
    key = jax.random.PRNGKey(seed)
    r = replay(jax_normals(key, 1, STEPS, (n_walkers, 22, 3)))
    want = JS.overdamped_langevin(
        jpot.energy, jnp.asarray(walkers(ju, n_walkers)), n_steps=STEPS,
        dt=jex.DT, kT=jex.KT, key=key, thin=STEPS)
    got = S.overdamped_langevin(
        pot.energy, torch.as_tensor(walkers(u, n_walkers)), n_steps=STEPS,
        dt=ex.DT, kT=ex.KT, generator=gen(), thin=STEPS)
    assert r.done()
    check(got, want)


@pytest.mark.parametrize("name, barrier, n_walkers, gamma", [
    ("adaptive_cv_loop", 5.0, 4, 1.0 + 5.0 / 0.25),
])
def test_metadynamics_along_an_autoencoder_cv(replay, ae_cv, name, barrier,
                                             n_walkers, gamma):
    ex, jex = port_example(name), jax_example(name)
    jm, pm = ae_cv
    ju, u, jpot, pot = alanine_pair(barrier)
    key = jax.random.PRNGKey(4)
    r = replay(jax_normals(key, 1, STEPS, (n_walkers, 22, 3)))
    kw = dict(n_steps=STEPS, height=2.0 * 0.25, sigma=0.05, stride=STEPS,
              well_tempered_gamma=gamma)
    want = JS.metadynamics_langevin(
        jpot.energy, jm, jnp.asarray(walkers(ju, n_walkers)), dt=jex.DT,
        kT=jex.KT, key=key, **kw)
    got = S.metadynamics_langevin(
        pot.energy, pm, torch.as_tensor(walkers(u, n_walkers)), dt=ex.DT,
        kT=ex.KT, generator=gen(), **kw)
    assert r.done()
    check(got, want, metad=True)


def own_noise_trapped():
    """The unbiased run (barrier 5, 20 kT) on each package's own generator,
    16 walkers for its 2,000 quick steps."""
    ex = port_example("adaptive_cv_loop")
    return trapped_run_stats(5.0, 16, i=0, n_steps=2000, dt=ex.DT, kT=ex.KT,
                             thin=10)


@pytest.fixture(scope="module")
def trapped():
    return own_noise_trapped()


@pytest.mark.parametrize("statistic", ["highest cos phi", "energy"])
def test_adaptive_cv_loop_own_noise_unbiased(trapped, statistic):
    agree(*trapped[statistic], statistic)


def test_adaptive_cv_loop_own_noise_trapped(trapped):
    """``cos_unbiased_max < -0.5`` at every port walker."""
    assert (trapped["highest cos phi"][0] < -0.5).all()
