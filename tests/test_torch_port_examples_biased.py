"""The port's ``biased_dynamics`` example at the JAX example's quick size
on the CPU, held to the JAX test's own assertions with their thresholds
(``tests/test_sampling.py::test_closed_loop_example_escapes``), and its
deterministic stage ``phi_cv`` against the JAX example's on the same
inputs (1e-5).

The outcome test runs the port example on the JAX example's random
numbers (``example_twins.jax_randomness``: the dynamics' normals and the
networks' initial weights drawn from the same ``PRNGKey``s). With them the
port example is the JAX example step for step. At other seeds neither
package's example reliably meets these assertions at quick size
(``tests/example_seeds.py``; the pass counts are in CHANGES.md). The
own-noise tests run the unbiased run and the steered pull on each
package's own generator with more walkers, hold their statistics to
agree within ``example_twins.K`` standard errors, and hold the outcome the
example states of each stage at every port walker.

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
                           energies, gen, jax_example, jax_randomness, phis,
                           port_example, run_both, seed, torch_threads,
                           trapped_run_stats, walkers)
from molann_tpu import sampling as JS
from molann_tpu.systems import alanine_universe as jalanine_universe
from molann_tpu_torch import sampling as S
from molann_tpu_torch.systems import alanine_universe
from test_torch_port_sampling import jax_normals, replay  # noqa: F401


def test_closed_loop_example_escapes():
    ex = port_example("biased_dynamics")
    with torch_threads(1), jax_randomness(ex):
        res = ex.main(quick=True, device="cpu")
    assert res["escaped"]
    assert res["cos_unbiased_max"] < -0.5 < res["cos_biased_max"]
    assert res["cv_gap"] > 5 * res["cv_spread"]  # CV separates the basins



@pytest.mark.parametrize("use_angle_value", [True, False])
def test_phi_cv_matches_jax(use_angle_value):
    ex, jex = port_example("biased_dynamics"), jax_example("biased_dynamics")
    assert (ex.KT, ex.DT) == (jex.KT, jex.DT)
    ju = jalanine_universe()
    rng = np.random.default_rng(4)
    x = (ju.atoms.positions[None]
         + 0.1 * rng.normal(size=(16, 22, 3))).astype(np.float32)
    want = np.asarray(jex.phi_cv(ju, use_angle_value)(jnp.asarray(x)))
    got = ex.phi_cv(alanine_universe(), use_angle_value)(
        torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)



def test_feature_layer_puts_its_tables_on_a_device_once(monkeypatch):
    """The eager ``FeatureLayer`` copied its index tables from the host at
    every call, which on the card made every biased step along an eager CV
    wait for the card (``chip_smoke.py`` phase 16). Now the first call on a
    device puts them there and later calls copy nothing; the values stay
    the JAX package's (1e-5)."""
    from molann_tpu import FeatureLayer as JFeatureLayer
    from molann_tpu.systems import alanine_histogram_features as jhist
    from molann_tpu_torch.models.ann import FeatureLayer
    from molann_tpu_torch.systems import alanine_histogram_features

    u, ju = alanine_universe(), jalanine_universe()
    layer = FeatureLayer(alanine_histogram_features(u), u.atoms)
    rng = np.random.default_rng(9)
    x = (ju.atoms.positions[None]
         + 0.05 * rng.normal(size=(8, 22, 3))).astype(np.float32)
    copies = []
    as_tensor = torch.as_tensor

    def counting(data, *args, **kw):
        if not isinstance(data, torch.Tensor):
            copies.append(data)
        return as_tensor(data, *args, **kw)

    monkeypatch.setattr(torch, "as_tensor", counting)
    xt = as_tensor(x)
    first = layer(xt)
    n_first = len(copies)
    second = layer(xt)
    assert n_first > 0 and len(copies) == n_first
    assert torch.equal(first, second)
    want = np.asarray(JFeatureLayer(jhist(ju), ju.atoms)(jnp.asarray(x)))
    np.testing.assert_allclose(second.numpy(), want, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def ae_cv(tmp_path_factory):
    return ae_cv_pair(tmp_path_factory.mktemp("ae"))


@pytest.mark.parametrize("name, barrier, n_walkers, seed", [
    ("biased_dynamics", 6.0, 2, 0),       # the unbiased trapped run
    ("biased_dynamics", 6.0, 1, 2),       # basin-A training data
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


def test_biased_dynamics_steered_pull(replay):
    ex, jex = port_example("biased_dynamics"), jax_example("biased_dynamics")
    ju, u, jpot, pot = alanine_pair(6.0)
    key = jax.random.PRNGKey(1)
    r = replay(jax_normals(key, 1, STEPS, (1, 22, 3)))
    want = JS.steered_langevin(
        jpot.energy, jex.phi_cv(ju, True), jnp.asarray(walkers(ju, 1)),
        s0=[np.pi], s1=[0.0], k_spring=10.0, n_steps=STEPS, dt=jex.DT,
        kT=jex.KT, key=key, thin=STEPS)
    got = S.steered_langevin(
        pot.energy, ex.phi_cv(u, True), torch.as_tensor(walkers(u, 1)),
        s0=[np.pi], s1=[0.0], k_spring=10.0, n_steps=STEPS, dt=ex.DT,
        kT=ex.KT, generator=gen(), thin=STEPS)
    assert r.done()
    check(got, want)


@pytest.mark.parametrize("name, barrier, n_walkers, gamma", [
    ("biased_dynamics", 6.0, 2, None),
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
    """The unbiased run (barrier 6, 24 kT) on each package's own generator,
    16 walkers for its 2,000 quick steps."""
    ex = port_example("biased_dynamics")
    return trapped_run_stats(6.0, 16, i=0, n_steps=2000, dt=ex.DT, kT=ex.KT,
                             thin=50)


def own_noise_steered():
    """The steered pull along phi from pi to 0 (k 10, 3,000 steps) on each
    package's own generator, 8 walkers: the final cos phi and energy."""
    ex, jex = port_example("biased_dynamics"), jax_example("biased_dynamics")
    ju, u, jpot, pot = alanine_pair(6.0)
    x0 = walkers(ju, 8)
    kw = dict(s0=[np.pi], s1=[0.0], k_spring=10.0, n_steps=3000, dt=ex.DT,
              kT=ex.KT, thin=50)
    (_, xp), (_, xj) = run_both(
        lambda: S.steered_langevin(
            pot.energy, ex.phi_cv(u, True), torch.as_tensor(x0),
            generator=torch.Generator().manual_seed(seed(1)), **kw),
        lambda: JS.steered_langevin(
            jpot.energy, jex.phi_cv(ju, True), jnp.asarray(x0),
            key=jax.random.PRNGKey(seed(1)), **kw))
    return {"final cos phi": tuple(np.cos(phis(pot, x[None]))[0]
                                   for x in (xp, xj)),
            "energy": tuple(energies(pot, x[None])[0] for x in (xp, xj))}


@pytest.fixture(scope="module")
def trapped():
    return own_noise_trapped()


@pytest.fixture(scope="module")
def steered():
    return own_noise_steered()


@pytest.mark.parametrize("statistic", ["highest cos phi", "energy"])
def test_biased_dynamics_own_noise_unbiased(trapped, statistic):
    agree(*trapped[statistic], statistic)


def test_biased_dynamics_own_noise_trapped(trapped):
    """``cos_unbiased_max < -0.5`` at every port walker."""
    assert (trapped["highest cos phi"][0] < -0.5).all()


@pytest.mark.parametrize("statistic", ["final cos phi", "energy"])
def test_biased_dynamics_own_noise_steered(steered, statistic):
    agree(*steered[statistic], statistic)


def test_biased_dynamics_own_noise_pull_crosses(steered):
    """Every port walker ends the pull in basin B (cos phi > 0.5)."""
    assert (steered["final cos phi"][0] > 0.5).all()
