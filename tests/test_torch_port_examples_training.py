"""The port's ``committor_cv`` and ``committee_uncertainty`` examples at
the JAX examples' quick size on the CPU, held to the JAX tests' own
assertions with their thresholds (``tests/test_sampling.py::
test_committor_cv_example_validates``, ``tests/test_ensemble.py::
test_committee_uncertainty_example_quick``), and their stage functions
against the JAX examples'.

The committor example runs on the JAX example's random numbers
(``example_twins.jax_randomness``: the first-passage runs' normals and the
model's initial weights), with which it is the JAX example step for step.
Its first-passage runs on each package's own generator are held to agree
within ``example_twins.K`` standard errors by the own-noise tests.
The committee trains its members on bootstrap resamples that the port
draws with its own generator, which the JAX package's cannot stand in for:
it runs on the port's own seeds (it passed at five of five,
``tests/example_seeds.py``, CHANGES.md).

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

from example_twins import (STEPS, agree, gen, jax_example, jax_randomness,
                           port_example, run_both, seed, torch_threads)
from molann_tpu import sampling as JS
from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_universe as jalanine_universe
from molann_tpu_torch import sampling as S
from molann_tpu_torch.io import load_model
from molann_tpu_torch.systems import alanine_universe
from test_torch_port_sampling import (close, jax_normals,  # noqa: F401
                                      replay)


def test_committor_cv_example_validates():
    ex = port_example("committor_cv")
    with torch_threads(1), jax_randomness(ex, split_init=False):
        res = ex.main(quick=True, device="cpu")
    assert res["loss1"] < 0.1 * res["loss0"]
    assert res["pred_q_a"] < 0.1 and res["pred_q_b"] > 0.9
    assert abs(res["pred_q_mid"] - 0.5) < 0.05
    assert res["resolved_mid"] > 0.6
    assert res["emp_q_a"] < 0.15 and res["emp_q_b"] > 0.85
    # 64 replicas, ~50 resolved: MC sigma ~0.07 around the true ~0.5
    assert 0.3 < res["emp_q_mid"] < 0.75


def test_committee_uncertainty_example_quick():
    with torch_threads(1):
        res = port_example("committee_uncertainty").main(quick=True,
                                                         device="cpu")
    assert res["ratio"] > 3.0
    assert np.asarray(res["losses"])[-1].mean() < 0.2


def test_committor_model_matches_jax(tmp_path):
    """``build_committor_model`` is the JAX example's model: the same
    structure, so the JAX model's weights load into it and give the same
    q on the torsion sweep (1e-5)."""
    ex, jex = port_example("committor_cv"), jax_example("committor_cv")
    assert (ex.FREE, ex.KT, ex.BARRIER, ex.EDGE) == (
        jex.FREE, jex.KT, jex.BARRIER, jex.EDGE)
    jm = jex.build_committor_model(jalanine_universe(),
                                   jax.random.PRNGKey(0))
    m = load_model(jsave_model(str(tmp_path / "q.npz"), jm), device="cpu")
    mine = ex.build_committor_model(alanine_universe(),
                                    torch.Generator().manual_seed(0), "cpu")
    assert [p.shape for p in m.parameters()] == [
        p.shape for p in mine.parameters()]
    mine.load_state_dict(m.state_dict())
    from molann_tpu.sampling import rotate_torsion as jrotate
    x = np.stack([jrotate(jalanine_universe(), ex.FREE, a)
                  for a in np.linspace(-np.pi, np.pi, 16)])
    with torch.no_grad():
        got = torch.sigmoid(mine(torch.as_tensor(x))[:, 0]).numpy()
    want = np.asarray(jax.nn.sigmoid(jm(jax.numpy.asarray(x))[:, 0]))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_committee_members_match_jax(tmp_path):
    """``make_members`` builds the JAX example's committee structure and
    ``ae_loss`` its loss: the JAX members' weights give the same loss
    (1e-5 relative) on the same frames."""
    ex, jex = (port_example("committee_uncertainty"),
               jax_example("committee_uncertainty"))
    assert (ex.KT, ex.DT, ex.PHI) == (jex.KT, jex.DT, jex.PHI)
    ju = jalanine_universe()
    jmembers = jex.make_members(ju, 2)
    members = ex.make_members(alanine_universe(), 2, device="cpu")
    rng = np.random.default_rng(2)
    x = (ju.atoms.positions[None]
         + 0.05 * rng.normal(size=(32, 22, 3))).astype(np.float32)
    for k, jmem in enumerate(jmembers):
        loaded = load_model(jsave_model(str(tmp_path / f"m{k}.npz"), jmem),
                            device="cpu")
        for mine, theirs in zip(members[k], loaded):
            assert [p.shape for p in mine.parameters()] == [
                p.shape for p in theirs.parameters()]
        want = float(jex.ae_loss(jmem, jax.numpy.asarray(x)))
        got = float(ex.ae_loss(loaded, torch.as_tensor(x)).detach())
        assert abs(got - want) <= 1e-5 * abs(want)


def test_committee_sample_basin(replay):
    ex, jex = (port_example("committee_uncertainty"),
               jax_example("committee_uncertainty"))
    ju, u = jalanine_universe(), alanine_universe()
    x_b = JS.rotate_torsion(ju, jex.PHI, np.pi)
    np.testing.assert_array_equal(S.rotate_torsion(u, ex.PHI, np.pi), x_b)
    key = jax.random.PRNGKey(2)
    r = replay(jax_normals(key, 2, 10, (4, 22, 3)))
    jf = jex.sample_basin(JS.ToyPeptidePotential(ju, barrier=5.0), x_b,
                          n_steps=STEPS, key=key)
    pf = ex.sample_basin(S.ToyPeptidePotential(u, barrier=5.0), x_b,
                         n_steps=STEPS, generator=gen())
    assert r.done()
    close(pf, jf)


def test_committor_first_passage(replay):
    """``empirical_committor`` from three torsion-sweep starts with the
    example's basin indicators, 64 replicas each."""
    ex, jex = port_example("committor_cv"), jax_example("committor_cv")
    ju, u = jalanine_universe(), alanine_universe()
    jpot = JS.ToyPeptidePotential(ju, free_torsion=jex.FREE,
                                  barrier=jex.BARRIER)
    pot = S.ToyPeptidePotential(u, free_torsion=ex.FREE, barrier=ex.BARRIER)
    starts = np.stack([JS.rotate_torsion(ju, jex.FREE, a)
                       for a in (0.0, 1.2, np.pi)])
    phi_ref = pot.phi_ref
    key = jax.random.PRNGKey(1)
    r = replay([np.asarray(jax.random.normal(k, (3 * 64, 22, 3),
                                             jnp.float32))
                for k in jax.random.split(key, STEPS)])

    def jmk(sign):
        return lambda xx: sign * jnp.cos(jpot.phi(xx) - phi_ref) > jex.EDGE

    def mk(sign):
        return lambda xx: sign * torch.cos(pot.phi(xx) - phi_ref) > ex.EDGE

    jq, jfrac = JS.empirical_committor(
        jpot.energy, starts, jmk(1.0), jmk(-1.0), n_steps=STEPS, dt=1e-3,
        kT=jex.KT, key=key, n_replicas=64)
    q, frac = S.empirical_committor(
        pot.energy, torch.as_tensor(starts), mk(1.0), mk(-1.0),
        n_steps=STEPS, dt=1e-3, kT=ex.KT, generator=gen(), n_replicas=64)
    assert r.done()
    np.testing.assert_array_equal(np.isnan(q.numpy()), np.isnan(jq))
    close(frac, jfrac, atol=0)


def own_noise_first_passage():
    """``committor_cv``'s first-passage committor (barrier 8 kT, dt 1e-3,
    its basin indicators) on each package's own generator, from the top of
    the free torsion's barrier, 64 replicas for 2,000 steps: per replica
    whether it resolved, and per resolved replica whether it reached B
    first."""
    ex, jex = port_example("committor_cv"), jax_example("committor_cv")
    ju, u = jalanine_universe(), alanine_universe()
    jpot = JS.ToyPeptidePotential(ju, free_torsion=jex.FREE,
                                  barrier=jex.BARRIER)
    pot = S.ToyPeptidePotential(u, free_torsion=ex.FREE, barrier=ex.BARRIER)
    start = np.asarray(JS.rotate_torsion(ju, ex.FREE, np.pi / 2))[None]
    n = 64
    kw = dict(n_steps=2000, dt=1e-3, kT=ex.KT, n_replicas=n)
    ref = pot.phi_ref
    (qp, fp), (qj, fj) = run_both(
        lambda: S.empirical_committor(
            pot.energy, torch.as_tensor(start),
            lambda x: torch.cos(pot.phi(x) - ref) > ex.EDGE,
            lambda x: -torch.cos(pot.phi(x) - ref) > ex.EDGE,
            generator=torch.Generator().manual_seed(seed(1)), **kw),
        lambda: JS.empirical_committor(
            jpot.energy, jnp.asarray(start),
            lambda x: jnp.cos(jpot.phi(x) - ref) > jex.EDGE,
            lambda x: -jnp.cos(jpot.phi(x) - ref) > jex.EDGE,
            key=jax.random.PRNGKey(seed(1)), **kw))
    m = [int(round(f[0] * n)) for f in (fp, fj)]
    return {"resolved": tuple(np.arange(n) < k for k in m),
            "committor": tuple(np.arange(k) < round(q[0] * k)
                               for q, k in zip((qp, qj), m))}


@pytest.fixture(scope="module")
def first_passage():
    return own_noise_first_passage()


@pytest.mark.parametrize("statistic", ["resolved", "committor"])
def test_committor_own_noise(first_passage, statistic):
    agree(*first_passage[statistic], statistic)
