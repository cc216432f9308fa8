"""The port's ``train_timelagged_cv`` example at the JAX example's quick
size on the CPU, held to ``tests/test_timelagged.py::
test_timelagged_example_learns_hopping_mode``'s assertions with their
thresholds: the VAMP-2-trained CV on unbiased two-basin dynamics is the
interbasin hopping mode and matches or beats linear TICA.

The port example runs on the JAX example's random numbers
(``example_twins.jax_randomness``), with which it is the JAX example step
for step. At other seeds the quick run's hop count is seed luck in both
packages: a pass needs one of the eight walkers to cross in 60,000 steps,
which about one walker in twenty does in either package
(``tests/example_hop_rates.py``; PERF.md). The own-noise tests below run
the unbiased run on each package's own generator with more walkers and
hold its statistics to agree within ``example_twins.K`` standard errors.

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

from example_twins import (STEPS, agree, alanine_pair, energies, gen,
                           jax_example, jax_randomness, overdamped_both,
                           phis, port_example, torch_threads, walkers)
from molann_tpu import sampling as JS
from molann_tpu.systems import alanine_universe as jalanine_universe
from test_torch_port_sampling import (close, jax_normals,  # noqa: F401
                                      replay)


def test_timelagged_example_learns_hopping_mode():
    ex = port_example("train_timelagged_cv")
    jex = jax_example("train_timelagged_cv")
    assert (ex.KT, ex.DT, ex.BARRIER, ex.THIN, ex.LAG) == (
        jex.KT, jex.DT, jex.BARRIER, jex.THIN, jex.LAG)
    with torch_threads(1), jax_randomness(ex, split_init=False):
        res = ex.main(quick=True, device="cpu")
    assert res["hops"] > 10
    assert res["corr_basin"] > 0.9
    assert res["vamp_ac"] > res["tica_ac"] - 0.02
    assert res["vamp2"] > 0.9


def test_timelagged_two_basin_start(replay):
    """``sample_hopping``, half the walkers in each basin."""
    ex, jex = (port_example("train_timelagged_cv"),
               jax_example("train_timelagged_cv"))
    ju, u, jpot, pot = alanine_pair(jex.BARRIER)
    xb = np.asarray(JS.rotate_torsion(ju, (4, 6, 8, 14), np.pi))
    x0 = np.concatenate([walkers(ju, 4), np.repeat(xb[None], 4, 0)])
    key = jax.random.PRNGKey(0)
    r = replay(jax_normals(key, 1, jex.THIN, (8, 22, 3)))
    jt, _ = JS.overdamped_langevin(jpot.energy, jnp.asarray(x0),
                                   n_steps=jex.THIN, dt=jex.DT, kT=jex.KT,
                                   key=key, thin=jex.THIN)
    traj, cos_phi, hops = ex.sample_hopping(u, pot, n_steps=ex.THIN,
                                            generator=gen())
    assert r.done() and ex.THIN == STEPS
    close(traj, jt)
    close(cos_phi, np.cos(np.asarray(jpot.phi(jt.reshape(-1, 22, 3))))
          .reshape(1, 8), atol=1e-5)
    assert hops == 0


def own_noise_two_basin():
    """``sample_hopping``'s run (barrier 2.5 kT) on each package's own
    generator, 12 walkers in each basin for 1,500 steps: per walker, after
    500 steps, the mean energy (the temperature the noise gives), the mean
    of cos 2(phi - phi_ref) (the basins' width along the free torsion) and
    the farthest it goes toward the barrier, max sin^2(phi - phi_ref)."""
    ex = port_example("train_timelagged_cv")
    ju = jalanine_universe()
    xb = np.asarray(JS.rotate_torsion(ju, (4, 6, 8, 14), np.pi))
    x0 = np.concatenate([walkers(ju, 12), np.repeat(xb[None], 12, 0)])
    pot, tp, tj = overdamped_both(ex.BARRIER, x0, i=0, n_steps=1500,
                                       dt=ex.DT, kT=ex.KT, thin=10)
    c2 = [np.cos(2 * (phis(pot, t[50:]) - pot.phi_ref)) for t in (tp, tj)]
    return {"energy": tuple(energies(pot, t[50:]).mean(0) for t in (tp, tj)),
            "cos 2(phi - phi_ref)": tuple(c.mean(0) for c in c2),
            "max sin^2(phi - phi_ref)": tuple((1 - c).max(0) / 2
                                              for c in c2)}


@pytest.fixture(scope="module")
def two_basin():
    return own_noise_two_basin()


@pytest.mark.parametrize("statistic", ["energy", "cos 2(phi - phi_ref)",
                                       "max sin^2(phi - phi_ref)"])
def test_timelagged_own_noise(two_basin, statistic):
    agree(*two_basin[statistic], statistic)
