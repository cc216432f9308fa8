"""The port's ``train_eigenfunction_cv`` example at the JAX example's quick
size on the CPU, held to the JAX test's own assertions with their
thresholds (``tests/test_train.py::
test_eigenfunction_example_learns_slow_mode``), and its deterministic stage
``_weighted_corr`` against the JAX example's on the same inputs.

The outcome test runs the port example on the JAX example's random numbers
(``example_twins.jax_randomness``), with which it is the JAX example step
for step; at other seeds neither package's example reliably meets these
assertions at quick size (``tests/example_seeds.py``, CHANGES.md).

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

from example_twins import (alanine_pair, gen, jax_example, jax_randomness,
                           port_example, torch_threads, walkers)
from molann_tpu import FeatureLayer as JFeatureLayer
from molann_tpu import PreprocessingANN as JPP
from molann_tpu import sampling as JS
from test_torch_port_sampling import (close, jax_normals,  # noqa: F401
                                      replay)

def test_eigenfunction_example_learns_slow_mode():
    ex = port_example("train_eigenfunction_cv")
    with torch_threads(1), jax_randomness(ex, split_init=False):
        res = ex.main(quick=True, device="cpu")
    assert res["gap"] > 3.0                 # slow mode well separated
    assert abs(res["corr_basin"]) > 0.5     # CV0 tracks the hopping mode
    assert abs(res["corr_cvs"]) < 0.5       # orthonormality held
    assert 0.0 < res["pop_b"] < 0.5         # reweighting is sane


def test_weighted_corr_matches_jax():
    ex = port_example("train_eigenfunction_cv")
    jex = jax_example("train_eigenfunction_cv")
    assert (ex.KT, ex.DT, ex.BARRIER) == (jex.KT, jex.DT, jex.BARRIER)
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=(2, 500))
    b = b + 0.3 * a
    w = rng.uniform(0.1, 2.0, 500)
    assert abs(ex._weighted_corr(a, b, w)
               - jex._weighted_corr(a, b, w)) <= 1e-12


def test_eigenfunction_well_tempered_phi_run(replay):
    """``sample_both_basins``, one deposit period (its stride, 50 steps)."""
    ex = port_example("train_eigenfunction_cv")
    jex = jax_example("train_eigenfunction_cv")
    ju, u, jpot, pot = alanine_pair(jex.BARRIER)
    jphi = JPP(None, JFeatureLayer(
        [jex.Feature("phi", "dihedral",
                     ju.select_atoms("bynum 5") + ju.select_atoms("bynum 7")
                     + ju.select_atoms("bynum 9")
                     + ju.select_atoms("bynum 15"))], ju.atoms))
    key = jax.random.PRNGKey(0)
    stride = 50
    r = replay(jax_normals(key, 1, stride, (6, 22, 3)))
    jt, _, jb = JS.metadynamics_langevin(
        jpot.energy, jphi, jnp.asarray(walkers(ju, 6)), n_steps=stride,
        dt=jex.DT, kT=jex.KT, key=key, height=0.5, sigma=0.3, stride=stride,
        well_tempered_gamma=1.0 + 3.0 / jex.KT)
    x_all, cos_phi, bias, _ = ex.sample_both_basins(
        u, pot, n_steps=stride, generator=gen())
    assert r.done()
    close(x_all, np.asarray(jt).reshape(-1, 22, 3))
    close(bias.centers, jb.centers, what="deposits")
    close(bias.weights, jb.weights, what="weights")
    assert bias.gamma == jb.gamma
