"""The two packages' examples side by side, for the port's example tests:
the JAX example loaded by path from ``examples/`` (as the JAX package's
tests load theirs) and the port's from ``molann_tpu_torch.examples``."""

import contextlib
import importlib
import importlib.util
import io
import os

import numpy as np
import torch

EXAMPLES = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples")


def jax_example(name):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port_example(name):
    """The port's ``molann_tpu_torch.examples.<name>``."""
    return importlib.import_module(f"molann_tpu_torch.examples.{name}")


def run_printing(fn, **kwargs):
    """``(fn(**kwargs), what it printed)``."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(**kwargs)
    return out, buf.getvalue()


@contextlib.contextmanager
def torch_threads(n):
    """Run the enclosed eager loops on ``n`` intra-op threads: the examples'
    steps are small tensors, where more threads only add contention
    between the suite's workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(before)


class _Draws:
    """Hands out a list of arrays in order, each checked against the
    shape asked for (the port's noise helpers' signature)."""

    def __init__(self, arrays):
        self._it = iter(arrays)

    def __call__(self, shape, generator):
        a = next(self._it)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.from_numpy(np.array(a))

    def done(self):
        return next(self._it, None) is None


def _jax_noise(name, kw, x0):
    """The normals the JAX package's ``name`` draws from ``PRNGKey(seed)``,
    in the order it draws them: a split per period, then one per step
    (``empirical_committor``: one per step)."""
    import jax
    import jax.numpy as jnp

    key = jax.random.PRNGKey(kw["generator"].initial_seed())
    n = kw["n_steps"]
    if name == "empirical_committor":
        shape = (x0.shape[0] * kw.get("n_replicas", 32),) + tuple(
            x0.shape[1:])
        keys = jax.random.split(key, n)
        per = None
    else:
        shape = tuple(x0.shape)
        per = kw.get("stride") or kw.get("thin", 10)
        keys = jax.random.split(key, n // per)
    def draw(k):
        return jax.random.normal(k, shape, jnp.float32)

    if per is None:
        return np.asarray(jax.jit(jax.vmap(draw))(keys))
    steps = jax.jit(jax.vmap(lambda k: jax.vmap(draw)(
        jax.random.split(k, per))))(keys)
    return np.asarray(steps).reshape((-1,) + shape)


@contextlib.contextmanager
def jax_randomness(*modules, split_init=True):
    """Run port examples on the JAX examples' random numbers: each
    dynamics call of ``modules`` (where a module names it) draws the
    normals that the JAX package draws from ``PRNGKey(i)`` for the call's
    ``torch.Generator`` seeded with ``i``, through the port's noise helper
    ``sampling.langevin._normal``; each ``create_sequential_nn`` call takes
    the JAX package's initial weights for the same seed
    (``split(PRNGKey(i))[k]`` for the k-th network drawn from one
    generator when ``split_init``, else ``PRNGKey(i)``)."""
    import jax

    from molann_tpu.ann import create_sequential_nn as jcreate
    from molann_tpu_torch.sampling import langevin as L

    dynamics = ("overdamped_langevin", "steered_langevin",
                "metadynamics_langevin", "empirical_committor")
    saved, drawn = [], {}

    def replayed(name, fn):
        def call(*args, **kw):
            x0 = args[2] if name in ("steered_langevin",
                                     "metadynamics_langevin") else args[1]
            draws = _Draws(_jax_noise(name, kw, x0))
            before = L._normal
            L._normal = draws
            try:
                out = fn(*args, **kw)
            finally:
                L._normal = before
            assert draws.done()
            return out
        return call

    def jax_initialised(fn):
        def create(layer_dims, activation="tanh", *, generator=None,
                   **kw):
            net = fn(layer_dims, activation, generator=generator, **kw)
            k = drawn.get(id(generator), 0)
            drawn[id(generator)] = k + 1
            key = jax.random.PRNGKey(generator.initial_seed())
            if split_init:
                key = jax.random.split(key)[k]
            ref = jcreate(list(layer_dims), key=key)
            with torch.no_grad():
                for lin, (w, b) in zip(net.layers, ref.params):
                    lin.weight.copy_(torch.from_numpy(np.array(w).T))
                    lin.bias.copy_(torch.from_numpy(np.array(b)))
            return net
        return create

    for mod in modules:
        for name in dynamics:
            if hasattr(mod, name):
                saved.append((mod, name, getattr(mod, name)))
                setattr(mod, name, replayed(name, getattr(mod, name)))
        if hasattr(mod, "create_sequential_nn"):
            saved.append((mod, "create_sequential_nn",
                          mod.create_sequential_nn))
            mod.create_sequential_nn = jax_initialised(
                mod.create_sequential_nn)
    try:
        yield
    finally:
        for mod, name, fn in reversed(saved):
            setattr(mod, name, fn)


# --- the replayed dynamics stages (the first STEPS steps of each) ----------

STEPS = 20


def walkers(u, n):
    """``n`` copies of a universe's positions, ``[n, n_atoms, 3]`` float32."""
    return np.repeat(u.atoms.positions[None], n, axis=0).astype(np.float32)


def gen():
    """A CPU generator: its draws are replaced by the JAX run's."""
    return torch.Generator()


def check(got, want, metad=False):
    """A dynamics stage's outputs against JAX's: trajectory and final
    walkers, and for metadynamics the deposits and their weights, 1e-4."""
    from test_torch_port_sampling import close

    close(got[0], want[0], what="trajectory")
    close(got[1], want[1], what="final walkers")
    if metad:
        close(got[2].centers, want[2].centers, what="deposits")
        close(got[2].weights, want[2].weights, what="weights")


def alanine_pair(barrier):
    """``(jax universe, port universe, jax toy potential, port toy
    potential)`` at ``barrier``."""
    from molann_tpu import sampling as JS
    from molann_tpu.systems import alanine_universe as jalanine_universe
    from molann_tpu_torch import sampling as S
    from molann_tpu_torch.systems import alanine_universe

    ju, u = jalanine_universe(), alanine_universe()
    return (ju, u, JS.ToyPeptidePotential(ju, barrier=barrier),
            S.ToyPeptidePotential(u, barrier=barrier))


def ae_cv_pair(directory):
    """An autoencoder-style CV (histogram features -> ``[d, 16, 1]``) at its
    initial weights in both packages: the JAX model, saved by
    ``molann_tpu.io.save_model`` into ``directory`` and loaded by the
    port."""
    import jax

    from molann_tpu import FeatureLayer as JFeatureLayer
    from molann_tpu import MolANN as JMolANN
    from molann_tpu import PreprocessingANN as JPP
    from molann_tpu import create_sequential_nn as jcreate_sequential_nn
    from molann_tpu.io import save_model as jsave_model
    from molann_tpu.systems import alanine_histogram_features as jhist
    from molann_tpu.systems import alanine_universe as jalanine_universe
    from molann_tpu_torch.io import load_model

    ju = jalanine_universe()
    pp = JPP(None, JFeatureLayer(jhist(ju), ju.atoms))
    jm = JMolANN(pp, jcreate_sequential_nn(
        [pp.output_dimension(), 16, 1], key=jax.random.PRNGKey(0)))
    path = os.path.join(str(directory), "cv.npz")
    return jm, load_model(jsave_model(path, jm), device="cpu")


# --- the dynamics stages on each package's own random numbers -------------
#
# The port's stage on ``torch.Generator().manual_seed(seed(i))``, the JAX
# package's on ``jax.random.PRNGKey(seed(i))``, for the example's seed i,
# with more walkers than the example: walkers are independent, so each
# package gives one sample of a statistic a walker, and the two packages'
# means must agree within K standard errors of their difference whatever
# the seeds. ``python tests/example_noise_study.py <shift>...`` runs every
# such stage with 1000 * shift added to its seeds and prints the
# differences in standard errors.

# a difference of the means past K standard errors fails: under 1e-5 a
# statistic when both packages draw from the same distribution
K = 4.5
SHIFT = 0


def seed(i):
    """The example's seed ``i`` (shifted by ``SHIFT`` in the study)."""
    return i + SHIFT


def agree(port, jax_, what):
    """The means of two sets of independent samples within ``K`` standard
    errors of their difference."""
    p = np.asarray(port, np.float64).ravel()
    j = np.asarray(jax_, np.float64).ravel()
    se = np.sqrt(p.var(ddof=1) / p.size + j.var(ddof=1) / j.size)
    z = (p.mean() - j.mean()) / se if se else 0.0
    print(f"AGREE shift {SHIFT} {what}: port {p.mean():.6g} JAX "
          f"{j.mean():.6g} z {z:.3f}")
    assert abs(p.mean() - j.mean()) <= K * se, (
        f"{what}: port {p.mean():.5g}, JAX {j.mean():.5g}, standard error "
        f"{se:.3g}")


def run_both(port_fn, jax_fn):
    """``(port outputs, JAX outputs)`` as tuples of numpy arrays, the port
    on one thread."""
    with torch_threads(1):
        p = port_fn()
    return (tuple(np.asarray(t.detach().cpu()) for t in p),
            tuple(np.asarray(t) for t in jax_fn()))


def overdamped_both(barrier, x0, *, i, n_steps, dt, kT, thin):
    """The toy peptide at ``barrier`` from ``x0`` in both packages, each on
    its own generator for seed ``i``: ``(port pot, port traj, JAX traj)``,
    ``[T, W, n, 3]`` numpy arrays."""
    import jax
    import jax.numpy as jnp

    from molann_tpu import sampling as JS
    from molann_tpu_torch import sampling as S

    ju, u, jpot, pot = alanine_pair(barrier)
    kw = dict(n_steps=n_steps, dt=dt, kT=kT, thin=thin)
    (tp, _), (tj, _) = run_both(
        lambda: S.overdamped_langevin(
            pot.energy, torch.as_tensor(x0),
            generator=torch.Generator().manual_seed(seed(i)), **kw),
        lambda: JS.overdamped_langevin(
            jpot.energy, jnp.asarray(x0), key=jax.random.PRNGKey(seed(i)),
            **kw))
    return pot, tp, tj


def energies(pot, traj):
    """``[T, W]`` port energies of a ``[T, W, n, 3]`` trajectory."""
    with torch.no_grad():
        e = pot.energy(torch.from_numpy(np.array(
            traj.reshape(-1, 22, 3))))
    return e.numpy().reshape(traj.shape[:2])


def phis(pot, traj):
    """``[T, W]`` free-torsion angles of a ``[T, W, n, 3]`` trajectory."""
    with torch.no_grad():
        phi = pot.phi(torch.from_numpy(np.array(
            traj.reshape(-1, 22, 3))))
    return phi.numpy().reshape(traj.shape[:2])


def trapped_run_stats(barrier, n_walkers, *, i, n_steps, dt, kT, thin):
    """An unbiased run from basin A that the example calls trapped: per
    walker the highest cos phi and the mean energy, ``{statistic: (port,
    JAX)}``."""
    u = alanine_pair(barrier)[0]
    pot, tp, tj = overdamped_both(
        barrier, walkers(u, n_walkers), i=i, n_steps=n_steps, dt=dt, kT=kT,
        thin=thin)
    return {"highest cos phi": tuple(np.cos(phis(pot, t)).max(0)
                                     for t in (tp, tj)),
            "energy": tuple(energies(pot, t).mean(0) for t in (tp, tj))}
