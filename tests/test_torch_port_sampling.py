"""``molann_tpu_torch.sampling``'s potentials and integrators against
``molann_tpu.sampling`` in the same process (the biases and path CVs are in
``tests/test_torch_port_sampling_biases.py``, which uses this file's
replayed noise and fixtures).

Torch cannot draw JAX's numbers from a key, so every run at kT > 0 replays
JAX's noise: the port's noise helpers (``langevin._normal`` and
``_uniform``) are replaced by the normals and uniforms that ``jax.random``
draws from the same key, split as the JAX function splits it. The model is
the JAX package's alanine model (``[38, 5, 2]`` head, key 3) saved as
``.npz`` and loaded by the port. Tolerances: coordinates 1e-4 after at most
100 steps; deposits, weights and bandwidths 1e-4; energies and CV values
1e-5 relative; bias files are read across in both directions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu import sampling as JS
from molann_tpu.io import save_model as jsave_model
from molann_tpu.systems import alanine_model as jalanine_model
from molann_tpu_torch import sampling as S
from molann_tpu_torch.io import load_model
from molann_tpu_torch.ops.fused import fused_model_forward
from molann_tpu_torch.sampling import langevin as L
from molann_tpu_torch.systems import alanine_universe

TOL = 1e-4
N = 22
W = 3


# --- JAX's noise, drawn in the order the JAX functions draw it -------------

def jax_normals(key, n_periods, per, shape):
    """``split(key, n_periods)``, then ``split(k, per)`` of each, one
    ``normal(k, shape)`` each: the draws of the Langevin loops."""
    def period(k):
        return jax.vmap(lambda kk: jax.random.normal(kk, shape, jnp.float32))(
            jax.random.split(k, per))
    a = np.asarray(jax.vmap(period)(jax.random.split(key, n_periods)))
    return list(a.reshape((n_periods * per,) + tuple(shape)))


def jax_baoab_normals(key, n_periods, per, shape):
    """BAOAB's: the start velocities from the second half of one split,
    then the steps' from the first half."""
    key, k0 = jax.random.split(key)
    v0 = np.asarray(jax.random.normal(k0, shape, jnp.float32))
    return [v0] + jax_normals(key, n_periods, per, shape)


class Replay:
    """Stands in for the port's noise helpers: hands out the given draws
    in order, each checked against the shape asked for."""

    def __init__(self, normals=(), uniforms=()):
        self.normals, self.uniforms = list(normals), list(uniforms)

    def _next(self, queue, shape):
        a = queue.pop(0)
        assert a.shape == tuple(shape), (a.shape, shape)
        return torch.tensor(np.array(a))

    def normal(self, shape, generator):
        return self._next(self.normals, shape)

    def uniform(self, shape, generator):
        return self._next(self.uniforms, shape)

    def done(self):
        return not self.normals and not self.uniforms


@pytest.fixture()
def replay(monkeypatch):
    """``replay(normals, uniforms)`` patches the noise helpers."""
    def install(normals=(), uniforms=()):
        r = Replay(normals, uniforms)
        monkeypatch.setattr(L, "_normal", r.normal)
        monkeypatch.setattr(L, "_uniform", r.uniform)
        return r
    return install


def close(got, want, atol=TOL, what=""):
    np.testing.assert_allclose(
        got.detach().cpu().numpy() if isinstance(got, torch.Tensor)
        else np.asarray(got), np.asarray(want), atol=atol, rtol=0,
        err_msg=what)


# --- shared systems ---------------------------------------------------------

@pytest.fixture(scope="module")
def system(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_sampling")
    jm, ju = jalanine_model(hidden_dims=(5, 2), key=jax.random.PRNGKey(3))
    jsave_model(str(d / "model.npz"), jm)
    pm = load_model(str(d / "model.npz"), device="cpu")
    for p in pm.parameters():
        p.requires_grad_(False)
    pu = alanine_universe()
    x0 = np.repeat(ju.atoms.positions[None], W, axis=0).astype(np.float32)
    return dict(jm=jm, pm=pm, jpot=JS.ToyPeptidePotential(ju),
                ppot=S.ToyPeptidePotential(pu), ju=ju, pu=pu, x0=x0, dir=d)


def gen():
    return torch.Generator()


# --- potentials ---------------------------------------------------------------

def test_toy_peptide_potential_matches_jax(system):
    """Tables, reference values, energies, phi and forces of the toy force
    field on noisy frames."""
    jp, pp = system["jpot"], system["ppot"]
    for name in ("free_torsion", "bond_idx", "pair13_idx", "torsion_idx"):
        np.testing.assert_array_equal(getattr(pp, name), getattr(jp, name))
    for name in ("bond_ref", "pair13_ref", "torsion_ref"):
        close(getattr(pp, name), getattr(jp, name), atol=0)
    assert pp.phi_ref == jp.phi_ref
    rng = np.random.default_rng(0)
    x = (system["x0"][:1] + 0.05 * rng.normal(size=(8, N, 3))).astype(
        np.float32)
    e_j = np.asarray(jp.energy(jnp.asarray(x)))
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(jp.energy(v)))(
        jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    e_p = pp(xt)
    (g_p,) = torch.autograd.grad(e_p.sum(), xt)
    np.testing.assert_allclose(e_p.detach().numpy(), e_j, rtol=1e-5)
    close(g_p, g_j, atol=1e-5 * max(1.0, np.abs(g_j).max()))
    close(pp.phi(torch.tensor(x)), jp.phi(jnp.asarray(x)), atol=1e-6)


def test_lennard_jones_potential_matches_jax():
    """Energies and forces of the periodic LJ fluid, the cutoff checks."""
    from molann_tpu.systems import lj_fluid

    u, box = lj_fluid(3, spacing=1.3)
    jp = JS.LennardJonesPotential(27, box, sigma=1.1)
    pp = S.LennardJonesPotential(27, box, sigma=1.1)
    np.testing.assert_array_equal(pp.pair_idx, jp.pair_idx)
    assert (pp.box, pp.cutoff, pp._shift) == (jp.box, jp.cutoff, jp._shift)
    rng = np.random.default_rng(1)
    x = (u.atoms.positions[None] + 0.05 * rng.normal(size=(4, 27, 3))).astype(
        np.float32)
    e_j = np.asarray(jp(jnp.asarray(x)))
    g_j = np.asarray(jax.grad(lambda v: jnp.sum(jp(v)))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    e_p = pp(xt)
    (g_p,) = torch.autograd.grad(e_p.sum(), xt)
    np.testing.assert_allclose(e_p.detach().numpy(), e_j, rtol=1e-5)
    close(g_p, g_j, atol=1e-5 * max(1.0, np.abs(g_j).max()))
    for bad in (dict(cutoff=10.0), dict(cutoff=0.0)):
        with pytest.raises(ValueError, match="cutoff"):
            S.LennardJonesPotential(27, box, **bad)
    with pytest.raises(ValueError, match="box"):
        S.LennardJonesPotential(27, [1.0, 2.0])


# --- integrators ------------------------------------------------------------

def test_overdamped_langevin_matches_jax(system, replay):
    """Overdamped dynamics with an extra energy term (a restraint through
    the model), 60 steps recorded every 20."""
    key = jax.random.PRNGKey(11)
    jm, pm = system["jm"], system["pm"]
    r = replay(jax_normals(key, 3, 20, (W, N, 3)))
    jt, jx = JS.overdamped_langevin(
        system["jpot"].energy, jnp.asarray(system["x0"]), n_steps=60,
        dt=2e-4, kT=0.25, key=key, thin=20,
        extra_energy_fn=lambda x: 3.0 * jnp.sum(jm(x) ** 2, axis=-1))
    pt, px = S.overdamped_langevin(
        system["ppot"].energy, torch.tensor(system["x0"]), n_steps=60,
        dt=2e-4, kT=0.25, generator=gen(), thin=20,
        extra_energy_fn=lambda x: 3.0 * torch.sum(pm(x) ** 2, dim=-1))
    assert r.done() and pt.shape == (3, W, N, 3)
    close(pt, jt)
    close(px, jx)
    with pytest.raises(ValueError, match="multiple of thin"):
        S.overdamped_langevin(system["ppot"].energy, px, n_steps=7, dt=1e-4,
                              kT=0.1, generator=gen(), thin=2)


def test_baoab_langevin_matches_jax(system, replay):
    """BAOAB with the topology's per-atom masses and Maxwell-Boltzmann
    start velocities; kinetic temperatures of the final velocities."""
    key = jax.random.PRNGKey(12)
    masses = system["pu"].atoms.masses.astype(np.float32)
    np.testing.assert_allclose(masses, system["ju"].atoms.masses, rtol=1e-6)
    r = replay(jax_baoab_normals(key, 4, 10, (W, N, 3)))
    jt, jx, jv = JS.baoab_langevin(
        system["jpot"].energy, jnp.asarray(system["x0"]), n_steps=40,
        dt=5e-3, kT=0.25, gamma=5.0, key=key, mass=masses, thin=10)
    pt, px, pv = S.baoab_langevin(
        system["ppot"].energy, torch.tensor(system["x0"]), n_steps=40,
        dt=5e-3, kT=0.25, gamma=5.0, generator=gen(), mass=masses, thin=10)
    assert r.done()
    close(pt, jt)
    close(pv, jv, atol=1e-3 * max(1.0, float(np.abs(jv).max())))
    close(S.kinetic_temperature(pv, masses),
          JS.kinetic_temperature(jv, masses), atol=1e-3)
    with pytest.raises(ValueError, match="positive"):
        S.kinetic_temperature(pv, np.zeros(N))
    with pytest.raises(ValueError, match="n_atoms"):
        S.kinetic_temperature(pv, np.ones(3))


def test_baoab_given_velocities_draws_no_start_noise(system, replay):
    """With ``v0`` given only the steps draw noise, as in JAX."""
    key = jax.random.PRNGKey(13)
    v0 = np.random.default_rng(2).normal(size=(W, N, 3)).astype(np.float32)
    r = replay(jax_normals(jax.random.split(key)[0], 2, 10, (W, N, 3)))
    jt, _, jv = JS.baoab_langevin(
        system["jpot"].energy, jnp.asarray(system["x0"]), n_steps=20,
        dt=5e-3, kT=0.25, gamma=2.0, key=key, v0=v0, thin=10)
    pt, _, pv = S.baoab_langevin(
        system["ppot"].energy, torch.tensor(system["x0"]), n_steps=20,
        dt=5e-3, kT=0.25, gamma=2.0, generator=gen(), v0=v0, thin=10)
    assert r.done()
    close(pt, jt)
    close(pv, jv, atol=1e-3)


def test_steered_langevin_matches_jax(system, replay):
    """The moving restraint's schedule and dynamics, through the fused
    forward's plain version (the command's CV)."""
    key = jax.random.PRNGKey(14)
    jm, pm = system["jm"], system["pm"]
    s0 = np.asarray(jm(jnp.asarray(system["x0"][:1])))[0]
    s1 = s0 + 0.3
    r = replay(jax_normals(key, 4, 10, (W, N, 3)))
    jt, jx = JS.steered_langevin(
        system["jpot"].energy, jm, jnp.asarray(system["x0"]), s0=s0, s1=s1,
        k_spring=20.0, n_steps=40, dt=2e-4, kT=0.25, key=key, thin=10)
    pt, px = S.steered_langevin(
        system["ppot"].energy, lambda x: fused_model_forward(pm, x),
        torch.tensor(system["x0"]), s0=s0, s1=s1, k_spring=20.0, n_steps=40,
        dt=2e-4, kT=0.25, generator=gen(), thin=10)
    assert r.done()
    close(pt, jt)
    close(px, jx)


# --- the port's own rules ---------------------------------------------------------

def test_noise_helpers_and_the_generator_rule(system):
    """The one noise source draws float32 on the generator's device; a
    generator that is not a torch.Generator, or on another device type
    than the walkers, is refused."""
    g = torch.Generator().manual_seed(0)
    a = L._normal((2, 3), g)
    u = L._uniform((4,), g)
    assert a.dtype == u.dtype == torch.float32 and a.shape == (2, 3)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    with pytest.raises(TypeError, match="torch.Generator"):
        S.overdamped_langevin(system["ppot"].energy,
                              torch.tensor(system["x0"]), n_steps=10,
                              dt=1e-4, kT=0.1, generator=jax.random.PRNGKey(0))
    x = torch.tensor(system["x0"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            S.overdamped_langevin(system["ppot"].energy, system["x0"],
                                  n_steps=10, dt=1e-4, kT=0.1,
                                  generator=g)
    t1, x1 = S.overdamped_langevin(system["ppot"].energy, x, n_steps=20,
                                   dt=1e-4, kT=0.1,
                                   generator=torch.Generator().manual_seed(4))
    t2, x2 = S.overdamped_langevin(system["ppot"].energy, x, n_steps=20,
                                   dt=1e-4, kT=0.1,
                                   generator=torch.Generator().manual_seed(4))
    assert torch.equal(t1, t2) and torch.equal(x1, x2)


def test_deposit_counts_the_model_calls(system):
    """Metadynamics calls the CV once a step under autograd and once a
    period without a graph: the launches the card's kernels are held to
    (no call to size the buffers)."""
    calls = {"grad": 0, "nograd": 0}
    pm = system["pm"]

    def cv(x):
        calls["grad" if torch.is_grad_enabled() else "nograd"] += 1
        return pm(x)

    S.metadynamics_langevin(system["ppot"].energy, cv,
                            torch.tensor(system["x0"]), n_steps=40, dt=1e-4,
                            kT=0.0, generator=gen(), height=0.1, sigma=0.1,
                            stride=20)
    assert calls == {"grad": 40, "nograd": 2}
    calls.update(grad=0, nograd=0)
    S.opes_langevin(system["ppot"].energy, cv, torch.tensor(system["x0"]),
                    n_steps=40, dt=1e-4, kT=0.25, generator=gen(),
                    sigma=0.1, stride=20, barrier=4.0, adaptive=True)
    assert calls == {"grad": 40, "nograd": 2}
