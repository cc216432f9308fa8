"""The port's analysis half of ``molann_tpu_torch.sampling`` against
``molann_tpu.sampling`` in the same process: MBAR, umbrella windows and the
PMF, the string method and the grid interpolator, replica exchange and the
empirical committor (under JAX's replayed noise, as in
``tests/test_torch_port_sampling.py``), the torsion rotation, and the
numpy MSM/TPT estimators.

Tolerances: ``mbar``'s ``f_k`` and ``log_w`` 1e-4 (both iterate in float32
to the same stop rule); string images and energies 1e-4; coordinates and
CV samples 1e-4 after at most 100 steps; MSM/TPT 1e-10 (the same numpy
code on the same inputs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu import sampling as JS
from molann_tpu_torch import sampling as S
from test_torch_port_sampling import (TOL, close, jax_normals,  # noqa: F401
                                      replay, system)

MSM_TOL = 1e-10


# --- MBAR, umbrella windows, PMF ------------------------------------------------

def _windows(seed=0, K=5, n=200):
    rng = np.random.default_rng(seed)
    centers = np.linspace(-1.0, 1.0, K).astype(np.float32)
    k = 20.0
    s = (centers[:, None] + rng.normal(size=(K, n)) / np.sqrt(k + 2.0)).astype(
        np.float32)
    pooled = s.reshape(-1)
    u = (0.5 * k * (pooled[None, :] - centers[:, None]) ** 2).astype(
        np.float32)
    return u, np.full(K, n), pooled


@pytest.mark.parametrize("target", [False, True])
def test_mbar_matches_jax(target):
    """Window free energies and log-weights, with and without a target
    ensemble's reduced potential; the default tolerance (1e-10, met only
    by a fixed point in float32) and a loose one with few iterations."""
    u, n_k, pooled = _windows()
    kw = dict(target_u_n=0.3 * pooled ** 2) if target else {}
    for extra in ({}, dict(tol=1e-3, max_iter=7)):
        jf, jw = JS.mbar(u, n_k, **kw, **extra)
        pf, pw = S.mbar(torch.tensor(u), n_k, **kw, **extra)
        close(pf, jf)
        close(pw, jw)
        assert abs(float(torch.logsumexp(pw, 0))) < 1e-5


def test_pmf_from_samples_matches_jax():
    u, n_k, pooled = _windows(1)
    _, log_w = JS.mbar(u, n_k)
    edges = np.linspace(-1.5, 1.5, 31)
    f_j = JS.pmf_from_samples(pooled, log_w, edges, kT=0.5)
    f_p = S.pmf_from_samples(torch.tensor(pooled), torch.tensor(
        np.asarray(log_w)), edges, kT=0.5)
    np.testing.assert_array_equal(np.isfinite(f_p), np.isfinite(f_j))
    ok = np.isfinite(f_j)
    np.testing.assert_allclose(f_p[ok], f_j[ok], atol=1e-12)
    with pytest.raises(ValueError, match="no samples fall inside"):
        S.pmf_from_samples(pooled, np.asarray(log_w), [5.0, 6.0])


def test_umbrella_sampling_matches_jax(system, replay):
    """Harmonic windows on the model's first CV: CV samples after the
    equilibration frames and the windows' trajectories."""
    key = jax.random.PRNGKey(21)
    jm, pm = system["jm"], system["pm"]
    x0 = system["x0"]
    c0 = float(np.asarray(jm(jnp.asarray(x0[:1])))[0, 0])
    centers = np.asarray([c0 - 0.05, c0, c0 + 0.05], np.float32)
    r = replay(jax_normals(key, 6, 10, x0.shape))
    js, jt = JS.umbrella_sampling(
        system["jpot"].energy, lambda x: jm(x)[:, 0], jnp.asarray(x0),
        centers, k_spring=30.0, n_steps=60, dt=2e-4, kT=0.25, key=key,
        thin=10, n_equil=2)
    ps, pt = S.umbrella_sampling(
        system["ppot"].energy, lambda x: pm(x)[:, 0], torch.tensor(x0),
        centers, k_spring=30.0, n_steps=60, dt=2e-4, kT=0.25,
        generator=torch.Generator(), thin=10, n_equil=2)
    assert r.done() and ps.shape == (3, 4)
    close(ps, js)
    close(pt, jt)


# --- the string method ------------------------------------------------------------

def _quad(lib):
    def f(z):
        return lib.sum((z * z - 1.0) ** 2, -1) + 0.5 * z[:, 0] * z[:, 1]
    return f


@pytest.mark.parametrize("pin", [False, True])
def test_string_method_on_an_analytic_surface(pin):
    """Images and energies of the simplified string on a quartic, with
    the endpoints free and pinned."""
    j0 = JS.linear_path([-1.0, -1.2], [1.1, 0.9], 9)
    p0 = S.linear_path(torch.tensor([-1.0, -1.2]), [1.1, 0.9], 9)
    close(p0, j0, atol=1e-7)
    ji, je = JS.string_method(_quad(jnp), j0, n_iterations=200, step=2e-2,
                              pin_ends=pin)
    pi_, pe = S.string_method(_quad(torch), p0, n_iterations=200, step=2e-2,
                              pin_ends=pin)
    close(pi_, ji)
    close(pe, je)
    with pytest.raises(ValueError, match="n_images >= 3"):
        S.string_method(_quad(torch), p0[:2])


def test_string_method_on_a_grid_and_a_bias():
    """The string on a gridded 2-D FES through ``grid_interpolator``
    (values, gradients, clamping, fill) and on a metadynamics bias's
    ``-V``. The grid's nodes sit off the path's minima: the interpolant
    has a kink on every grid line, where a float32 rounding decides the
    cell and so the gradient."""
    xs = np.linspace(-1.55, 1.45, 31)
    ys = np.linspace(-1.05, 0.95, 21)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    f = (gx ** 2 - 1.0) ** 2 + 2.0 * gy ** 2
    f[0, 0] = np.nan
    jf = JS.grid_interpolator([xs, ys], f, fill=9.0)
    pf = S.grid_interpolator([xs, ys], f, fill=9.0)
    q = np.random.default_rng(3).uniform(-1.8, 1.8, size=(40, 2)).astype(
        np.float32)
    close(pf(torch.tensor(q)), jf(jnp.asarray(q)), atol=1e-5)
    close(pf(torch.tensor(q[0])), jf(jnp.asarray(q[0])), atol=1e-5)
    qt = torch.tensor(q, requires_grad=True)
    (g_p,) = torch.autograd.grad(pf(qt).sum(), qt)
    g_j = jax.grad(lambda z: jnp.sum(jf(z)))(jnp.asarray(q))
    close(g_p, g_j, atol=1e-4)
    a, b = [-1.1, 0.3], [1.1, -0.2]
    ji, je = JS.string_method(jf, JS.linear_path(a, b, 12), n_iterations=150,
                              step=2e-2)
    pi_, pe = S.string_method(pf, S.linear_path(torch.tensor(a), b, 12),
                              n_iterations=150, step=2e-2)
    close(pi_, ji)
    close(pe, je)
    c = np.concatenate([np.full((20, 1), -1.0), np.full((20, 1), 1.0)])
    jb, pb = JS.MetadBias(c, 0.2, 0.4), S.MetadBias(c, 0.2, 0.4)
    ji, je = JS.string_method(lambda z: -jb.energy(z),
                              JS.linear_path([-0.9], [0.9], 8),
                              n_iterations=100, step=5e-2)
    pi_, pe = S.string_method(lambda z: -pb.energy(z),
                              S.linear_path(torch.tensor([-0.9]), [0.9], 8),
                              n_iterations=100, step=5e-2)
    close(pi_, ji)
    close(pe, je)
    for bad, msg in ((dict(mids=[xs], values=f), "grid shape"),
                     (dict(mids=[xs[:1]], values=f[:1, 0]), ">= 2 points"),
                     (dict(mids=[xs ** 2, ys], values=f), "uniformly"),
                     (dict(mids=[xs, ys], values=f), "non-finite")):
        with pytest.raises(ValueError, match=msg):
            S.grid_interpolator(bad["mids"], bad["values"])


# --- replica exchange, committor, torsion rotation ------------------------------

def _well(lib):
    def energy(x):
        return lib.sum((x[..., 0] ** 2 - 1.0) ** 2 + 0.5 * x[..., 1] ** 2
                       + 0.5 * x[..., 2] ** 2, -1)
    return energy


def test_replica_exchange_matches_jax(replay):
    """Four rungs on a double well: per-rung trajectories (thinned), the
    final configurations and the swap acceptance, with the swaps' uniforms
    replayed too."""
    key = jax.random.PRNGKey(31)
    R, stride, rounds = 4, 5, 12
    x0 = np.random.default_rng(4).normal(size=(R, 2, 3)).astype(np.float32)
    temps = np.asarray([0.2, 0.4, 0.8, 1.6], np.float32)
    normals, uniforms = [], []
    for k in jax.random.split(key, rounds):
        k_dyn, k_swap = jax.random.split(k)
        normals += [np.asarray(jax.random.normal(kk, x0.shape, jnp.float32))
                    for kk in jax.random.split(k_dyn, stride)]
        uniforms.append(np.asarray(jax.random.uniform(k_swap, (R,))))
    r = replay(normals, uniforms)
    jt, jx, ja = JS.replica_exchange_langevin(
        _well(jnp), x0, temps, n_steps=stride * rounds, dt=1e-2, key=key,
        exchange_stride=stride, thin=3)
    pt, px, pa = S.replica_exchange_langevin(
        _well(torch), torch.tensor(x0), temps, n_steps=stride * rounds,
        dt=1e-2, generator=torch.Generator(), exchange_stride=stride, thin=3)
    assert r.done() and pt.shape == (4, R, 2, 3)
    close(pt, jt)
    close(px, jx)
    close(pa, ja, atol=0)
    assert float(pa.max()) > 0
    for bad, msg in ((dict(n_steps=7), "exchange_stride"),
                     (dict(thin=5), "divide by"),
                     (dict(temperatures=temps[:3]), "one temperature")):
        kw = dict(n_steps=stride * rounds, dt=1e-2, exchange_stride=stride,
                  generator=torch.Generator())
        kw.update(bad)
        temperatures = kw.pop("temperatures", temps)
        with pytest.raises(ValueError, match=msg):
            S.replica_exchange_langevin(_well(torch), torch.tensor(x0),
                                        temperatures, **kw)


def test_empirical_committor_matches_jax(replay):
    """Replicas from three starts on a double well, frozen at their first
    basin entry: committor estimates and resolved fractions."""
    key = jax.random.PRNGKey(32)
    x0 = np.zeros((3, 1, 3), np.float32)
    x0[:, 0, 0] = [-0.3, 0.0, 0.4]
    n_rep, steps = 8, 80
    r = replay([np.asarray(jax.random.normal(k, (3 * n_rep, 1, 3),
                                             jnp.float32))
                for k in jax.random.split(key, steps)])
    jq, jr = JS.empirical_committor(
        _well(jnp), x0, lambda x: x[:, 0, 0] < -0.8,
        lambda x: x[:, 0, 0] > 0.8, n_steps=steps, dt=1e-2, kT=0.4,
        key=key, n_replicas=n_rep)
    pq, pr = S.empirical_committor(
        _well(torch), torch.tensor(x0), lambda x: x[:, 0, 0] < -0.8,
        lambda x: x[:, 0, 0] > 0.8, n_steps=steps, dt=1e-2, kT=0.4,
        generator=torch.Generator(), n_replicas=n_rep)
    assert r.done()
    np.testing.assert_array_equal(np.isnan(pq.numpy()), np.isnan(jq))
    close(pr, jr, atol=0)
    ok = ~np.isnan(np.asarray(jq))
    close(pq.numpy()[ok], np.asarray(jq)[ok], atol=0)
    assert 0 < float(pr.sum())


def test_rotate_torsion_matches_jax(system):
    """The torsion rotation is the JAX package's numpy code: the same
    positions for a few angles; a ring axis is refused."""
    for angle in (0.0, 1.0, np.pi):
        np.testing.assert_array_equal(
            S.rotate_torsion(system["pu"], (4, 6, 8, 14), angle),
            JS.rotate_torsion(system["ju"], (4, 6, 8, 14), angle))

    class Ring:
        class atoms:
            positions = np.asarray([[np.cos(a), np.sin(a), 0.0] for a in
                                    np.linspace(0, 2 * np.pi, 7)[:-1]],
                                   np.float32) * 1.4

    with pytest.raises(ValueError, match="ring"):
        S.rotate_torsion(Ring, (0, 1, 2, 3), 0.5)


# --- MSM and TPT (numpy, carried) ---------------------------------------------------

@pytest.fixture(scope="module")
def series():
    """Three-basin CV series: an AR(1) process in a drifting well, binned
    on a 1-D and a 2-D grid, as one trajectory and as four walkers."""
    rng = np.random.default_rng(41)
    z = np.empty((4000, 2))
    z[0] = 0.0
    for t in range(1, len(z)):
        z[t] = 0.9 * z[t - 1] + 0.45 * rng.normal(size=2)
    edges = [np.linspace(-2, 2, 7), np.linspace(-2, 2, 4)]
    return dict(z=z, edges=edges,
                labels=JS.grid_assign(z, edges),
                walkers=[JS.grid_assign(z[i::4], edges) for i in range(4)])


def _same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, (int, np.integer)) and not isinstance(a, bool):
        assert a == b
    else:
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=MSM_TOL, rtol=0)


def test_msm_estimators_match_jax(series):
    """grid_assign, count_matrix, transition_matrix (reversible and not),
    estimate_msm and its methods, ck_test, mfpt, PCCA+, coarse_grain and
    the bootstrap, on the same series."""
    z, edges = series["z"], series["edges"]
    _same(S.grid_assign(z, edges), JS.grid_assign(z, edges))
    _same(S.grid_assign(z[:, 0], edges[0]), JS.grid_assign(z[:, 0],
                                                           edges[0]))
    n = 18
    for lab in (series["labels"], series["walkers"]):
        for sliding in (True, False):
            _same(S.count_matrix(lab, n, 3, sliding=sliding),
                  JS.count_matrix(lab, n, 3, sliding=sliding))
    c = JS.count_matrix(series["labels"], n, 2)
    for rev in (True, False):
        _same(S.transition_matrix(c, reversible=rev),
              JS.transition_matrix(c, reversible=rev))
        pm = S.estimate_msm(series["walkers"], n, 2, reversible=rev)
        jm = JS.estimate_msm(series["walkers"], n, 2, reversible=rev)
        for name in ("transition", "pi", "lag", "eigenvalues"):
            _same(getattr(pm, name), getattr(jm, name))
        _same(pm.timescales(), jm.timescales())
    pm = S.estimate_msm(series["labels"], n, 2)
    jm = JS.estimate_msm(series["labels"], n, 2)
    _same(pm.mfpt([0, 1]), jm.mfpt([0, 1]))
    _same(S.mfpt(pm.transition, [5], lag=2.0),
          JS.mfpt(jm.transition, [5], lag=2.0))
    _same(pm.metastable_sets(3), jm.metastable_sets(3))
    _same(pm.coarse_grain(3), jm.coarse_grain(3))
    chi = JS.pcca_memberships(jm.transition, 2)
    _same(S.pcca_memberships(pm.transition, 2), chi)
    _same(S.coarse_grain(pm.transition, pm.pi, chi),
          JS.coarse_grain(jm.transition, jm.pi, chi))
    _same(S.ck_test(series["labels"], n, 2, factors=(2, 3)),
          JS.ck_test(series["labels"], n, 2, factors=(2, 3)))
    for lab in (series["labels"], series["walkers"]):
        pb = S.bootstrap_msm(lab, n, 2, n_samples=5, seed=3)
        jb = JS.bootstrap_msm(lab, n, 2, n_samples=5, seed=3)
        for name in ("timescales", "pi", "block", "n_resampled"):
            _same(getattr(pb, name), getattr(jb, name))
        _same(pb.timescale_ci(), jb.timescale_ci())
        _same(pb.pi_ci(0.9), jb.pi_ci(0.9))
    assert S.MSM.__dataclass_fields__.keys() == JS.MSM.__dataclass_fields__.keys()
    for fn, args, msg in (
            (S.count_matrix, (series["labels"], n, 0), "lag"),
            (S.count_matrix, (series["labels"], 3, 1), "outside"),
            (S.transition_matrix, (-np.ones((2, 2)),), "nonnegative"),
            (S.mfpt, (jm.transition, []), "at least one"),
            (S.pcca_memberships, (jm.transition, 1), "n_sets"),
            (S.bootstrap_msm, (series["labels"], n, 2), None)):
        if msg is None:
            with pytest.raises(ValueError, match="n_samples"):
                fn(*args, n_samples=1)
            continue
        with pytest.raises(ValueError, match=msg):
            fn(*args)


def test_tpt_matches_jax(series):
    """Forward committor, the full TPT analysis and its pathways, on the
    MSM of the series and through ``MSM.tpt``."""
    n = 18
    jm = JS.estimate_msm(series["labels"], n, 2)
    pm = S.estimate_msm(series["labels"], n, 2)
    a, b = [0, 1], [16, 17]
    _same(S.forward_committor(pm.transition, a, b),
          JS.forward_committor(jm.transition, a, b))
    for pr, jr in ((S.tpt(pm.transition, pm.pi, a, b, lag=2.0),
                    JS.tpt(jm.transition, jm.pi, a, b, lag=2.0)),
                   (pm.tpt(a, b), jm.tpt(a, b))):
        assert type(pr).__name__ == "TPT"
        for name in ("q_plus", "q_minus", "flux", "net_flux", "total_flux",
                     "rate", "lag", "source", "target"):
            _same(getattr(pr, name), getattr(jr, name))
        _same(pr.pathways(4), jr.pathways(4))
    with pytest.raises(ValueError, match="overlap"):
        S.forward_committor(pm.transition, [0, 1], [1, 2])
    with pytest.raises(ValueError, match="at least one"):
        S.tpt(pm.transition, pm.pi, [], b)
