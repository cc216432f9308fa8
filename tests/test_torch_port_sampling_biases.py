"""``molann_tpu_torch.sampling``'s biases against ``molann_tpu.sampling``
in the same process: metadynamics (standard, well-tempered, and through
a blocked model), OPES (fixed and adaptive), the bias files read across
the packages, and the path CVs. The replayed noise, the model and the
tolerances are those of ``tests/test_torch_port_sampling.py``, whose
helpers and fixtures this file uses.
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
from test_torch_port_sampling import (TOL, N, W, close, gen,  # noqa: F401
                                      jax_normals, replay, system)


@pytest.mark.parametrize("gamma", [None, 8.0])
def test_metadynamics_matches_jax(system, replay, gamma):
    """Standard and well-tempered metadynamics: trajectory, deposit
    centers and weights after 5 periods of 20 steps."""
    key = jax.random.PRNGKey(15)
    jm, pm = system["jm"], system["pm"]
    r = replay(jax_normals(key, 5, 20, (W, N, 3)))
    jt, jx, jb = JS.metadynamics_langevin(
        system["jpot"].energy, jm, jnp.asarray(system["x0"]), n_steps=100,
        dt=2e-4, kT=0.25, key=key, height=0.5, sigma=0.05, stride=20,
        well_tempered_gamma=gamma)
    pt, px, pb = S.metadynamics_langevin(
        system["ppot"].energy, lambda x: fused_model_forward(pm, x),
        torch.tensor(system["x0"]), n_steps=100, dt=2e-4, kT=0.25,
        generator=gen(), height=0.5, sigma=0.05, stride=20,
        well_tempered_gamma=gamma)
    assert r.done()
    close(pt, jt)
    close(pb.centers, jb.centers)
    close(pb.weights, jb.weights)
    assert (pb.height, pb.sigma, pb.gamma, pb.n_active) == (
        jb.height, jb.sigma, jb.gamma, jb.n_active)
    if gamma is not None:
        assert float(pb.weights.min()) < 1.0
    grid = np.asarray(jb.centers)[:7] + 0.01
    np.testing.assert_allclose(pb.free_energy_estimate(grid).numpy(),
                               np.asarray(jb.free_energy_estimate(grid)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pb.frame_weights(grid, 0.25).numpy(),
                               np.asarray(jb.frame_weights(grid, 0.25)),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="well_tempered_gamma"):
        S.metadynamics_langevin(system["ppot"].energy, pm, px, n_steps=20,
                                dt=1e-4, kT=0.1, generator=gen(), height=1,
                                sigma=1, stride=10, well_tempered_gamma=1.0)


@pytest.mark.parametrize("adaptive", [False, True])
def test_opes_matches_jax(system, replay, adaptive):
    """OPES, fixed and adaptive: trajectory, kernel centers, importance
    weights, bandwidths and the count after 5 periods. The adaptive run
    keeps 2 slots with a small bandwidth, so that deposits append, merge
    and fill the list."""
    key = jax.random.PRNGKey(16)
    jm, pm = system["jm"], system["pm"]
    kw = dict(n_steps=100, dt=2e-4, kT=0.25, sigma=0.05, stride=20,
              barrier=8.0, adaptive=adaptive, max_kernels=2)
    r = replay(jax_normals(key, 5, 20, (W, N, 3)))
    jt, jx, jb = JS.opes_langevin(system["jpot"].energy, jm,
                                  jnp.asarray(system["x0"]), key=key, **kw)
    pt, px, pb = S.opes_langevin(
        system["ppot"].energy, lambda x: fused_model_forward(pm, x),
        torch.tensor(system["x0"]), generator=gen(), **kw)
    assert r.done()
    close(pt, jt)
    assert pb.n_active == jb.n_active
    if adaptive:
        assert pb.n_active == 2
    close(pb.centers, jb.centers)
    np.testing.assert_allclose(pb.weights.numpy(), np.asarray(jb.weights),
                               rtol=TOL, atol=TOL)
    close(pb.sigmas, jb.sigmas)
    assert (pb.gamma, pb.kT, pb.barrier, pb.sigma) == (
        jb.gamma, jb.kT, jb.barrier, jb.sigma)
    cv = np.asarray(jm(jnp.asarray(np.asarray(jt)[-1])))
    close(pb.energy(cv), jb.energy(cv), atol=1e-4)
    close(pb.free_energy_estimate(cv), jb.free_energy_estimate(cv),
          atol=1e-4)
    for bad, msg in ((dict(barrier=0.0), "barrier"),
                     (dict(gamma=1.0), "gamma"),
                     (dict(adaptive=True, max_kernels=0), "max_kernels")):
        with pytest.raises(ValueError, match=msg):
            S.opes_langevin(system["ppot"].energy, pm, px, **{
                **kw, **bad}, generator=gen())


def test_empty_opes_bias_is_zero_with_finite_gradient():
    """No kernel deposited: V = 0 and its gradient is 0, not NaN."""
    b = S.OpesBias(np.zeros((3, 2)), np.zeros(3), sigma=0.1, gamma=5.0,
                   kT=1.0, barrier=4.0, n_active=0)
    cv = torch.tensor([[0.1, 0.2]], requires_grad=True)
    v = b.energy(cv)
    (g,) = torch.autograd.grad(v.sum(), cv)
    assert float(v.detach()) == 0.0 and torch.isfinite(g).all()
    with pytest.raises(ValueError, match="gamma"):
        S.OpesBias(np.zeros((1, 1)), np.ones(1), sigma=0.1, gamma=1.0,
                   kT=1.0, barrier=1.0)


# --- bias files ---------------------------------------------------------------

def _bias_pairs():
    rng = np.random.default_rng(5)
    c = rng.normal(size=(6, 2)).astype(np.float32)
    w = rng.uniform(0.2, 1.0, 6).astype(np.float32)
    s = rng.uniform(0.1, 0.3, 6).astype(np.float32)
    return [
        ("metad", dict(centers=c, height=0.4, sigma=0.3)),
        ("metad", dict(centers=c, height=0.4, sigma=0.3, weights=w,
                       gamma=6.0)),
        ("opes", dict(centers=c, weights=w, sigma=0.2, sigmas=s, gamma=8.0,
                      kT=0.5, barrier=4.0)),
    ]


@pytest.mark.parametrize("case", range(3))
def test_bias_files_cross_between_packages(tmp_path, case):
    """A file written by either package loads in the other (``load_bias``
    dispatching on the ``opes`` marker) with the same keys, arrays and
    energies."""
    kind, kw = _bias_pairs()[case]
    jcls = JS.OpesBias if kind == "opes" else JS.MetadBias
    pcls = S.OpesBias if kind == "opes" else S.MetadBias
    if kind == "opes":
        jb = jcls(kw["centers"], kw["weights"], **{
            k: v for k, v in kw.items() if k not in ("centers", "weights")})
        pb = pcls(kw["centers"], kw["weights"], **{
            k: v for k, v in kw.items() if k not in ("centers", "weights")})
    else:
        jb, pb = jcls(**kw), pcls(**kw)
    jb.save(str(tmp_path / "j.npz"))
    pb.save(str(tmp_path / "p.npz"))
    with np.load(tmp_path / "j.npz") as a, np.load(tmp_path / "p.npz") as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for k in a:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    q = np.random.default_rng(6).normal(size=(9, 2)).astype(np.float32)
    for src, load, other in (("j.npz", S.load_bias, jb),
                             ("p.npz", JS.load_bias, pb)):
        got = load(str(tmp_path / src))
        assert type(got).__name__ == type(other).__name__
        want = (pb if load is S.load_bias else jb).energy(q)
        close(got.energy(q), want.numpy() if isinstance(want, torch.Tensor)
              else want, atol=1e-6)
    if kind == "opes":
        S.MetadBias(np.zeros((1, 1)), 1.0, 1.0).save(str(tmp_path / "m.npz"))
        with pytest.raises(ValueError, match="not an OPES"):
            S.OpesBias.load(str(tmp_path / "m.npz"))


# --- path CVs ------------------------------------------------------------------

def test_pathcv_matches_jax(system, tmp_path):
    """Progress and tube on CV points, the composed CV and wall through the
    model (values and coordinate gradients), ``from_mep`` on .npy and .csv,
    and the checks."""
    rng = np.random.default_rng(7)
    imgs = np.cumsum(rng.uniform(0.1, 0.3, size=(6, 2)), axis=0).astype(
        np.float32)
    jp, pp = JS.PathCV(imgs), S.PathCV(imgs)
    assert pp.lam == jp.lam
    z = (imgs[::2] + 0.05).astype(np.float32)
    for a, b in zip(pp(torch.tensor(z)), jp(jnp.asarray(z))):
        close(a, b, atol=1e-6)
    s1, t1 = pp(torch.tensor(z[0]))
    assert s1.ndim == 0 and t1.ndim == 0
    jm, pm = system["jm"], system["pm"]
    x = system["x0"] + 0.02 * rng.normal(size=(W, N, 3)).astype(np.float32)
    c0 = np.asarray(jm(jnp.asarray(x)))
    t = np.linspace(0.0, 1.0, 5)[:, None]
    path = (c0[0] * (1 - t) + (c0[0] + 0.5) * t).astype(np.float32)
    np.save(tmp_path / "mep.npy", np.concatenate([path, np.ones((5, 1))], 1))
    with open(tmp_path / "mep.csv", "w") as fh:
        fh.write("cv0,cv1,free_energy\n")
        for row in path:
            fh.write(f"{row[0]:.6g},{row[1]:.6g},1\n")
    close(S.PathCV.from_mep(str(tmp_path / "mep.csv")).images,
          JS.PathCV.from_mep(str(tmp_path / "mep.csv")).images, atol=0)
    for name in ("mep.npy",):
        jp = JS.PathCV.from_mep(str(tmp_path / name))
        pp = S.PathCV.from_mep(str(tmp_path / name))
        close(pp.images, jp.images, atol=0)
        fj = [jp.along(jm), jp.wall(jm, k_wall=5.0, t_max=-0.01)]
        fp = [pp.along(lambda v: fused_model_forward(pm, v)),
              pp.wall(pm, k_wall=5.0, t_max=-0.01)]
        for f_j, f_p in zip(fj, fp):
            close(f_p(torch.tensor(x)), f_j(jnp.asarray(x)), atol=1e-5)
            g_j = np.asarray(jax.grad(lambda v: jnp.sum(f_j(v)))(
                jnp.asarray(x)))
            xt = torch.tensor(x, requires_grad=True)
            (g_p,) = torch.autograd.grad(f_p(xt).sum(), xt)
            close(g_p, g_j, atol=1e-4 * max(1.0, np.abs(g_j).max()))
    for bad in (np.zeros((1, 2)), np.zeros((3, 2))):
        with pytest.raises(ValueError):
            S.PathCV(bad)
    with pytest.raises(ValueError, match="lam"):
        S.PathCV(imgs, lam=-1.0)
    with pytest.raises(ValueError, match="k_wall"):
        S.PathCV(imgs).wall(pm, k_wall=-1.0, t_max=0.0)


def test_metadynamics_through_a_blocked_model_matches_jax(tmp_path, system,
                                                          replay):
    """A ``[38, 65, 3]`` head is past the unrolled kernels' width, so
    ``fused_model_forward`` takes the blocked formulation (K6 and K7 on
    the card, their plain versions here) under autograd with respect to
    the walkers: 40 steps of metadynamics against the JAX model."""
    from molann_tpu_torch.ops.fused import model_select_mode

    jm, _ = jalanine_model(hidden_dims=(65, 3), key=jax.random.PRNGKey(5))
    jsave_model(str(tmp_path / "wide.npz"), jm)
    pm = load_model(str(tmp_path / "wide.npz"), device="cpu")
    pm.requires_grad_(False)
    assert model_select_mode(pm) == "blocked"
    key = jax.random.PRNGKey(17)
    r = replay(jax_normals(key, 2, 20, (W, N, 3)))
    jt, _, jb = JS.metadynamics_langevin(
        system["jpot"].energy, jm, jnp.asarray(system["x0"]), n_steps=40,
        dt=2e-4, kT=0.25, key=key, height=0.5, sigma=0.1, stride=20)
    pt, _, pb = S.metadynamics_langevin(
        system["ppot"].energy, lambda x: fused_model_forward(pm, x),
        torch.tensor(system["x0"]), n_steps=40, dt=2e-4, kT=0.25,
        generator=gen(), height=0.5, sigma=0.1, stride=20)
    assert r.done()
    close(pt, jt)
    close(pb.centers, jb.centers)
