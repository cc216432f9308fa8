"""Basin-crossing statistics of ``train_timelagged_cv``'s unbiased run in
either package, each on its own generator, outside the suite.

    python tests/example_hop_rates.py <port|jax> <seed> <walkers> <n_steps>

Runs the example's stage 1 (overdamped Langevin on the toy peptide at
``BARRIER``, ``KT``, ``DT``, recording every ``THIN`` steps) from half of
``walkers`` in basin A and half in basin B (the free torsion turned by
pi, as the example starts its eight), on the CPU and one thread: the
port through ``molann_tpu_torch.examples.train_timelagged_cv``'s
constants with ``torch.Generator().manual_seed(seed)``, the JAX package
through ``examples/train_timelagged_cv.py``'s with
``jax.random.PRNGKey(seed)``. Prints one line ``HOPRATE {json}``: per
start basin the walkers, how many crossed (cos phi changed sign from its
start at a recorded frame), the recorded frame of each first crossing,
the share of frames in the other basin, and the mean of cos phi over
the frames before each walker's first crossing; and in all the
example's ``hops`` (sign changes summed over walkers).
"""

import json
import os
import sys
import time

import numpy as np


def _first_crossings(cos_phi):
    """Per walker, the first recorded frame whose sign of cos phi differs
    from frame 0's, or -1."""
    moved = np.sign(cos_phi) != np.sign(cos_phi[:1])
    first = np.where(moved.any(0), moved.argmax(0), -1)
    return first


def _summary(cos_phi):
    first = _first_crossings(cos_phi)
    t = np.arange(len(cos_phi))[:, None]
    before = (first < 0)[None, :] | (t < first[None, :])
    other = np.sign(cos_phi) != np.sign(cos_phi[:1])
    return {
        "walkers": int(cos_phi.shape[1]),
        "crossed": int((first >= 0).sum()),
        "first_frames": sorted(int(f) for f in first if f >= 0),
        "other_basin_share": float(other.mean()),
        "cos_before_crossing": float(cos_phi[before].mean()),
    }


def _port(seed, walkers, n_steps):
    import torch

    from molann_tpu_torch.examples import train_timelagged_cv as ex
    from molann_tpu_torch.sampling import (ToyPeptidePotential,
                                           overdamped_langevin,
                                           rotate_torsion)
    from molann_tpu_torch.systems import alanine_universe

    torch.set_num_threads(1)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=ex.BARRIER)
    xb = rotate_torsion(u, (4, 6, 8, 14), np.pi)
    x0 = torch.as_tensor(np.concatenate([
        np.repeat(u.atoms.positions[None], walkers // 2, 0),
        np.repeat(xb[None], walkers - walkers // 2, 0)]))
    traj, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_steps, dt=ex.DT, kT=ex.KT,
        generator=torch.Generator().manual_seed(seed), thin=ex.THIN)
    phi = pot.phi(traj.reshape(-1, 22, 3)).numpy()
    return np.cos(phi).reshape(traj.shape[:2])


def _jax(seed, walkers, n_steps):
    import importlib.util

    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from molann_tpu.sampling import (ToyPeptidePotential,
                                     overdamped_langevin, rotate_torsion)
    from molann_tpu.systems import alanine_universe

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", "train_timelagged_cv.py")
    spec = importlib.util.spec_from_file_location("jax_timelagged", path)
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    u = alanine_universe()
    pot = ToyPeptidePotential(u, barrier=ex.BARRIER)
    xb = np.asarray(rotate_torsion(u, (4, 6, 8, 14), np.pi))
    x0 = jnp.asarray(np.concatenate([
        np.repeat(u.atoms.positions[None], walkers // 2, 0),
        np.repeat(xb[None], walkers - walkers // 2, 0)]))
    traj, _ = overdamped_langevin(
        pot.energy, x0, n_steps=n_steps, dt=ex.DT, kT=ex.KT,
        key=jax.random.PRNGKey(seed), thin=ex.THIN)
    phi = np.asarray(pot.phi(traj.reshape(-1, 22, 3)))
    return np.cos(phi).reshape(traj.shape[:2])


def main(argv):
    package, seed, walkers, n_steps = (argv[0], int(argv[1]), int(argv[2]),
                                       int(argv[3]))
    t0 = time.perf_counter()
    cos_phi = {"port": _port, "jax": _jax}[package](seed, walkers, n_steps)
    half = walkers // 2
    hops = int(np.sum(np.abs(np.diff(np.sign(cos_phi), axis=0)) > 0))
    print("HOPRATE", json.dumps({
        "package": package, "seed": seed, "n_steps": n_steps,
        "seconds": time.perf_counter() - t0, "hops": hops,
        "from_a": _summary(cos_phi[:, :half]),
        "from_b": _summary(cos_phi[:, half:])}))


if __name__ == "__main__":
    main(sys.argv[1:])
