"""Enhanced-sampling building blocks (the port of ``molann_tpu/sampling/``).

A differentiable toy internal-coordinate force field (:mod:`potentials`),
overdamped and BAOAB Langevin integrators (:mod:`langevin`), and CV-space
biases — steered-MD moving restraints, (well-tempered) metadynamics
(:mod:`bias`) and OPES (:mod:`opes`) — whose forces come from
differentiating a CV model with respect to the coordinates; path CVs,
umbrella sampling with MBAR, replica exchange, the string method,
committors, and Markov state models with transition path theory.

Walkers are a leading batch axis; steps and periods are a Python loop
over tensors preallocated on the walkers' device; deposits are index
writes into buffers sized up front, and no step reads a value back to the
host. A JAX key becomes ``generator``, a ``torch.Generator`` on that
device. Given ``cv_model = lambda x: fused_model_forward(model, x)`` on
the card, each biased step runs the forward kernel and autograd runs the
backward kernel for the force (K1 and K2, or K6 and K7 for a blocked
model). :mod:`msm` and :mod:`tpt` are host numpy.
"""

from .bias import MetadBias, metadynamics_langevin, steered_langevin
from .committor import empirical_committor, rotate_torsion
from .opes import OpesBias, opes_langevin
from .langevin import baoab_langevin, kinetic_temperature, overdamped_langevin
from .mbar import mbar, pmf_from_samples, umbrella_sampling
from .msm import (
    MSM,
    BootstrapMSM,
    bootstrap_msm,
    ck_test,
    coarse_grain,
    count_matrix,
    estimate_msm,
    grid_assign,
    mfpt,
    pcca_memberships,
    transition_matrix,
)
from .pathcv import PathCV
from .potentials import LennardJonesPotential, ToyPeptidePotential
from .remd import replica_exchange_langevin
from .tpt import TPT, forward_committor, tpt
from .string import grid_interpolator, linear_path, string_method


def load_bias(path):
    """Load a saved bias file: dispatches between OPES kernels
    (:meth:`OpesBias.save`) and metadynamics hills
    (:meth:`MetadBias.save`) by the ``opes`` marker field — the one
    loader the ``fes``/``mep``/``reweight`` commands use."""
    import numpy as np

    with np.load(path) as f:
        is_opes = "opes" in f
    return OpesBias.load(path) if is_opes else MetadBias.load(path)


__all__ = [
    "ToyPeptidePotential",
    "LennardJonesPotential",
    "overdamped_langevin",
    "baoab_langevin",
    "kinetic_temperature",
    "steered_langevin",
    "metadynamics_langevin",
    "MetadBias",
    "opes_langevin",
    "OpesBias",
    "load_bias",
    "empirical_committor",
    "rotate_torsion",
    "mbar",
    "umbrella_sampling",
    "pmf_from_samples",
    "replica_exchange_langevin",
    "string_method",
    "grid_interpolator",
    "linear_path",
    "PathCV",
    "MSM",
    "estimate_msm",
    "grid_assign",
    "count_matrix",
    "transition_matrix",
    "ck_test",
    "mfpt",
    "pcca_memberships",
    "coarse_grain",
    "bootstrap_msm",
    "BootstrapMSM",
    "TPT",
    "tpt",
    "forward_committor",
]
