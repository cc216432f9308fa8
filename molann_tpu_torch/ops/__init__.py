"""Tensor ops of the port: feature math, Kabsch alignment, the fused serving
and training ops with their CUDA kernels (:mod:`.fused` for small systems,
:mod:`.fused_blocked` for large and condensed-phase ones), and neighbor
culling of coordination pair tables (:mod:`.neighbor`). The same names as
``molann_tpu/ops/__init__.py``."""

from . import alignment, features, fused, fused_blocked, neighbor  # noqa: F401
from .alignment import align_frames, rotation_eigh, rotation_qcp, rotation_svd
from .features import (
    angle_features,
    apply_compiled_features,
    bond_features,
    dihedral_features,
    position_features,
)
from .fused import (
    active_atom_indices,
    fused_apply,
    fused_cv_forces,
    fused_model_forward,
    fused_train_grads,
    model_select_mode,
)
from .fused_blocked import blocked_apply, blocked_cv_forces, blocked_train_grads
from .neighbor import (
    CullReport,
    cull_model,
    cull_spec,
    max_displacement,
    neighbor_pairs,
    switching_cutoff,
)

__all__ = [
    "align_frames",
    "rotation_svd",
    "rotation_eigh",
    "rotation_qcp",
    "angle_features",
    "bond_features",
    "dihedral_features",
    "position_features",
    "apply_compiled_features",
    "fused_apply",
    "fused_model_forward",
    "active_atom_indices",
    "model_select_mode",
    "fused_cv_forces",
    "fused_train_grads",
    "blocked_apply",
    "blocked_cv_forces",
    "blocked_train_grads",
    "CullReport",
    "cull_model",
    "cull_spec",
    "max_displacement",
    "neighbor_pairs",
    "switching_cutoff",
]
