"""molann_tpu_torch — the PyTorch/CUDA port of molann_tpu.

Collective-variable networks over molecular features (bonds, angles,
dihedrals, positions) with Kabsch alignment, as ``torch.nn.Module``s, and
the biased-MD serving ops (CV values and their coordinate gradients) as
hand-written CUDA kernels for Hopper (``sm_90a``), built at first use.

Importing this package imports ``torch`` and numpy only: no JAX, and
pandas only inside ``get_feature_info``. The JAX package ``molann_tpu`` is
the reference the port is held against; see ROADMAP.md for what is ported.
"""

from . import ann, feature, ops, spec, topology  # noqa: F401
from .ann import (  # noqa: F401
    AlignmentLayer,
    FeatureLayer,
    FeatureMap,
    Identity,
    MolANN,
    PreprocessingANN,
    SequentialNN,
    create_sequential_nn,
)
from .feature import Feature, FeatureFileReader  # noqa: F401
from .ops.fused import fused_cv_forces, fused_model_forward  # noqa: F401
from .topology import Atom, AtomGroup, Universe  # noqa: F401

__version__ = "0.1.0"

__all__ = [
    "Feature",
    "FeatureFileReader",
    "AlignmentLayer",
    "FeatureMap",
    "FeatureLayer",
    "PreprocessingANN",
    "MolANN",
    "SequentialNN",
    "Identity",
    "create_sequential_nn",
    "Atom",
    "AtomGroup",
    "Universe",
    "fused_model_forward",
    "fused_cv_forces",
]
