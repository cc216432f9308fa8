"""Alias module mirroring the reference's import path ``molann.ann``:
``from molann_tpu_torch.ann import MolANN, ...``. Implementation lives in
:mod:`molann_tpu_torch.models.ann`.
"""

from .models.ann import (  # noqa: F401
    AlignmentLayer,
    FeatureLayer,
    FeatureMap,
    Identity,
    MolANN,
    PreprocessingANN,
    SequentialNN,
    create_sequential_nn,
)

__all__ = [
    "AlignmentLayer",
    "FeatureMap",
    "FeatureLayer",
    "PreprocessingANN",
    "MolANN",
    "SequentialNN",
    "Identity",
    "create_sequential_nn",
]
