"""Eager ``nn.Module`` layers of the port (see :mod:`.ann`)."""

from .ann import (  # noqa: F401
    ACTIVATIONS,
    AlignmentLayer,
    FeatureLayer,
    FeatureMap,
    Identity,
    MolANN,
    PreprocessingANN,
    SequentialNN,
    create_sequential_nn,
    model_dims,
)
