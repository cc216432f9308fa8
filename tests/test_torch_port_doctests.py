"""The port's runnable docstring examples: doctest over the port's
counterparts of the eight modules ``tests/test_docs.py`` runs for the JAX
package, one case a module, with no failures and at least 40 statements
attempted in all, as the JAX test asks."""

import doctest
import importlib

import pytest

MODULES = (
    "molann_tpu_torch.models.ann",
    "molann_tpu_torch.feature",
    "molann_tpu_torch.train.losses",
    "molann_tpu_torch.train.timelagged",
    "molann_tpu_torch.sampling.string",
    "molann_tpu_torch.train.discriminant",
    "molann_tpu_torch.sampling.pathcv",
    "molann_tpu_torch.pbc",
)

ATTEMPTED = {}


@pytest.mark.parametrize("name", MODULES)
def test_docstring_examples_execute(name):
    res = doctest.testmod(importlib.import_module(name), verbose=False)
    assert res.failed == 0, f"doctest failures in {name}"
    assert res.attempted > 0, f"{name} carries no runnable example"
    ATTEMPTED[name] = res.attempted


def test_docstring_examples_count():
    """The eight modules carry at least 40 statements in all (the JAX
    package's own floor), and the classes of ``models/ann.py`` each carry
    one example."""
    total = 0
    for name in MODULES:
        if name not in ATTEMPTED:
            ATTEMPTED[name] = doctest.testmod(
                importlib.import_module(name), verbose=False).attempted
        total += ATTEMPTED[name]
    assert total >= 40, f"docstring examples shrank: only {total} statements"
    ann = importlib.import_module("molann_tpu_torch.models.ann")
    for obj in (ann.create_sequential_nn, ann.AlignmentLayer, ann.FeatureMap,
                ann.FeatureLayer, ann.PreprocessingANN, ann.MolANN):
        assert ">>>" in obj.__doc__, obj.__name__
