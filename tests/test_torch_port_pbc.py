"""The port's periodic-boundary functions (``pbc.py``) against the JAX
package's, on inputs from numpy seeds: ``minimum_image``, ``wrap``,
``unwrap_time`` and ``make_whole`` (torch functions on CPU tensors) within
1e-5 abs, orthorhombic and triclinic, one box and per-frame boxes;
``guess_bonds``, ``bond_tree_levels``, ``box_to_dcd_cell`` and
``dcd_cell_to_box`` (numpy, carried over) equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from molann_tpu import pbc as J
from molann_tpu.systems import alanine_universe as jalanine_universe
from molann_tpu_torch import pbc as T
from molann_tpu_torch.systems import alanine_universe, synthetic_peptide

ATOL = 1e-5
BOXES = {
    "orthorhombic": np.diag([9.0, 10.0, 11.0]).astype(np.float32),
    "triclinic": np.array([[9.0, 0, 0], [2.5, 9.5, 0], [-1.5, 2.0, 10.0]],
                          np.float32),
}


def _close(got, want):
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def _per_frame(box, l, seed):
    rng = np.random.default_rng(seed)
    return (box[None] * rng.uniform(0.9, 1.1, size=(l, 1, 1))).astype(
        np.float32)


@pytest.mark.parametrize("kind", list(BOXES))
@pytest.mark.parametrize("per_frame", [False, True])
def test_minimum_image_and_wrap_match_jax(kind, per_frame):
    rng = np.random.default_rng(1)
    l, n = 9, 13
    box = _per_frame(BOXES[kind], l, 2) if per_frame else BOXES[kind]
    dx = (25.0 * rng.normal(size=(l, n, 3))).astype(np.float32)
    x = (40.0 * rng.uniform(-1, 1, size=(l, n, 3))).astype(np.float32)
    _close(T.minimum_image(dx, box, device="cpu"),
           J.minimum_image(jnp.asarray(dx), jnp.asarray(box)))
    _close(T.wrap(torch.as_tensor(x), torch.as_tensor(box)),
           J.wrap(jnp.asarray(x), jnp.asarray(box)))
    if not per_frame:  # a single vector
        _close(T.minimum_image(torch.as_tensor(dx[0, 0]), box),
               J.minimum_image(jnp.asarray(dx[0, 0]), jnp.asarray(box)))


def test_docstring_examples_and_errors():
    box = torch.diag(torch.tensor([10.0, 10.0, 10.0]))
    assert T.minimum_image(torch.tensor([9.0, 0.2, -9.5]), box).tolist() == [
        -1.0, 0.20000000298023224, 0.5]
    assert T.wrap(torch.tensor([-1.0, 5.5, 17.0]),
                  torch.diag(torch.tensor([4.0, 5.0, 6.0]))).tolist() == [
        3.0, 0.5, 5.0]
    with pytest.raises(ValueError, match="box"):
        T.wrap(torch.zeros(3), torch.zeros(3))
    with pytest.raises(ValueError, match="per-frame"):
        T.minimum_image(torch.zeros(4, 2, 3), torch.zeros(3, 3, 3))
    with pytest.raises(ValueError, match="frames"):
        T.unwrap_time(torch.zeros(4, 3), torch.eye(3))
    with pytest.raises(ValueError, match="boxes"):
        T.unwrap_time(torch.zeros(4, 2, 3), torch.ones(3, 3, 3))
    with pytest.raises(ValueError, match="needs bonds"):
        T.make_whole(torch.zeros(2, 3), torch.eye(3))


@pytest.mark.parametrize("kind", list(BOXES))
@pytest.mark.parametrize("per_frame", [False, True])
def test_unwrap_time_matches_jax(kind, per_frame):
    """A random walk wrapped into the box, unwrapped frame by frame in the
    reference's order of operations."""
    rng = np.random.default_rng(3)
    l, n = 40, 7
    box = _per_frame(BOXES[kind], l, 4) if per_frame else BOXES[kind]
    walk = np.cumsum(rng.normal(scale=0.8, size=(l, n, 3)), axis=0)
    wrapped = np.array(J.wrap(jnp.asarray(walk, jnp.float32),
                              jnp.asarray(box)))
    got = T.unwrap_time(torch.as_tensor(wrapped), torch.as_tensor(box))
    want = J.unwrap_time(jnp.asarray(wrapped), jnp.asarray(box))
    _close(got, want)
    if kind == "orthorhombic" and not per_frame:  # the walk comes back
        np.testing.assert_allclose(got.numpy() - got.numpy()[:1],
                                   walk - walk[:1], atol=1e-3)


@pytest.mark.parametrize("kind", list(BOXES))
def test_make_whole_matches_jax(kind):
    """Alanine translated across the box's faces and wrapped: made whole
    with bonds, a universe or levels, per frame and for one frame."""
    u = alanine_universe()
    ju = jalanine_universe()
    box = BOXES[kind]
    rng = np.random.default_rng(5)
    l = 6
    x = (u.atoms.positions[None] + rng.uniform(-20, 20, size=(l, 1, 3))
         + 0.05 * rng.normal(size=(l, 22, 3))).astype(np.float32)
    wrapped = np.array(J.wrap(jnp.asarray(x), jnp.asarray(box)))
    bonds = T.guess_bonds(u)
    np.testing.assert_array_equal(bonds, J.guess_bonds(ju))
    levels = T.bond_tree_levels(22, bonds)
    jlevels = J.bond_tree_levels(22, bonds)
    assert len(levels) == len(jlevels)
    for (c, p), (jc, jp) in zip(levels, jlevels):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(p, jp)
    want = J.make_whole(jnp.asarray(wrapped), jnp.asarray(box), bonds=bonds)
    _close(T.make_whole(wrapped, box, bonds=bonds, device="cpu"), want)
    _close(T.make_whole(torch.as_tensor(wrapped), box, universe=u), want)
    _close(T.make_whole(torch.as_tensor(wrapped), torch.as_tensor(box),
                        levels=levels), want)
    _close(T.make_whole(torch.as_tensor(wrapped[0]), box, bonds=bonds),
           J.make_whole(jnp.asarray(wrapped[0]), jnp.asarray(box),
                        bonds=bonds))
    boxes = _per_frame(box, l, 6)
    _close(T.make_whole(torch.as_tensor(wrapped), torch.as_tensor(boxes),
                        levels=levels),
           J.make_whole(jnp.asarray(wrapped), jnp.asarray(boxes),
                        levels=jlevels))


@pytest.mark.parametrize("tolerance", [0.2, 0.45, 0.8])
def test_guess_bonds_and_levels_on_a_peptide(tolerance):
    from molann_tpu.systems import synthetic_peptide as jsynthetic_peptide

    u, ju = synthetic_peptide(12), jsynthetic_peptide(12)
    bonds = T.guess_bonds(u, tolerance=tolerance)
    np.testing.assert_array_equal(bonds, J.guess_bonds(ju,
                                                       tolerance=tolerance))
    assert bonds.dtype == np.int64
    for (c, p), (jc, jp) in zip(T.bond_tree_levels(len(u.atoms), bonds),
                                J.bond_tree_levels(len(u.atoms), bonds)):
        np.testing.assert_array_equal(c, jc)
        np.testing.assert_array_equal(p, jp)
    with pytest.raises(ValueError, match="outside"):
        T.bond_tree_levels(3, [[0, 5]])


def test_dcd_cells_match_jax():
    rng = np.random.default_rng(7)
    boxes = np.stack([BOXES["orthorhombic"], BOXES["triclinic"],
                      np.zeros((3, 3), np.float32)])
    cells = T.box_to_dcd_cell(boxes)
    np.testing.assert_array_equal(cells, J.box_to_dcd_cell(boxes))
    np.testing.assert_array_equal(T.box_to_dcd_cell(boxes[1]),
                                  J.box_to_dcd_cell(boxes[1]))
    np.testing.assert_array_equal(T.dcd_cell_to_box(cells[:2]),
                                  J.dcd_cell_to_box(cells[:2]))
    degrees = np.array([[20.0, 90.0, 21.0, 80.0, 100.0, 22.0]])
    degrees[:, (0, 2, 5)] += rng.uniform(size=(1, 3))
    np.testing.assert_array_equal(T.dcd_cell_to_box(degrees),
                                  J.dcd_cell_to_box(degrees))
    np.testing.assert_allclose(T.dcd_cell_to_box(cells[:2]), boxes[:2],
                               atol=ATOL)
