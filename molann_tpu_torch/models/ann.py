"""ANN layers over molecular features as ``torch.nn.Module``s.

The PyTorch port of ``molann_tpu/models/ann.py`` (same class names, same
numerical contract as reference molann/ann.py): ``AlignmentLayer``,
``FeatureMap``, ``FeatureLayer``, ``PreprocessingANN``, ``MolANN``,
``SequentialNN`` / ``create_sequential_nn`` and ``model_dims``::

    model = MolANN(pp_layer, create_sequential_nn([8, 5, 3], generator=g))
    y = model(x)                              # x: [l, n_inp, 3] float32

These eager layers are the port's CPU oracle: the fused CUDA kernels in
:mod:`molann_tpu_torch.ops.fused` are held against them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.alignment import ROTATION_METHODS, align_frames
from ..ops.features import (
    _apply_compiled,
    _spec_tables,
    angle_features,
    bond_features,
    coordination_features,
    dihedral_features,
    position_features,
)
from ..spec import (
    CompiledFeatures,
    compile_features,
    coordination_pair_list,
    resolve_local_indices,
)

__all__ = [
    "ACTIVATIONS",
    "create_sequential_nn",
    "SequentialNN",
    "AlignmentLayer",
    "FeatureMap",
    "FeatureLayer",
    "PreprocessingANN",
    "MolANN",
    "Identity",
    "model_dims",
    "named_tensors",
]

# Activations by name, the names ``molann_tpu.io.serialize`` writes
# (``jax.nn.gelu`` defaults to the tanh approximation).
ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "gelu": lambda x: torch.nn.functional.gelu(x, approximate="tanh"),
    "elu": torch.nn.functional.elu,
    "celu": torch.nn.functional.celu,
    "softplus": torch.nn.functional.softplus,
    "swish": torch.nn.functional.silu,
    "identity": lambda x: x,
}


def model_dims(model):
    """``(n_input_atoms, d_out)`` of any evaluable model (:class:`MolANN`,
    :class:`PreprocessingANN` or :class:`FeatureLayer`)."""
    if isinstance(model, MolANN):
        n = model.preprocessing_layer.feature_layer.spec.n_input_atoms
        return n, model.ann_layers.output_dimension()
    if isinstance(model, PreprocessingANN):
        return model.feature_layer.spec.n_input_atoms, model.output_dimension()
    if isinstance(model, FeatureLayer):
        return model.spec.n_input_atoms, model.output_dimension()
    raise TypeError(f"cannot evaluate a {type(model).__name__}")


def named_tensors(model):
    """``[(name, tensor)]`` of a model's parameters, then its buffers (the
    alignment ``ref_x``): the leaves a JAX model's pytree holds. A tuple or
    list of models (the ``(model, decoder)`` pair the autoencoder losses
    train) gives each member's tensors under its index,
    ``0.ann_layers.layers.0.weight``, ``1.layers.0.weight``."""
    if isinstance(model, (tuple, list)):
        return [(f"{i}.{name}", t) for i, m in enumerate(model)
                for name, t in named_tensors(m)]
    return [*model.named_parameters(), *model.named_buffers()]


def _check_input(x, n_atoms):
    if x.ndim != 3 or x.shape[1] != n_atoms or x.shape[2] != 3:
        raise AssertionError(
            f"Input should be a 3d array with sizes [*, {n_atoms}, 3]. "
            f"Actual sizes: {tuple(x.shape)}"
        )


class SequentialNN(nn.Module):
    """Dense MLP: ``Linear`` + activation per hidden layer, bare ``Linear``
    last (reference molann/ann.py:60-65). ``layers`` holds the
    ``nn.Linear``s (weight ``[d_out, d_in]``); ``activation`` is a name in
    :data:`ACTIVATIONS`."""

    def __init__(self, layers, activation="tanh"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}; choose from "
                             f"{sorted(ACTIVATIONS)}")
        self.layers = nn.ModuleList(layers)
        self.activation = activation
        self.layer_dims = (self.layers[0].in_features,
                           *(lin.out_features for lin in self.layers))

    def forward(self, x):
        act = ACTIVATIONS[self.activation]
        n = len(self.layers)
        for i, lin in enumerate(self.layers):
            x = lin(x)
            if i < n - 1:
                x = act(x)
        return x

    def output_dimension(self):
        return self.layer_dims[-1]

    def __len__(self):
        return len(self.layers)


def create_sequential_nn(layer_dims, activation="tanh", *, generator=None,
                         dtype=torch.float32, device="cpu"):
    """Construct a feedforward network (reference molann/ann.py:37-67).

    Weights and biases are drawn from U(-1/√fan_in, 1/√fan_in) with
    ``generator`` (``torch.nn.Linear``'s default scheme; a fresh generator
    seeded with 0 when omitted), so a model is reproducible from a seed.

    Example (executed by tests/test_torch_port_doctests.py):

    >>> import torch
    >>> g = torch.Generator().manual_seed(0)
    >>> nn = create_sequential_nn([2, 5, 3], generator=g, device="cpu")
    >>> len(nn)                      # two Linear layers
    2
    >>> nn.output_dimension()
    3
    >>> nn(torch.ones((4, 2))).shape   # [batch, d_out]
    torch.Size([4, 3])
    """
    if len(layer_dims) < 2:
        raise AssertionError(
            "Error: at least 2 layers are needed to define a neural network "
            "(length={})!".format(len(layer_dims)))
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    layers = []
    for d_in, d_out in zip(layer_dims[:-1], layer_dims[1:]):
        bound = 1.0 / math.sqrt(d_in)
        lin = nn.Linear(d_in, d_out, dtype=dtype, device=device)
        with torch.no_grad():
            w = torch.empty((d_out, d_in), dtype=dtype).uniform_(
                -bound, bound, generator=generator)
            b = torch.empty((d_out,), dtype=dtype).uniform_(
                -bound, bound, generator=generator)
            lin.weight.copy_(w)
            lin.bias.copy_(b)
        layers.append(lin)
    return SequentialNN(layers, activation)


class Identity(nn.Module):
    """No-op layer standing in for alignment (molann/ann.py:539-542)."""

    def forward(self, x):
        return x


class AlignmentLayer(nn.Module):
    """Kabsch translation+rotation alignment onto a fixed reference
    (reference molann/ann.py:69-199).

    ``ref_x`` (the align-group positions centred once at construction) is
    a buffer: it moves with ``.to(device)`` and is not trained. Forward
    maps ``[l, n_inp, 3] → [l, n_inp, 3]``.

    Example (reference molann/ann.py:88-112):

    >>> import torch
    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> align = AlignmentLayer(u.select_atoms("bynum 1 2 5"), u.atoms,
    ...                        device="cpu")
    >>> x = torch.as_tensor(u.atoms.positions[None])   # [1, 22, 3]
    >>> aligned = align(x)
    >>> aligned.shape
    torch.Size([1, 22, 3])
    >>> # self-alignment maps the align atoms onto the centered reference
    >>> bool(torch.allclose(aligned[0, [0, 1, 4]], align.ref_x, atol=1e-5))
    True
    """

    def __init__(self, align_atom_group, input_atom_group, method="qcp", *,
                 device="cpu"):
        super().__init__()
        if method not in ROTATION_METHODS:
            raise ValueError(
                f"unknown rotation method {method!r}; "
                f"choose from {sorted(ROTATION_METHODS)}"
            )
        self.align_atom_indices = tuple(int(i) for i in align_atom_group.ix)
        self.input_atom_indices = tuple(int(i) for i in input_atom_group.ix)
        self.input_atom_num = len(input_atom_group)
        self.method = method
        ref = np.asarray(align_atom_group.positions, dtype=np.float32)
        self.register_buffer("ref_x", torch.as_tensor(
            ref - ref.mean(axis=0, keepdims=True), device=device))
        input_list = list(self.input_atom_indices)
        try:
            self._local_align_atom_indices = tuple(
                input_list.index(idx) for idx in self.align_atom_indices)
        except ValueError:
            raise ValueError("Atoms used for alignment must be among the input")

    def forward(self, x):
        _check_input(x, self.input_atom_num)
        return align_frames(x, self.ref_x, self._local_align_atom_indices,
                            method=self.method)


class FeatureMap(nn.Module):
    """Map coordinates to ONE feature's value(s)
    (reference molann/ann.py:201-356).

    Example (golden value from BASELINE.md; reference
    molann/ann.py:219-241):

    >>> import numpy as np, torch
    >>> from molann_tpu_torch.feature import Feature
    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> fmap = FeatureMap(
    ...     Feature("b1", "bond", u.select_atoms("bynum 2 5")), u.atoms)
    >>> fmap.dim()
    1
    >>> x = torch.as_tensor(u.atoms.positions[None])
    >>> print(np.round(fmap(x).numpy(), 4))
    [[1.5297]]
    """

    def __init__(self, feature, input_atom_group, use_angle_value=False):
        super().__init__()
        self.feature = feature
        self.type_id = feature.get_type_id()
        self.use_angle_value = bool(use_angle_value)
        self.input_atom_num = len(input_atom_group)
        self._local_atom_indices = tuple(resolve_local_indices(
            [int(i) - 1 for i in feature.get_atom_indices()],
            input_atom_group.ix))

    def dim(self):
        if self.type_id in (0, 1, 4):
            return 1
        if self.type_id == 2:
            return 1 if self.use_angle_value else 2
        return 3 * len(self._local_atom_indices)

    def _coordination_args(self):
        n_a, r0, nn_, mm = self.feature.get_coordination_params()
        idx = self._local_atom_indices
        pairs = coordination_pair_list(idx[:n_a], idx[n_a:])
        box = getattr(self.feature, "pbc_box", None)
        dmax = getattr(self.feature, "d_max", None)
        return (tuple(pairs), ((0, len(pairs)),), ((r0, nn_, mm),),
                (box,), (dmax,))

    def forward(self, x):
        _check_input(x, self.input_atom_num)
        idx = self._local_atom_indices
        if self.type_id == 0:
            return angle_features(x, (idx,), self.use_angle_value)
        if self.type_id == 1:
            return bond_features(x, (idx,))
        if self.type_id == 2:
            d = dihedral_features(x, (idx,), self.use_angle_value)
            return d if self.use_angle_value else d.reshape(-1, 2)
        if self.type_id == 4:
            return coordination_features(x, *self._coordination_args())
        return position_features(x, idx)


class FeatureLayer(nn.Module):
    """Map coordinates to ALL features of a feature list, columns in
    feature-list order (reference molann/ann.py:358-474), computed
    type-grouped through the compiled spec.

    Example (reference molann/ann.py:379-415; golden values BASELINE.md):

    >>> import numpy as np, torch
    >>> from molann_tpu_torch.feature import Feature
    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> feats = [Feature("b1", "bond", u.select_atoms("bynum 2 5")),
    ...          Feature("a1", "angle", u.select_atoms("bynum 20")
    ...                  + u.select_atoms("bynum 19")
    ...                  + u.select_atoms("bynum 21"))]
    >>> layer = FeatureLayer(feats, u.atoms)
    >>> layer.output_dimension()
    2
    >>> layer.get_feature(0).get_name()
    'b1'
    >>> x = torch.as_tensor(u.atoms.positions[None])
    >>> print(np.round(layer(x).numpy(), 4))   # columns in list order
    [[ 1.5297 -0.3328]]
    """

    def __init__(self, feature_list, input_atom_group, use_angle_value=False):
        super().__init__()
        if len(feature_list) == 0:
            raise AssertionError("Error: feature list is empty!")
        self.feature_list = tuple(feature_list)
        self.use_angle_value = bool(use_angle_value)
        self.input_atom_num = len(input_atom_group)
        self.feature_map_list = nn.ModuleList(
            FeatureMap(f, input_atom_group, use_angle_value)
            for f in feature_list)
        self._spec = compile_features(feature_list, input_atom_group.ix,
                                      use_angle_value)

    def get_feature_info(self):
        """One pandas row per feature (pandas imported here only)."""
        import pandas as pd

        return pd.concat([f.get_feature_info() for f in self.feature_list],
                         ignore_index=True)

    def get_feature(self, idx):
        return self.feature_list[idx]

    def output_dimension(self):
        return self._spec.out_dim

    @property
    def spec(self) -> CompiledFeatures:
        """The compiled static index spec."""
        return self._spec

    def forward(self, x):
        _check_input(x, self.input_atom_num)
        # the spec's index tables, put on each device once: a copy at every
        # call would make the host wait for the card
        on = self.__dict__.setdefault("_device_tables", {})
        if x.device not in on:
            on[x.device] = _spec_tables(self._spec, x.device)
        return _apply_compiled(self._spec, x, on[x.device])


class PreprocessingANN(nn.Module):
    """Optional alignment followed by the feature layer
    (reference molann/ann.py:476-565); ``None`` alignment → Identity.

    Example (reference molann/ann.py:483-529):

    >>> import torch
    >>> from molann_tpu_torch.feature import Feature
    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> flayer = FeatureLayer(
    ...     [Feature("b1", "bond", u.select_atoms("bynum 2 5"))], u.atoms)
    >>> pp = PreprocessingANN(None, flayer)   # None -> Identity alignment
    >>> type(pp.align_layer).__name__
    'Identity'
    >>> pp.output_dimension()
    1
    >>> pp(torch.as_tensor(u.atoms.positions[None])).shape
    torch.Size([1, 1])
    """

    def __init__(self, align_layer, feature_layer):
        super().__init__()
        self.align_layer = align_layer if align_layer is not None else Identity()
        self.feature_layer = feature_layer

    def output_dimension(self):
        return self.feature_layer.output_dimension()

    def forward(self, x):
        return self.feature_layer(self.align_layer(x))


class MolANN(nn.Module):
    """Full model: preprocessing + trainable network
    (reference molann/ann.py:567-625).

    Example (reference molann/ann.py:576-599); the model is a
    ``torch.nn.Module``, so autograd gives its coordinate gradients:

    >>> import torch
    >>> from molann_tpu_torch.feature import Feature
    >>> from molann_tpu_torch.systems import alanine_universe
    >>> u = alanine_universe()
    >>> pp = PreprocessingANN(None, FeatureLayer(
    ...     [Feature("b1", "bond", u.select_atoms("bynum 2 5"))], u.atoms))
    >>> model = MolANN(pp, create_sequential_nn([pp.output_dimension(), 5, 2]))
    >>> x = torch.as_tensor(u.atoms.positions[None]).requires_grad_(True)
    >>> model(x).shape
    torch.Size([1, 2])
    >>> (g,) = torch.autograd.grad(model(x).sum(), x)   # coordinate gradients
    >>> bool((torch.linalg.norm(g[0, [1, 4]], dim=-1) > 0).all())
    True
    >>> bool(g[0, 0].abs().max() == 0)   # non-feature atom: zero grad
    True
    """

    def __init__(self, preprocessing_layer, ann_layers):
        super().__init__()
        self.preprocessing_layer = preprocessing_layer
        self.ann_layers = ann_layers

    def get_preprocessing_layer(self):
        return self.preprocessing_layer

    def forward(self, x):
        return self.ann_layers(self.preprocessing_layer(x))
