"""Export port models as TorchScript artifacts in the reference's layout.

The port of ``molann_tpu/io/torch_export.py``. The reference's downstream
MD and enhanced-sampling engines embed LibTorch and load
``torch.jit.script(model).save(...)`` archives (reference README.rst:51,
test/test_molann.py:36-114). :func:`export_torchscript` writes that
artifact from a ``molann_tpu_torch`` model: the same module tree, class
names (``MolANN``, ``PreprocessingANN``, ``AlignmentLayer``,
``FeatureLayer``, ``FeatureMap``, a ``torch.nn.Sequential`` head) and
attributes as a reference export, so a model built or trained here drops
into an engine that already consumes reference models::

    from molann_tpu_torch.io.torch_export import export_torchscript
    export_torchscript(model, "model.pt")

or ``python -m molann_tpu_torch export-torch model.npz --out model.pt``.

The classes below are the port's own copy of the reference layout (the
JAX package builds the same ones in ``_torch_classes``). Their forward is
the reference's math: the SVD Kabsch alignment of reference
molann/ann.py:157-199 and the feature maps of :288-356. They are filled
from the port's modules; every tensor is copied to the host, so an
artifact exported from a model on the card loads anywhere. Coordination
features have no counterpart in the reference layout and are refused
(the engine artifact of :mod:`.export` takes them).
"""

from __future__ import annotations

from typing import List

import torch

__all__ = ["export_torchscript"]

# the port's activation names -> torch.nn class names
_TORCH_ACTIVATIONS = {
    "tanh": "Tanh",
    "relu": "ReLU",
    "sigmoid": "Sigmoid",
    "gelu": "GELU",
    "elu": "ELU",
    "celu": "CELU",
    "softplus": "Softplus",
    "swish": "SiLU",
    "identity": "Identity",
}


class FeatureMap(torch.nn.Module):
    def __init__(self, type_id: int, local_indices, input_atom_indices,
                 use_angle_value: bool):
        super().__init__()
        self.type_id = int(type_id)
        self.use_angle_value = bool(use_angle_value)
        self.input_atom_indices: List[int] = [
            int(i) for i in input_atom_indices]
        self.input_atom_num = len(self.input_atom_indices)
        self._local_atom_indices: List[int] = [int(i) for i in local_indices]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        idx = self._local_atom_indices
        out = torch.zeros(x.size(0), 1)
        if self.type_id == 0:  # angle at the middle atom
            va = x[:, idx[0], :] - x[:, idx[1], :]
            vb = x[:, idx[2], :] - x[:, idx[1], :]
            cos_v = (va * vb).sum(dim=1, keepdim=True) / (
                torch.norm(va, dim=1, keepdim=True)
                * torch.norm(vb, dim=1, keepdim=True)
            )
            out = torch.acos(cos_v) if self.use_angle_value else cos_v
        elif self.type_id == 1:  # bond
            out = torch.norm(x[:, idx[1], :] - x[:, idx[0], :],
                             dim=1, keepdim=True)
        elif self.type_id == 2:  # dihedral
            b1 = x[:, idx[1], :] - x[:, idx[0], :]
            b2 = x[:, idx[2], :] - x[:, idx[1], :]
            b3 = x[:, idx[3], :] - x[:, idx[2], :]
            n1 = torch.cross(b1, b2, dim=1)
            n2 = torch.cross(b2, b3, dim=1)
            cos_u = (n1 * n2).sum(dim=1, keepdim=True)
            sin_u = (n1 * b3).sum(dim=1, keepdim=True) * torch.norm(
                b2, dim=1, keepdim=True)
            if self.use_angle_value:
                out = torch.atan2(sin_u, cos_u)
            else:
                rho = torch.sqrt(cos_u ** 2 + sin_u ** 2)
                out = torch.cat((cos_u / rho, sin_u / rho), dim=1)
        else:  # position: x,y,z per atom, row-major
            out = x[:, idx, :].reshape((-1, 3 * len(idx)))
        return out


class FeatureLayer(torch.nn.Module):
    def __init__(self, feature_maps, input_atom_num: int):
        super().__init__()
        self.feature_map_list = torch.nn.ModuleList(feature_maps)
        self.input_atom_num = int(input_atom_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cols: List[torch.Tensor] = []
        for fmap in self.feature_map_list:
            cols.append(fmap(x))
        return torch.cat(cols, dim=1)


class AlignmentLayer(torch.nn.Module):
    def __init__(self, ref_x_centered, align_atom_indices,
                 input_atom_indices, local_align_indices):
        super().__init__()
        self.align_atom_indices: List[int] = [
            int(i) for i in align_atom_indices]
        self.input_atom_indices: List[int] = [
            int(i) for i in input_atom_indices]
        self.input_atom_num = len(self.input_atom_indices)
        self.register_buffer("ref_x", ref_x_centered.detach().to(
            "cpu", torch.float32).clone())
        self._local_align_atom_indices: List[int] = [
            int(i) for i in local_align_indices]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        sub = x[:, self._local_align_atom_indices, :]
        centroid = torch.mean(sub, 1, True)
        cov = torch.matmul((sub - centroid).permute((0, 2, 1)), self.ref_x)
        u, s, vh = torch.linalg.svd(cov)
        fix = torch.eye(3).unsqueeze(0).repeat(x.size(0), 1, 1).to(
            x.device, dtype=u.dtype)
        fix[:, 2, 2] = torch.sign(
            torch.linalg.det(torch.matmul(u, vh))).detach()
        rot = torch.bmm(torch.bmm(u, fix), vh)
        return torch.matmul(x - centroid, rot)


class PreprocessingANN(torch.nn.Module):
    def __init__(self, align_layer, feature_layer):
        super().__init__()
        self.align_layer = (align_layer if align_layer is not None
                            else torch.nn.Identity())
        self.feature_layer = feature_layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.feature_layer(self.align_layer(x))


class MolANN(torch.nn.Module):
    def __init__(self, preprocessing_layer, ann_layers):
        super().__init__()
        self.preprocessing_layer = preprocessing_layer
        self.ann_layers = ann_layers

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.ann_layers(self.preprocessing_layer(x))


def _export_sequential(seq):
    if seq.activation not in _TORCH_ACTIVATIONS:
        raise ValueError(
            f"activation {seq.activation!r} has no torch.nn equivalent; "
            f"supported: {sorted(_TORCH_ACTIVATIONS)}")
    # the reference's create_sequential_nn reuses ONE activation module
    # between layers (molann/ann.py:37,64)
    act = getattr(torch.nn, _TORCH_ACTIVATIONS[seq.activation])()
    mods = []
    for i, lin in enumerate(seq.layers):
        out = torch.nn.Linear(lin.in_features, lin.out_features)
        with torch.no_grad():
            out.weight.copy_(lin.weight.detach().cpu())
            out.bias.copy_(lin.bias.detach().cpu())
        mods.append(out)
        if i < len(seq.layers) - 1:
            mods.append(act)
    return torch.nn.Sequential(*mods)


def _global_numbering(n_inp, pairs):
    """Global 0-based input numbering from ``(local, 1-based)`` pairs:
    identity for atoms no feature touches (their numbering is not
    observable in the artifact's forward)."""
    input_ix = list(range(n_inp))
    for local_j, one_based in pairs:
        input_ix[local_j] = int(one_based) - 1
    return input_ix


def _refuse_coordination(names):
    if names:
        raise ValueError(
            f"coordination features {names} have no counterpart in the "
            "reference library's TorchScript layout; models using them "
            "cannot be exported to .pt (use io.export.export_artifact)")


def _export_feature_layer(flayer, input_ix=None):
    _refuse_coordination([f.name for f in flayer.feature_list
                          if f.get_type_id() == 4])
    if input_ix is None:
        # the layer keeps only local indices; recover the global numbering
        # from the Features
        input_ix = _global_numbering(flayer.input_atom_num, (
            pair for feat, fmap in zip(flayer.feature_list,
                                       flayer.feature_map_list)
            for pair in zip(fmap._local_atom_indices,
                            feat.get_atom_indices())))
    fmaps = [FeatureMap(fmap.type_id, fmap._local_atom_indices, input_ix,
                        fmap.use_angle_value)
             for fmap in flayer.feature_map_list]
    return FeatureLayer(fmaps, flayer.input_atom_num)


def _export_alignment(align):
    return AlignmentLayer(align.ref_x, align.align_atom_indices,
                          align.input_atom_indices,
                          align._local_align_atom_indices)


def _export_any(model):
    from ..models.ann import (
        AlignmentLayer as PortAlignment,
        FeatureLayer as PortFeatureLayer,
        FeatureMap as PortFeatureMap,
        Identity,
        MolANN as PortMolANN,
        PreprocessingANN as PortPreprocessing,
        SequentialNN,
    )

    if isinstance(model, PortMolANN):
        return MolANN(_export_any(model.preprocessing_layer),
                      _export_sequential(model.ann_layers))
    if isinstance(model, PortPreprocessing):
        align = model.align_layer
        if isinstance(align, Identity):
            talign, input_ix = None, None
        else:
            talign = _export_alignment(align)
            # alignment and features share ONE input group: its stored
            # global numbering serves the feature maps
            input_ix = [int(i) for i in align.input_atom_indices]
        return PreprocessingANN(
            talign, _export_feature_layer(model.feature_layer, input_ix))
    if isinstance(model, PortFeatureLayer):
        return _export_feature_layer(model)
    if isinstance(model, PortFeatureMap):
        _refuse_coordination([model.feature.name] if model.type_id == 4
                             else [])
        input_ix = _global_numbering(model.input_atom_num, zip(
            model._local_atom_indices, model.feature.get_atom_indices()))
        return FeatureMap(model.type_id, model._local_atom_indices, input_ix,
                          model.use_angle_value)
    if isinstance(model, PortAlignment):
        return _export_alignment(model)
    if isinstance(model, SequentialNN):
        return _export_sequential(model)
    raise TypeError(
        f"cannot export a {type(model).__name__} to TorchScript; "
        "supported: MolANN, PreprocessingANN, FeatureLayer, FeatureMap, "
        "AlignmentLayer, SequentialNN")


def export_torchscript(model, path=None):
    """Script a port model as a reference-layout TorchScript artifact.

    Returns the scripted module (its tensors on the host); when ``path`` is
    given it is also ``.save(path)``d, the pattern the reference documents
    for downstream engines (``torch.jit.script(model).save(name)``,
    reference README.rst:51). Takes every class the reference exports:
    :class:`~molann_tpu_torch.models.ann.MolANN`, ``PreprocessingANN``,
    ``FeatureLayer``, ``FeatureMap``, ``AlignmentLayer`` and
    ``SequentialNN``.
    """
    scripted = torch.jit.script(_export_any(model))
    if path is not None:
        scripted.save(str(path))
    return scripted
