"""Import the reference's TorchScript artifacts as port models.

The port of ``molann_tpu/io/torch_import.py``. The reference's only
serialization is ``torch.jit.script(model).save(path)`` (reference
README.rst:51, test/test_molann.py:36-114): the archive holds the static
index lists, the centred ``ref_x`` buffer and the MLP weights. A reference
user loads those ``.pt`` files into the port with no reference install and
no retraining::

    from molann_tpu_torch.io.torch_import import load_torchscript
    model = load_torchscript("model.pt")     # on the card; device="cpu"

or ``python -m molann_tpu_torch import-torch model.pt --out model.npz``.

Structure is recovered by walking the scripted module tree by class name
(``original_name``) and reading the attributes the reference's forward
methods keep: ``AlignmentLayer`` its ``_local_align_atom_indices``,
``input_atom_num`` and centred ``ref_x`` (reference molann/ann.py:131-146,
157-199); ``FeatureMap`` its ``type_id``, ``use_angle_value``,
``_local_atom_indices`` and ``input_atom_num`` (molann/ann.py:252-263,
288-356); ``FeatureLayer`` its ``feature_map_list`` (molann/ann.py:426);
the MLP is a ``torch.nn.Sequential`` of Linear and activation modules
(molann/ann.py:60-65).

The JAX package's rules hold: the global ``input_atom_indices`` and
``align_atom_indices`` are used where the archive kept them and atoms are
numbered 0..n_inp-1 where it did not; features are named ``f0, f1, ...``
(scripting drops the reference's MDAnalysis groups); feature maps that
disagree on ``use_angle_value`` are refused.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device

__all__ = ["load_torchscript"]

# reference molann/feature.py:89-97 type_id assignment
_TYPE_NAMES = {0: "angle", 1: "bond", 2: "dihedral", 3: "position"}

# torch.nn activation class name -> the port's activation name
_ACTIVATION_CLASSES = {
    "Tanh": "tanh",
    "ReLU": "relu",
    "Sigmoid": "sigmoid",
    "GELU": "gelu",
    "ELU": "elu",
    "CELU": "celu",
    "Softplus": "softplus",
    "SiLU": "swish",
    "Identity": "identity",
}


def _class_name(scripted):
    """Original (pre-scripting) class name of a RecursiveScriptModule."""
    return getattr(scripted, "original_name", type(scripted).__name__)


def _int_list(scripted, name):
    """A ``List[int]`` attribute if the archive kept it, else None."""
    try:
        val = getattr(scripted, name)
    except (AttributeError, RuntimeError):
        return None
    try:
        return [int(v) for v in val]
    except TypeError:
        return None


def _import_sequential(seq):
    """torch.nn.Sequential of Linear/activation -> SequentialNN."""
    from ..models.ann import SequentialNN

    layers, act_names = [], set()
    for child in seq.children():
        cname = _class_name(child)
        if cname == "Linear":
            w = child.weight.detach().to("cpu", torch.float32)  # [out, in]
            lin = torch.nn.Linear(w.shape[1], w.shape[0])
            with torch.no_grad():
                lin.weight.copy_(w)
                if getattr(child, "bias", None) is not None:
                    lin.bias.copy_(child.bias.detach().cpu())
                else:
                    lin.bias.zero_()
            layers.append(lin)
        elif cname in _ACTIVATION_CLASSES:
            act_names.add(_ACTIVATION_CLASSES[cname])
        else:
            raise ValueError(
                f"cannot import Sequential child {cname!r}; supported: "
                f"Linear + {sorted(_ACTIVATION_CLASSES)}")
    if not layers:
        raise ValueError("Sequential contains no Linear layers")
    if len(act_names) > 1:
        raise ValueError(
            f"mixed activations {sorted(act_names)} are not supported "
            "(SequentialNN shares one activation across hidden layers, "
            "like the reference's create_sequential_nn)")
    return SequentialNN(layers, act_names.pop() if act_names else "tanh")


def _input_group(scripted):
    """The FrozenAtomGroup of the layer's input atoms: the archived global
    indices when present, identity numbering otherwise."""
    from ..topology import FrozenAtomGroup

    n_inp = int(scripted.input_atom_num)
    ix = _int_list(scripted, "input_atom_indices")
    if ix is None or len(ix) != n_inp:
        ix = list(range(n_inp))
    return FrozenAtomGroup(ix)


def _import_alignment(scripted):
    from ..models.ann import AlignmentLayer
    from ..topology import FrozenAtomGroup

    input_group = _input_group(scripted)
    input_ix = list(input_group.ix)
    local = _int_list(scripted, "_local_align_atom_indices")
    if local is None:
        raise ValueError(
            "scripted AlignmentLayer lacks _local_align_atom_indices")
    ref_x = scripted.ref_x.detach().cpu().numpy().astype(np.float32)
    if ref_x.shape != (len(local), 3):
        raise ValueError(f"ref_x shape {ref_x.shape} does not match "
                         f"{len(local)} align atoms")
    # ref_x is already centred (reference molann/ann.py:140-141), so the
    # constructor's centring leaves it as it is, up to float32 rounding
    align_group = FrozenAtomGroup([input_ix[j] for j in local],
                                  positions=ref_x)
    return AlignmentLayer(align_group, input_group)


def _import_feature_map_parts(scripted, input_group, counter):
    """-> (Feature, use_angle_value) recovered from a scripted FeatureMap."""
    from ..feature import Feature
    from ..topology import FrozenAtomGroup

    input_ix = list(input_group.ix)
    type_id = int(scripted.type_id)
    if type_id not in _TYPE_NAMES:
        raise ValueError(f"unknown feature type_id {type_id}")
    local = _int_list(scripted, "_local_atom_indices")
    if local is None:
        raise ValueError("scripted FeatureMap lacks _local_atom_indices")
    group = FrozenAtomGroup([input_ix[j] for j in local])
    return (Feature(f"f{counter}", _TYPE_NAMES[type_id], group),
            bool(scripted.use_angle_value))


def _import_feature_layer(scripted):
    from ..models.ann import FeatureLayer
    from ..topology import FrozenAtomGroup

    # the reference's FeatureLayer archives only input_atom_num
    # (molann/ann.py:426-427); the global numbering lives on each
    # FeatureMap's input_atom_indices, one input group for all maps
    n_inp = int(scripted.input_atom_num)
    maps = list(scripted.feature_map_list.children())
    input_group = None
    for fmap in maps:
        ix = _int_list(fmap, "input_atom_indices")
        if ix is not None and len(ix) == n_inp:
            input_group = FrozenAtomGroup(ix)
            break
    if input_group is None:
        input_group = FrozenAtomGroup(list(range(n_inp)))
    features, flags = [], set()
    for i, fmap in enumerate(maps):
        if _class_name(fmap) != "FeatureMap":
            raise ValueError(f"feature_map_list child {i} is "
                             f"{_class_name(fmap)!r}, expected FeatureMap")
        feature, uav = _import_feature_map_parts(fmap, input_group, i)
        features.append(feature)
        flags.add(uav)
    if not features:
        raise ValueError("scripted FeatureLayer has no feature maps")
    if len(flags) > 1:
        raise ValueError(
            "feature maps disagree on use_angle_value; a FeatureLayer "
            "carries one flag for all features")
    return FeatureLayer(features, input_group, flags.pop())


def _import_feature_map(scripted):
    from ..models.ann import FeatureMap

    input_group = _input_group(scripted)
    feature, uav = _import_feature_map_parts(scripted, input_group, 0)
    return FeatureMap(feature, input_group, uav)


def _import_preprocessing(scripted):
    from ..models.ann import PreprocessingANN

    align_mod = scripted.align_layer
    if _class_name(align_mod) == "AlignmentLayer":
        align = _import_alignment(align_mod)
    elif _class_name(align_mod) == "Identity":
        align = None  # reference molann/ann.py:539-542: None -> Identity
    else:
        raise ValueError(
            f"unexpected align_layer class {_class_name(align_mod)!r}")
    return PreprocessingANN(align,
                            _import_feature_layer(scripted.feature_layer))


def _import_any(scripted):
    name = _class_name(scripted)
    if name == "MolANN":
        from ..models.ann import MolANN

        return MolANN(_import_preprocessing(scripted.preprocessing_layer),
                      _import_sequential(scripted.ann_layers))
    if name == "PreprocessingANN":
        return _import_preprocessing(scripted)
    if name == "FeatureLayer":
        return _import_feature_layer(scripted)
    if name == "FeatureMap":
        return _import_feature_map(scripted)
    if name == "AlignmentLayer":
        return _import_alignment(scripted)
    if name == "Sequential":
        return _import_sequential(scripted)
    raise ValueError(
        f"cannot import a scripted {name!r}; supported roots: MolANN, "
        "PreprocessingANN, FeatureLayer, FeatureMap, AlignmentLayer, "
        "Sequential")


def load_torchscript(path_or_module, *, device=None):
    """Load a reference TorchScript artifact as a port model on ``device``.

    Accepts a path to a ``.pt`` written by ``torch.jit.script(model)
    .save(path)`` on any class the reference exports (MolANN,
    PreprocessingANN, FeatureLayer, FeatureMap, AlignmentLayer, or a bare
    Sequential MLP), or an already-loaded scripted module. Returns the
    equivalent port model, which :func:`~molann_tpu_torch.io.save_model`
    writes and the fused kernels serve. ``device``: ``None`` means the card
    (an error without one), ``"cpu"`` the host.
    """
    device = resolve_device(device)
    if isinstance(path_or_module, (str, bytes)) or hasattr(
            path_or_module, "__fspath__"):
        scripted = torch.jit.load(str(path_or_module), map_location="cpu")
    else:
        scripted = path_or_module
    return _import_any(scripted).to(device)
