"""Load models saved by the JAX package's ``molann_tpu.io.save_model``.

The ``.npz`` artifact (format v1, ``molann_tpu/io/serialize.py:286-309``)
holds a JSON structure description under ``__meta__`` plus numpy arrays.
It is read here with numpy and JSON only, so weights cross from the JAX
package to the port without JAX installed:

- ``SequentialNN`` weights ``w [d_in, d_out]`` become
  ``nn.Linear.weight [d_out, d_in]`` (transposed);
- ``ref_x`` and the compiled feature spec are taken as they are.

Atom groups come back as :class:`~molann_tpu_torch.topology.FrozenAtomGroup`
shims carrying indices (and positions where saved): no PDB is needed.
"""

from __future__ import annotations

import json

import numpy as np
import torch
from torch import nn

from ..feature import Feature
from ..models.ann import (
    ACTIVATIONS,
    AlignmentLayer,
    FeatureLayer,
    FeatureMap,
    Identity,
    MolANN,
    PreprocessingANN,
    SequentialNN,
)
from ..spec import CompiledFeatures
from ..topology import FrozenAtomGroup

__all__ = ["load_model", "model_from_arrays", "FORMAT_VERSION"]

FORMAT_VERSION = 1


def _feature_from_dict(d, arrays):
    pos = arrays[d["positions"]] if "positions" in d else None
    if d["type"] == "coordination":
        c = d["coord"]
        n_a, ix = int(c["n_a"]), d["ix"]
        ag_a = FrozenAtomGroup(ix[:n_a], pos[:n_a] if pos is not None else None)
        ag_b = (FrozenAtomGroup(ix[n_a:], pos[n_a:] if pos is not None else None)
                if len(ix) > n_a else None)
        return Feature(d["name"], "coordination", ag_a, group_b=ag_b,
                       r0=c["r0"], nn=c["nn"], mm=c["mm"],
                       pbc_box=c.get("box"), d_max=c.get("d_max"))
    return Feature(d["name"], d["type"], FrozenAtomGroup(d["ix"], pos))


def _spec_from_dict(d):
    n_coord = len(d.get("coord_slices", ()))
    return CompiledFeatures(
        n_input_atoms=d["n_input_atoms"],
        use_angle_value=d["use_angle_value"],
        out_dim=d["out_dim"],
        angle_idx=tuple(tuple(t) for t in d["angle_idx"]),
        bond_idx=tuple(tuple(t) for t in d["bond_idx"]),
        dihedral_idx=tuple(tuple(t) for t in d["dihedral_idx"]),
        position_idx=tuple(d["position_idx"]),
        perm=tuple(d["perm"]) if d["perm"] is not None else None,
        feature_dims=tuple(d["feature_dims"]),
        coord_pairs=tuple(tuple(t) for t in d.get("coord_pairs", ())),
        coord_slices=tuple(tuple(t) for t in d.get("coord_slices", ())),
        coord_params=tuple((float(r0), int(nn_), int(mm))
                           for r0, nn_, mm in d.get("coord_params", ())),
        coord_boxes=tuple(
            None if b is None else tuple(tuple(float(v) for v in row)
                                         for row in b)
            for b in d.get("coord_boxes", (None,) * n_coord)),
        coord_dmax=tuple(None if v is None else float(v)
                         for v in d.get("coord_dmax", (None,) * n_coord)),
    )


def _bare(cls):
    """An instance of an ``nn.Module`` subclass with only the Module
    machinery initialised (its attributes come from the checkpoint)."""
    obj = cls.__new__(cls)
    nn.Module.__init__(obj)
    return obj


def _from_dict(d, arrays, device):
    kind = d["kind"]
    if kind == "MolANN":
        return MolANN(_from_dict(d["preprocessing_layer"], arrays, device),
                      _from_dict(d["ann_layers"], arrays, device))
    if kind == "PreprocessingANN":
        align = _from_dict(d["align_layer"], arrays, device)
        return PreprocessingANN(align,
                                _from_dict(d["feature_layer"], arrays, device))
    if kind == "Identity":
        return Identity()
    if kind == "AlignmentLayer":
        obj = _bare(AlignmentLayer)
        obj.align_atom_indices = tuple(d["align_atom_indices"])
        obj.input_atom_indices = tuple(d["input_atom_indices"])
        obj.input_atom_num = d["input_atom_num"]
        obj._local_align_atom_indices = tuple(d["local_align_atom_indices"])
        obj.method = d["method"]
        obj.register_buffer("ref_x", torch.as_tensor(
            np.asarray(arrays[d["ref_x"]], np.float32), device=device))
        return obj
    if kind == "FeatureLayer":
        obj = _bare(FeatureLayer)
        features = tuple(_feature_from_dict(fd, arrays) for fd in d["features"])
        obj.feature_list = features
        obj.use_angle_value = d["use_angle_value"]
        obj.input_atom_num = d["input_atom_num"]
        obj._spec = _spec_from_dict(d["spec"])
        fmaps = []
        for f, local in zip(features, d["input_atom_indices"]):
            fm = _bare(FeatureMap)
            fm.feature = f
            fm.type_id = f.get_type_id()
            fm.use_angle_value = d["use_angle_value"]
            fm.input_atom_num = d["input_atom_num"]
            fm._local_atom_indices = tuple(local)
            fmaps.append(fm)
        obj.feature_map_list = nn.ModuleList(fmaps)
        return obj
    if kind == "SequentialNN":
        layers = []
        for wk, bk in d["params"]:
            w = np.asarray(arrays[wk], np.float32)  # [d_in, d_out]
            lin = nn.Linear(w.shape[0], w.shape[1], device=device)
            with torch.no_grad():
                lin.weight.copy_(torch.as_tensor(w.T.copy()))
                lin.bias.copy_(torch.as_tensor(
                    np.asarray(arrays[bk], np.float32)))
            layers.append(lin)
        if d["activation"] not in ACTIVATIONS:
            raise ValueError(f"unknown activation {d['activation']!r}")
        return SequentialNN(layers, d["activation"])
    raise TypeError(f"cannot load kind {kind!r}")


def model_from_arrays(structure, arrays, *, device="cpu"):
    """Build a port model from a checkpoint's JSON ``structure`` (the
    ``"model"`` entry of ``__meta__``) and its ``arrays`` (name → numpy)."""
    return _from_dict(structure, arrays, device)


def load_model(path, *, device="cpu"):
    """Load a ``molann_tpu.io.save_model`` ``.npz`` into a port model on
    ``device``."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"].tobytes()).decode())
        if meta.get("format_version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported checkpoint format {meta.get('format_version')}")
        arrays = {k: data[k] for k in data.files if k != "__meta__"}
    return model_from_arrays(meta["model"], arrays, device=device)
