"""Model saving and loading, trajectory reading and writing, and the
artifacts for engines, for the port: what ``molann_tpu/io/__init__.py``
exports, with the TorchScript engine artifact (:func:`export_artifact`,
:func:`load_artifact`) in place of StableHLO, and the reference-layout
TorchScript both ways (:func:`export_torchscript`,
:func:`load_torchscript`)."""

from .dcd import DCDWriter, read_dcd, write_dcd
from .export import export_artifact, load_artifact
from .netcdf import NetCDFReader, NetCDFWriter, read_netcdf, write_netcdf
from .reader import open_frame_reader
from .serialize import load_model, model_from_arrays, save_model
from .torch_export import export_torchscript
from .torch_import import load_torchscript
from .xdr import TRRWriter, XTCWriter, read_trr, read_xtc, write_trr, write_xtc

__all__ = [
    "open_frame_reader",
    "save_model",
    "load_model",
    "model_from_arrays",
    "export_artifact",
    "load_artifact",
    "export_torchscript",
    "load_torchscript",
    "read_dcd",
    "write_dcd",
    "read_trr",
    "write_trr",
    "read_xtc",
    "write_xtc",
    "read_netcdf",
    "write_netcdf",
    "DCDWriter",
    "NetCDFReader",
    "NetCDFWriter",
    "TRRWriter",
    "XTCWriter",
]
