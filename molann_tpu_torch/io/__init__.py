"""Model saving and loading, and trajectory reading and writing, for the
port: the readers and writers ``molann_tpu/io/__init__.py`` exports. The
StableHLO and TorchScript artifacts are still to be ported (ROADMAP.md,
queue 2, item 6)."""

from .dcd import DCDWriter, read_dcd, write_dcd
from .netcdf import NetCDFReader, NetCDFWriter, read_netcdf, write_netcdf
from .reader import open_frame_reader
from .serialize import load_model, model_from_arrays, save_model
from .xdr import TRRWriter, XTCWriter, read_trr, read_xtc, write_trr, write_xtc

__all__ = [
    "open_frame_reader",
    "save_model",
    "load_model",
    "model_from_arrays",
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
