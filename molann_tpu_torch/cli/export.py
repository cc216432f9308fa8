"""Model construction and artifact exchange commands: build, export,
import-torch, export-torch (the port of ``molann_tpu/cli/export.py``).

Each has the JAX command's flags, printed lines and exit codes; ``--device``
is the port's own (where the model is loaded or built; default the card).

- ``build`` reads a topology (PDB/GRO/XYZ) and a feature file and writes the
  JAX package's ``.npz`` model format. The MLP's weights are drawn from
  U(-1/√fan_in, 1/√fan_in) by a ``torch.Generator`` seeded with 0, so they
  are not the JAX command's numbers (its weights come from
  ``PRNGKey(0)``); everything else in the file is the same.
- ``export`` writes the engine artifact of :mod:`..io.export`, a
  TorchScript archive (default ``--out model.pt``) in place of the JAX
  command's StableHLO; ``--fused`` calls the CUDA kernels as torch custom
  ops, takes any batch unless ``--batch`` fixes one, and runs on a machine
  without a card. ``--raw-mlir`` and ``--batch-sizes`` exit 2: they frame
  StableHLO for a bare PJRT runtime, which cannot take a polymorphic
  batch, and a TorchScript artifact needs neither.
- ``import-torch`` reads a reference-layout TorchScript ``.pt`` into an
  ``.npz``; ``export-torch`` writes an ``.npz`` model as one.
"""

from __future__ import annotations

import sys

from ._common import _device, _load_model, add_device_arg

# export's JAX flags that frame StableHLO, and why the artifact needs neither
REFUSED = {
    "raw_mlir": ("error: --raw-mlir frames bare StableHLO for a PJRT runtime; "
                 "the TorchScript artifact is what LibTorch loads, so "
                 "there is nothing to choose"),
    "batch_sizes": ("error: --batch-sizes bundles fixed-batch modules "
                    "because a bare PJRT runtime cannot refine a polymorphic "
                    "batch; the TorchScript artifact takes any batch"),
}


def cmd_export(args):
    from ..io import export_artifact

    for flag, msg in REFUSED.items():
        if getattr(args, flag):
            print(msg, file=sys.stderr)
            return 2
    model = _load_model(args.model, _device(args))
    export_artifact(model, n_atoms=args.n_atoms, path=args.out,
                    with_gradient=args.with_gradient,
                    batch_size=args.export_batch, fused=args.fused)
    print(f"wrote {args.out}")
    if args.fused:
        from ..ops.fused import model_chunk_matrix, model_select_mode

        if (model_select_mode(model) == "blocked"
                and model_chunk_matrix(model) is not None):
            print(
                "note: this model chunks a coordination pair table — the "
                "artifact carries it as one buffer (the pair operand of "
                "model_chunk_matrix), so the artifact takes x alone")
    return 0


def cmd_import_torch(args):
    """Convert a reference TorchScript artifact (torch.jit.script(...).save)
    into an .npz model: the migration path for existing reference models
    (reference README.rst:51)."""
    from ..io import load_torchscript, save_model
    from ..models.ann import FeatureLayer, MolANN, PreprocessingANN
    from .evaluate import feature_table

    model = load_torchscript(args.torchscript, device=_device(args))
    save_model(args.out, model)
    flayer = None
    if isinstance(model, MolANN):
        flayer = model.preprocessing_layer.feature_layer
    elif isinstance(model, PreprocessingANN):
        flayer = model.feature_layer
    elif isinstance(model, FeatureLayer):
        flayer = model
    print(f"imported {type(model).__name__}; wrote {args.out}")
    if flayer is not None:
        print(feature_table(flayer.feature_list))
    return 0


def cmd_export_torch(args):
    """Serialize a saved model as a reference-layout TorchScript artifact
    (torch.jit.script(...).save, reference README.rst:51) so LibTorch-
    embedded MD engines consuming reference models run it unchanged."""
    from ..io import export_torchscript

    model = _load_model(args.model, _device(args))
    export_torchscript(model, args.out)
    print(f"wrote {args.out} (TorchScript, reference layout)")
    return 0


def cmd_build(args):
    from ..ann import (
        AlignmentLayer,
        FeatureLayer,
        MolANN,
        PreprocessingANN,
        create_sequential_nn,
    )
    from ..feature import FeatureFileReader
    from ..io import save_model
    from ..topology import Universe

    device = _device(args)
    u = Universe(args.pdb)
    features = FeatureFileReader(args.features, args.section, u).read()
    if not features:
        print(f"error: no features in section [{args.section}]",
              file=sys.stderr)
        return 1
    flayer = FeatureLayer(features, u.atoms, args.use_angle_value)
    align = (
        AlignmentLayer(u.select_atoms(args.align), u.atoms, device=device)
        if args.align else None
    )
    pp = PreprocessingANN(align, flayer)
    dims = [pp.output_dimension(), *args.mlp] if args.mlp else None
    if dims:
        model = MolANN(pp, create_sequential_nn(dims, device=device))
    else:
        model = pp
    save_model(args.out, model)
    print(f"wrote {args.out} (feature dim {pp.output_dimension()})")
    return 0


def register(sub):
    px = sub.add_parser(
        "export", help="export a TorchScript engine artifact (LibTorch)")
    px.add_argument("model")
    px.add_argument("--n-atoms", type=int, required=True)
    px.add_argument("--out", default="model.pt")
    px.add_argument("--with-gradient", action="store_true")
    px.add_argument("--batch", type=int, default=None, dest="export_batch",
                    help="fix the frame-batch size (default: any)")
    px.add_argument("--raw-mlir", action="store_true",
                    help="refused (exit 2): StableHLO framing for PJRT "
                         "runtimes, which a TorchScript artifact needs not")
    px.add_argument("--fused", action="store_true",
                    help="call the CUDA kernels as torch custom ops "
                         "(torch.ops.molann_tpu_torch.*; runs on the card "
                         "only, exports anywhere)")
    px.add_argument("--batch-sizes", default=None,
                    help="refused (exit 2): a TorchScript artifact takes any "
                         "batch")
    add_device_arg(px, "load the model on")
    px.set_defaults(fn=cmd_export)

    pm = sub.add_parser(
        "import-torch",
        help="convert a reference TorchScript .pt artifact to .npz")
    pm.add_argument("torchscript", help=".pt file from "
                                        "torch.jit.script(model).save(...)")
    pm.add_argument("--out", default="model.npz")
    add_device_arg(pm, "build the imported model on")
    pm.set_defaults(fn=cmd_import_torch)

    pxt = sub.add_parser(
        "export-torch",
        help="serialize a saved model as a TorchScript .pt artifact "
             "(reference layout, for LibTorch-embedded engines)")
    pxt.add_argument("model", help="saved model (.npz)")
    pxt.add_argument("--out", default="model.pt")
    add_device_arg(pxt, "load the model on")
    pxt.set_defaults(fn=cmd_export_torch)

    pb = sub.add_parser(
        "build",
        help="build a model from a topology (PDB/GRO/XYZ) + feature file")
    pb.add_argument("pdb")
    pb.add_argument("features")
    pb.add_argument("--section", required=True)
    pb.add_argument("--align", default=None,
                    help="selection string for the alignment group")
    pb.add_argument("--mlp", type=int, nargs="*", default=None,
                    help="hidden/output dims appended after the feature dim")
    pb.add_argument("--use-angle-value", action="store_true")
    pb.add_argument("--out", default="model.npz")
    add_device_arg(pb, "build the model on")
    pb.set_defaults(fn=cmd_build)
