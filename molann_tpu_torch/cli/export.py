"""Model construction commands: build (the port of
``molann_tpu/cli/export.py``'s ``build``).

``build`` reads a topology (PDB/GRO/XYZ) and a feature file and writes the
JAX package's ``.npz`` model format, with the JAX command's flags, printed
lines and exit codes; ``--device`` is the port's own. The MLP's weights are
drawn from U(-1/√fan_in, 1/√fan_in) by a ``torch.Generator`` seeded with 0,
so they are not the JAX command's numbers (its weights come from
``PRNGKey(0)``); everything else in the file is the same. ``export``,
``import-torch`` and ``export-torch`` are not ported yet (ROADMAP.md,
queue 2, item 8).
"""

from __future__ import annotations

import sys

from ._common import _device, add_device_arg


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
