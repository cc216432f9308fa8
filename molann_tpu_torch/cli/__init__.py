"""Command-line tools of the port: ``python -m molann_tpu_torch``.

The port of ``molann_tpu/cli/``, with the JAX commands' flags, messages,
output files and exit codes::

    python -m molann_tpu_torch info model.npz
    python -m molann_tpu_torch evaluate model.npz traj.dcd --out cvs.npy
    python -m molann_tpu_torch forces model.npz traj.xtc --component 0 \\
        --out cv0.npy --forces-out f.npy
    python -m molann_tpu_torch committee m0.npz m1.npz m2.npz traj.npy \\
        --calibrate train.npy --out mean.npy --std-out std.npy
    python -m molann_tpu_torch convert traj.dcd traj.xtc
    python -m molann_tpu_torch unwrap wrapped.xtc system.pdb whole.xtc \\
        --mode whole+nojump
    python -m molann_tpu_torch build model.pdb features.txt --section Output \\
        --align "bynum 1 2 5" --mlp 8 5 3 --out model.npz
    python -m molann_tpu_torch export model.npz --n-atoms 22 --fused \\
        --with-gradient --out model.pt
    python -m molann_tpu_torch import-torch reference_model.pt --out model.npz
    python -m molann_tpu_torch export-torch trained.npz --out model.pt
    python -m molann_tpu_torch train model.npz traj.npy --loss eigenfunction \\
        --beta 4 --weights w.npy --steps 2000 --out trained.npz
    python -m molann_tpu_torch sample model.npz model.pdb --bias metad \\
        --out sampled.xtc --bias-out bias.npz
    python -m molann_tpu_torch fes bias.npz --grid=-3.2:3.2:200 --out fes.npy
    python -m molann_tpu_torch mep fes.npy --grid=-3.2:3.2:200 \\
        --start=-1 --end 1 --out path.npy
    python -m molann_tpu_torch msm cvs.npy --lag 10 --grid=-1:1:10

Trajectories are ``.npy`` ([n_frames, n_atoms, 3] or packed [n_frames,
3n] float32), ``.dcd``, ``.trr``, ``.xtc`` or Amber ``.nc``, read by the
native loader (``--backend native``) or the numpy decoders. ``evaluate``,
``forces``, ``committee``, ``unwrap``, ``build``, ``sample``, ``fes``,
``reweight``, ``mep``, ``pmf`` and ``train`` run on the CUDA card unless
``--device cpu`` is given; without a card they fail rather than fall back
to the host. ``sample`` runs the CV model through the fused kernels
(``fused_model_forward``: the forward kernel every step and deposit, the
backward kernel for every step's force). ``info``, ``convert`` and
``msm`` are host work. ``export`` writes a TorchScript engine artifact
(``--fused``: the CUDA kernels as torch custom ops), ``import-torch`` and
``export-torch`` convert reference-layout TorchScript ``.pt`` files.
"""

from __future__ import annotations

import argparse
import sys

# the JAX package's subcommands that the port does not have: none
NOT_PORTED = ()


def main(argv=None):
    from . import analysis, evaluate, export, sampling, traj, train

    argv = sys.argv[1:] if argv is None else list(argv)
    p = argparse.ArgumentParser(
        prog="molann_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)
    # registration order = --help listing order, as in the JAX package
    for mod in (evaluate, traj, export, sampling, analysis, train):
        mod.register(sub)
    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # stdout closed early (piped into `head`): exit quietly with
        # 128+SIGPIPE, stdout pointed at devnull for the final flush
        import os

        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 141


if __name__ == "__main__":
    sys.exit(main())
