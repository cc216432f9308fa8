"""Command-line tools of the port: ``python -m molann_tpu_torch``.

The port of ``molann_tpu/cli/``. One subcommand is ported so far::

    python -m molann_tpu_torch train model.npz traj.npy --loss eigenfunction \\
        --beta 4 --weights w.npy --steps 2000 --out trained.npz

It trains on the CUDA card unless ``--device cpu`` is given; without a
card it fails rather than fall back to the host. The JAX package's other
subcommands (``info``, ``evaluate``, ``forces``, ``committee``, ``build``,
``sample``, ...) exit with status 2 until they are ported (ROADMAP.md,
queue 2, item 8).
"""

from __future__ import annotations

import argparse
import sys

# the JAX package's subcommands that the port does not have yet
NOT_PORTED = ("info", "evaluate", "forces", "committee", "export",
              "import-torch", "export-torch", "build", "sample", "fes",
              "reweight", "mep", "pmf", "msm", "convert", "unwrap")


def main(argv=None):
    from . import train

    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in NOT_PORTED:
        print(f"error: the {argv[0]!r} command is not ported to "
              "molann_tpu_torch yet (ROADMAP.md, queue 2, item 8); use "
              "python -m molann_tpu", file=sys.stderr)
        return 2
    p = argparse.ArgumentParser(
        prog="molann_tpu_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = p.add_subparsers(dest="command", required=True)
    train.register(sub)
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
