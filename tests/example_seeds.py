"""Run one example's quick outcome at shifted seeds, outside the suite:
the robustness study behind the port's example tests.

    python tests/example_seeds.py <name> <offset> [--jax]

Every integer seed the example passes (``torch.Generator.manual_seed``,
``np.random.default_rng``; with ``--jax`` the JAX example's
``jax.random.PRNGKey`` and ``np.random.default_rng``) is shifted by
``1000 * offset``; offset 0 is the example's own. Runs the port example
(``molann_tpu_torch.examples.<name>``) on the CPU, or with ``--jax`` the
JAX package's ``examples/<name>.py``, on one thread, and prints one line
``SEEDRESULT {json}`` with the returned scalars, the seconds, and the
error the example's own checks raised, if any.
"""

import importlib
import importlib.util
import json
import os
import sys
import time

import numpy as np


def _shift_numpy(offset):
    rng = np.random.default_rng

    def default_rng(seed=None):
        return rng(None if seed is None else int(seed) + 1000 * offset)

    np.random.default_rng = default_rng


def _port(name, offset):
    import torch

    torch.set_num_threads(1)
    if offset:
        class ShiftedGenerator(torch.Generator):
            def manual_seed(self, seed):
                return super().manual_seed(int(seed) + 1000 * offset)

        torch.Generator = ShiftedGenerator
        _shift_numpy(offset)
    mod = importlib.import_module(f"molann_tpu_torch.examples.{name}")
    kw = {"device": "cpu"}
    if name not in ("serve_biased_md", "train_autoencoder_cv"):
        kw["quick"] = True
    return lambda: mod.main(**kw)


def _jax(name, offset):
    import jax

    jax.config.update("jax_platforms", "cpu")
    if offset:
        key = jax.random.PRNGKey
        jax.random.PRNGKey = lambda seed: key(int(seed) + 1000 * offset)
        _shift_numpy(offset)
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return lambda: mod.main(quick=True)


def main(argv):
    name, offset = argv[0], int(argv[1])
    run = (_jax if "--jax" in argv else _port)(name, offset)
    t0 = time.perf_counter()
    try:
        out, err = run(), None
    except (AssertionError, RuntimeError) as e:  # the examples' own checks
        out, err = {}, f"{type(e).__name__}: {e}"
    res = {k: float(v) if isinstance(v, np.floating) else v
           for k, v in (out or {}).items()
           if isinstance(v, (int, float, bool, str, type(None), np.floating))}
    print("SEEDRESULT", json.dumps({
        "name": name, "package": "jax" if "--jax" in argv else "port",
        "offset": offset, "error": err,
        "seconds": time.perf_counter() - t0, **res}))


if __name__ == "__main__":
    main(sys.argv[1:])
