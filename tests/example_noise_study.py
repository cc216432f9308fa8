"""Run the example tests' own-noise stages at shifted seeds, outside the
suite: how far the port's statistics fall from the JAX package's, in
standard errors of their difference, when each draws from its own
generator.

    PYTHONPATH=.:tests python tests/example_noise_study.py <shift>...

For each shift, every ``own_noise_*`` function of the
``tests/test_torch_port_examples_*.py`` files runs with ``1000 * shift``
added to its seeds (``example_twins.SHIFT``); each statistic prints one
line ``AGREE shift <seeds' shift> <statistic>: port <mean> JAX <mean> z
<difference in standard errors>``, and one the suite's test would fail
also ``FAILED``.
"""

import glob
import importlib
import inspect
import os
import sys

import example_twins


def stages():
    here = os.path.dirname(os.path.abspath(__file__))
    for path in sorted(glob.glob(os.path.join(
            here, "test_torch_port_examples_*.py"))):
        mod = importlib.import_module(os.path.basename(path)[:-3])
        for name, fn in vars(mod).items():
            if name.startswith("own_noise_") and inspect.isfunction(fn):
                yield name, fn


def main(argv):
    import conftest  # noqa: F401  (the suite's JAX settings)

    for shift in map(int, argv):
        example_twins.SHIFT = 1000 * shift
        for name, fn in stages():
            args = (("cold",), ("warm",)) if "particles" in name else ((),)
            for a in args:
                for what, (p, j) in fn(*a).items():
                    try:
                        example_twins.agree(p, j, f"{name}{a} {what}")
                    except AssertionError as e:
                        print(f"FAILED shift {example_twins.SHIFT} {e}")


if __name__ == "__main__":
    main(sys.argv[1:])
