"""Training-side helpers of the port. Only the coordinate-gradient oracle
is ported so far (:mod:`.forces`)."""

from .forces import coordinate_gradients, force_fn  # noqa: F401
