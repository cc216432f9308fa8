"""Data parallelism over ``torch.distributed`` (the port of
``molann_tpu/parallel/``): one process per device, a 1-D data mesh of
ranks, replicated parameters and sharded frames. See :mod:`.mesh`,
:mod:`.data_parallel` and :mod:`.multihost`."""

from .mesh import batch_sharding, data_mesh, replicated_sharding
from .data_parallel import (
    make_data_parallel_fn,
    psum_mean_grads,
    shard_batch,
)

__all__ = [
    "data_mesh",
    "batch_sharding",
    "replicated_sharding",
    "make_data_parallel_fn",
    "shard_batch",
    "psum_mean_grads",
]

from .multihost import (  # noqa: E402
    global_batch,
    initialize_multihost,
    process_local_slice,
)

__all__ += [
    "initialize_multihost",
    "global_batch",
    "process_local_slice",
]
