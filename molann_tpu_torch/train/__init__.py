"""Training on the port: data, losses, the loop and checkpoints (ports of
``molann_tpu/train/{data,losses,loop,checkpoint}.py``), and the
coordinate-gradient oracle (:mod:`.forces`). The other objectives, the
lagged and packed iterators and data-parallel training are still to be
ported (ROADMAP.md, queue 2)."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_training_state,
    save_training_state,
)
from .data import TrajectoryDataset, batch_iterator, save_trajectory  # noqa: F401
from .forces import coordinate_gradients, force_fn  # noqa: F401
from .losses import fused_mse_loss, mse_loss  # noqa: F401
from .loop import (  # noqa: F401
    TrainResult,
    fit,
    make_fused_train_step,
    make_train_step,
    masked_optimizer,
    trainable_mask,
)
