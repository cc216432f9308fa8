"""Training on the port (ports of ``molann_tpu/train/``): data and the
lagged-pair iterator, the losses (MSE, autoencoder, eigenfunction,
committor, VAMP-2), TICA, HLDA, committees, the loop and checkpoints, the
coordinate-gradient oracle (:mod:`.forces`), and optax's update rules in
``torch.optim`` form (:mod:`.optim`). The trainers take ``mesh=`` (a
:func:`~molann_tpu_torch.parallel.data_mesh`) for data-parallel training
over ``torch.distributed`` ranks. ``loss_registry`` is the objectives'
registry under the JAX package's name; ``registry`` is the same dict."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_training_state,
    save_training_state,
)
from .data import (  # noqa: F401
    TrajectoryDataset,
    batch_iterator,
    lagged_pair_iterator,
    packed_batch_iterator,
    save_trajectory,
)
from .discriminant import HLDAResult, hlda  # noqa: F401
from .ensemble import (  # noqa: F401
    EnsembleResult,
    calibrated_committee,
    committee,
    committee_calibration,
    ensemble_apply,
    ensemble_size,
    fit_ensemble,
    make_ensemble_train_step,
    reinitialized_members,
    stack_models,
    unstack_model,
)
from .forces import coordinate_gradients, force_fn  # noqa: F401
from .losses import (  # noqa: F401
    autoencoder_loss,
    committor_loss,
    cv_coordinate_gradients,
    eigenfunction_loss,
    fused_mse_loss,
    make_committor_loss,
    make_eigenfunction_loss,
    mse_loss,
    registry,
    timelagged_autoencoder_loss,
)
from .losses import registry as loss_registry  # noqa: F401
from .loop import (  # noqa: F401
    TrainResult,
    fit,
    make_fused_train_step,
    make_train_step,
    masked_optimizer,
    trainable_mask,
)
from .timelagged import (  # noqa: F401
    TICAResult,
    make_vamp_loss,
    tica,
    vamp2_loss,
    vamp2_score,
)

__all__ = [
    "make_train_step",
    "make_fused_train_step",
    "masked_optimizer",
    "fit",
    "TrainResult",
    "trainable_mask",
    "mse_loss",
    "fused_mse_loss",
    "autoencoder_loss",
    "timelagged_autoencoder_loss",
    "cv_coordinate_gradients",
    "eigenfunction_loss",
    "make_eigenfunction_loss",
    "committor_loss",
    "make_committor_loss",
    "loss_registry",
    "TrajectoryDataset",
    "batch_iterator",
    "lagged_pair_iterator",
    "packed_batch_iterator",
    "save_trajectory",
    "coordinate_gradients",
    "force_fn",
    "save_training_state",
    "load_training_state",
    "latest_checkpoint",
    "HLDAResult",
    "hlda",
    "EnsembleResult",
    "stack_models",
    "unstack_model",
    "ensemble_size",
    "ensemble_apply",
    "committee",
    "committee_calibration",
    "calibrated_committee",
    "reinitialized_members",
    "make_ensemble_train_step",
    "fit_ensemble",
    "TICAResult",
    "tica",
    "vamp2_score",
    "vamp2_loss",
    "make_vamp_loss",
]
