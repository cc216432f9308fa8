"""Training on the port (ports of ``molann_tpu/train/``): data and the
lagged-pair iterator, the losses (MSE, autoencoder, eigenfunction,
committor, VAMP-2), TICA, HLDA, committees, the loop and checkpoints, the
coordinate-gradient oracle (:mod:`.forces`), and optax's update rules in
``torch.optim`` form (:mod:`.optim`). ``packed_batch_iterator`` and
data-parallel training are still to be ported (ROADMAP.md, queue 2)."""

from .checkpoint import (  # noqa: F401
    latest_checkpoint,
    load_training_state,
    save_training_state,
)
from .data import (  # noqa: F401
    TrajectoryDataset,
    batch_iterator,
    lagged_pair_iterator,
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
