"""VAR training: index streams, loss and optimizer, the train step, and
checkpoints with auto-resume."""
from fpqvar_tpu_torch.train.data import (  # noqa: F401
    dist_infinite_batches,
    eval_shard,
    infinite_batches,
)
from fpqvar_tpu_torch.train.resume import (  # noqa: F401
    auto_resume,
    make_manager,
    save_train_state,
)
from fpqvar_tpu_torch.train.trainer import (  # noqa: F401
    TrainState,
    cross_entropy_loss,
    lr_wd_schedule,
    make_train_state,
    train_step,
)
