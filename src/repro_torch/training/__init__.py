from repro_torch.training.loss import lm_loss  # noqa: F401
from repro_torch.training.optimizer import (  # noqa: F401
    OptimizerConfig, adamw_init, adamw_update, lr_at,
)
from repro_torch.training.steps import (  # noqa: F401
    init_dp_state,
    init_train_state,
    make_dp_compressed_step,
    make_train_step,
)
