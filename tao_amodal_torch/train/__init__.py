"""Training: the detector + expander loss and the Siamese losses, anchor
targets and augmentations, the DiMP meta-training actor, the samplers,
the optimizers and schedules, the single-device train step, the trainer
loop with checkpoint/resume and fail-safe retry, and PasteNOcclude."""

from tao_amodal_torch.train.loop import Trainer, TrainConfig  # noqa: F401
from tao_amodal_torch.train.optim import (  # noqa: F401
    log_schedule,
    warmup_log_schedule,
    staged_unfreeze_mask,
)
from tao_amodal_torch.train.anchor_target import (  # noqa: F401
    assign_anchor_targets,
)
