"""Training driver of the port."""
from repro_torch.runtime.trainer import (  # noqa: F401
    Trainer, TrainerConfig, make_train_step)
