"""Optimizers, schedules and gradient compression of the port."""
from repro_torch.optim.adamw import AdamW  # noqa: F401
from repro_torch.optim.compression import compress_gradients  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401


def build_optimizer(cfg, lr_schedule):
    """Optimizer per the arch config.  AdamW keeps f32 master copies only
    when the params are low precision.  Adafactor (the reference's
    choice for the >=100B archs) is not ported yet (ROADMAP.md Queue 1
    item 12)."""
    if cfg.optimizer == "adafactor":
        raise NotImplementedError("adafactor is not ported yet "
                                  "(ROADMAP.md Queue 1 item 12)")
    return AdamW(lr_schedule, master_fp32=(cfg.param_dtype != "float32"))
