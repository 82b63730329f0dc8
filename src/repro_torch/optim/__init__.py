"""Optimizers, schedules and gradient compression of the port."""
from repro_torch.optim.adafactor import Adafactor  # noqa: F401
from repro_torch.optim.adamw import AdamW  # noqa: F401
from repro_torch.optim.compression import compress_gradients  # noqa: F401
from repro_torch.optim.schedule import constant, warmup_cosine  # noqa: F401


def build_optimizer(cfg, lr_schedule):
    """Optimizer per the arch config: Adafactor for the configs that name
    it (the >=100B archs), over the reference's layer stacking; else
    AdamW, with f32 master copies only when the params are low
    precision."""
    if cfg.optimizer == "adafactor":
        from repro_torch.models.transformer import period_pattern
        return Adafactor(lr_schedule, period=period_pattern(cfg)[2])
    return AdamW(lr_schedule, master_fp32=(cfg.param_dtype != "float32"))
