"""LR schedules: functions of the (1-based) step count, as in the
reference, evaluated on the host in Python floats."""
from __future__ import annotations

import math


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``."""
    def schedule(step) -> float:
        step = float(step)
        if step < warmup:
            return peak_lr * step / max(warmup, 1)
        t = min(max((step - warmup) / max(total - warmup, 1), 0.0), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * t))
        return peak_lr * (floor + (1 - floor) * cos)
    return schedule


def constant(lr: float):
    return lambda step: lr
