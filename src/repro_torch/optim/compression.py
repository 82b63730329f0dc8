"""Int8 gradient compression with error feedback (the reference's
``src/repro/optim/compression.py``): each gradient plus its carried
error is quantized to int8 with a per-tensor scale, dequantized, and
the quantization error is carried to the next step."""
from __future__ import annotations

import torch


def init_error(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


@torch.no_grad()
def compress_gradients(grads: dict, error: dict) -> tuple[dict, dict]:
    """Returns (dequantized int8 grads, new error feedback state)."""
    deq_all, err_all = {}, {}
    for name, g in grads.items():
        g = g.to(torch.float32) + error[name]
        amax = torch.amax(torch.abs(g))
        scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
        q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
        deq = q.to(torch.float32) * scale
        deq_all[name], err_all[name] = deq, g - deq
    return deq_all, err_all
