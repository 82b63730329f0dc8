"""AdamW with f32 moments and, for low-precision params, f32 master
weights - the reference's update rule (``src/repro/optim/adamw.py``:
b2 0.95, bias-corrected moments, decoupled weight decay on the f32
base) as plain tensor code.  ``torch.optim.AdamW`` differs from it (it
decays before the step, and on the low-precision param), so it is not
used.

Params, grads and state are dicts keyed by parameter name.  ``update``
writes the new values into the params and the state in place (the
reference returns new trees) and returns (params, state).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr_schedule: Callable[[int], float]
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    master_fp32: bool = True

    @torch.no_grad()
    def init(self, params: dict) -> dict:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        state = {"m": {k: zeros(p) for k, p in params.items()},
                 "v": {k: zeros(p) for k, p in params.items()},
                 "step": 0}
        if self.master_fp32:
            state["master"] = {k: p.detach().to(torch.float32).clone()
                               for k, p in params.items()}
        return state

    @torch.no_grad()
    def update(self, grads: dict, state: dict, params: dict):
        step = state["step"] + 1
        lr = self.lr_schedule(step)
        b1, b2 = self.b1, self.b2
        b1c = 1.0 - b1 ** step
        b2c = 1.0 - b2 ** step
        master = state.get("master")
        for name, p in params.items():
            g = grads[name].to(torch.float32)
            m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            base = master[name] if master is not None else p.to(torch.float32)
            upd = (m / b1c) / (torch.sqrt(v / b2c) + self.eps)
            new = base - lr * (upd + self.weight_decay * base)
            if master is not None:
                master[name].copy_(new)
            p.copy_(new.to(p.dtype))
        state["step"] = step
        return params, state
