"""Device policy of the port.

Every entry point runs on the card unless its caller passes
``device="cpu"``; :func:`resolve_device` raises when a CUDA device is
asked for and none exists, rather than moving to the CPU.  It also pins
the float32 numerics: TF32 is off for matrix products
(``torch.backends.cuda.matmul.allow_tf32``) and for cuDNN
(``torch.backends.cudnn.allow_tf32``), and bf16 products may not use
reduced-precision reductions - the reference computes in full f32
accumulation.
"""
from __future__ import annotations

import torch


def set_numerics() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def resolve_device(device=None) -> torch.device:
    """``device`` or the default ``cuda`` (with its index resolved);
    raises if CUDA is asked for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device available: this entry point runs on the "
                "card by default; pass device='cpu' to run the plain "
                "versions")
        if dev.index is None:       # "cuda" means the current card
            dev = torch.device("cuda", torch.cuda.current_device())
    set_numerics()
    return dev
