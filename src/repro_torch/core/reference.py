"""Plain attention oracle of the port: dense softmax in float32.

``exact_attention`` is the reference's ``core.reference.exact_attention``
(impl ``"exact"`` of :func:`repro_torch.kernels.ops.multihead_attention`
and the tests' gold answer).  The reference's other algorithms here
(lazy softmax, the jnp FA-2 and the block merge) are not ported: the
port runs FA-2 through its kernels.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """softmax(Q K^T * scale) V in float32 over (..., Lq, d) x (..., Lkv, d);
    causal masks key j > i + (Lkv - Lq)."""
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    s = torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        lq, lkv = q.shape[-2], k.shape[-2]
        qi = torch.arange(lq, device=q.device)[:, None]
        kj = torch.arange(lkv, device=q.device)[None, :]
        s = torch.where(kj <= qi + (lkv - lq), s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.to(torch.float32))
