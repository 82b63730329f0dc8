"""Block-FAU triplet algebra: the Eq. (16) merge and the final normalize.

Every paged attention kernel returns the unnormalized triplet (o~, m, l)
per query row.  ``merge_partials`` combines triplets with the
log-domain ACC rule, and ``finalize_decode`` divides by ``l`` - a float
divide on the fa2 rail, LogDiv on the hfa rail.  Both stay plain torch,
as the reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmath

# Finite, so (m_prev - m_new) stays finite on fully masked rows.
NEG_INF = -1e30


def merge_partials(o_parts: torch.Tensor, m_parts: torch.Tensor,
                   l_parts: torch.Tensor, *, use_hfa: bool = False):
    """Eq. (1)/(16): merge P block-FAU triplets (the ACC cascade).

    o_parts (P, ..., d); m_parts / l_parts (P, ...).  With ``use_hfa``
    the rescale factors go through the FIX16 quantized log-domain path.
    """
    m_n = torch.amax(m_parts, dim=0)
    dm = torch.clamp(m_parts - m_n[None], max=0.0)
    if use_hfa:
        w = bitmath.exp2_hfa_rail(bitmath.quant_rail(dm))
    else:
        w = torch.exp(dm)
    l_n = torch.sum(l_parts * w, dim=0)
    o_n = torch.sum(o_parts * w[..., None], dim=0)
    return o_n, m_n, l_n


def finalize_decode(o_acc: torch.Tensor, l: torch.Tensor, *,
                    use_hfa: bool = False) -> torch.Tensor:
    """Final normalization: float divide (FA-2) or LogDiv (H-FA).  Rows
    with ``l <= 0`` (nothing visible) come out zero."""
    dead = l <= 0.0
    safe = torch.where(dead, torch.ones_like(l), l)
    if use_hfa:
        recip = bitmath.recip_logdiv(safe)
        recip = torch.where(dead, torch.zeros_like(recip), recip)
        return o_acc * recip[..., None]
    return torch.where(dead[..., None], torch.zeros_like(o_acc),
                       o_acc / safe[..., None])
