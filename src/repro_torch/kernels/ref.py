"""Plain oracles of the dense attention kernels.

* ``ref_fa2``     - FA-2 is exact attention in f32.
* ``ref_hfa_mxu`` - the tile-level H-FA oracle: the same 128-key tile
  walk, diagonal skip, BF16 score rounding and rail ops as the H-FA
  kernel (``kernels/hfa.py``).  It is the kernel's plain version and,
  under autograd, its backward: the rail functions carry the
  straight-through estimator (``bitmath._ste``), as in the reference.
* ``ref_decode_partial`` - the streamed decode triplet over one KV span
  (the reference's oracle of ``decode_partial_pallas``; no ``kv_len``
  mask).
* ``ref_hfa_datapath`` - the bit-accurate ``core.hfa`` emulation.
"""
from __future__ import annotations

import torch

from repro_torch.core import hfa as core_hfa
from repro_torch.core import reference
from repro_torch.kernels import bitmath
from repro_torch.kernels.decode import decode_partial_plain

NEG_INF = -1e30


def ref_fa2(q, k, v, *, causal=False, scale=None):
    """Oracle for the FA-2 kernel: exact attention in f32."""
    return reference.exact_attention(q, k, v, causal=causal, scale=scale)


def ref_hfa_mxu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = False, scale: float | None = None,
                block_kv: int = 128, q_offset: int | None = None):
    """H-FA over (..., Lq, d) x (..., Lkv, d) -> (..., Lq, d) f32.

    KV is walked in blocks of ``block_kv`` (the kernel's sequential
    axis), all queries at once.  Lkv may be a non-multiple of
    ``block_kv`` (padded and masked, as the kernel sees its padding);
    ``q_offset`` is the causal position of query 0 (default Lkv - Lq).
    """
    d = q.shape[-1]
    scale_v = (1.0 / d ** 0.5) if scale is None else scale
    lq, lkv = q.shape[-2], k.shape[-2]
    pad = (-lkv) % block_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if q_offset is None:
        q_offset = lkv - lq
    qf = q.to(torch.float32)
    batch = q.shape[:-2]
    m = torch.full(batch + (lq,), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(batch + (lq,), dtype=torch.float32, device=q.device)
    acc = torch.zeros(batch + (lq, d), dtype=torch.float32, device=q.device)
    q_ids = q_offset + torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lkv + pad, block_kv):
        if causal and k0 > q_offset + lq - 1:
            break          # the kernel skips blocks above the diagonal
        kb = k[..., k0:k0 + block_kv, :].to(torch.float32)
        vb = v[..., k0:k0 + block_kv, :].to(torch.float32)
        s = torch.einsum("...qd,...kd->...qk", qf, kb) * scale_v
        s = s.to(torch.bfloat16).to(torch.float32)     # BF16 score datapath
        kv_ids = k0 + torch.arange(block_kv, device=q.device)[None, :]
        mask = (kv_ids < lkv).expand(lq, block_kv)
        if causal:
            mask = mask & (kv_ids <= q_ids)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = bitmath.exp2_hfa_rail(bitmath.quant_rail(
            torch.minimum(m - m_new, torch.zeros_like(m))))
        p = bitmath.exp2_hfa_rail(bitmath.quant_rail(s - m_new[..., None]))
        p = torch.where(mask & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("...qk,...kd->...qd",
                                                    p, vb)
        m = m_new
    dead = l <= 0.0
    safe = torch.where(dead, torch.ones_like(l), l)
    recip = bitmath.recip_logdiv(safe)
    recip = torch.where(dead, torch.zeros_like(recip), recip)
    return acc * recip[..., None]


def ref_decode_partial(q, k, v, *, scale=None, use_hfa=False, block_kv=128):
    """Oracle of the dense decode kernel: the streamed triplet (o~, m, l)
    of q (..., G, d) over k, v (..., S, d) - the kernel's plain version
    with no ``kv_len`` mask."""
    return decode_partial_plain(q, k, v, scale=scale, block_kv=block_kv,
                                use_hfa=use_hfa)


def ref_hfa_datapath(q, k, v, *, causal=False, scale=None):
    """Oracle of the per-element datapath kernel: the bit-accurate
    ``core.hfa`` emulation, (..., Lq, d) bf16."""
    return core_hfa.hfa_attention(q, k, v, causal=causal, scale=scale)
