"""Plain oracles of the dense attention kernels.

* ``ref_fa2``     - FA-2 is exact attention in f32.
* ``ref_hfa_mxu`` - the tile-level H-FA oracle: the same 128-key tile
  walk, diagonal skip, BF16 score rounding and rail ops as the H-FA
  kernel (``kernels/hfa.py``).  It is the kernel's plain version and,
  under autograd, its backward: the rail functions carry the
  straight-through estimator (``bitmath._ste``), as in the reference.
* ``ref_hfa_walk`` - the same walk fed precomputed bf16 scores (the
  checks feed it the scores the tensor-core kernel formed).
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
    lkv = k.shape[-2]
    pad = (-lkv) % block_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    qf = q.to(torch.float32)

    def scores(k0):
        kb = k[..., k0:k0 + block_kv, :].to(torch.float32)
        s = torch.einsum("...qd,...kd->...qk", qf, kb) * scale_v
        return s.to(torch.bfloat16).to(torch.float32)  # BF16 score datapath
    return _hfa_walk(scores, v, q.shape[-2], causal=causal,
                     block_kv=block_kv, q_offset=q_offset)


def ref_hfa_walk(s: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                 block_kv: int = 128, q_offset: int | None = None):
    """The walk of :func:`ref_hfa_mxu` fed precomputed bf16 scores s
    (..., Lq, Lkv) - already scaled and rounded, such as the ones the
    tensor-core kernel writes out - in place of its QK^T einsum; the
    same masks, tiles, rail and finalize.  Fed ``ref_hfa_mxu``'s own
    scores it returns ``ref_hfa_mxu``'s output bit for bit."""
    pad = (-s.shape[-1]) % block_kv
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    return _hfa_walk(lambda k0: s[..., k0:k0 + block_kv].to(torch.float32),
                     v, s.shape[-2], causal=causal, block_kv=block_kv,
                     q_offset=q_offset)


def _hfa_walk(scores, v, lq, *, causal, block_kv, q_offset):
    """The H-FA tile walk over v (..., Lkv, d): ``scores(k0)`` gives the
    bf16-valued f32 score tile of keys k0 .. k0 + block_kv (zero-padded
    past Lkv, where the mask hides it)."""
    lkv, d = v.shape[-2], v.shape[-1]
    pad = (-lkv) % block_kv
    if pad:
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if q_offset is None:
        q_offset = lkv - lq
    batch = v.shape[:-2]
    m = torch.full(batch + (lq,), NEG_INF, dtype=torch.float32,
                   device=v.device)
    l = torch.zeros(batch + (lq,), dtype=torch.float32, device=v.device)
    acc = torch.zeros(batch + (lq, d), dtype=torch.float32, device=v.device)
    q_ids = q_offset + torch.arange(lq, device=v.device)[:, None]
    for k0 in range(0, lkv + pad, block_kv):
        if causal and k0 > q_offset + lq - 1:
            break          # the kernel skips blocks above the diagonal
        vb = v[..., k0:k0 + block_kv, :].to(torch.float32)
        s = scores(k0)
        kv_ids = k0 + torch.arange(block_kv, device=v.device)[None, :]
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
