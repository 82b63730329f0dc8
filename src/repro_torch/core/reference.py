"""Plain attention oracles of the port (paper Sec. II), the reference's
``src/repro/core/reference.py`` in torch:

* ``exact_attention``  - softmax(QK^T * scale) V in float32 (impl
  ``"exact"`` of :func:`repro_torch.kernels.ops.multihead_attention` and
  the tests' gold answer).
* ``lazy_attention``   - Alg. 1: two passes, lazy softmax division.
* ``fa2_partial`` / ``fa2_attention`` - Alg. 2: FlashAttention-2's
  single-pass streaming with delayed division, block by block.
* ``merge_blocks`` / ``merge_many`` - Eq. (1): combine (m, l, o) triplets
  of disjoint KV blocks, cascaded as the ACC units of Fig. 2.
* ``blockparallel_attention`` - Fig. 2: KV split into FAU blocks, merged.

All take Q (..., Lq, d), K/V (..., Lkv, d) with any leading dims.  These
are oracles: the port's impl ``fa2`` runs the FA-2 kernels (their plain
versions on the CPU), not this block loop; the tests hold the two
against each other.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NEG_INF = -1e30


class PartialAttn(NamedTuple):
    """Per-query partial attention state (m, l, o) for one KV block."""

    m: torch.Tensor  # (..., Lq)        running max score
    l: torch.Tensor  # (..., Lq)        running sum of exponentials
    o: torch.Tensor  # (..., Lq, d)     unnormalized output accumulator


def _scores(q: torch.Tensor, k: torch.Tensor, scale: float) -> torch.Tensor:
    return torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                        k.to(torch.float32)) * scale


def _masked_scores(q, k, causal: bool, scale) -> torch.Tensor:
    """Scaled f32 scores; causal masks key j > i + (Lkv - Lq) to NEG_INF."""
    scale = (1.0 / q.shape[-1] ** 0.5) if scale is None else scale
    s = _scores(q, k, scale)
    if causal:
        lq, lkv = q.shape[-2], k.shape[-2]
        qi = torch.arange(lq, device=q.device)[:, None]
        kj = torch.arange(lkv, device=q.device)[None, :]
        s = torch.where(kj <= qi + (lkv - lq), s, torch.full_like(s, NEG_INF))
    return s


def exact_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = False,
                    scale: float | None = None) -> torch.Tensor:
    """Dense softmax attention in float32 (the gold reference)."""
    p = torch.softmax(_masked_scores(q, k, causal, scale), dim=-1)
    return torch.einsum("...qk,...kd->...qd", p, v.to(torch.float32))


def lazy_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   causal: bool = False,
                   scale: float | None = None) -> torch.Tensor:
    """Alg. 1: the global max first, then the exponentials, their sum and
    the weighted values, divided once at the end."""
    s = _masked_scores(q, k, causal, scale)
    m = torch.amax(s, dim=-1, keepdim=True)          # pass 1: global max
    f = torch.exp(s - m)                             # pass 2: accumulate
    o = torch.einsum("...qk,...kd->...qd", f, v.to(torch.float32))
    return o / torch.sum(f, dim=-1, keepdim=True)


def fa2_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                scale: float | None = None, mask: torch.Tensor | None = None,
                causal: bool = False, kv_offset: int = 0,
                q_offset: int | None = None, block: int = 128) -> PartialAttn:
    """Alg. 2's inner loop over one KV span, returning (m, l, o).

    KV streams in blocks of ``block`` with the online max and rescale
    (lines 4-6 of Alg. 2); the span is zero-padded to whole blocks and
    the padded keys masked.  Causality comes per block from the global
    indices: ``kv_offset`` is the index of k[..., 0, :] and query i sits
    at ``q_offset + i`` (default: the suffix of this span).  ``mask``
    ((..., Lq, Lkv) boolean) adds an irregular pattern.  A block in which
    every key is masked leaves the state as it was.
    """
    d = q.shape[-1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    lq, lkv = q.shape[-2], k.shape[-2]
    qf = q.to(torch.float32)
    batch_shape = tuple(q.shape[:-2]) + (lq,)
    nblk = (lkv + block - 1) // block
    pad = nblk * block - lkv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        if mask is not None:
            mask = torch.nn.functional.pad(mask, (0, pad))
    q_ids = None
    if causal:
        if q_offset is None:
            q_offset = kv_offset + lkv - lq
        q_ids = q_offset + torch.arange(lq, device=q.device)

    dev = q.device
    m = torch.full(batch_shape, NEG_INF, dtype=torch.float32, device=dev)
    ell = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
    o = torch.zeros(batch_shape + (d,), dtype=torch.float32, device=dev)
    for ib in range(nblk):
        sl = slice(ib * block, (ib + 1) * block)
        s = torch.einsum("...qd,...kd->...qk", qf,
                         k[..., sl, :].to(torch.float32)) * scale
        kv_ids = kv_offset + ib * block + torch.arange(block, device=dev)
        valid = kv_ids < kv_offset + lkv
        if causal:
            valid = valid[None, :] & (kv_ids[None, :] <= q_ids[:, None])
        if mask is not None:
            valid = valid & mask[..., sl]
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        # A fully masked block keeps m at NEG_INF and adds nothing.
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))  # e^{m_{i-1}-m_i}
        p = torch.exp(s - m_new[..., None])                 # e^{s_i - m_i}
        p = torch.where(valid & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        ell = ell * alpha + torch.sum(p, dim=-1)
        o = o * alpha[..., None] + torch.einsum(
            "...qk,...kd->...qd", p, v[..., sl, :].to(torch.float32))
        m = m_new
    return PartialAttn(m, ell, o)


def fa2_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, scale: float | None = None,
                  block: int = 128) -> torch.Tensor:
    """Alg. 2: FlashAttention-2 with delayed softmax division."""
    part = fa2_partial(q, k, v, scale=scale, causal=causal, block=block)
    return part.o / part.l[..., None]


def merge_blocks(a: PartialAttn, b: PartialAttn) -> PartialAttn:
    """Eq. (1): merge two partial triplets from disjoint KV blocks."""
    m = torch.maximum(a.m, b.m)
    ea = torch.exp(a.m - m)
    eb = torch.exp(b.m - m)
    return PartialAttn(m, a.l * ea + b.l * eb,
                       a.o * ea[..., None] + b.o * eb[..., None])


def merge_many(parts: list[PartialAttn]) -> PartialAttn:
    """Cascaded ACC merge (Fig. 2's vertical pipeline)."""
    acc = parts[0]
    for p in parts[1:]:
        acc = merge_blocks(acc, p)
    return acc


def blockparallel_attention(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, num_blocks: int,
                            causal: bool = False,
                            scale: float | None = None) -> torch.Tensor:
    """Fig. 2: KV split into ``num_blocks`` FAU blocks, merged by ACC
    units; causality by the global rows (the queries are the suffix of
    the whole span)."""
    lkv = k.shape[-2]
    if lkv % num_blocks:
        raise ValueError(f"{lkv} keys do not split into {num_blocks} blocks")
    span = lkv // num_blocks
    parts = [fa2_partial(q, k[..., i * span:(i + 1) * span, :],
                         v[..., i * span:(i + 1) * span, :], scale=scale,
                         causal=causal, kv_offset=i * span,
                         q_offset=lkv - q.shape[-2])
             for i in range(num_blocks)]
    merged = merge_many(parts)
    return merged.o / merged.l[..., None]
