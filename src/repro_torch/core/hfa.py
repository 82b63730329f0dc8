"""Bit-accurate H-FA attention emulation (paper Sec. IV-V).

The datapath-faithful model of the proposed hardware, as the reference's
``src/repro/core/hfa.py``: attention scores, running maxima and score
differences in BFloat16 floating point; the fused (l, o) accumulation,
the cross-block ACC merge and the final normalization in the FIX16
logarithmic domain of :mod:`repro_torch.core.lns`.

* ``hfa_attention``     - H-FA attention for one KV span (one streaming
  FAU, Alg. 2 + Eq. 14).
* ``hfa_partial``       - the FAU's partial state (m, sign, raw) without
  the final LogDiv; ``hfa_partial_scores`` the same walk fed given bf16
  scores.
* ``acc_merge``         - the log-domain ACC merge of two partials
  (Eq. 16).
* ``hfa_blockparallel`` - Fig. 2: p parallel FAU blocks, cascaded ACC
  merge, LogDiv.
* ``logdiv``            - Eq. (15) + (22): o / l as a fixed-point
  subtraction, back to BFloat16.

The streaming state follows Eq. (12): O_i = [l_i, o_i] with V_i = [1,
v_i], kept as (sign, raw) LNS tensors of width d+1.  The reference scans
over the keys (``lax.scan``); here it is a Python loop over the key
axis.  This module is the plain version of the per-element datapath
kernel (:mod:`repro_torch.kernels.hfa_datapath`) and the port's impl
``hfa`` on the CPU.

Every function takes the reference's ``cfg`` (an ``lns.LNSConfig``, the
Table III ablations), default ``lns.DEFAULT``.  These functions are
plain torch on any device; no impl route hands a kernel a ``cfg`` (the
datapath kernel computes ``DEFAULT`` only, as the reference's does).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import lns
from repro_torch.core.numerics import LOG_ZERO, to_bf16

NEG_INF = -1e30


class HFAPartial(NamedTuple):
    """Partial FAU state: float max + LNS fused accumulator O = [l, o]."""

    m: torch.Tensor        # (..., Lq)       float32 (carries BF16 values)
    sign: torch.Tensor     # (..., Lq, d+1)  int32 {0, 1}
    raw: torch.Tensor      # (..., Lq, d+1)  FIX16 rail (float32, integers)


def _empty_state(batch_shape: tuple[int, ...], d: int,
                 device) -> HFAPartial:
    return HFAPartial(
        m=torch.full(batch_shape, NEG_INF, dtype=torch.float32,
                     device=device),
        sign=torch.zeros(batch_shape + (d + 1,), dtype=torch.int32,
                         device=device),
        raw=torch.full(batch_shape + (d + 1,), float(LOG_ZERO),
                       dtype=torch.float32, device=device),
    )


def _rescale(raw: torch.Tensor, q_d: torch.Tensor) -> torch.Tensor:
    """raw + q_d on the rail, saturated; a zero stays zero."""
    out = lns.clamp_rail(raw + q_d)
    return torch.where(raw <= LOG_ZERO, torch.full_like(out, float(LOG_ZERO)),
                       out)


def hfa_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                scale: float | None = None, mask: torch.Tensor | None = None,
                cfg: lns.LNSConfig = lns.DEFAULT,
                init: HFAPartial | None = None) -> HFAPartial:
    """Stream one KV span through the FAU (Alg. 2 with Eq. 14 updates).

    q (..., Lq, d); k, v (..., Lkv, d).  ``mask`` is an optional (...,
    Lq, Lkv) boolean: masked keys are skipped exactly (the hardware does
    not clock them in).  ``init`` carries in a previous partial state.
    """
    d = q.shape[-1]
    scale_v = (1.0 / d ** 0.5) if scale is None else scale
    # Scores for the whole span in BF16 (the FP half of the datapath).
    s_all = torch.einsum("...qd,...kd->...qk", q.to(torch.float32),
                         k.to(torch.float32)) * scale_v
    return hfa_partial_scores(to_bf16(s_all).to(torch.float32), v,
                              mask=mask, cfg=cfg, init=init)


def hfa_partial_scores(s_all: torch.Tensor, v: torch.Tensor, *,
                       mask: torch.Tensor | None = None,
                       cfg: lns.LNSConfig = lns.DEFAULT,
                       init: HFAPartial | None = None) -> HFAPartial:
    """:func:`hfa_partial` fed the bf16-valued f32 scores s_all (..., Lq,
    Lkv) - already scaled and rounded - in place of its QK^T; the same
    walk.  Fed :func:`hfa_partial`'s own scores it returns the same state
    bit for bit."""
    d = v.shape[-1]
    batch_shape = tuple(s_all.shape[:-1])
    state = init if init is not None else _empty_state(batch_shape, d,
                                                       v.device)
    valid_all = (torch.ones(s_all.shape, dtype=torch.bool, device=v.device)
                 if mask is None else torch.broadcast_to(mask, s_all.shape))
    # V_i = [1, v_i] in LNS, for every key at once: (..., Lkv, d+1).
    vb = v.to(torch.bfloat16)
    v_ext = torch.cat([torch.ones(vb.shape[:-1] + (1,), dtype=vb.dtype,
                                  device=vb.device), vb], dim=-1)
    sgn_v_all, raw_v_all = lns.lns_from_bf16(v_ext, cfg)

    m_prev, sgn_prev, raw_prev = state
    for i in range(s_all.shape[-1]):
        s_i = s_all[..., i]                                  # (..., Lq)
        valid_i = valid_all[..., i]
        m_new = torch.maximum(m_prev, s_i)
        live = valid_i & (m_new > NEG_INF / 2)
        q_dm = lns.quant_scorediff(m_prev - m_new, cfg)     # Eq. (14b)
        q_ds = lns.quant_scorediff(s_i - m_new, cfg)        # Eq. (14c)
        # A: the rescaled previous accumulator.
        a_raw = _rescale(raw_prev, q_dm[..., None])
        # B: the incoming [1, v_i] times the exp term, broadcast over Lq.
        raw_v = raw_v_all[..., i, None, :]                  # (..., 1, d+1)
        b_raw = torch.broadcast_to(_rescale(raw_v, q_ds[..., None]),
                                   raw_prev.shape)
        sgn_b = torch.broadcast_to(sgn_v_all[..., i, None, :],
                                   sgn_prev.shape)
        sgn_new, raw_new = lns.lns_add(sgn_prev, a_raw, sgn_b, b_raw, cfg)
        m_prev = torch.where(live, m_new, m_prev)
        sgn_prev = torch.where(live[..., None], sgn_new, sgn_prev)
        raw_prev = torch.where(live[..., None], raw_new, raw_prev)
    return HFAPartial(m_prev, sgn_prev, raw_prev)


def logdiv(state: HFAPartial,
           cfg: lns.LNSConfig = lns.DEFAULT) -> torch.Tensor:
    """Eq. (15)+(22): attention = o_N / l_N as an LNS subtraction ->
    BFloat16."""
    raw_l, sgn_l = state.raw[..., :1], state.sign[..., :1]
    raw_o, sgn_o = state.raw[..., 1:], state.sign[..., 1:]
    raw_attn = lns.clamp_rail(raw_o - raw_l)
    sgn_attn = torch.bitwise_xor(sgn_o, sgn_l)
    empty = (raw_l <= LOG_ZERO) | (raw_o <= LOG_ZERO)
    raw_attn = torch.where(empty, torch.full_like(raw_attn, float(LOG_ZERO)),
                           raw_attn)
    return lns.lns_to_bf16(sgn_attn, raw_attn, cfg)


def acc_merge(a: HFAPartial, b: HFAPartial,
              cfg: lns.LNSConfig = lns.DEFAULT) -> HFAPartial:
    """Eq. (16): log-domain ACC merge of two partial FAU states.  A side
    that never saw a key has m = NEG_INF; max() recovers the other."""
    m_n = torch.maximum(a.m, b.m)
    a_raw = _rescale(a.raw, lns.quant_scorediff(a.m - m_n, cfg)[..., None])
    b_raw = _rescale(b.raw, lns.quant_scorediff(b.m - m_n, cfg)[..., None])
    sgn, raw = lns.lns_add(a.sign, a_raw, b.sign, b_raw, cfg)
    return HFAPartial(m_n, sgn, raw)


def causal_mask(lq: int, kv_ids: torch.Tensor, lkv: int) -> torch.Tensor:
    """(Lq, n) mask of keys ``kv_ids`` visible to each query row when the
    queries are the last Lq positions of Lkv: key j <= i + (Lkv - Lq)."""
    qi = torch.arange(lq, device=kv_ids.device)[:, None]
    return kv_ids[None, :] <= qi + (lkv - lq)


def hfa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = False, scale: float | None = None,
                  cfg: lns.LNSConfig = lns.DEFAULT) -> torch.Tensor:
    """Full H-FA attention for one KV span (a single FAU): (..., Lq, d)
    bf16."""
    mask = None
    if causal:
        lkv = k.shape[-2]
        mask = causal_mask(q.shape[-2], torch.arange(lkv, device=q.device),
                           lkv)
    return logdiv(hfa_partial(q, k, v, scale=scale, mask=mask, cfg=cfg),
                  cfg)


def hfa_blockparallel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      num_blocks: int, causal: bool = False,
                      scale: float | None = None,
                      cfg: lns.LNSConfig = lns.DEFAULT) -> torch.Tensor:
    """Fig. 2: ``num_blocks`` parallel FAU blocks over equal KV spans and
    a cascaded log-domain ACC merge, then LogDiv."""
    lkv, lq = k.shape[-2], q.shape[-2]
    if lkv % num_blocks:
        raise ValueError(f"{lkv} keys do not split into {num_blocks} blocks")
    span = lkv // num_blocks
    parts = []
    for i in range(num_blocks):
        sl = slice(i * span, (i + 1) * span)
        mask = None
        if causal:
            mask = causal_mask(lq, torch.arange(i * span, (i + 1) * span,
                                                device=q.device), lkv)
        parts.append(hfa_partial(q, k[..., sl, :], v[..., sl, :],
                                 scale=scale, mask=mask, cfg=cfg))
    acc = parts[0]
    for p in parts[1:]:
        acc = acc_merge(acc, p, cfg)
    return logdiv(acc, cfg)
