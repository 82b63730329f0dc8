"""Dense flash-decode and the block-FAU triplet algebra.

``decode_partial`` replaces the Pallas kernel
``src/repro/kernels/decode.py::_decode_kernel`` (wrapper
``decode_partial_pallas``): the G query heads that share one KV head
against a contiguous cache, streamed in 128-key tiles with the Alg. 2
online update and a ``kv_len`` mask, returning the unnormalized triplet
(o~, m, l).  On a CUDA tensor it launches ``dense_decode_fwd_v2`` of
``csrc/dense_decode.cu`` and counts the launch in :data:`launches`; on a
CPU tensor it runs :func:`decode_partial_plain`.  One new token per
(sequence, KV head) does 2 flops per K/V byte, so the kernel is bound by
the bytes of the live K/V rows; it reads them in place from the
serving ring, (B, S, Hkv, d) with its strides, through a cp.async ring,
and stops at the last tile that holds a key below ``kv_len``, where the
reference pads and copies the ring per call.  On the FA-2 rail it splits
each walk across blocks into runs of whole tiles and merges them by Eq.
16 in the kernel (``kernels/ref.py::dense_decode_split_model`` models
it).  On the hfa rail the result depends on where the online rescales
fall (alpha and p are quantized per tile), so the kernel walks exactly
the reference's 128-key tiles, unsplit.

Every paged attention kernel also returns the unnormalized triplet per
query row.  ``merge_partials`` combines triplets with the log-domain
ACC rule, and ``finalize_decode`` divides by ``l`` - a float divide on
the fa2 rail, LogDiv on the hfa rail.  Both stay plain torch, as the
reference leaves them to XLA.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmath, cuda_lib

# Finite, so (m_prev - m_new) stays finite on fully masked rows.
NEG_INF = -1e30
BLOCK_KV = 128        # the reference's tile, where the hfa rail rescales
launches = 0


def decode_partial_plain(q, k, v, *, scale=None, block_kv=BLOCK_KV,
                         kv_len=None, use_hfa=False):
    """The kernel's math in torch: q (..., G, d) against k, v (..., S,
    d), walked in ``block_kv``-key tiles (S padded up to a multiple),
    keys at or past ``kv_len`` masked as the kernel masks them.
    Returns o~ (..., G, d), m and l (..., G), all f32; with nothing
    visible, (0, NEG_INF, 0)."""
    d, s_len = q.shape[-1], k.shape[-2]
    scale_v = (1.0 / d ** 0.5) if scale is None else scale
    kv_len = s_len if kv_len is None else int(kv_len)
    qf = q.to(torch.float32)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for k0 in range(0, s_len, block_kv):
        kb = k[..., k0:k0 + block_kv, :].to(torch.float32)
        vb = v[..., k0:k0 + block_kv, :].to(torch.float32)
        pad = block_kv - kb.shape[-2]
        if pad:
            kb = torch.nn.functional.pad(kb, (0, 0, 0, pad))
            vb = torch.nn.functional.pad(vb, (0, 0, 0, pad))
        s = torch.einsum("...gd,...kd->...gk", qf, kb) * scale_v
        mask = (k0 + torch.arange(block_kv, device=q.device)) < min(kv_len,
                                                                    s_len)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        dm = torch.minimum(m - m_new, torch.zeros_like(m))
        if use_hfa:
            alpha = bitmath.exp2_hfa_rail(bitmath.quant_rail(dm))
            p = bitmath.exp2_hfa_rail(bitmath.quant_rail(s - m_new[..., None]))
        else:
            alpha = torch.exp(dm)
            p = torch.exp(s - m_new[..., None])
        p = torch.where(mask & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("...gk,...kd->...gd",
                                                    p, vb)
        m = m_new
    return acc, m, l


def decode_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   scale: float | None = None, block_kv: int = BLOCK_KV,
                   kv_len: int | None = None, use_hfa: bool = False):
    """Partial decode attention, one triplet per query row.

    q (..., G, d) grouped queries (G query heads per KV head); k, v
    (..., S, d) with the same one or two leading dims - any strided view
    whose last dim is contiguous, e.g. the serving ring (B, S, Hkv, d)
    seen as (B, Hkv, S, d).  ``kv_len`` (a host int, default S) masks
    the unwritten slots.  Returns o~ (..., G, d), m and l (..., G), f32.
    """
    if q.device.type == "cpu":
        return decode_partial_plain(q, k, v, scale=scale, block_kv=block_kv,
                                    kv_len=kv_len, use_hfa=use_hfa)
    if q.device.type != "cuda":
        raise ValueError(f"decode_partial: no kernel for {q.device}")
    if block_kv != BLOCK_KV:
        raise ValueError(f"decode_partial: the kernel's rescale tile is "
                         f"{BLOCK_KV} keys, got block_kv {block_kv}")
    global launches
    d, s_len = q.shape[-1], k.shape[-2]
    out = cuda_lib.launch_dense_decode(
        q, k, v, scale=(1.0 / d ** 0.5) if scale is None else scale,
        kv_len=s_len if kv_len is None else int(kv_len), use_hfa=use_hfa)
    launches += 1
    return out


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
