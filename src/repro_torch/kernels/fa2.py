"""FA-2 forward: kernel wrapper and plain version.

``fa2_forward`` replaces the Pallas kernel
``src/repro/kernels/fa2.py::_fa2_kernel`` (wrapper ``fa2_pallas``).  On
a CUDA tensor it launches a hand-written kernel on the fa2 rail and
counts the launch in :data:`launches`; on a CPU tensor it runs
:func:`fa2_forward_plain`.  The dtype picks the kernel
(``cuda_lib.launch_dense_fwd``): bf16 inputs - every full-width path -
go to the tensor-core kernel of ``csrc/dense_attention_tc.cu``, f32
inputs to the CUDA-core kernel of ``csrc/dense_attention.cu``.  The
causal forward does 4·BH·L²·d/2 flops on (BH, L, d) inputs, so at
training lengths the card's arithmetic bounds it, not its memory.  The
tensor-core kernel forms S = QKᵀ with wgmma from TMA-loaded bf16 tiles
(products exact in f32) and P·V as two wgmmas, on p split into bf16
hi + lo (within 2^-16 of p); tiles above the diagonal and past
``kv_len`` are skipped.  It takes d 64 and 128; bf16 inputs at d 32 and
96 are zero-padded to the next of those (:func:`pad_head_dim`), which
is exact, and the output is sliced back.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib

NEG_INF = -1e30
launches = 0


def _defaults(q, k, scale, kv_len, q_offset):
    lq, lkv, d = q.shape[1], k.shape[1], q.shape[-1]
    return ((1.0 / d ** 0.5) if scale is None else scale,
            lkv if kv_len is None else int(kv_len),
            (lkv - lq) if q_offset is None else int(q_offset))


def pad_head_dim(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Zero-pad the head dim (the last) of each tensor to the next width
    the tensor-core kernels take (64 or 128); a width they take comes
    back as it is.  Exact on both rails, forward and backward: the zero
    columns add exact zeros to every score q.k and to do.v, so scores,
    every partial sum of P V, LSE, delta, dq, dk and dv keep their
    values, and the padded columns of O, dq, dk and dv are zero.  The
    caller passes the scale of the true d and slices the outputs back.
    Raises on a width the kernels do not take."""
    d = ts[0].shape[-1]
    if d not in cuda_lib.HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {cuda_lib.HEAD_DIMS}")
    width = next(w for w in cuda_lib.TC_HEAD_DIMS if w >= d)
    if width == d:
        return ts
    return tuple(torch.nn.functional.pad(t, (0, width - d)) for t in ts)


def fa2_forward_plain(q, k, v, *, causal=False, scale=None, block_kv=128,
                      kv_len=None, q_offset=None):
    """The kernel's math as a torch tile loop: online softmax over
    ``block_kv``-key tiles with the kernel's masks (``kv_len`` padding,
    causal with ``q_offset``), all queries at once.  Returns O (BH, Lq,
    d) and LSE = m + ln l (BH, Lq), both f32; a row that sees no key
    gets O = 0 and LSE = NEG_INF."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    bh, lq, d = q.shape
    qf = q.to(torch.float32)
    m = torch.full((bh, lq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((bh, lq), dtype=torch.float32, device=q.device)
    acc = torch.zeros((bh, lq, d), dtype=torch.float32, device=q.device)
    q_ids = q_offset + torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, min(kv_len, k.shape[1]), block_kv):
        if causal and k0 > q_offset + lq - 1:
            break
        kb = k[:, k0:k0 + block_kv].to(torch.float32)
        vb = v[:, k0:k0 + block_kv].to(torch.float32)
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        kv_ids = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        mask = kv_ids < kv_len
        if causal:
            mask = mask & (kv_ids <= q_ids)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", p, vb)
        m = m_new
    safe = torch.where(l == 0.0, torch.ones_like(l), l)
    return acc / safe[..., None], m + torch.log(safe)


def fa2_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = False, scale: float | None = None,
                block_q: int = 128, block_kv: int = 128,
                kv_len: int | None = None, q_offset: int | None = None,
                return_lse: bool = False):
    """FA-2 over (BH, Lq, d) x (BH, Lkv, d) -> O (BH, Lq, d) f32 [, LSE
    (BH, Lq) f32].

    ``kv_len`` masks KV padding; ``q_offset`` is the causal position of
    query row 0 (default Lkv - Lq).  ``block_q``/``block_kv`` are the
    reference's tile sizes: the result does not depend on them beyond
    f32 rounding, and the kernel keeps its own tiles.
    """
    if q.device.type == "cpu":
        out, lse = fa2_forward_plain(q, k, v, causal=causal, scale=scale,
                                     block_kv=block_kv, kv_len=kv_len,
                                     q_offset=q_offset)
    elif q.device.type == "cuda":
        global launches
        scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
        d = q.shape[-1]
        if q.dtype == torch.bfloat16:
            q, k, v = pad_head_dim(q, k, v)
        out, lse = cuda_lib.launch_dense_fwd(
            q, k, v, causal=causal, scale=scale, kv_len=kv_len,
            q_offset=q_offset, use_hfa=False)
        out = out[..., :d].contiguous()
        launches += 1
    else:
        raise ValueError(f"fa2_forward: no kernel for {q.device}")
    return (out, lse) if return_lse else out
