"""FA-2 backward: the dq and the dk/dv kernel wrappers and their plain
versions.

``fa2_backward`` replaces the two Pallas kernels of
``src/repro/kernels/fa2_bwd.py``: ``_dq_kernel`` (dq = Σ_kv ds·k·scale)
and ``_dkv_kernel`` (dv = Σ_q pᵀ·do, dk = Σ_q dsᵀ·q·scale), with
p = exp(s - LSE) recomputed from the forward's LSE and
ds = p·(do·vᵀ - δ).  δ = rowsum(do·o) is computed here in torch, as the
reference computes it outside its kernels.  On CPU tensors
:func:`fa2_backward_plain` runs.  On CUDA tensors the cotangent's dtype
picks the kernels, with no fallback between them:

* bf16 q, k, v and a bf16 ``do`` (the model's path: the cotangent of a
  bf16 attention output) go to the tensor-core kernels of
  ``csrc/dense_attention_bwd_tc.cu`` (``dense_attn_dq_tc``,
  ``dense_attn_dkv_tc``: wgmma with TMA-fed tiles, P and dS into their
  products as bf16; d 32 and 96 zero-padded to 64 and 128, q, k, v and
  ``do`` alike, by ``fa2.pad_head_dim``, exactly, and dq, dk, dv sliced
  back), which raise on what they cannot take;
* an f32 ``do`` (the reduced f32 model, or bf16 inputs with an f32
  cotangent) goes to the CUDA-core kernels of ``csrc/dense_attention.cu``
  (``dense_attn_dq``, ``dense_attn_dkv``, f32 throughout); a bf16 ``do``
  with f32 inputs is widened to f32, exactly.

:data:`launches_dq` and :data:`launches_dkv` count both routes;
``cuda_lib.dense_dq_launches`` and ``dense_dkv_launches`` count them by
route.  Each block owns 128 (tensor cores) or 64 (CUDA cores) query rows
(dq) or key rows (dk/dv) and loops over 64-row tiles of the other side,
so no sum crosses blocks and nothing needs atomics.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.fa2 import _defaults, pad_head_dim

launches_dq = 0
launches_dkv = 0


def fa2_backward_plain(q, k, v, do, lse, delta, *, causal=False, scale=None,
                       block_kv=128, kv_len=None, q_offset=None):
    """The kernels' math as a torch loop over ``block_kv``-key tiles:
    (dq, dk, dv) in f32."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    lq, lkv = q.shape[1], k.shape[1]
    qf, dof = q.to(torch.float32), do.to(torch.float32)
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    q_ids = q_offset + torch.arange(lq, device=q.device)[:, None]
    for k0 in range(0, lkv, block_kv):
        kb = k[:, k0:k0 + block_kv].to(torch.float32)
        vb = v[:, k0:k0 + block_kv].to(torch.float32)
        s = torch.einsum("bqd,bkd->bqk", qf, kb) * scale
        kv_ids = k0 + torch.arange(kb.shape[1], device=q.device)[None, :]
        mask = kv_ids < kv_len
        if causal:
            mask = mask & (kv_ids <= q_ids)
        p = torch.where(mask, torch.exp(s - lse[..., None]),
                        torch.zeros_like(s))
        dp = torch.einsum("bqd,bkd->bqk", dof, vb)
        ds = p * (dp - delta[..., None])
        dq += torch.einsum("bqk,bkd->bqd", ds, kb) * scale
        dk[:, k0:k0 + block_kv] = torch.einsum("bqk,bqd->bkd", ds, qf) * scale
        dv[:, k0:k0 + block_kv] = torch.einsum("bqk,bqd->bkd", p, dof)
    return dq, dk, dv


def fa2_backward(q, k, v, o, do, lse, *, causal=False, scale=None,
                 block_q=128, block_kv=128, kv_len=None, q_offset=None):
    """(dq, dk, dv) for (BH, Lq, d) / (BH, Lkv, d) inputs, in q's, k's
    and v's dtypes.  ``o`` and ``lse`` are the forward's outputs, ``do``
    the output's cotangent (bf16 with bf16 inputs: the tensor-core
    kernels; f32: the CUDA-core ones)."""
    delta = torch.sum(do.to(torch.float32) * o.to(torch.float32), dim=-1)
    if q.device.type == "cpu":
        dq, dk, dv = fa2_backward_plain(q, k, v, do, lse, delta,
                                        causal=causal, scale=scale,
                                        block_kv=block_kv, kv_len=kv_len,
                                        q_offset=q_offset)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"fa2_backward: no kernel for {q.device}")
    global launches_dq, launches_dkv
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    kw = dict(causal=causal, scale=scale, kv_len=kv_len, q_offset=q_offset)
    d = q.shape[-1]
    if q.dtype == torch.bfloat16 and do.dtype == torch.bfloat16:
        launch_dq = cuda_lib.launch_dense_dq_tc
        launch_dkv = cuda_lib.launch_dense_dkv_tc
        q, k, v, do = pad_head_dim(q, k, v, do.contiguous())
    else:
        launch_dq = cuda_lib.launch_dense_dq
        launch_dkv = cuda_lib.launch_dense_dkv
        do = do.to(torch.float32).contiguous()
    dq = launch_dq(q, k, v, do, lse, delta, **kw)
    launches_dq += 1
    dk, dv = launch_dkv(q, k, v, do, lse, delta, **kw)
    launches_dkv += 1
    return tuple(t[..., :d].contiguous() for t in (dq, dk, dv))
