"""H-FA forward (the paper's hybrid float/log FlashAttention): kernel
wrapper and plain version.

``hfa_forward`` replaces the Pallas kernel
``src/repro/kernels/hfa.py::_hfa_kernel`` (wrapper ``hfa_pallas``):
scores rounded to BF16 after the scale, both exponentials through
``quant_rail`` -> ``exp2_hfa_rail`` (FIX16 rail, PWL, exponent packing),
P·V accumulated in f32, the ``recip_logdiv`` finalize, no LSE.  On a
CUDA tensor it launches a hand-written kernel on the H-FA rail (count
in :data:`launches`); on a CPU tensor it runs the tile oracle
:func:`repro_torch.kernels.ref.ref_hfa_mxu`.  bf16 inputs go to the
tensor-core kernel of ``csrc/dense_attention_tc.cu`` (wgmma, TMA; d 32
and 96 zero-padded to 64 and 128 by ``fa2.pad_head_dim``, exactly), f32
inputs to the CUDA-core kernel of ``csrc/dense_attention.cu``.  Every
rail value of p is g7/128·2^-k with g7 an integer in [64, 128], exact
in bf16, so P·V on bf16 tensor cores is exact apart from summation
order; the scores are the same bf16 roundings of f32 dot products
summed in another order.

The output depends on where the online rescales fall (a key's weight is
a product of quantized exponentials), so the kernel takes each row max
over the same ``block_kv`` = 128-key tiles as the reference and skips
the same tiles above the diagonal; it refuses another ``block_kv``.
Bound by its rail arithmetic on the CUDA cores at training lengths:
the products run on the tensor cores, the rail (in the integer form of
``csrc/hfa_rail.cuh``) on the CUDA cores beside them.

A summation order can round a score near a bf16 tie to the other
neighbour, and a sum l of p near a LogDiv rounding boundary to the
other side of it (either moves a row by a rail step, 0.54%), so the
card's checks hold the kernel on inputs whose scores and sums are
exact (:func:`dyadic_bf16` at bound 0.5) and, on random inputs,
against the plain walk fed the scores the kernel formed
(:func:`hfa_forward_scores`, :func:`hfa_forward_plain_from_scores`).
There is no backward kernel: the gradient is autograd through the tile
oracle under the straight-through estimator, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.fa2 import _defaults, pad_head_dim
from repro_torch.kernels.ref import ref_hfa_mxu, ref_hfa_walk

launches = 0


def hfa_forward_plain(q, k, v, *, causal=False, scale=None, block_kv=128,
                      kv_len=None, q_offset=None):
    """The tile oracle over the first ``kv_len`` keys: (BH, Lq, d) f32."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    return ref_hfa_mxu(q, k[:, :kv_len], v[:, :kv_len], causal=causal,
                       scale=scale, block_kv=block_kv, q_offset=q_offset)


def hfa_forward_plain_from_scores(s, v, *, causal=False, block_kv=128,
                                  kv_len=None, q_offset=None):
    """The plain version's walk fed precomputed bf16 scores s (BH, Lq,
    Lkv) in place of its QK^T: (BH, Lq, d) f32, masks as in
    :func:`hfa_forward`."""
    lkv = v.shape[1]
    kv_len = lkv if kv_len is None else int(kv_len)
    q_offset = (lkv - s.shape[1]) if q_offset is None else int(q_offset)
    return ref_hfa_walk(s[..., :kv_len], v[:, :kv_len], causal=causal,
                        block_kv=block_kv, q_offset=q_offset)


def hfa_forward_scores(q, k, v, *, causal=False, scale=None, kv_len=None,
                       q_offset=None):
    """For the checks: the tensor-core kernel's scores-out instantiation
    on bf16 CUDA tensors, (O (BH, Lq, d) f32, the bf16 scores (BH, Lq,
    Lkv) it formed).  Not counted in :data:`launches`."""
    if q.device.type != "cuda" or q.dtype != torch.bfloat16:
        raise ValueError("hfa_forward_scores: the scores-out kernel takes "
                         f"bf16 CUDA tensors, got {q.dtype} on {q.device}")
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    d = q.shape[-1]
    o, scores = cuda_lib.launch_dense_fwd_scores(
        *pad_head_dim(q, k, v), causal=causal, scale=scale, kv_len=kv_len,
        q_offset=q_offset)
    return o[..., :d].contiguous(), scores


def score_errors(q, k, s, *, causal=False, scale=None, kv_len=None,
                 q_offset=None, chunk=16):
    """Hold bf16 scores s (BH, Lq, Lkv) that a kernel formed against the
    plain f32 scores q k^T * scale, over the visible (query, key) pairs:
    each within one bf16 ulp of the plain score, plus the f32 dot
    product's own summation bound d 2^-24 sum_i |q_i k_i| scale (which
    matters only for scores near 0).  Returns (visible pairs, pairs whose
    score differs from bf16(plain), pairs beyond the bound, pairs that
    needed the summation term, worst |difference| in ulps)."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    d = q.shape[-1]
    lq, lkv = s.shape[1:]
    kv = torch.arange(lkv, device=s.device)[None, :]
    vis = (kv < kv_len).expand(lq, lkv)
    if causal:
        vis = vis & (kv <= q_offset + torch.arange(lq, device=s.device)[:, None])
    n = [0, 0, 0, 0]
    worst = 0.0
    for b0 in range(0, q.shape[0], chunk):
        qf, kf = q[b0:b0 + chunk].float(), k[b0:b0 + chunk].float()
        plain = torch.einsum("bqd,bkd->bqk", qf, kf) * scale
        dot_err = torch.einsum("bqd,bkd->bqk", qf.abs(), kf.abs()) \
            * (scale * d * 2.0 ** -24)
        got = s[b0:b0 + chunk].float()
        diff = (got - plain).abs()
        _, e = torch.frexp(torch.maximum(got.abs(), plain.abs()))
        ulp = torch.ldexp(torch.ones_like(diff), e - 8)    # x = m 2^e, m < 1
        n[0] += int(vis.sum()) * got.shape[0]
        n[1] += int(((got != plain.to(torch.bfloat16).float()) & vis).sum())
        n[2] += int(((diff > ulp + dot_err) & vis).sum())
        n[3] += int(((diff > ulp) & vis).sum())
        worst = max(worst, float(torch.where(vis, diff / ulp, 0.0).max()))
    return (*n, worst)


def dyadic_bf16(shape, generator: torch.Generator, device="cpu",
                bound: float = 2.0) -> torch.Tensor:
    """bf16 inputs on a coarse dyadic grid: multiples of bound / 8 in
    [-bound, bound].  Every product of two is a multiple of bound^2 / 64
    and every partial sum over d <= 128 of them is exact in f32, so QK^T
    is the same in any summation order.  At bound 0.5 every score also
    lies within 2.9 of its row max (|q.k| <= 32, scale 128^-0.5), so
    every H-FA p is at least 2^-9 and each tile's sum of p is exact in
    f32 too: l, and with it the LogDiv finalize, is order-independent."""
    x = torch.randint(-8, 9, shape, generator=generator, device=device)
    return (x.to(torch.float32) * (bound / 8)).to(torch.bfloat16)


def hfa_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = False, scale: float | None = None,
                block_q: int = 128, block_kv: int = 128,
                kv_len: int | None = None,
                q_offset: int | None = None) -> torch.Tensor:
    """H-FA over (BH, Lq, d) x (BH, Lkv, d) -> (BH, Lq, d) f32; masks as
    in :func:`repro_torch.kernels.fa2.fa2_forward`."""
    if q.device.type == "cpu":
        return hfa_forward_plain(q, k, v, causal=causal, scale=scale,
                                 block_kv=block_kv, kv_len=kv_len,
                                 q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"hfa_forward: no kernel for {q.device}")
    if block_kv != cuda_lib.DENSE_KV_TILE:
        raise ValueError(f"hfa_forward: the kernel's rescale tile is "
                         f"{cuda_lib.DENSE_KV_TILE} keys, got block_kv "
                         f"{block_kv}")
    global launches
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    d = q.shape[-1]
    if q.dtype == torch.bfloat16:       # d 32 / 96 padded, exactly
        q, k, v = pad_head_dim(q, k, v)
    out, _ = cuda_lib.launch_dense_fwd(q, k, v, causal=causal, scale=scale,
                                       kv_len=kv_len, q_offset=q_offset,
                                       use_hfa=True)
    launches += 1
    return out[..., :d].contiguous()
