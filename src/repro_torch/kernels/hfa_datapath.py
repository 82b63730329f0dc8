"""The per-element H-FA datapath (the paper's FAU, Fig. 3): kernel
wrapper and plain version.

``hfa_datapath`` replaces the Pallas kernel
``src/repro/kernels/hfa_datapath.py::_datapath_kernel`` (wrapper
``hfa_datapath_pallas``).  It streams keys one at a time and keeps the
fused accumulator O = [l, o] of every query row as (sign, FIX16 raw)
LNS state of width d+1: BF16 scores (f32 dot product, rounded to BF16
after the scale), Eq. (14) quantized score differences, Blinn log2 of
[1, v] (V read as BF16), Mitchell ``lns_add``, then LogDiv and
``lns_to_bf16``.  Forward only, as in the reference.

On a CUDA tensor it launches ``hfa_datapath_fwd`` of
``csrc/hfa_datapath.cu`` and counts the launch in :data:`launches`; on a
CPU tensor it runs :func:`hfa_datapath_plain`, the ``core.hfa``
emulation (``kernels/ref.py::ref_hfa_datapath``).  The gate is exact:
once the BF16 scores agree, every output bit agrees.  What bounds the
kernel on the card is its LNS updates - one per (visible query-key
pair, column), with no tensor-core form - so it runs them on the CUDA
cores, one thread per (row, column), each row's scores staged in shared
memory, and stops each causal row at its diagonal.
"""
from __future__ import annotations

import torch

from repro_torch.core import hfa as core_hfa
from repro_torch.kernels import cuda_lib

launches = 0


def hfa_datapath_plain(q, k, v, *, causal=False, scale=None, kv_len=None):
    """The ``core.hfa`` emulation over (BH, Lq, d) x (BH, Lkv, d) with the
    kernel's masks (key j visible when j < kv_len and, if causal, j <= i
    + Lkv - Lq): (BH, Lq, d) bf16."""
    lq, lkv = q.shape[-2], k.shape[-2]
    kv_ids = torch.arange(lkv, device=q.device)
    mask = (kv_ids < (lkv if kv_len is None else int(kv_len)))[None, :]
    if causal:
        mask = mask & core_hfa.causal_mask(lq, kv_ids, lkv)
    return core_hfa.logdiv(core_hfa.hfa_partial(q, k, v, scale=scale,
                                                mask=mask))


def hfa_datapath(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool = False, scale: float | None = None,
                 kv_len: int | None = None) -> torch.Tensor:
    """Per-element LNS H-FA over (BH, Lq, d) x (BH, Lkv, d) -> (BH, Lq, d)
    bf16; queries are the last Lq positions (causal offset Lkv - Lq) and
    ``kv_len`` (default Lkv) masks key padding."""
    if q.device.type == "cpu":
        return hfa_datapath_plain(q, k, v, causal=causal, scale=scale,
                                  kv_len=kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"hfa_datapath: no kernel for {q.device}")
    global launches
    d, lq, lkv = q.shape[-1], q.shape[-2], k.shape[-2]
    out = cuda_lib.launch_hfa_datapath(
        q, k, v, causal=causal,
        scale=(1.0 / d ** 0.5) if scale is None else scale,
        kv_len=lkv if kv_len is None else int(kv_len), q_offset=lkv - lq)
    launches += 1
    return out


def kernel_order_scores(q: torch.Tensor, k: torch.Tensor,
                        scale: float | None = None,
                        chunk: int = 8) -> torch.Tensor:
    """The BF16 scores as the kernel forms them, for bf16 q (BH, Lq, d)
    and k (BH, Lkv, d): lane l of a warp sums q[c] k[c] over c = l + 32 e
    in order of e, then a butterfly of shuffles (xor 16, 8, 4, 2, 1) adds
    the 32 lanes, then the scale and the rounding to bf16.  bf16 products
    are exact in f32, so each fused multiply-add is one rounded add and
    this reproduces the kernel's sums bit for bit.  (BH, Lq, Lkv) f32,
    computed ``chunk`` slabs at a time; used to tell apart rows whose
    scores the kernel and the plain version round differently."""
    d = q.shape[-1]
    scale_v = (1.0 / d ** 0.5) if scale is None else scale
    lanes = torch.arange(32, device=q.device)
    out = []
    for b0 in range(0, q.shape[0], chunk):
        qf = q[b0:b0 + chunk].to(torch.float32)
        kf = k[b0:b0 + chunk].to(torch.float32)
        x = None
        for e in range(d // 32):
            part = qf[:, :, None, 32 * e:32 * e + 32] * \
                kf[:, None, :, 32 * e:32 * e + 32]
            x = part if x is None else x + part
        for off in (16, 8, 4, 2, 1):
            x = x + x[..., lanes ^ off]
        out.append((x[..., 0] * scale_v).to(torch.bfloat16).to(torch.float32))
    return torch.cat(out)
