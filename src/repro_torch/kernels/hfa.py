"""H-FA forward (the paper's hybrid float/log FlashAttention): kernel
wrapper and plain version.

``hfa_forward`` replaces the Pallas kernel
``src/repro/kernels/hfa.py::_hfa_kernel`` (wrapper ``hfa_pallas``):
scores rounded to BF16 after the scale, both exponentials through
``quant_rail`` -> ``exp2_hfa_rail`` (FIX16 rail, PWL, exponent packing),
P·V accumulated in f32, the ``recip_logdiv`` finalize, no LSE.  On a
CUDA tensor it launches ``dense_attn_fwd`` of ``csrc/dense_attention.cu``
on the H-FA rail (count in :data:`launches`); on a CPU tensor it runs
the tile oracle :func:`repro_torch.kernels.ref.ref_hfa_mxu`.

The output depends on where the online rescales fall (a key's weight is
a product of quantized exponentials), so the kernel takes each row max
over the same ``block_kv`` = 128-key tiles as the reference and skips
the same tiles above the diagonal; it refuses another ``block_kv``.
Like the FA-2 forward it is bound by arithmetic at training lengths.
There is no backward kernel: the gradient is autograd through the tile
oracle under the straight-through estimator, as in the reference.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.fa2 import _defaults
from repro_torch.kernels.ref import ref_hfa_mxu

launches = 0


def hfa_forward_plain(q, k, v, *, causal=False, scale=None, block_kv=128,
                      kv_len=None, q_offset=None):
    """The tile oracle over the first ``kv_len`` keys: (BH, Lq, d) f32."""
    scale, kv_len, q_offset = _defaults(q, k, scale, kv_len, q_offset)
    return ref_hfa_mxu(q, k[:, :kv_len], v[:, :kv_len], causal=causal,
                       scale=scale, block_kv=block_kv, q_offset=q_offset)


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
    out, _ = cuda_lib.launch_dense_fwd(q, k, v, causal=causal, scale=scale,
                                       kv_len=kv_len, q_offset=q_offset,
                                       use_hfa=True)
    launches += 1
    return out
