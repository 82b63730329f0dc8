"""Paged multi-query verify for self-speculative decode: kernel wrapper
and plain version.

One verify step scores K = 1 + spec_k tokens per slot (the carry token
plus drafts) in a single page-table walk.  Token i of slot b sits at
``seq_lens[b] + i``; its K/V is already in the pools
(``paged_prefill.write_chunk_kv`` with ``start_pos = seq_lens``).  Row i
sees KV positions ``<= seq_lens[b] + i`` and ``< seq_lens[b] +
chunk_lens[b]``; ``chunk_lens[b] == 0`` is a free slot riding along and
yields (0, NEG_INF, 0).  With K = 1 it is the paged decode.

``paged_verify_partial`` replaces the Pallas kernel
``src/repro/kernels/paged_verify.py::_paged_verify_kernel`` (wrapper
``paged_verify_partial_pallas``).  On a CUDA tensor it launches the
kernel ``cuda_lib.paged_verify_route`` picks and counts it in
:data:`launches` (and in ``cuda_lib.paged_launches["verify"]``): with at
most 16 rows a (slot, kv head) - G K, 10 at qwen3-1.7b with spec_k 4 -
``paged_verify_fwd_v2`` of ``csrc/paged_attention_tc.cu``, the v2
decode's body with a causal limit per row (a cp.async ring, the walk
split across blocks on the FA-2 rail and merged by Eq. 16 in the
kernel, the rows split across blocks on the H-FA rail); with more, or
on the H-FA rail at a page size other than 16 (where the reference's
once-a-page rescale is not the v2 kernel's 16-key tile),
``paged_verify_fwd`` of ``csrc/paged_attention.cu`` (the CUDA cores),
which :func:`paged_verify_partial_simt` also launches for the checks.
Unsplit, the two are bit-equal, on int8 pools too (each decodes a tile
as it loads it; a log16 pool is read through its bf16 view, as
``paged_decode.kernel_pools`` says).  On a CPU tensor it runs the plain
version, which is also the counterpart of the reference's
``paged_verify_partial_ref``.  On the card it is bound by the bytes of
the live K/V pages; ``kernels/ref.py::paged_verify_split_model`` models
the split walk.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_decode import (_default_scale,
                                              kernel_pools,
                                              paged_partial_plain)

launches = 0


def paged_verify_partial_plain(q, k_pages, v_pages, page_table, seq_lens,
                               chunk_lens, *, scale=None, use_hfa=False,
                               codec=None, k_scales=None, v_scales=None):
    """Plain version of the paged verify kernel."""
    kw = q.shape[3]
    sl = seq_lens.to(torch.int32)
    q_pos = sl[:, None] + torch.arange(kw, dtype=torch.int32,
                                       device=q.device)[None]
    return paged_partial_plain(q, k_pages, v_pages, page_table, q_pos,
                               sl + chunk_lens.to(torch.int32),
                               scale=scale, use_hfa=use_hfa, codec=codec,
                               k_scales=k_scales, v_scales=v_scales)


def paged_verify_partial(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         seq_lens: torch.Tensor, chunk_lens: torch.Tensor, *,
                         scale: float | None = None, use_hfa: bool = False,
                         codec=None, k_scales=None, v_scales=None,
                         pairs: int | None = None):
    """Partial paged verify attention: q (B, Hkv, G, K, d); pools encoded
    by ``codec`` as ``paged_decode.paged_decode_partial`` takes them;
    returns o~ (B, Hkv, G, K, d) and m, l (B, Hkv, G, K), all f32.  Rows
    at ``i >= chunk_lens[b]`` are garbage the caller ignores.
    ``pairs``: the (slot, kv head) walks of the whole call when this is
    one shard of it (``cuda_lib.verify_splits``; default B Hkv)."""
    if q.device.type == "cpu":
        return paged_verify_partial_plain(q, k_pages, v_pages, page_table,
                                          seq_lens, chunk_lens, scale=scale,
                                          use_hfa=use_hfa, codec=codec,
                                          k_scales=k_scales,
                                          v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_partial: no kernel for {q.device}")
    global launches
    kp, vp, ks, vs = kernel_pools(codec, k_pages, v_pages, k_scales,
                                  v_scales)
    out = cuda_lib.launch_paged_verify(
        q, kp, vp, page_table, seq_lens, chunk_lens,
        scale=_default_scale(q.shape[-1], scale), use_hfa=use_hfa,
        k_scales=ks, v_scales=vs, pairs=pairs)
    launches += 1
    return out


def paged_verify_partial_simt(q, k_pages, v_pages, page_table, seq_lens,
                              chunk_lens, *, scale=None, use_hfa=False,
                              codec=None, k_scales=None, v_scales=None):
    """For the checks: the same triplet from the CUDA-core kernel
    ``paged_verify_fwd`` (16-row blocks, plain loads), whatever the route
    rule picks; counted in ``cuda_lib.paged_launches["verify"]["simt"]``,
    not in :data:`launches`."""
    kp, vp, ks, vs = kernel_pools(codec, k_pages, v_pages, k_scales,
                                  v_scales)
    return cuda_lib.launch_paged(
        "paged_verify_fwd", q, kp, vp, page_table, seq_lens, chunk_lens,
        scale=_default_scale(q.shape[-1], scale), use_hfa=use_hfa,
        k_scales=ks, v_scales=vs)
