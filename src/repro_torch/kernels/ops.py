"""Paged attention ops: GQA plumbing around the paged kernels.

``paged_{decode,prefill,verify}_partials`` return the block-FAU triplet
(o~, m, l) for grouped queries; the ``paged_*_attention`` functions take
(B, L, H, d) queries, group the heads kv-major ((B, L, H, d) ->
(B, Hkv, G, L, d), the GQA repeat order), call the partials and
finalize with a float divide (fa2 rail) or LogDiv (hfa rail).

Dispatch follows the tensors: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to its plain version (each kernel module's
``*_partial`` wrapper decides).  ``impl`` names the rail: any impl
starting with "hfa" runs the H-FA rail.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode as decode_k
from repro_torch.kernels import paged_decode as paged_k
from repro_torch.kernels import paged_prefill as paged_pf_k
from repro_torch.kernels import paged_verify as paged_v_k


def _use_hfa(impl: str) -> bool:
    return impl.startswith("hfa")


def paged_decode_partials(qg, k_pages, v_pages, page_table, kv_lens, *,
                          impl: str = "fa2", scale: float | None = None):
    """Paged decode partial triplet: (o~ (B,Hkv,G,d), m/l (B,Hkv,G))."""
    return paged_k.paged_decode_partial(
        qg.contiguous(), k_pages, v_pages, page_table, kv_lens,
        scale=scale, use_hfa=_use_hfa(impl))


def paged_prefill_partials(qg, k_pages, v_pages, page_table, start_pos,
                           kv_lens, *, impl: str = "fa2",
                           scale: float | None = None):
    """Paged chunked-prefill partial triplet: shapes (B,Hkv,G,L,[d])."""
    return paged_pf_k.paged_prefill_partial(
        qg.contiguous(), k_pages, v_pages, page_table, start_pos, kv_lens,
        scale=scale, use_hfa=_use_hfa(impl))


def paged_verify_partials(qg, k_pages, v_pages, page_table, seq_lens,
                          chunk_lens, *, impl: str = "fa2",
                          scale: float | None = None):
    """Paged speculative-verify partial triplet: shapes (B,Hkv,G,K,[d])."""
    return paged_v_k.paged_verify_partial(
        qg.contiguous(), k_pages, v_pages, page_table, seq_lens, chunk_lens,
        scale=scale, use_hfa=_use_hfa(impl))


def _group(q: torch.Tensor, hkv: int) -> torch.Tensor:
    """(B, L, H, d) -> (B, Hkv, G, L, d), heads kv-major."""
    b, ell, h, d = q.shape
    return q.transpose(1, 2).reshape(b, hkv, h // hkv, ell, d)


def _ungroup(out: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(B, Hkv, G, L, d) -> (B, L, H, d)."""
    b, hkv, g, ell, d = out.shape
    return out.reshape(b, hkv * g, ell, d).transpose(1, 2).to(dtype)


def paged_prefill_attention(q, k_pages, v_pages, page_table, start_pos,
                            chunk_lens, *, impl: str = "fa2",
                            scale: float | None = None) -> torch.Tensor:
    """Chunked-prefill attention against a paged KV cache.

    q (B, L, H, d); the chunk's K/V must already be in the pools
    (:func:`paged_prefill.write_chunk_kv`).  Returns (B, L, H, d) in
    q's dtype.
    """
    kv_lens = (start_pos + chunk_lens).to(torch.int32)
    o, _, ell = paged_prefill_partials(
        _group(q, k_pages.shape[2]), k_pages, v_pages, page_table,
        start_pos, kv_lens, impl=impl, scale=scale)
    out = decode_k.finalize_decode(o, ell, use_hfa=_use_hfa(impl))
    return _ungroup(out, q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens, *,
                           impl: str = "fa2",
                           scale: float | None = None) -> torch.Tensor:
    """Continuous-batching decode attention against a paged KV cache:
    q (B, 1, H, d), kv_lens (B,) with 0 marking a free slot."""
    b, one, h, d = q.shape
    assert one == 1, q.shape
    hkv = k_pages.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    o, _, ell = paged_decode_partials(qg, k_pages, v_pages, page_table,
                                      kv_lens, impl=impl, scale=scale)
    out = decode_k.finalize_decode(o, ell, use_hfa=_use_hfa(impl))
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_verify_attention(q, k_pages, v_pages, page_table, seq_lens,
                           chunk_lens, *, impl: str = "fa2",
                           scale: float | None = None) -> torch.Tensor:
    """Multi-query speculative-verify attention: q (B, K, H, d), token i
    of slot b at ``seq_lens[b] + i`` (its K/V already written).  Rows at
    ``i >= chunk_lens[b]`` are garbage the caller ignores."""
    o, _, ell = paged_verify_partials(
        _group(q, k_pages.shape[2]), k_pages, v_pages, page_table,
        seq_lens, chunk_lens, impl=impl, scale=scale)
    out = decode_k.finalize_decode(o, ell, use_hfa=_use_hfa(impl))
    return _ungroup(out, q.dtype)
