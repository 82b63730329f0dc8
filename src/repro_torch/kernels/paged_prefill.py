"""Paged chunked prefill: kernel wrapper, plain version, chunk write and
page copy.

A chunk of L prompt tokens starting at a per-slot offset ``start_pos``
attends causally against everything materialized in the pools for its
sequence - shared prefix pages, earlier chunks and the chunk itself,
which is scattered into the pools first (``write_chunk_kv``).

``paged_prefill_partial`` replaces the Pallas kernel
``src/repro/kernels/paged_prefill.py::_paged_prefill_kernel`` (wrapper
``paged_prefill_partial_pallas``).  On a CUDA tensor it launches one of
two kernels and counts the launch in :data:`launches` (and by route in
``cuda_lib.paged_launches["prefill"]``); on a CPU tensor it runs the
plain version.  The rule (``cuda_lib.paged_prefill_route``): a bf16 q
over bf16 pools (fp, or a log16 pool's bf16 view) at d 64 or 128 and
page 16 - the serving path - goes to ``paged_prefill_fwd_tc`` of
``csrc/paged_attention_tc.cu`` (wgmma on TMA-fed pages, the online
update page by page, P as bf16 on the H-FA rail and as bf16 hi + lo on
the FA-2 rail); everything else (f32 q, int8 pools, d 32 or 96, other
page sizes) to the CUDA-core ``paged_prefill_fwd`` of
``csrc/paged_attention.cu``, which decodes int8 tiles as it loads them
and on the H-FA rail rescales once a page (up to page
``cuda_lib.HFA_MAX_PAGE``, 2048).  Each block stops at the last page its rows
can see under the causal mask.  ``kernels/ref.py::paged_prefill_tc_model``
is a plain model of the tensor-core kernel's numerics, for the tests.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.paged_decode import (_default_scale,
                                              _flat_write_pos, _scatter_rows,
                                              kernel_pools,
                                              paged_partial_plain)

launches = 0


def paged_prefill_partial_plain(q, k_pages, v_pages, page_table, start_pos,
                                kv_lens, *, scale=None, use_hfa=False,
                                codec=None, k_scales=None, v_scales=None):
    """Plain version of the paged prefill kernel."""
    ell = q.shape[3]
    q_pos = start_pos.to(torch.int32)[:, None] + torch.arange(
        ell, dtype=torch.int32, device=q.device)[None]
    return paged_partial_plain(q, k_pages, v_pages, page_table, q_pos,
                               kv_lens, scale=scale, use_hfa=use_hfa,
                               codec=codec, k_scales=k_scales,
                               v_scales=v_scales)


def paged_prefill_partial(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, page_table: torch.Tensor,
                          start_pos: torch.Tensor, kv_lens: torch.Tensor, *,
                          scale: float | None = None, use_hfa: bool = False,
                          codec=None, k_scales=None, v_scales=None):
    """Partial paged chunked-prefill attention.

    q (B, Hkv, G, L, d); query row (g, l) of slot b sits at position
    ``start_pos[b] + l`` and sees KV positions ``<= start_pos[b] + l``
    and ``< kv_lens[b]``.  Rows at ``l >=`` the real chunk length are
    garbage the caller ignores.  Pools encoded by ``codec`` as
    ``paged_decode.paged_decode_partial`` takes them: a log16 pool's
    bf16 view keeps the tensor cores at bf16 compute, int8 pools go to
    the CUDA-core body.  Returns o~ (B, Hkv, G, L, d) and m, l (B, Hkv,
    G, L), all f32.
    """
    if q.device.type == "cpu":
        return paged_prefill_partial_plain(q, k_pages, v_pages, page_table,
                                           start_pos, kv_lens, scale=scale,
                                           use_hfa=use_hfa, codec=codec,
                                           k_scales=k_scales,
                                           v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_partial: no kernel for {q.device}")
    global launches
    kp, vp, ks, vs = kernel_pools(codec, k_pages, v_pages, k_scales,
                                  v_scales)
    out = cuda_lib.launch_paged_prefill(
        q, kp, vp, page_table, start_pos, kv_lens,
        scale=_default_scale(q.shape[-1], scale), use_hfa=use_hfa,
        k_scales=ks, v_scales=vs)
    launches += 1
    return out


# ------------------------------------------------------- page cache ops
def write_chunk_kv(k_pages, v_pages, k_new, v_new, page_table, start_pos,
                   chunk_lens):
    """Position-exact scatter of a prefill chunk's K/V into the pools.

    k_new/v_new: (B, L, Hkv, d); row b's token i lands at position
    ``start_pos[b] + i``.  Rows with ``i >= chunk_lens[b]`` (padding)
    are dropped, so shared prefix pages below ``start_pos`` and pages
    beyond the chunk stay intact.
    """
    ell = k_new.shape[1]
    offs = torch.arange(ell, dtype=torch.int32, device=k_new.device)[None]
    pos = start_pos.to(torch.int32)[:, None] + offs
    flat = _flat_write_pos(page_table, pos, k_pages.shape[1])
    keep = offs < chunk_lens.to(torch.int32)[:, None]
    _scatter_rows(k_pages, flat, k_new, keep)
    _scatter_rows(v_pages, flat, v_new, keep)
    return k_pages, v_pages


def copy_pages(pages: torch.Tensor, src: torch.Tensor, dst: torch.Tensor,
               axis: int = 0) -> torch.Tensor:
    """Device side of copy-on-write: ``pages[dst[i]] = pages[src[i]]``
    along ``axis``, in place.  Padding entries use an out-of-range
    ``dst`` and are dropped; ``src`` is clipped so the dead gather stays
    in bounds.  All sources are read before any write."""
    n = pages.shape[axis]
    src = torch.clamp(src.to(torch.int64), 0, n - 1)
    dst = dst.to(torch.int64)
    keep = (dst >= 0) & (dst < n)
    vals = torch.index_select(pages, axis, src[keep])
    pages.index_copy_(axis, dst[keep], vals)
    return pages
