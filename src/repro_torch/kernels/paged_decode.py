"""Paged flash-decode: kernel wrapper, plain version and page-cache ops.

The KV cache of each layer is a shared block pool of fixed-size pages,
``(num_pages, page_size, Hkv, d)``, addressed by a per-sequence page
table ``(B, pages_per_seq)``.

``paged_decode_partial`` replaces the Pallas kernel
``src/repro/kernels/paged_decode.py::_paged_decode_kernel`` (wrapper
``paged_decode_partial_pallas``).  On a CUDA tensor it launches the
kernel ``cuda_lib.paged_decode_route`` picks and counts the launch in
:data:`launches` (and in ``cuda_lib.paged_launches``): on the FA-2 rail
and on the H-FA rail at page 16, ``paged_decode_fwd_v2`` of
``csrc/paged_attention_tc.cu``; on the H-FA rail at any other page size
(up to ``cuda_lib.HFA_MAX_PAGE``, 2048), the CUDA-core
``paged_decode_fwd`` of ``csrc/paged_attention.cu``, which rescales once
a page as the reference does.  On a CPU tensor it runs
:func:`paged_decode_partial_plain`.  The pools may hold a page codec's
encoding (``kernels/page_codec.py``): both kernels decode int8 tiles
right after their load (value times its row's f32 scale), and a log16
pool is read through its bf16 view (:func:`kernel_pools`); the plain
version decodes the gathered pages with ``codec.decode``.  What bounds the
kernel on the card is the bytes of the live K/V pages it reads (one
query token per slot does 2 flops per K/V byte, far below the card's
ridge): it streams them through a cp.async ring, stops at
``ceil(kv_len / 16)`` tiles, and on the FA-2 rail splits each page walk
across blocks and merges the parts by Eq. 16 inside the kernel (the H-FA
rail walks unsplit, as its rescale points must stay where the
reference's are).  Unsplit, it is bit-equal to the CUDA-core kernel
``paged_decode_fwd`` of ``csrc/paged_attention.cu``, which
:func:`paged_decode_partial_simt` launches for the checks;
``kernels/ref.py::paged_decode_split_model`` models the split walk.

Also here: ``append_kv`` / ``write_prefill_kv`` scatter new K/V through
the page table, and ``gather_pages`` builds the dense view the plain
versions use.  Writes update the pools in place (the reference returns
new arrays); the functions return the pools for symmetry.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import bitmath, cuda_lib, page_codec
from repro_torch.kernels.decode import NEG_INF

launches = 0


def _default_scale(d: int, scale: float | None) -> float:
    return (1.0 / d ** 0.5) if scale is None else scale


def _gathered(pages, scales, page_table, codec):
    """Dense f32 view of each sequence's pages, decoded with ``codec``
    (None: the raw fp pool) - the reference's ``ops._gathered_kv``."""
    cache = gather_pages(pages, page_table)
    if codec is None:
        return cache.to(torch.float32)
    return page_codec.get_codec(codec).decode(cache, None if scales is None
                        else gather_pages(scales, page_table))


def kernel_pools(codec, k_pages, v_pages, k_scales, v_scales):
    """The pools and scales as the kernels read them: ``codec`` None (the
    raw fp pool) or int8 as they are - the int8 kernels decode each tile
    right after its load, value times its row's scale, as
    ``Int8Codec.decode``; log16 as ``pages.view(torch.bfloat16)``, which
    is ``Log16Codec.decode`` (a bitcast to bf16, then the widening every
    bf16 pool gets), not a shortcut of it."""
    codec = page_codec.get_codec(codec)
    if codec.name == "fp":
        return k_pages, v_pages, None, None
    if codec.name == "log16":
        return (k_pages.view(torch.bfloat16), v_pages.view(torch.bfloat16),
                None, None)
    if codec.name == "int8":
        return k_pages, v_pages, k_scales, v_scales
    raise ValueError(f"no paged kernel decodes page codec {codec.name!r}")


def paged_partial_plain(qg: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        q_pos: torch.Tensor, kv_lens: torch.Tensor, *,
                        scale: float | None, use_hfa: bool, codec=None,
                        k_scales=None, v_scales=None):
    """Plain triplet for every paged kernel: dense gather (decoded with
    ``codec``) + one-shot masked softmax pieces, all in f32 (p included).

    qg (B, Hkv, G, L, d); q_pos (B, L) absolute position per row;
    kv_lens (B,).  Row (b, l) sees KV positions ``<= q_pos[b, l]`` and
    ``< kv_lens[b]``.  Fully masked rows come back as the neutral
    triplet (0, NEG_INF, 0).
    """
    b, hkv, g, ell, d = qg.shape
    k_cache = _gathered(k_pages, k_scales, page_table, codec)
    v_cache = _gathered(v_pages, v_scales, page_table, codec)
    s_len = k_cache.shape[1]
    # One matrix product a (slot, kv head) on contiguous operands, so a
    # head's result does not depend on how many heads the pools hold (a
    # tensor-parallel shard's share); einsum picks its layout by shape.
    s = torch.matmul(
        qg.to(torch.float32).reshape(b, hkv, g * ell, d),
        k_cache.permute(0, 2, 3, 1).contiguous()).reshape(
            b, hkv, g, ell, s_len) * _default_scale(d, scale)
    kv_ids = torch.arange(s_len, dtype=torch.int32, device=qg.device)
    mask = (kv_ids[None, None, :] <= q_pos[:, :, None]) & \
        (kv_ids[None, None, :] < kv_lens.to(torch.int32)[:, None, None])
    mask = mask[:, None, None]                                # (B,1,1,L,S)
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    live = torch.any(mask, dim=-1)                            # (B,1,1,L)
    m = torch.amax(s, dim=-1)
    if use_hfa:
        p = bitmath.exp2_hfa_rail(bitmath.quant_rail(s - m[..., None]))
    else:
        p = torch.exp(s - m[..., None])
    p = torch.where(mask, p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)
    o = torch.matmul(p.reshape(b, hkv, g * ell, s_len),
                     v_cache.permute(0, 2, 1, 3).contiguous()).reshape(
                         b, hkv, g, ell, d)
    o = torch.where(live[..., None], o, torch.zeros_like(o))
    return o, m, l


def paged_decode_partial_plain(q, k_pages, v_pages, page_table, kv_lens, *,
                               scale=None, use_hfa=False, codec=None,
                               k_scales=None, v_scales=None):
    """Plain version of the paged decode kernel: (o~ (B,Hkv,G,d),
    m/l (B,Hkv,G)).  ``kv_lens[b] == 0`` marks a free slot."""
    kvl = kv_lens.to(torch.int32)
    o, m, l = paged_partial_plain(q[:, :, :, None, :], k_pages, v_pages,
                                  page_table, (kvl - 1)[:, None], kvl,
                                  scale=scale, use_hfa=use_hfa, codec=codec,
                                  k_scales=k_scales, v_scales=v_scales)
    return o[:, :, :, 0], m[..., 0], l[..., 0]


def paged_decode_partial(q: torch.Tensor, k_pages: torch.Tensor,
                         v_pages: torch.Tensor, page_table: torch.Tensor,
                         kv_lens: torch.Tensor, *, scale: float | None = None,
                         use_hfa: bool = False, codec=None, k_scales=None,
                         v_scales=None, pairs: int | None = None):
    """Partial paged decode attention, one triplet per (slot, kv head).

    q (B, Hkv, G, d) grouped queries; pools (P, page, Hkv, d), encoded
    by ``codec`` (None: the raw fp pool; int8 with its f32 scale
    sidecars (P, page, Hkv, 1)); page_table (B, J) int32; kv_lens (B,)
    int32 (0 = free slot, which yields (0, NEG_INF, 0)).  Returns o~ (B,
    Hkv, G, d) f32 and m, l (B, Hkv, G) f32.  A CUDA tensor launches the
    kernel on :func:`kernel_pools`; a CPU tensor runs the plain version.
    ``pairs``: the (slot, kv head) walks of the whole call when this is
    one shard of it (``cuda_lib.decode_splits``; default B Hkv).
    """
    if q.device.type == "cpu":
        return paged_decode_partial_plain(q, k_pages, v_pages, page_table,
                                          kv_lens, scale=scale,
                                          use_hfa=use_hfa, codec=codec,
                                          k_scales=k_scales,
                                          v_scales=v_scales)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_partial: no kernel for {q.device}")
    global launches
    kp, vp, ks, vs = kernel_pools(codec, k_pages, v_pages, k_scales,
                                  v_scales)
    out = cuda_lib.launch_paged_decode(
        q, kp, vp, page_table, kv_lens,
        scale=_default_scale(q.shape[-1], scale), use_hfa=use_hfa,
        k_scales=ks, v_scales=vs, pairs=pairs)
    launches += 1
    return out


def paged_decode_partial_simt(q, k_pages, v_pages, page_table, kv_lens, *,
                              scale=None, use_hfa=False, codec=None,
                              k_scales=None, v_scales=None):
    """For the checks: the same triplet from the CUDA-core kernel
    ``paged_decode_fwd`` (16-row blocks, one per (slot, kv head), plain
    loads); counted in ``cuda_lib.paged_launches["decode"]["simt"]``, not
    in :data:`launches`."""
    kp, vp, ks, vs = kernel_pools(codec, k_pages, v_pages, k_scales,
                                  v_scales)
    o, m, l = cuda_lib.launch_paged(
        "paged_decode_fwd", q[:, :, :, None, :], kp, vp, page_table,
        kv_lens, None, scale=_default_scale(q.shape[-1], scale),
        use_hfa=use_hfa, k_scales=ks, v_scales=vs)
    return o[:, :, :, 0], m[..., 0], l[..., 0]


# ------------------------------------------------------- page cache ops
def _flat_write_pos(page_table: torch.Tensor, positions: torch.Tensor,
                    page_size: int) -> torch.Tensor:
    """Pool-flat write index for (b, position): table[b, pos//page] * page
    + pos % page.  positions: (B, L).  Page indices are clamped to the
    table width, so padded positions past the allocation resolve to an
    in-bounds page; callers that can produce them drop those writes."""
    pidx = torch.clamp(positions // page_size, max=page_table.shape[1] - 1)
    page = torch.gather(page_table, 1, pidx.to(torch.int64))
    return page * page_size + positions % page_size


def _scatter_rows(pages: torch.Tensor, flat: torch.Tensor,
                  rows: torch.Tensor, keep: torch.Tensor | None = None):
    """pages.view(P*page, Hkv, d)[flat] = rows, skipping ``~keep``
    (torch has no drop mode: an out-of-range index would fault)."""
    p, page_size = pages.shape[:2]
    view = pages.view(p * page_size, *pages.shape[2:])
    flat = flat.reshape(-1).to(torch.int64)
    rows = rows.reshape(flat.shape[0], *pages.shape[2:])
    if keep is not None:
        keep = keep.reshape(-1)
        flat, rows = flat[keep], rows[keep]
    view[flat] = rows.to(pages.dtype)
    return pages


def append_kv(k_pages, v_pages, k_new, v_new, page_table, seq_lens):
    """Scatter one new token's K/V per *active* sequence into the pools.

    k_new/v_new: (B, 1, Hkv, d); the token for sequence b lands at
    position ``seq_lens[b]``.  Slots with ``seq_lens[b] == 0`` are free
    and their write is dropped.
    """
    pos = seq_lens.to(torch.int32)[:, None]
    flat = _flat_write_pos(page_table, pos, k_pages.shape[1])
    keep = pos > 0
    _scatter_rows(k_pages, flat, k_new, keep)
    _scatter_rows(v_pages, flat, v_new, keep)
    return k_pages, v_pages


def write_prefill_kv(k_pages, v_pages, k_new, v_new, page_table):
    """Write a fresh prompt's K/V (positions 0..L-1) through the page
    table; every row is written in full (padded tails are masked later
    by ``kv_lens``)."""
    b, ell = k_new.shape[:2]
    pos = torch.arange(ell, dtype=torch.int32,
                       device=k_new.device)[None].expand(b, ell)
    flat = _flat_write_pos(page_table, pos, k_pages.shape[1])
    _scatter_rows(k_pages, flat, k_new)
    _scatter_rows(v_pages, flat, v_new)
    return k_pages, v_pages


def gather_pages(pages: torch.Tensor, page_table: torch.Tensor):
    """Dense (B, pages_per_seq * page, Hkv, d) view of each sequence's KV."""
    b, j = page_table.shape
    page_size = pages.shape[1]
    out = pages[page_table.reshape(-1).to(torch.int64)]
    return out.reshape(b, j * page_size, *pages.shape[2:])
