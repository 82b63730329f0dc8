"""Layers of the dense transformer, as ``nn.Module`` parameter holders
plus the reference's ``*_apply`` functions.

Parameters keep the reference's einsum layouts (``wq`` is (d_model, H,
dh), ``wo`` is (H, dh, d_model), ``wg``/``wu`` are (d_model, d_ff)) so
:mod:`repro_torch.models.convert` copies them unchanged.  Norms,
softmax-adjacent math and RoPE run in f32 and cast back, as in the
reference.

Attention has three branches: the paged one the serving engine takes
(a paged cache and a ``page_state``), the dense ring of the fixed-batch
serving loop (a cache {"k", "v"} and ``cache_pos``), and the dense
causal one of training (no cache), which runs :func:`repro_torch.
kernels.ops.multihead_attention`.  Parameters are trainable; the
serving methods run under ``torch.no_grad()``.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.kernels import page_codec
from repro_torch.kernels import paged_decode as paged_k
from repro_torch.kernels import paged_prefill as paged_pf_k
from repro_torch.parallel import collectives


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device))


# ---------------------------------------------------------------- modules
class RMSNorm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device):
        super().__init__()
        self.emb = _param((vocab, d), dtype, device)


class Attention(nn.Module):
    """GQA attention params (qk-norm and qkv bias optional)."""

    def __init__(self, cfg, dtype, device):
        super().__init__()
        d, h, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head
        self.wq = _param((d, h, dh), dtype, device)
        self.wk = _param((d, hkv, dh), dtype, device)
        self.wv = _param((d, hkv, dh), dtype, device)
        self.wo = _param((h, dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param((h, dh), dtype, device)
            self.bk = _param((hkv, dh), dtype, device)
            self.bv = _param((hkv, dh), dtype, device)
        if cfg.qk_norm:
            self.q_norm = _param((dh,), dtype, device)
            self.k_norm = _param((dh,), dtype, device)


class SwiGLU(nn.Module):
    def __init__(self, d: int, ff: int, dtype, device):
        super().__init__()
        self.wg = _param((d, ff), dtype, device)
        self.wu = _param((d, ff), dtype, device)
        self.wd = _param((ff, d), dtype, device)


def init_dense_(w: torch.Tensor, generator: torch.Generator,
                scale: float) -> None:
    """Fill ``w`` with N(0, 1) * scale drawn from ``generator`` (on the
    generator's device, then copied to ``w``)."""
    x = torch.randn(tuple(w.shape), generator=generator,
                    device=generator.device, dtype=torch.float32)
    w.copy_(x.mul_(scale).to(w.dtype))


# ---------------------------------------------------------------- apply
def rmsnorm_apply(p: RMSNorm, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p.scale.to(torch.float32)).to(x.dtype)


def embedding_lookup(p: Embedding, ids: torch.Tensor) -> torch.Tensor:
    return p.emb[ids]


def rope_apply(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """Rotary embedding, half-split, in f32. x: (B, S, H, dh),
    positions: (B, S) or (S,)."""
    dh = x.shape[-1]
    half = dh // 2
    freqs = 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                          device=x.device) / half))
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].to(torch.float32) * freqs     # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _head_rmsnorm(scale: torch.Tensor, x: torch.Tensor, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)


def swiglu_apply(p: SwiGLU, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p.wg.to(x.dtype))
    u = torch.einsum("bsd,df->bsf", x, p.wu.to(x.dtype))
    y = torch.nn.functional.silu(g.to(torch.float32)).to(x.dtype) * u
    return torch.einsum("bsf,fd->bsd", y, p.wd.to(x.dtype))


def attention_apply(p: Attention, x: torch.Tensor, cfg, *,
                    positions: torch.Tensor | None = None,
                    cache: dict | None = None,
                    cache_pos: int | None = None,
                    page_state: dict | None = None):
    """Causal self-attention.  Returns (out (B, S, d_model), cache).

    Without a cache (training): dense causal attention over the
    sequence, positions 0..S-1 unless given; the cache is None.  With a
    dense ring {"k", "v"} (B, max_seq, Hkv, dh) of this layer, the
    tokens sit at ``cache_pos`` (a host int): see :func:`_ring_attention`.
    With a paged block pool {"k_pages", "v_pages"}, ``page_state`` holds
    the engine's tables: {"page_table" (B, J), "seq_lens" (B,)} for
    decode, plus "chunk_lens" and "verify" for a speculative verify
    step, or "prefill", "start_pos" and "chunk_lens" for a chunked
    prefill.  ``cfg.attn_impl`` names the impl: on the paged path
    "hfa..." runs the H-FA rail and anything else fa2; the dense paths
    dispatch it through ``multihead_attention`` (and decode through
    ``decode_attention`` with :func:`_decode_impl`).
    """
    wdt = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(wdt))
    k = torch.einsum("bsd,dhk->bshk", x, p.wk.to(wdt))
    v = torch.einsum("bsd,dhk->bshk", x, p.wv.to(wdt))
    if cfg.qkv_bias:
        q = q + p.bq.to(wdt)
        k = k + p.bk.to(wdt)
        v = v + p.bv.to(wdt)
    if cfg.qk_norm:
        q = _head_rmsnorm(p.q_norm, q)
        k = _head_rmsnorm(p.k_norm, k)
    if cfg.pos_emb != "rope":
        raise NotImplementedError("only rope positions are ported")
    if positions is None:
        base = 0 if cache_pos is None else cache_pos
        positions = base + torch.arange(x.shape[1], device=x.device)
    q = rope_apply(q, positions, cfg.rope_theta)
    k = rope_apply(k, positions, cfg.rope_theta)
    if cache is None:
        out = kops.multihead_attention(q, k, v, impl=cfg.attn_impl,
                                       causal=True, block_q=cfg.attn_block,
                                       block_kv=cfg.attn_block)
    elif "k" in cache:
        out = _ring_attention(q, k, v, cache, cache_pos or 0, cfg)
    else:
        out, cache = _paged_attention(q, k, v, cache, page_state,
                                      impl=cfg.attn_impl,
                                      block=cfg.attn_block)
    out = torch.einsum("bshk,hkd->bsd", out, p.wo.to(wdt))
    return out, cache


def _ring_attention(q, k, v, cache, pos: int, cfg):
    """Attention over a dense ring {"k", "v"} (B, max_seq, Hkv, dh),
    written in place at ``pos``.

    Decode (S == 1): an index write of the token at ``pos`` (the
    reference's select over the ring gives the same cache), then
    ``decode_attention`` over the first ``pos + 1`` slots.  Prefill (S >
    1, fresh, at position 0): the chunk's K/V land at ``pos``.. and it
    attends causally within itself; the ring is storage only.  The
    reference's tensor-parallel ``shardmap_merge`` decode is not ported
    (ROADMAP.md Queue 1 item 11b).
    """
    s, max_seq = q.shape[1], cache["k"].shape[1]
    if pos + s > max_seq:
        raise ValueError(f"dense cache full: {s} tokens at position {pos} "
                         f"of a {max_seq}-slot ring")
    cache["k"][:, pos:pos + s] = k.to(cache["k"].dtype)
    cache["v"][:, pos:pos + s] = v.to(cache["v"].dtype)
    if s == 1:
        return kops.decode_attention(q, cache["k"], cache["v"],
                                     impl=_decode_impl(cfg.attn_impl),
                                     kv_len=pos + 1)
    return kops.multihead_attention(q, k, v, impl=cfg.attn_impl, causal=True,
                                    block_q=cfg.attn_block,
                                    block_kv=cfg.attn_block)


def _decode_impl(impl: str) -> str:
    """The decode impl paired with a prefill impl (the reference's
    mapping: the H-FA impls decode on the tiled H-FA rail)."""
    return {"fa2": "fa2", "exact": "fa2", "hfa": "hfa_pallas",
            "fa2_pallas": "fa2_pallas", "hfa_pallas": "hfa_pallas",
            "hfa_datapath": "hfa_pallas"}.get(impl, "fa2")


def _paged_attention(q, k, v, cache, page_state, *, impl, block):
    """Attention against a paged block-pool KV cache (serving path).

    Verify: scatter the K step tokens at positions seq_lens[b].. (rows
    past chunk_lens dropped), then score all K positions in one walk.
    Decode: append the token at seq_lens[b], then attend over each
    slot's pages.  Chunked prefill: scatter the chunk at start_pos[b]..
    (padding rows dropped), then attend causally against everything
    written for the sequence.  Whole-prompt prefill (no start_pos): the
    chunk from position 0 with every row of the (B, L) input real, so
    all L rows are written (the reference writes them all too); with the
    fp codec attention takes the same paged prefill kernel, where the
    reference attends over the raw chunk - the same attention on the
    FA-2 rail, its dense walk on the H-FA rail (ROADMAP.md Queue 3 C5).
    With another codec it attends over the raw chunk, as the reference
    does: the pages would give the quantized K/V.

    Every write encodes with the page codec (``page_state["codec"]``);
    the reads of a codec other than fp pass it and the scale sidecars to
    the kernels, and fp reads on ``codec=None``, byte for byte the
    pre-codec path (the reference's rule).

    Under a serving mesh (``page_state["mesh"]``) with a "model" or
    "data" axis above 1, every branch goes through
    :func:`repro_torch.parallel.collectives.shardmap_paged_attention`:
    the pools hold this rank's KV heads, it writes and attends them and
    the ranks merge their triplets; the whole-prompt prefill then
    attends through the pages, as the reference's sharded branch does.
    """
    pt = page_state["page_table"]
    codec = page_codec.get_codec(page_state.get("codec"))
    rcodec = None if codec.name == "fp" else codec
    mesh = page_state.get("mesh")
    if collectives.tp_shards(mesh) > 1 or \
            collectives.tp_shards(mesh, "data") > 1:
        return _sharded(q, k, v, cache, page_state, mesh, impl, codec)

    def read(pools):
        return dict(codec=rcodec, k_scales=pools.get("k_scale"),
                    v_scales=pools.get("v_scale"))

    if page_state.get("verify", False):
        sl = page_state["seq_lens"]
        cl = page_state["chunk_lens"]
        pools = page_codec.encode_write(paged_pf_k.write_chunk_kv, codec,
                                        cache, k, v, pt, sl, cl)
        out = kops.paged_verify_attention(
            q, pools["k_pages"], pools["v_pages"], pt, sl, cl, impl=impl,
            **read(pools))
    elif not page_state.get("prefill", False):
        sl = page_state["seq_lens"]
        pools = page_codec.encode_write(paged_k.append_kv, codec, cache, k,
                                        v, pt, sl)
        kv_lens = torch.where(sl > 0, sl + 1, torch.zeros_like(sl))
        out = kops.paged_decode_attention(
            q, pools["k_pages"], pools["v_pages"], pt, kv_lens, impl=impl,
            **read(pools))
    else:
        whole = "start_pos" not in page_state
        if whole:
            b, ell = q.shape[0], q.shape[1]
            sp = torch.zeros((b,), dtype=torch.int32, device=q.device)
            cl = torch.full((b,), ell, dtype=torch.int32, device=q.device)
        else:
            sp = page_state["start_pos"]
            cl = page_state["chunk_lens"]
        pools = page_codec.encode_write(paged_pf_k.write_chunk_kv, codec,
                                        cache, k, v, pt, sp, cl)
        if whole and rcodec is not None:
            out = kops.multihead_attention(q, k, v, impl=impl, causal=True,
                                           block_q=block, block_kv=block)
        else:
            out = kops.paged_prefill_attention(
                q, pools["k_pages"], pools["v_pages"], pt, sp, cl,
                impl=impl, **read(pools))
    return out, pools


def _sharded(q, k, v, cache, page_state, mesh, impl, codec):
    """The paged branches' lengths for the sharded call (the reference's
    ``layers._paged_attention`` under a mesh)."""
    if page_state.get("verify", False):
        mode, la, lb = ("verify", page_state["seq_lens"],
                        page_state["chunk_lens"])
    elif not page_state.get("prefill", False):
        sl = page_state["seq_lens"]
        mode, la, lb = "decode", sl, torch.zeros_like(sl)
    elif "start_pos" in page_state:
        mode, la, lb = ("prefill", page_state["start_pos"],
                        page_state["chunk_lens"])
    else:
        b, ell = q.shape[:2]
        mode = "prefill"
        la = torch.zeros((b,), dtype=torch.int32, device=q.device)
        lb = torch.full((b,), ell, dtype=torch.int32, device=q.device)
    return collectives.shardmap_paged_attention(
        q, k, v, cache, page_state["page_table"], la, lb, mesh=mesh,
        mode=mode, impl=impl, codec=codec)
