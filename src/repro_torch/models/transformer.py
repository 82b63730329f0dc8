"""Pre-norm transformer blocks and the cache layouts.

A block is a mixer - attention, or the Mamba-2 SSD mixer
(:mod:`repro_torch.models.mamba2`) - and an FFN - dense SwiGLU, a
Mixture-of-Experts (:mod:`repro_torch.models.moe`) or none (a pure SSM
stack) - as ``period_pattern`` names them for the layer, each behind an
RMSNorm with a residual.  A block returns its
FFN's aux losses (empty for a dense FFN) and ``stack_apply`` sums them
over the layers on every path: training, the dense ring and the paged
pools.  The reference scans over a leading ``groups`` axis
(``lax.scan``); here the layers are an ``nn.ModuleList`` walked by a
Python loop.  Both caches keep the reference's stacked layout: the
paged KV pools ``{"l{i}": {"k_pages", "v_pages"}}`` with leaves (groups,
P, page, Hkv, dh), and the dense caches - rings ``{"l{i}": {"k", "v"}}``
with leaves (groups, B, max_seq, Hkv, dh) for attention layers, Mamba
states ``{"l{i}": {"ssm", "conv_x", "conv_B", "conv_C"}}`` with leaves
(groups, B, ...) for Mamba layers.  Layer ``g * period + i`` reads
``["l{i}"][...][g]`` - a view, so the in-place ring writes land in the
stacked tensor; a Mamba layer's new state is copied into it.

Without caches (training) each block runs under
``torch.utils.checkpoint`` when ``cfg.remat == "full"``: its
activations are recomputed in the backward, as ``jax.checkpoint`` does
around the reference's scan body.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import page_codec
from repro_torch.models import layers as L
from repro_torch.models import mamba2, moe


class Block(nn.Module):
    """A mixer of kind ``kind`` ("attn", "mamba": :class:`repro_torch.
    models.mamba2.Mamba2`) + an FFN of kind ``ffn_kind`` ("dense":
    SwiGLU, "moe": :class:`repro_torch.models.moe.MoE`, "none": no FFN
    and no second norm), pre-norm residual."""

    def __init__(self, cfg, dtype, device, ffn_kind: str = "dense",
                 kind: str = "attn"):
        super().__init__()
        if ffn_kind not in ("dense", "moe", "none") \
                or kind not in ("attn", "mamba"):
            raise NotImplementedError(
                f"block {kind!r} / FFN {ffn_kind!r} is not ported "
                "(ROADMAP.md Queue 1 item 13b)")
        self.kind, self.ffn_kind = kind, ffn_kind
        self.norm1 = L.RMSNorm(cfg.d_model, dtype, device)
        self.mixer = (L.Attention(cfg, dtype, device) if kind == "attn"
                      else mamba2.Mamba2(cfg, dtype, device))
        if ffn_kind != "none":
            self.norm2 = L.RMSNorm(cfg.d_model, dtype, device)
            self.ffn = (moe.MoE(cfg, dtype, device) if ffn_kind == "moe"
                        else L.SwiGLU(cfg.d_model, cfg.d_ff, dtype, device))


def block_apply(blk: Block, x, cfg, *, positions=None, cache=None,
                cache_pos=None, page_state=None):
    """Returns (x, this layer's cache or None without one - a Mamba
    layer's new state -, aux losses: the MoE's {load_balance, router_z},
    empty for a dense FFN or none)."""
    h = L.rmsnorm_apply(blk.norm1, x, cfg.norm_eps)
    if blk.kind == "mamba":
        y, new_cache = mamba2.mamba_apply(blk.mixer, h, cfg, state=cache)
        if cache is None:
            new_cache = None
    else:
        y, new_cache = L.attention_apply(blk.mixer, h, cfg,
                                         positions=positions, cache=cache,
                                         cache_pos=cache_pos,
                                         page_state=page_state)
    x = x + y
    if blk.ffn_kind == "none":
        return x, new_cache, {}
    h = L.rmsnorm_apply(blk.norm2, x, cfg.norm_eps)
    if blk.ffn_kind == "moe":
        y, aux = moe.moe_apply(blk.ffn, h, cfg)
    else:
        y, aux = L.swiglu_apply(blk.ffn, h), {}
    return x + y, new_cache, aux


def period_pattern(cfg) -> tuple[list[str], list[str], int]:
    """(mixer kinds, ffn kinds, period length) - the repeating unit the
    stacked cache layout is grouped by."""
    kinds = cfg.layer_kinds()
    ffns = cfg.ffn_kinds()
    n = cfg.n_layers
    for p in range(1, n + 1):
        if n % p:
            continue
        if (kinds == kinds[:p] * (n // p)) and (ffns == ffns[:p] * (n // p)):
            return kinds[:p], ffns[:p], p
    return kinds, ffns, n


def _block_out(blk: Block, x, cfg):
    x, _, aux = block_apply(blk, x, cfg)
    return x, aux


def stack_apply(layers: nn.ModuleList, x, cfg, *, positions=None,
                caches=None, cache_pos=None, page_state=None):
    """Run every layer; returns (x, caches, aux summed over the layers:
    {load_balance, router_z}, f32 zeros for a dense stack).  ``caches``
    are the stacked paged pools (with ``page_state``, shared by all
    layers of one step) or dense rings (with ``cache_pos``, a host int),
    updated in place; without caches the stack is the dense causal
    (training) forward, each block checkpointed under ``cfg.remat ==
    "full"``."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    total = {"load_balance": zero, "router_z": zero}
    period = period_pattern(cfg)[2]
    for idx, blk in enumerate(layers):
        if caches is None:
            if cfg.remat == "none":
                x, aux = _block_out(blk, x, cfg)
            else:
                x, aux = checkpoint(_block_out, blk, x, cfg,
                                    use_reentrant=False)
        else:
            g, i = divmod(idx, period)
            cache = {key: pool[g] for key, pool in caches[f"l{i}"].items()}
            x, new, aux = block_apply(blk, x, cfg, positions=positions,
                                      cache=cache, cache_pos=cache_pos,
                                      page_state=page_state)
            if blk.kind == "mamba":
                for key, val in new.items():
                    cache[key].copy_(val)
        for key, val in aux.items():
            total[key] = total[key] + val
    return x, caches, total


def stack_init_cache(cfg, batch: int, max_seq: int, dtype, device):
    """Dense caches for fixed-batch decode, stacked with a leading groups
    axis and zero-filled: an attention layer's ring (groups, B, max_seq,
    Hkv, dh) for k and v, a Mamba layer's state (``mamba2.
    mamba_init_state``: the f32 SSM state, the conv windows in
    ``dtype``).  No encoder cross caches (ROADMAP.md Queue 1 item 13b)."""
    kinds, _, period = period_pattern(cfg)
    groups = cfg.n_layers // period

    def one_layer(kind):
        if kind == "mamba":
            return {key: torch.zeros((groups,) + tuple(t.shape),
                                     dtype=t.dtype, device=device)
                    for key, t in mamba2.mamba_init_state(
                        cfg, batch, dtype, "meta").items()}
        shape = (groups, batch, max_seq, cfg.n_kv_heads, cfg.d_head)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    return {f"l{i}": one_layer(kinds[i]) for i in range(period)}


def stack_init_paged_cache(cfg, num_pages: int, page_size: int, dtype,
                           device, codec: str = "fp",
                           n_kv_heads: int | None = None):
    """Paged block-pool caches, stacked (groups, P, page, Hkv, dh), one
    shared pool per layer, zero-filled.  The data pools take the codec's
    storage dtype; a codec with scales adds f32 sidecar pools "k_scale" /
    "v_scale" of shape (groups, P, page, Hkv, 1), which every page-table
    mechanism (scatter, copy-on-write, gather) treats as it treats the
    data.  ``n_kv_heads`` (default the config's): the heads the pools
    hold, a tensor-parallel shard's share."""
    kinds, _, period = period_pattern(cfg)
    groups = cfg.n_layers // period
    if not all(k == "attn" for k in kinds):
        raise NotImplementedError(
            f"paged KV cache supports attention-only stacks, got {kinds} "
            "(ROADMAP.md Queue 1 item 13b)")
    c = page_codec.get_codec(codec)
    sdt = c.storage_dtype(dtype)
    hkv = cfg.n_kv_heads if n_kv_heads is None else n_kv_heads
    shape = (groups, num_pages, page_size, hkv, cfg.d_head)

    def one_layer():
        leaves = {"k_pages": torch.zeros(shape, dtype=sdt, device=device),
                  "v_pages": torch.zeros(shape, dtype=sdt, device=device)}
        if c.has_scales:
            for key in ("k_scale", "v_scale"):
                leaves[key] = torch.zeros(shape[:-1] + (1,),
                                          dtype=torch.float32, device=device)
        return leaves

    return {f"l{i}": one_layer() for i in range(period)}
