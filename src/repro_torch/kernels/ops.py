"""Attention ops: GQA plumbing, padding and impl dispatch around the
kernels.

``multihead_attention`` is what the model's dense (training) attention
calls: (B, Lq, H, d) queries against (B, Lkv, Hkv, d) keys/values, heads
repeated kv-major to H, sequences padded to the block sizes, the kernel
run through a ``torch.autograd.Function`` (:class:`_KernelAttention`,
the reference's ``_pallas_attention`` custom_vjp) and the padding cut
off again.  Impl names keep the reference's meaning:

  exact          dense softmax in f32 (plain torch)
  fa2            FA-2 forward + dq + dk/dv kernels (exact softmax in f32,
                 as the reference's jnp FA-2)
  fa2_pallas     the same kernels (the reference's Pallas FA-2)
  hfa_pallas     the H-FA forward kernel; backward = autograd through
                 the tile oracle under the STE
  hfa            the per-element H-FA: the ``core/hfa.py`` emulation on
                 the CPU, the datapath kernel on the card (bit-identical
                 by the reference's own gate); forward only
  hfa_datapath   the per-element LNS datapath kernel (its plain version,
                 the same emulation, on the CPU); forward only

``decode_attention`` is the dense ring's single-token decode: the
grouped queries against the (B, S, Hkv, d) cache through the dense
decode kernel (:func:`repro_torch.kernels.decode.decode_partial`), read
in place, then the float divide or LogDiv.

The paged half below serves the engine:

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

from repro_torch.core import reference
from repro_torch.kernels import decode as decode_k
from repro_torch.kernels import fa2 as fa2_k
from repro_torch.kernels import fa2_bwd
from repro_torch.kernels import hfa as hfa_k
from repro_torch.kernels import hfa_datapath as dp_k
from repro_torch.kernels import ref as kref
from repro_torch.kernels import paged_decode as paged_k
from repro_torch.kernels import paged_prefill as paged_pf_k
from repro_torch.kernels import paged_verify as paged_v_k


IMPLS = ("exact", "fa2", "hfa", "fa2_pallas", "hfa_pallas", "hfa_datapath")
# impl -> rail of the dense kernels
_KERNEL_RAIL = {"fa2": "fa2", "fa2_pallas": "fa2", "hfa_pallas": "hfa"}


def _pad_to(x: torch.Tensor, axis: int, mult: int) -> tuple[torch.Tensor, int]:
    """Zero-pad ``axis`` up to a multiple of ``mult``; returns (x, old n)."""
    n = x.shape[axis]
    pad = (-n) % mult
    if pad == 0:
        return x, n
    widths = [0, 0] * (x.dim() - 1 - axis) + [0, pad]
    return torch.nn.functional.pad(x, widths), n


def _gqa_expand(k: torch.Tensor, hq: int) -> torch.Tensor:
    """Repeat KV heads to H query heads, kv-major (``jnp.repeat``
    order): (B, L, Hkv, d) -> (B, L, H, d)."""
    hkv = k.shape[2]
    if hkv == hq:
        return k
    if hq % hkv:
        raise ValueError(f"{hq} query heads over {hkv} KV heads")
    return torch.repeat_interleave(k, hq // hkv, dim=2)


class _KernelAttention(torch.autograd.Function):
    """Differentiable kernel attention over padded (BH, L, d) tiles.

    fa2: the FA-2 forward kernel saves (q, k, v, O, LSE) and the
    backward runs the dq and dk/dv kernels, with the cotangent in q's
    dtype when q is bf16.  hfa: the H-FA forward
    kernel; the backward differentiates the tile oracle on the unpadded
    keys with the cotangent in f32, so the gradient follows the
    quantized numerics the kernel computed (STE) - the reference's
    ``ops._pallas_attention_bwd``.
    """

    @staticmethod
    def forward(ctx, q3, k3, v3, rail, causal, scale, block_q, block_kv,
                kv_len, q_offset):
        kw = dict(causal=causal, scale=scale, block_q=block_q,
                  block_kv=block_kv, kv_len=kv_len, q_offset=q_offset)
        ctx.kw, ctx.rail = kw, rail
        if rail == "fa2":
            out, lse = fa2_k.fa2_forward(q3, k3, v3, return_lse=True, **kw)
            ctx.save_for_backward(q3, k3, v3, out, lse)
        else:
            out = hfa_k.hfa_forward(q3, k3, v3, **kw)
            ctx.save_for_backward(q3, k3, v3)
        return out

    @staticmethod
    def backward(ctx, g):
        kw = ctx.kw
        if ctx.rail == "fa2":
            q3, k3, v3, out, lse = ctx.saved_tensors
            if q3.dtype == torch.bfloat16:
                # Exact: multihead_attention casts this Function's f32
                # output to bf16, so the cotangent holds bf16 values; in
                # bf16 it reaches the tensor-core backward.
                g = g.to(torch.bfloat16)
            dq, dk, dv = fa2_bwd.fa2_backward(q3, k3, v3, out, g, lse, **kw)
        else:
            q3, k3, v3 = ctx.saved_tensors
            with torch.enable_grad():
                q, k, v = (t.detach().requires_grad_() for t in (q3, k3, v3))
                n = kw["kv_len"]
                out = kref.ref_hfa_mxu(q, k[:, :n], v[:, :n],
                                       causal=kw["causal"], scale=kw["scale"],
                                       block_kv=kw["block_kv"],
                                       q_offset=kw["q_offset"])
                dq, dk, dv = torch.autograd.grad(out, (q, k, v),
                                                 g.to(torch.float32))
        return (dq.to(q3.dtype), dk.to(k3.dtype), dv.to(v3.dtype),
                None, None, None, None, None, None, None)


def multihead_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, impl: str = "fa2", causal: bool = True,
                        scale: float | None = None, block_q: int = 128,
                        block_kv: int = 128) -> torch.Tensor:
    """Multi-head attention: q (B, Lq, H, d), k/v (B, Lkv, Hkv, d) with
    Hkv | H; returns (B, Lq, H, d) in q's dtype."""
    if impl not in IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; have {IMPLS}")
    b, lq, h, d = q.shape
    lkv = k.shape[1]
    k = _gqa_expand(k, h)
    v = _gqa_expand(v, h)
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, L, d)
    if impl == "exact":
        out = reference.exact_attention(qh, kh, vh, causal=causal,
                                        scale=scale)
    elif impl in ("hfa", "hfa_datapath"):
        out = dp_k.hfa_datapath(
            *(t.reshape(b * h, -1, d).contiguous() for t in (qh, kh, vh)),
            causal=causal, scale=scale).reshape(b, h, lq, d)
    else:
        q3 = qh.reshape(b * h, lq, d)
        k3 = kh.reshape(b * h, lkv, d)
        v3 = vh.reshape(b * h, lkv, d)
        q3, lq0 = _pad_to(q3, 1, block_q)
        k3, lkv0 = _pad_to(k3, 1, block_kv)
        v3, _ = _pad_to(v3, 1, block_kv)
        out = _KernelAttention.apply(
            q3.contiguous(), k3.contiguous(), v3.contiguous(),
            _KERNEL_RAIL[impl], causal, scale, block_q, block_kv, lkv0,
            lkv0 - lq0)
        out = out[:, :lq0].reshape(b, h, lq, d)
    return out.transpose(1, 2).to(q.dtype)


def _use_hfa(impl: str) -> bool:
    return impl.startswith("hfa")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, impl: str = "fa2",
                     scale: float | None = None, kv_len: int | None = None,
                     block_kv: int = 128) -> torch.Tensor:
    """Single-token decode attention against a dense KV ring.

    q (B, 1, H, d); k_cache, v_cache (B, S, Hkv, d); ``kv_len`` (a host
    int, default S) masks the unwritten slots.  Every impl runs the
    dense decode kernel on its rail ("hfa..." the H-FA rail, anything
    else fa2) over the ring in place, then the float divide or LogDiv.
    Returns (B, 1, H, d) in q's dtype.
    """
    b, one, h, d = q.shape
    assert one == 1, q.shape
    hkv = k_cache.shape[2]
    use_hfa = _use_hfa(impl)
    qg = q.reshape(b, hkv, h // hkv, d)
    o, _, ell = decode_k.decode_partial(
        qg, k_cache.transpose(1, 2), v_cache.transpose(1, 2), scale=scale,
        block_kv=block_kv, kv_len=kv_len, use_hfa=use_hfa)
    out = decode_k.finalize_decode(o, ell, use_hfa=use_hfa)
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_decode_partials(qg, k_pages, v_pages, page_table, kv_lens, *,
                          impl: str = "fa2", scale: float | None = None,
                          codec=None, k_scales=None, v_scales=None,
                          pairs: int | None = None):
    """Paged decode partial triplet: (o~ (B,Hkv,G,d), m/l (B,Hkv,G)).
    ``codec`` (None: the raw fp pool) and the scale sidecars select the
    page codec the kernels decode each tile with; ``pairs`` the (slot, kv
    head) walks of the whole call a shard belongs to (the split rule)."""
    return paged_k.paged_decode_partial(
        qg.contiguous(), k_pages, v_pages, page_table, kv_lens,
        scale=scale, use_hfa=_use_hfa(impl), codec=codec,
        k_scales=k_scales, v_scales=v_scales, pairs=pairs)


def paged_prefill_partials(qg, k_pages, v_pages, page_table, start_pos,
                           kv_lens, *, impl: str = "fa2",
                           scale: float | None = None, codec=None,
                           k_scales=None, v_scales=None):
    """Paged chunked-prefill partial triplet: shapes (B,Hkv,G,L,[d])."""
    return paged_pf_k.paged_prefill_partial(
        qg.contiguous(), k_pages, v_pages, page_table, start_pos, kv_lens,
        scale=scale, use_hfa=_use_hfa(impl), codec=codec,
        k_scales=k_scales, v_scales=v_scales)


def paged_verify_partials(qg, k_pages, v_pages, page_table, seq_lens,
                          chunk_lens, *, impl: str = "fa2",
                          scale: float | None = None, codec=None,
                          k_scales=None, v_scales=None,
                          pairs: int | None = None):
    """Paged speculative-verify partial triplet: shapes (B,Hkv,G,K,[d])."""
    return paged_v_k.paged_verify_partial(
        qg.contiguous(), k_pages, v_pages, page_table, seq_lens, chunk_lens,
        scale=scale, use_hfa=_use_hfa(impl), codec=codec,
        k_scales=k_scales, v_scales=v_scales, pairs=pairs)


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
                            scale: float | None = None, codec=None,
                            k_scales=None, v_scales=None) -> torch.Tensor:
    """Chunked-prefill attention against a paged KV cache.

    q (B, L, H, d); the chunk's K/V must already be in the pools
    (:func:`paged_prefill.write_chunk_kv`).  Returns (B, L, H, d) in
    q's dtype.
    """
    kv_lens = (start_pos + chunk_lens).to(torch.int32)
    o, _, ell = paged_prefill_partials(
        _group(q, k_pages.shape[2]), k_pages, v_pages, page_table,
        start_pos, kv_lens, impl=impl, scale=scale, codec=codec,
        k_scales=k_scales, v_scales=v_scales)
    out = decode_k.finalize_decode(o, ell, use_hfa=_use_hfa(impl))
    return _ungroup(out, q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, kv_lens, *,
                           impl: str = "fa2", scale: float | None = None,
                           codec=None, k_scales=None,
                           v_scales=None) -> torch.Tensor:
    """Continuous-batching decode attention against a paged KV cache:
    q (B, 1, H, d), kv_lens (B,) with 0 marking a free slot."""
    b, one, h, d = q.shape
    assert one == 1, q.shape
    hkv = k_pages.shape[2]
    qg = q.reshape(b, hkv, h // hkv, d)
    o, _, ell = paged_decode_partials(qg, k_pages, v_pages, page_table,
                                      kv_lens, impl=impl, scale=scale,
                                      codec=codec, k_scales=k_scales,
                                      v_scales=v_scales)
    out = decode_k.finalize_decode(o, ell, use_hfa=_use_hfa(impl))
    return out.reshape(b, 1, h, d).to(q.dtype)


def paged_verify_attention(q, k_pages, v_pages, page_table, seq_lens,
                           chunk_lens, *, impl: str = "fa2",
                           scale: float | None = None, codec=None,
                           k_scales=None, v_scales=None) -> torch.Tensor:
    """Multi-query speculative-verify attention: q (B, K, H, d), token i
    of slot b at ``seq_lens[b] + i`` (its K/V already written).  Rows at
    ``i >= chunk_lens[b]`` are garbage the caller ignores."""
    o, _, ell = paged_verify_partials(
        _group(q, k_pages.shape[2]), k_pages, v_pages, page_table,
        seq_lens, chunk_lens, impl=impl, scale=scale, codec=codec,
        k_scales=k_scales, v_scales=v_scales)
    out = decode_k.finalize_decode(o, ell, use_hfa=_use_hfa(impl))
    return _ungroup(out, q.dtype)
