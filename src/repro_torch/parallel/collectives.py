"""Tensor- and data-parallel paged attention: the paper's multi-KV-block
merge (Fig. 2 / Eq. 16) across the ranks of a serving mesh.

The reference's ``shardmap_paged_attention`` (``src/repro/parallel/
collectives.py``) as a plain function of one rank's tensors, the ranks
being processes of a :class:`repro_torch.launch.mesh.Mesh`:

  * the pools keep the full page layout on every rank but only ``Hkv /
    tp`` KV heads, this rank's (``model_index``); page tables, lengths
    and every host structure stay replicated, so paging (refcounts, COW,
    the prefix cache, rollback) is untouched;
  * each rank encodes and scatters its heads' K/V of the whole batch
    (shard-local encode equals the global one: the codecs work a row of
    one head at a time) and computes the partial triplet (o~, m, l) of
    its heads through the same ``kernels/ops.py`` partials the
    single-shard path finalizes, on kernels 1-3;
  * it pads its triplet to full head width with the merge's neutral
    element (o~ = 0, m = NEG_INF, l = 0), the ranks of its "model" line
    all-gather the padded triplets, and :func:`repro_torch.kernels.
    decode.merge_partials` (shard 0 first) and ``finalize_decode`` (float
    divide or LogDiv) run on every rank.

A head's triplet comes from exactly one rank, and the merge with the
neutral element is an fp identity (the owner's weight is exp(0) = 1,
the neutral's l and o~ are exactly 0), so each head comes out bit-equal
to the single-shard finalize - provided the kernels compute that head as
the single-shard call does.  They do once the split rule sizes each
shard's grid for the whole call: the v2 decode and verify split each
page walk by the number of (slot, kv head) walks, so every call passes
``pairs`` = B Hkv of the global call (``cuda_lib.decode_splits``).

Data parallelism (a "data" axis of size dp > 1): when dp divides the
batch, each rank attends only its slots' slice (the page table and
lengths sliced alike, ``pairs`` still global) but scatters the whole
batch's K/V, so the pool replicas of a "model" column stay identical
with no collective; the outputs come back together by an all-gather
over the data line.  An odd batch (a chunked-prefill group) is computed
in full on every rank, the same arithmetic everywhere.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode as dk
from repro_torch.kernels import ops as kops
from repro_torch.kernels import page_codec
from repro_torch.kernels import paged_decode as paged_k
from repro_torch.kernels import paged_prefill as paged_pf_k

MODES = ("decode", "verify", "prefill")


def tp_shards(mesh, axis: str = "model") -> int:
    """Size of ``axis`` on ``mesh`` (1 = not sharded, or no mesh)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(axis, 1))


def head_slice(hkv: int, tp: int, shard: int) -> slice:
    """The KV heads shard ``shard`` of ``tp`` holds (heads are kv-major,
    so its query heads are those heads' G-groups)."""
    if hkv % tp:
        raise ValueError(f"paged TP needs kv_heads % tp == 0, got {hkv} % "
                         f"{tp}")
    n = hkv // tp
    return slice(shard * n, (shard + 1) * n)


def shard_pools(pools: dict, tp: int, shard: int) -> dict:
    """Shard ``shard``'s copy of full-width pools (P, page, Hkv, .) (the
    scale sidecars too): its KV heads, contiguous."""
    hs = head_slice(pools["k_pages"].shape[2], tp, shard)
    return {k: v[:, :, hs].contiguous() for k, v in pools.items()}


def shard_partials(mode: str, qg: torch.Tensor, pools: dict,
                   page_table: torch.Tensor, lens_a: torch.Tensor,
                   lens_b: torch.Tensor, *, pairs: int, impl: str = "fa2",
                   scale: float | None = None, codec=None):
    """One shard's partial triplet over the K/V already in its pools:
    ``qg`` grouped (B, Hkv_l, G, [L,] d) for its heads; lens as
    :func:`shardmap_paged_attention` takes them; ``pairs`` the (slot, kv
    head) walks of the whole call (the split rule)."""
    cod = page_codec.get_codec(codec)
    read = dict(impl=impl, scale=scale,
                codec=None if cod.name == "fp" else cod,
                k_scales=pools.get("k_scale"), v_scales=pools.get("v_scale"))
    kp, vp = pools["k_pages"], pools["v_pages"]
    if mode == "decode":
        kv_lens = torch.where(lens_a > 0, lens_a + 1,
                              torch.zeros_like(lens_a))
        return kops.paged_decode_partials(qg, kp, vp, page_table, kv_lens,
                                          pairs=pairs, **read)
    if mode == "verify":
        return kops.paged_verify_partials(qg, kp, vp, page_table, lens_a,
                                          lens_b, pairs=pairs, **read)
    return kops.paged_prefill_partials(qg, kp, vp, page_table, lens_a,
                                       (lens_a + lens_b).to(torch.int32),
                                       **read)


def pad_neutral(o: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                hkv: int, heads: slice) -> torch.Tensor:
    """A shard's triplet at full head width, the other heads the merge's
    neutral element, packed as one (B, Hkv, ..., d + 2) f32 tensor (o~,
    then m, then l) for a single all-gather."""
    full = list(o.shape)
    full[1] = hkv
    out = torch.zeros(full[:-1] + [full[-1] + 2], dtype=torch.float32,
                      device=o.device)
    out[..., -2] = dk.NEG_INF
    out[:, heads] = torch.cat([o, m[..., None], l[..., None]], dim=-1)
    return out


def merge_shards(packed: torch.Tensor, *, use_hfa: bool) -> torch.Tensor:
    """Eq. 16 over the gathered, padded triplets (shards, B, Hkv, ...,
    d + 2), shard 0 first, then the finalize: (B, Hkv, ..., d) f32."""
    o, m, l = packed[..., :-2], packed[..., -2], packed[..., -1]
    om, _, lm = dk.merge_partials(o, m, l, use_hfa=use_hfa)
    return dk.finalize_decode(om, lm, use_hfa=use_hfa)


def shardmap_paged_attention(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, pools: dict,
                             page_table: torch.Tensor, lens_a: torch.Tensor,
                             lens_b: torch.Tensor, *, mesh, mode: str,
                             impl: str = "fa2", scale: float | None = None,
                             codec=None):
    """Tensor- (and data-) parallel paged attention on this rank.

    q (B, L, H, dh) (decode L 1, verify L K, prefill the chunk) and
    k_new / v_new (B, L, Hkv, dh): this step's, at full head width (the
    model computes them replicated); ``pools`` this rank's {"k_pages",
    "v_pages"[, "k_scale", "v_scale"]}, each (P, page, Hkv / tp, .),
    written in place; ``page_table`` (B, J), ``lens_a`` (B,) the decode
    and verify seq_lens or the prefill start, ``lens_b`` (B,) the verify
    and prefill chunk lengths (zeros for decode) - all replicated.
    ``mesh``: a :class:`repro_torch.launch.mesh.Mesh` (``shape``,
    ``model_index``, ``data_index``, ``all_gather``).  Every rank of the
    mesh must make the call.  Returns (out (B, L, H, dh) in q's dtype,
    pools)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    b, _, h, _ = q.shape
    hkv = k_new.shape[2]
    tp, dp = tp_shards(mesh), tp_shards(mesh, "data")
    heads = head_slice(hkv, tp, mesh.model_index)
    cod = page_codec.get_codec(codec)
    lens_a = lens_a.to(torch.int32)
    lens_b = lens_b.to(torch.int32)
    # Every data shard writes the whole batch: its pool replica stays
    # the same as the others' with no collective.
    k_loc, v_loc = k_new[:, :, heads], v_new[:, :, heads]
    if mode == "decode":
        pools = page_codec.encode_write(paged_k.append_kv, cod, pools,
                                        k_loc, v_loc, page_table, lens_a)
    else:
        pools = page_codec.encode_write(paged_pf_k.write_chunk_kv, cod,
                                        pools, k_loc, v_loc, page_table,
                                        lens_a, lens_b)
    shard_b = dp > 1 and b % dp == 0
    rows = slice(None)
    if shard_b:
        bl = b // dp
        rows = slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)
    g = h // hkv
    # (B, L, H_l, d) -> (B, Hkv_l, G, L, d), heads kv-major; decode has
    # no L axis.
    qg = kops._group(q[rows][:, :, heads.start * g:heads.stop * g],
                     heads.stop - heads.start)
    if mode == "decode":
        qg = qg[:, :, :, 0]
    o, m, l = shard_partials(mode, qg, pools, page_table[rows],
                             lens_a[rows], lens_b[rows], pairs=b * hkv,
                             impl=impl, scale=scale, codec=cod)
    packed = mesh.all_gather(pad_neutral(o, m, l, hkv, heads), "model")
    out = merge_shards(packed, use_hfa=impl.startswith("hfa"))
    out = kops._ungroup(out[:, :, :, None] if mode == "decode" else out,
                        q.dtype)
    if shard_b:
        out = torch.cat(tuple(mesh.all_gather(out, "data")), dim=0)
    return out, pools
