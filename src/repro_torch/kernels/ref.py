"""Plain oracles of the dense attention kernels.

* ``ref_fa2``     - FA-2 is exact attention in f32.
* ``ref_hfa_mxu`` - the tile-level H-FA oracle: the same 128-key tile
  walk, diagonal skip, BF16 score rounding and rail ops as the H-FA
  kernel (``kernels/hfa.py``).  It is the kernel's plain version and,
  under autograd, its backward: the rail functions carry the
  straight-through estimator (``bitmath._ste``), as in the reference.
* ``ref_hfa_walk`` - the same walk fed precomputed bf16 scores (the
  checks feed it the scores the tensor-core kernel formed).
* ``ref_decode_partial`` - the streamed decode triplet over one KV span
  (the reference's oracle of ``decode_partial_pallas``; no ``kv_len``
  mask).
* ``ref_hfa_datapath`` - the bit-accurate ``core.hfa`` emulation.
* ``paged_prefill_tc_model`` - a model of the tensor-core paged
  prefill's numerics (page by page, P as bf16 or bf16 hi + lo).
* ``paged_walk_model`` - the paged kernels' walk (``paged_attention.cu``
  and the v2 decode and verify): per-row causal limits, the online
  update one rescale step at a time - 16 keys on the FA-2 rail, one page
  on the H-FA rail, as the reference - and the split walk's Eq. 16
  merge; ``paged_verify_split_model``, ``paged_decode_split_model`` and
  ``paged_prefill_model`` are its verify, decode and prefill.
* ``dense_decode_split_model`` - the same for the dense decode's walk of
  128-key tiles.
* ``datapath_update_model`` - the per-element datapath kernel's column
  update (``csrc/hfa_datapath.cu``): the rescales and lns_add with only
  the cases its operands reach.

The models are for the tests only; the kernels' plain versions stay
``paged_prefill_partial_plain``, ``paged_verify_partial_plain``,
``paged_decode_partial_plain`` and ``decode_partial_plain``.
"""
from __future__ import annotations

import torch

from repro_torch.core import hfa as core_hfa
from repro_torch.core import lns
from repro_torch.core import reference
from repro_torch.core.numerics import LOG_ZERO
from repro_torch.kernels import bitmath
from repro_torch.kernels.decode import decode_partial_plain, merge_partials
from repro_torch.kernels.paged_decode import gather_pages

NEG_INF = -1e30


def ref_fa2(q, k, v, *, causal=False, scale=None):
    """Oracle for the FA-2 kernel: exact attention in f32."""
    return reference.exact_attention(q, k, v, causal=causal, scale=scale)


def ref_hfa_mxu(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                causal: bool = False, scale: float | None = None,
                block_kv: int = 128, q_offset: int | None = None):
    """H-FA over (..., Lq, d) x (..., Lkv, d) -> (..., Lq, d) f32.

    KV is walked in blocks of ``block_kv`` (the kernel's sequential
    axis), all queries at once.  Lkv may be a non-multiple of
    ``block_kv`` (padded and masked, as the kernel sees its padding);
    ``q_offset`` is the causal position of query 0 (default Lkv - Lq).
    """
    d = q.shape[-1]
    scale_v = (1.0 / d ** 0.5) if scale is None else scale
    lkv = k.shape[-2]
    pad = (-lkv) % block_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
    qf = q.to(torch.float32)

    def scores(k0):
        kb = k[..., k0:k0 + block_kv, :].to(torch.float32)
        s = torch.einsum("...qd,...kd->...qk", qf, kb) * scale_v
        return s.to(torch.bfloat16).to(torch.float32)  # BF16 score datapath
    return _hfa_walk(scores, v, q.shape[-2], causal=causal,
                     block_kv=block_kv, q_offset=q_offset)


def ref_hfa_walk(s: torch.Tensor, v: torch.Tensor, *, causal: bool = False,
                 block_kv: int = 128, q_offset: int | None = None):
    """The walk of :func:`ref_hfa_mxu` fed precomputed bf16 scores s
    (..., Lq, Lkv) - already scaled and rounded, such as the ones the
    tensor-core kernel writes out - in place of its QK^T einsum; the
    same masks, tiles, rail and finalize.  Fed ``ref_hfa_mxu``'s own
    scores it returns ``ref_hfa_mxu``'s output bit for bit."""
    pad = (-s.shape[-1]) % block_kv
    if pad:
        s = torch.nn.functional.pad(s, (0, pad))
    return _hfa_walk(lambda k0: s[..., k0:k0 + block_kv].to(torch.float32),
                     v, s.shape[-2], causal=causal, block_kv=block_kv,
                     q_offset=q_offset)


def _hfa_walk(scores, v, lq, *, causal, block_kv, q_offset):
    """The H-FA tile walk over v (..., Lkv, d): ``scores(k0)`` gives the
    bf16-valued f32 score tile of keys k0 .. k0 + block_kv (zero-padded
    past Lkv, where the mask hides it)."""
    lkv, d = v.shape[-2], v.shape[-1]
    pad = (-lkv) % block_kv
    if pad:
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    if q_offset is None:
        q_offset = lkv - lq
    batch = v.shape[:-2]
    m = torch.full(batch + (lq,), NEG_INF, dtype=torch.float32,
                   device=v.device)
    l = torch.zeros(batch + (lq,), dtype=torch.float32, device=v.device)
    acc = torch.zeros(batch + (lq, d), dtype=torch.float32, device=v.device)
    q_ids = q_offset + torch.arange(lq, device=v.device)[:, None]
    for k0 in range(0, lkv + pad, block_kv):
        if causal and k0 > q_offset + lq - 1:
            break          # the kernel skips blocks above the diagonal
        vb = v[..., k0:k0 + block_kv, :].to(torch.float32)
        s = scores(k0)
        kv_ids = k0 + torch.arange(block_kv, device=v.device)[None, :]
        mask = (kv_ids < lkv).expand(lq, block_kv)
        if causal:
            mask = mask & (kv_ids <= q_ids)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        alpha = bitmath.exp2_hfa_rail(bitmath.quant_rail(
            torch.minimum(m - m_new, torch.zeros_like(m))))
        p = bitmath.exp2_hfa_rail(bitmath.quant_rail(s - m_new[..., None]))
        p = torch.where(mask & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("...qk,...kd->...qd",
                                                    p, vb)
        m = m_new
    dead = l <= 0.0
    safe = torch.where(dead, torch.ones_like(l), l)
    recip = bitmath.recip_logdiv(safe)
    recip = torch.where(dead, torch.zeros_like(recip), recip)
    return acc * recip[..., None]


def ref_decode_partial(q, k, v, *, scale=None, use_hfa=False, block_kv=128):
    """Oracle of the dense decode kernel: the streamed triplet (o~, m, l)
    of q (..., G, d) over k, v (..., S, d) - the kernel's plain version
    with no ``kv_len`` mask."""
    return decode_partial_plain(q, k, v, scale=scale, block_kv=block_kv,
                                use_hfa=use_hfa)


def ref_hfa_datapath(q, k, v, *, causal=False, scale=None):
    """Oracle of the per-element datapath kernel: the bit-accurate
    ``core.hfa`` emulation, (..., Lq, d) bf16."""
    return core_hfa.hfa_attention(q, k, v, causal=causal, scale=scale)


def paged_prefill_tc_model(q, k_pages, v_pages, page_table, start_pos,
                           kv_lens, *, scale=None, use_hfa=False):
    """Model of ``paged_prefill_fwd_tc``: the online update one page of
    the pools at a time, in order (the reference's page grid axis), f32
    scores and p, l = l alpha + sum p (two roundings), and P V with P in
    bf16 - exact on the H-FA rail, where every p is g7/128 2^-k - or as
    bf16 hi + lo on the FA-2 rail: acc = (acc alpha + P_hi V) + P_lo V.
    q (B, Hkv, G, L, d); masks and returns as ``paged_prefill_partial``."""
    b, hkv, g, ell, d = q.shape
    page = k_pages.shape[1]
    scale = (1.0 / d ** 0.5) if scale is None else scale
    qf = q.to(torch.float32)
    q_pos = start_pos.to(torch.int32)[:, None] + torch.arange(
        ell, dtype=torch.int32, device=q.device)[None]          # (B, L)
    kvl = kv_lens.to(torch.int32)
    m = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for j in range(page_table.shape[1]):
        ids = page_table[:, j].to(torch.int64)
        kp = k_pages[ids].to(torch.float32).transpose(1, 2)   # (B, Hkv, page, d)
        vp = v_pages[ids].to(torch.float32).transpose(1, 2)
        s = torch.einsum("bhgld,bhkd->bhglk", qf, kp) * scale
        kv = j * page + torch.arange(page, dtype=torch.int32,
                                     device=q.device)
        mask = (kv[None, None] <= q_pos[..., None]) & \
            (kv[None, None] < kvl[:, None, None])
        mask = mask[:, None, None]                             # (B,1,1,L,page)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        dm = torch.minimum(m - m_new, torch.zeros_like(m))
        if use_hfa:
            alpha = bitmath.exp2_hfa_rail(bitmath.quant_rail(dm))
            p = bitmath.exp2_hfa_rail(bitmath.quant_rail(s - m_new[..., None]))
        else:
            alpha = torch.exp(dm)
            p = torch.exp(s - m_new[..., None])
        p = torch.where(mask & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        l = l * alpha + torch.sum(p, dim=-1)
        hi = p.to(torch.bfloat16).to(torch.float32)
        acc = acc * alpha[..., None] + torch.einsum("bhglk,bhkd->bhgld", hi, vp)
        if not use_hfa:
            lo = (p - hi).to(torch.bfloat16).to(torch.float32)
            acc = acc + torch.einsum("bhglk,bhkd->bhgld", lo, vp)
        m = m_new
    return acc, m, l


DECODE_TILE = 16      # keys a rescale takes on the FA-2 rail (both walks)


def paged_rescale_step(page: int, use_hfa: bool) -> int:
    """Keys per online update of the paged kernels' walk: 16 on the FA-2
    rail at any page size; the page on the H-FA rail, where the output
    depends on where the rescales fall and the reference rescales once a
    page."""
    return page if use_hfa else DECODE_TILE


def _tile_walk(qf, kc, vc, mask, tile, scale, use_hfa):
    """The online update ``tile`` keys at a time, in order: qf (..., R,
    d) f32 against kc, vc (..., S, d) f32 (S a multiple of ``tile``),
    scores times ``scale``, key s visible to row r where mask (..., R,
    S).  Returns (o~, m, l).  With ``tile`` the page it is the
    reference's walk."""
    m = torch.full(qf.shape[:-1], NEG_INF, dtype=torch.float32,
                   device=qf.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(qf.shape, dtype=torch.float32, device=qf.device)
    for k0 in range(0, kc.shape[-2], tile):
        mk = mask[..., k0:k0 + tile]
        s = torch.einsum("...rd,...kd->...rk", qf,
                         kc[..., k0:k0 + tile, :]) * scale
        s = torch.where(mk, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        dm = torch.minimum(m - m_new, torch.zeros_like(m))
        if use_hfa:
            alpha = bitmath.exp2_hfa_rail(bitmath.quant_rail(dm))
            p = bitmath.exp2_hfa_rail(bitmath.quant_rail(s - m_new[..., None]))
        else:
            alpha = torch.exp(dm)
            p = torch.exp(s - m_new[..., None])
        p = torch.where(mk & (m_new != NEG_INF)[..., None], p,
                        torch.zeros_like(p))
        l = l * alpha + torch.sum(p, dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "...rk,...kd->...rd", p, vc[..., k0:k0 + tile, :])
        m = m_new
    return acc, m, l


def _runs(n_tiles: int, splits: int):
    """The v2 kernels' cut of a walk of ``n_tiles`` tiles into ``splits``
    contiguous runs of ceil(n_tiles / splits) tiles: [(t0, t1), ...]."""
    per = -(-n_tiles // splits)
    return [(min(sp * per, n_tiles), min(min(sp * per, n_tiles) + per,
                                          n_tiles)) for sp in range(splits)]


def paged_walk_model(q, k_pages, v_pages, page_table, base, limit, *,
                     splits=1, scale=None, use_hfa=False):
    """Model of the paged kernels' walk: row r of the G L rows of a (slot,
    kv head) sees kv <= base[b] + r % L and kv < limit[b].  Slot b's walk
    of n = ceil(min(base[b] + L, limit[b], J page) / t) steps of t keys -
    t = :func:`paged_rescale_step` (16 on the FA-2 rail, the page on the
    H-FA rail) - is cut into ``splits`` contiguous runs of ceil(n /
    splits) steps; each run's triplet is the online update step by step
    (p in f32); the runs merge by Eq. 16 (``merge_partials``).  A run with
    no step is the neutral triplet.  One split is the unsplit walk (the
    only one the H-FA rail runs).  q (B, Hkv, G, L, d); returns o~ (B,
    Hkv, G, L, d), m and l (B, Hkv, G, L)."""
    b, hkv, g, ell, d = q.shape
    scale = (1.0 / d ** 0.5) if scale is None else scale
    tile = paged_rescale_step(k_pages.shape[1], use_hfa)
    j_max = page_table.shape[1] * k_pages.shape[1]
    pad = (-j_max) % tile
    kc, vc = (torch.nn.functional.pad(
        gather_pages(x, page_table).transpose(1, 2).to(torch.float32),
        (0, 0, 0, pad)) for x in (k_pages, v_pages))   # (B, Hkv, S, d)
    qf = q.to(torch.float32).reshape(b, hkv, g * ell, d)
    kv = torch.arange(j_max + pad, device=q.device)
    outs = []
    for bi in range(b):
        lo, hi = int(base[bi]), int(limit[bi])
        n_kv = max(0, min(lo + ell, hi, j_max))
        pos = lo + torch.arange(g * ell, device=q.device) % ell  # (R,)
        mask = (kv[None] <= pos[:, None]) & (kv[None] < hi) & \
            (kv[None] < n_kv)
        parts = []
        for t0, t1 in _runs(-(-n_kv // tile), splits):
            k0, k1 = t0 * tile, t1 * tile
            parts.append(_tile_walk(qf[bi], kc[bi, :, k0:k1],
                                    vc[bi, :, k0:k1], mask[:, k0:k1],
                                    tile, scale, use_hfa))
        outs.append(parts[0] if splits == 1 else merge_partials(
            *(torch.stack(x) for x in zip(*parts)), use_hfa=use_hfa))
    o, m, l = (torch.stack(x) for x in zip(*outs))
    return (o.reshape(q.shape), m.reshape(q.shape[:-1]),
            l.reshape(q.shape[:-1]))


def paged_verify_split_model(q, k_pages, v_pages, page_table, seq_lens,
                             chunk_lens, *, splits, scale=None,
                             use_hfa=False):
    """Model of ``paged_verify_fwd_v2`` and ``paged_verify_fwd``: row r of
    the G K rows of a (slot, kv head) sees kv <= seq_lens[b] + r % K and
    kv < seq_lens[b] + chunk_lens[b]; :func:`paged_walk_model` of that.
    q (B, Hkv, G, K, d); returns o~ (B, Hkv, G, K, d), m and l (B, Hkv,
    G, K)."""
    sl = seq_lens.to(torch.int32)
    return paged_walk_model(q, k_pages, v_pages, page_table, sl,
                            sl + chunk_lens.to(torch.int32), splits=splits,
                            scale=scale, use_hfa=use_hfa)


def paged_decode_split_model(q, k_pages, v_pages, page_table, kv_lens, *,
                             splits, scale=None, use_hfa=False):
    """Model of ``paged_decode_fwd_v2`` and ``paged_decode_fwd``: decode is
    verify with K = 1 at seq_lens = kv_lens - 1 and chunk_lens = 1 (its G
    rows see kv < kv_lens[b]), so :func:`paged_verify_split_model` of
    that.  q (B, Hkv, G, d); returns o~ (B, Hkv, G, d), m and l (B, Hkv,
    G)."""
    kvl = kv_lens.to(torch.int32)
    o, m, l = paged_verify_split_model(
        q[:, :, :, None], k_pages, v_pages, page_table, kvl - 1,
        torch.ones_like(kvl), splits=splits, scale=scale, use_hfa=use_hfa)
    return o[:, :, :, 0], m[..., 0], l[..., 0]


def paged_prefill_model(q, k_pages, v_pages, page_table, start_pos,
                        kv_lens, *, scale=None, use_hfa=False):
    """Model of the CUDA-core ``paged_prefill_fwd``: row (g, l) sees kv <=
    start_pos[b] + l and kv < kv_lens[b]; :func:`paged_walk_model` of that,
    unsplit.  q (B, Hkv, G, L, d); returns as ``paged_prefill_partial``."""
    return paged_walk_model(q, k_pages, v_pages, page_table,
                            start_pos.to(torch.int32),
                            kv_lens.to(torch.int32), scale=scale,
                            use_hfa=use_hfa)


def dense_decode_split_model(q, k, v, *, kv_len, splits, scale=None,
                             use_hfa=False):
    """Model of ``dense_decode_fwd_v2``: the walk of n = ceil(min(kv_len,
    S) / 128) tiles of 128 keys (the reference's block_kv) is cut into
    ``splits`` contiguous runs of ceil(n / splits) tiles; each run's
    triplet is ``decode_partial_plain`` over its keys; the runs merge by
    Eq. 16 (``merge_partials``).  A run with no tile is the neutral
    triplet; one split is the unsplit walk.  q (..., G, d) against k, v
    (..., S, d); returns o~ (..., G, d), m and l (..., G)."""
    n_kv = max(0, min(int(kv_len), k.shape[-2]))
    tile = 128
    parts = [decode_partial_plain(
        q, k[..., t0 * tile:t1 * tile, :], v[..., t0 * tile:t1 * tile, :],
        scale=scale, block_kv=tile,
        kv_len=min(n_kv, t1 * tile) - t0 * tile, use_hfa=use_hfa)
        for t0, t1 in _runs(-(-n_kv // tile), splits)]
    if splits == 1:
        return parts[0]
    return merge_partials(*(torch.stack(x) for x in zip(*parts)),
                          use_hfa=use_hfa)


def datapath_update_model(sign, raw, sign_v, raw_v, q_dm, q_ds):
    """The kernel's column update of a live (row, key) (``fau_step`` and
    ``fau_step_zero_v`` of ``csrc/hfa_datapath.cu``) in plain torch, for
    the tests: A = max(raw + q_dm, LOG_ZERO); where raw_v is LOG_ZERO (v
    = 0) the result is A, sign 0 if A is zero; else B = raw_v + q_ds and
    lns_add with only the cancellation and the top clamp (the kernel
    looks the correction up in ``lns.exp2_neg_table``, equal to
    ``lns.exp2_neg`` on every d).  It equals the reference's rescales and
    lns_add wherever raw_v is the Blinn log of a bf16 and q_dm, q_ds are
    quantized score differences in [-2770, 0].  Returns (sign, raw)."""
    a = lns.rail_rescale(raw, q_dm)
    b = raw_v + q_ds
    big = torch.maximum(a, b)
    d = big - torch.minimum(a, b)
    corr = lns.exp2_neg(d)
    same = sign == sign_v
    rc = torch.where(same, big + corr, big - corr)
    sc = torch.where(a > b, sign, sign_v)
    cancel = ~same & (d == 0)
    rc = torch.where(cancel, torch.full_like(rc, float(LOG_ZERO)), rc)
    sc = torch.where(cancel, torch.zeros_like(sc), sc)
    rc = torch.clamp(rc, max=32767.0)
    v_zero = raw_v <= LOG_ZERO
    rc = torch.where(v_zero, a, rc)
    sc = torch.where(v_zero, torch.where(a <= LOG_ZERO,
                                         torch.zeros_like(sign), sign), sc)
    return sc.to(torch.int32), rc
