"""Numerics of the redesigned paged kernels, modelled on the CPU.

``paged_prefill_fwd_tc`` and ``paged_decode_fwd_v2``
(``csrc/paged_attention_tc.cu``) run only on the card, where
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold them against their
plain versions and the CUDA-core kernel.  Here their plain models
(``kernels/ref.py``) are held against the reference's Pallas kernels in
interpret mode, on numpy inputs from a seed (shuffled page tables, ragged
chunks, a free slot, the dead rows past a chunk's length are not
compared):

* the prefill model - page by page, P as bf16 hi + lo on the FA-2 rail -
  within 1e-5 of ``paged_prefill_partial_pallas`` after finalize; on the
  H-FA rail (P as bf16, exact) within 1e-5 on a dyadic grid
  (``hfa.dyadic_bf16(bound=0.5)``: every score and every page's sum of p
  is exact, so no summation order can move a rail step), and within a
  rail step (1e-2) on random inputs, where the two packages' f32 dot
  products may round a score across one (the share of rows that differ
  at all is printed);
* the split decode model - runs of 16-key tiles merged by Eq. 16 - within
  1e-5 of ``paged_decode_partial_pallas`` after finalize, and m exact on
  the dyadic grid (on random inputs the two packages' dot products may
  differ in the last bit);
* ``fa2.pad_head_dim``: the plain forward (both rails) and backward of
  zero-padded d 32 / 96 inputs, sliced back, are bit-equal to those of
  the inputs themselves.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import decode as jdec
from repro.kernels import paged_decode as jpd
from repro.kernels import paged_prefill as jpp
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import fa2_bwd as tfa2_bwd
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import ref

B, HKV = 3, 2


def _inputs(seed, shape_q, d, page, pages_each, dyadic):
    """numpy q, pools and a shuffled page table."""
    rng = np.random.default_rng(seed)
    num_pages = B * pages_each + 2
    pool = (num_pages, page, HKV, d)
    if dyadic:
        gen = torch.Generator().manual_seed(seed)
        q, kp = (thfa.dyadic_bf16(s, gen, bound=0.5).float().numpy()
                 for s in (shape_q, pool))
    else:
        q = rng.standard_normal(shape_q).astype(np.float32)
        kp = rng.standard_normal(pool).astype(np.float32)
    vp = rng.standard_normal(pool).astype(np.float32)
    pt = rng.permutation(num_pages)[:B * pages_each].reshape(
        B, pages_each).astype(np.int32)
    return q, kp, vp, pt


# (G, d, page): every G, d and page size at least once.
PREFILL_CASES = [(1, 32, 4), (2, 64, 16), (4, 96, 16), (2, 128, 4)]
CHUNK = 12


def _prefill(g, d, page, use_hfa, dyadic, seed):
    """Finalized outputs, m and l of the model and of the reference, the
    live-row mask (B, L) and the dead slot's model triplet."""
    pages_each = -(-40 // page)
    q, kp, vp, pt = _inputs(seed, (B, HKV, g, CHUNK, d), d, page,
                            pages_each, dyadic)
    start = np.array([0, 21, 0], np.int32)
    chunk = np.array([CHUNK, 5, 0], np.int32)          # ragged, one free
    kvl = start + chunk
    args = (q, kp, vp, pt, start, kvl)
    po, pm, pl_ = jpp.paged_prefill_partial_pallas(
        *map(jnp.asarray, args), use_hfa=use_hfa, interpret=True)
    to, tm, tl = ref.paged_prefill_tc_model(*map(torch.from_numpy, args),
                                            use_hfa=use_hfa)
    want = np.asarray(jdec.finalize_decode(po, pl_, use_hfa=use_hfa))
    got = tdec.finalize_decode(to, tl, use_hfa=use_hfa).numpy()
    live = np.arange(CHUNK)[None] < chunk[:, None]
    mask = np.broadcast_to(live[:, None, None], want.shape[:4])
    return got, want, tm.numpy(), np.asarray(pm), mask, (to[2], tm[2], tl[2])


def _assert_neutral(dead):
    o, m, l = dead
    assert torch.all(o == 0) and torch.all(m == ref.NEG_INF) \
        and torch.all(l == 0)


@pytest.mark.parametrize("g,d,page", PREFILL_CASES)
def test_prefill_model_fa2_matches_reference(g, d, page):
    got, want, tm, pm, mask, dead = _prefill(g, d, page, False, False,
                                             seed=d + g)
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm[mask], pm[mask], atol=1e-6, rtol=1e-6)
    _assert_neutral(dead)


@pytest.mark.parametrize("g,d,page", PREFILL_CASES)
def test_prefill_model_hfa_dyadic_matches_reference(g, d, page):
    got, want, tm, pm, mask, dead = _prefill(g, d, page, True, True,
                                             seed=d + g)
    np.testing.assert_allclose(got[mask], want[mask], atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm[mask], pm[mask])
    _assert_neutral(dead)


@pytest.mark.parametrize("g,d,page", PREFILL_CASES[1:3])
def test_prefill_model_hfa_random_within_a_rail_step(g, d, page):
    got, want, _, _, mask, _ = _prefill(g, d, page, True, False, seed=d)
    diff = np.abs(got - want)
    rows = diff.max(axis=-1)[mask]
    print(f"hfa prefill model vs reference, random inputs (G {g}, d {d}, "
          f"page {page}): {np.mean(rows > 0):.2%} of {rows.size} live rows "
          f"differ at all, max |diff| {rows.max():.3g}")
    assert rows.max() <= 1e-2


# (G, d, page, splits): an uneven split, splits beyond the shortest walk
# (empty runs: the neutral triplet), one split (the unsplit walk).
DECODE_CASES = [(1, 32, 4, 3), (2, 64, 16, 2), (4, 96, 16, 5),
                (2, 128, 4, 4), (2, 64, 16, 1)]


def _decode(g, d, page, splits, dyadic, seed):
    pages_each = -(-48 // page)
    q, kp, vp, pt = _inputs(seed, (B, HKV, g, d), d, page, pages_each,
                            dyadic)
    kvl = np.array([47, 0, 13], np.int32)            # a free slot
    args = (q, kp, vp, pt, kvl)
    po, pm, pl_ = jpd.paged_decode_partial_pallas(
        *map(jnp.asarray, args), interpret=True)
    to, tm, tl = ref.paged_decode_split_model(*map(torch.from_numpy, args),
                                              splits=splits)
    want = np.asarray(jdec.finalize_decode(po, pl_))
    got = tdec.finalize_decode(to, tl).numpy()
    live = kvl > 0
    return got, want, tm.numpy(), np.asarray(pm), live, (to[1], tm[1], tl[1])


@pytest.mark.parametrize("g,d,page,splits", DECODE_CASES)
def test_decode_split_model_fa2_matches_reference(g, d, page, splits):
    got, want, tm, pm, live, dead = _decode(g, d, page, splits, False,
                                            seed=d + splits)
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got[live], want[live], atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm[live], pm[live], atol=1e-6, rtol=1e-6)
    _assert_neutral(dead)
    # Exact scores: m equal bit for bit.
    _, _, tm, pm, live, _ = _decode(g, d, page, splits, True, seed=d)
    np.testing.assert_array_equal(tm[live], pm[live])


def test_prefill_route_rule():
    def route(dtype, d, page=16, pages=4):
        return cuda_lib.paged_prefill_route(
            torch.zeros((1, 1, 2, 4, d), dtype=dtype),
            torch.zeros((2, page, 1, d), dtype=dtype),
            torch.zeros((1, pages), dtype=torch.int32))
    bf, f32 = torch.bfloat16, torch.float32
    assert route(bf, 128) == route(bf, 64) == "tc"
    assert route(bf, 128, pages=cuda_lib.PAGED_TC_MAX_PAGES) == "tc"
    for args in ((f32, 128), (bf, 96), (bf, 32), (bf, 128, 4),
                 (bf, 128, 16, cuda_lib.PAGED_TC_MAX_PAGES + 1)):
        assert route(*args) == "simt"


@pytest.mark.parametrize("d", [32, 96])
@pytest.mark.parametrize("kind", ["fa2_fwd", "hfa_fwd", "backward"])
def test_pad_head_dim_is_exact(kind, d):
    gen = torch.Generator().manual_seed(d)
    q, k, v, do = (torch.randn((2, 150, d), generator=gen).to(torch.bfloat16)
                   for _ in range(4))
    padded = tfa2.pad_head_dim(q, k, v, do)
    assert all(t.shape[-1] == (64 if d == 32 else 128) for t in padded)
    kw = dict(causal=True, scale=d ** -0.5, kv_len=140, q_offset=10)
    if kind == "hfa_fwd":
        want = [thfa.hfa_forward_plain(q, k, v, **kw)]
        got = [thfa.hfa_forward_plain(*padded[:3], **kw)]
    else:
        want = list(tfa2.fa2_forward_plain(q, k, v, **kw))
        got = list(tfa2.fa2_forward_plain(*padded[:3], **kw))
        if kind == "backward":
            delta = torch.sum(do.float() * want[0], dim=-1)
            want = tfa2_bwd.fa2_backward_plain(q, k, v, do, want[1], delta,
                                               **kw)
            got = tfa2_bwd.fa2_backward_plain(*padded, got[1], delta, **kw)
    for w, g in zip(want, got):
        if g.dim() == 3:
            assert torch.all(g[..., d:] == 0)
            g = g[..., :d]
        assert torch.equal(w.view(torch.int32), g.contiguous().view(
            torch.int32))


@pytest.mark.parametrize("d", [16, 48, 160])
def test_pad_head_dim_refuses_other_widths(d):
    with pytest.raises(ValueError, match="head dim"):
        tfa2.pad_head_dim(torch.zeros((1, 4, d)))
