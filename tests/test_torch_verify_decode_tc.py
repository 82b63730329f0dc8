"""Numerics of the redesigned paged verify and dense decode, modelled on
the CPU.

``paged_verify_fwd_v2`` (``csrc/paged_attention_tc.cu``) and
``dense_decode_fwd_v2`` (``csrc/dense_decode.cu``) run only on the card,
where ``tests/test_torch_gpu.py`` and ``chip_smoke.py`` hold them against
their plain versions and the CUDA-core verify.  Here their plain models
(``kernels/ref.py``) are held against the reference's Pallas kernels in
interpret mode, on numpy inputs from a seed:

* the verify model - a causal limit per row, the walk of 16-key tiles
  cut into runs and merged by Eq. 16 - over shuffled page tables, ragged
  ``chunk_lens`` and a free slot, unsplit, split unevenly and split into
  more runs than the walk has tiles: on the FA-2 rail within 1e-5 of
  ``paged_verify_partial_pallas`` after finalize and m within 1e-6
  (exact on ``hfa.dyadic_bf16(bound=0.5)``, where every score is exact);
  on the H-FA rail, unsplit as the kernel runs it, page by page as the
  reference (at page 16 the v2 kernel's 16-key tiles are the pages; at
  page 4 the CUDA-core body takes it) within 1e-5 on the dyadic grid
  (every score and every page's sum of p exact, so no summation order
  moves a rail step) and within a rail step (1e-2) on random inputs.
  Rows past a slot's chunk are not compared; the free slot's are the
  neutral triplet.
* the dense decode model - the walk of 128-key tiles cut into runs and
  merged by Eq. 16 - against ``decode_partial_pallas`` with a ``kv_len``
  mask, the same tolerances; ``kv_len`` 0 is the neutral triplet.
* the route rule of verify and the split rules of verify and the dense
  decode, as pure functions of the shapes and the SM count.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import decode as jdec
from repro.kernels import paged_verify as jpv
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import decode as tdec
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import ref

B, HKV, K = 3, 2, 5


def _values(shape, seed, dyadic):
    if dyadic:
        gen = torch.Generator().manual_seed(seed)
        return thfa.dyadic_bf16(shape, gen, bound=0.5).float().numpy()
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _assert_neutral(o, m, l):
    assert torch.all(o == 0) and torch.all(m == ref.NEG_INF) \
        and torch.all(l == 0)


# (G, d, page, splits): one run, an uneven split, more runs than the
# longest walk has tiles (empty runs: the neutral triplet).
VERIFY_CASES = [(1, 32, 4, 1), (2, 64, 16, 2), (2, 96, 4, 3),
                (1, 128, 16, 8)]


def _verify(g, d, page, splits, use_hfa, dyadic, seed):
    """Finalized outputs and m of the model and of the Pallas kernel on
    the live rows, and the free slot's model triplet."""
    pages_each = -(-48 // page)
    num_pages = B * pages_each + 2
    rng = np.random.default_rng(seed)
    pool = (num_pages, page, HKV, d)
    q = _values((B, HKV, g, K, d), seed, dyadic)
    kp = _values(pool, seed + 1, dyadic)
    vp = _values(pool, seed + 2, False)
    pt = rng.permutation(num_pages)[:B * pages_each].reshape(
        B, pages_each).astype(np.int32)
    sl = np.array([37, 0, 20], np.int32)
    cl = np.array([K, 0, 2], np.int32)                 # a free slot, ragged
    args = (q, kp, vp, pt, sl, cl)
    po, pm, pl_ = jpv.paged_verify_partial_pallas(
        *map(jnp.asarray, args), use_hfa=use_hfa, interpret=True)
    to, tm, tl = ref.paged_verify_split_model(
        *map(torch.from_numpy, args), splits=splits, use_hfa=use_hfa)
    want = np.asarray(jdec.finalize_decode(po, pl_, use_hfa=use_hfa))
    got = tdec.finalize_decode(to, tl, use_hfa=use_hfa).numpy()
    live = np.broadcast_to((np.arange(K)[None] < cl[:, None])[:, None, None],
                           (B, HKV, g, K))
    assert np.all(np.isfinite(got))
    return got[live], want[live], tm.numpy()[live], np.asarray(pm)[live], (
        to[1], tm[1], tl[1])


@pytest.mark.parametrize("g,d,page,splits", VERIFY_CASES)
def test_verify_split_model_fa2_matches_reference(g, d, page, splits):
    got, want, tm, pm, dead = _verify(g, d, page, splits, False, False,
                                      seed=d + splits)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm, pm, atol=1e-6, rtol=1e-6)
    _assert_neutral(*dead)
    # Exact scores: m equal bit for bit.
    got, want, tm, pm, _ = _verify(g, d, page, splits, False, True, seed=d)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm, pm)


@pytest.mark.parametrize("g,d", [(2, 64), (1, 96)])
def test_verify_model_hfa_dyadic_matches_reference(g, d):
    got, want, tm, pm, dead = _verify(g, d, 16, 1, True, True, seed=g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm, pm)
    _assert_neutral(*dead)


def test_verify_model_hfa_page_4_within_a_rail_step():
    """At a page size other than 16 the H-FA rail still rescales where the
    reference does: once a page.  The kernel that runs there (the
    CUDA-core body, ``cuda_lib.paged_verify_route``) and so its model walk
    page by page, so on the dyadic grid the model equals the Pallas
    kernel as at page 16: within 1e-5 after finalize, m bit for bit."""
    got, want, tm, pm, _ = _verify(1, 96, 4, 1, True, True, seed=1)
    np.testing.assert_array_equal(tm, pm)
    diff = np.abs(got - want).max()
    print(f"hfa verify model at page 4 vs reference (dyadic grid): max "
          f"|diff| {diff:.3g}")
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_verify_model_hfa_random_within_a_rail_step():
    got, want, _, _, _ = _verify(2, 128, 16, 1, True, False, seed=3)
    rows = np.abs(got - want).max(axis=-1)
    print(f"hfa verify model vs reference, random inputs: "
          f"{np.mean(rows > 0):.2%} of {rows.size} live rows differ at all, "
          f"max |diff| {rows.max():.3g}")
    assert rows.max() <= 1e-2


# (G, d, kv_len, splits): S = 384 (three 128-key tiles); one run, an
# uneven split, more runs than tiles, a kv_len inside the first tile.
DENSE_CASES = [(2, 64, 300, 1), (4, 128, 300, 2), (1, 32, 384, 5),
               (8, 96, 77, 3)]


def _dense(g, d, kv_len, splits, use_hfa, dyadic, seed):
    q = _values((B * HKV, g, d), seed, dyadic)
    k = _values((B * HKV, 384, d), seed + 1, dyadic)
    v = _values((B * HKV, 384, d), seed + 2, False)
    po, pm, pl_ = jdec.decode_partial_pallas(
        *map(jnp.asarray, (q, k, v)), kv_len=kv_len, use_hfa=use_hfa,
        interpret=True)
    to, tm, tl = ref.dense_decode_split_model(
        *map(torch.from_numpy, (q, k, v)), kv_len=kv_len, splits=splits,
        use_hfa=use_hfa)
    want = np.asarray(jdec.finalize_decode(po, pl_, use_hfa=use_hfa))
    got = tdec.finalize_decode(to, tl, use_hfa=use_hfa).numpy()
    assert np.all(np.isfinite(got))
    return got, want, tm.numpy(), np.asarray(pm)


@pytest.mark.parametrize("g,d,kv_len,splits", DENSE_CASES)
def test_dense_decode_split_model_fa2_matches_reference(g, d, kv_len,
                                                        splits):
    got, want, tm, pm = _dense(g, d, kv_len, splits, False, False,
                               seed=d + g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_allclose(tm, pm, atol=1e-6, rtol=1e-6)
    got, want, tm, pm = _dense(g, d, kv_len, splits, False, True, seed=d)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm, pm)


@pytest.mark.parametrize("g,d,kv_len", [(2, 128, 300), (4, 32, 77)])
def test_dense_decode_model_hfa_matches_reference(g, d, kv_len):
    got, want, tm, pm = _dense(g, d, kv_len, 1, True, True, seed=g)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(tm, pm)
    got, want, _, _ = _dense(g, d, kv_len, 1, True, False, seed=d)
    assert np.abs(got - want).max() <= 1e-2


@pytest.mark.parametrize("splits", [1, 3])
def test_dense_decode_model_empty_walk_is_neutral(splits):
    q, k, v = (torch.from_numpy(_values(s, 7, False)) for s in
               ((2, 2, 32), (2, 256, 32), (2, 256, 32)))
    _assert_neutral(*ref.dense_decode_split_model(q, k, v, kv_len=0,
                                                  splits=splits))


def test_verify_route_rule():
    for use_hfa in (False, True):          # page 16: the same on both rails
        assert cuda_lib.paged_verify_route(2, 5, 16, use_hfa) == "v2"
        assert cuda_lib.paged_verify_route(1, 16, 16, use_hfa) == "v2"
        assert cuda_lib.paged_verify_route(16, 1, 16, use_hfa) == "v2"
        assert cuda_lib.paged_verify_route(4, 5, 16, use_hfa) == "simt"
        assert cuda_lib.paged_verify_route(1, 17, 16, use_hfa) == "simt"
    # The H-FA rail splits the rows by query head, the FA-2 rail not.
    assert cuda_lib.verify_row_blocks(2, 5, True) == 2
    assert cuda_lib.verify_row_blocks(2, 5, False) == 1


def test_split_rules():
    # Verify: about four blocks of G K rows an SM (9), at most a run per
    # 64 keys, each run of the longest walk the same whole number of 64-key
    # steps (8 runs of 4).
    assert cuda_lib.verify_splits(64, 2048, False, 132) == 8
    assert cuda_lib.verify_splits(64, 100, False, 132) == 2
    assert cuda_lib.verify_splits(1024, 2048, False, 132) == 1
    assert cuda_lib.verify_splits(64, 2048, True, 132) == 1
    # Dense decode: about two blocks an SM, at most a run per 128 keys.
    assert cuda_lib.dense_decode_splits(64, 576, False, 132) == 5
    assert cuda_lib.dense_decode_splits(64, 100, False, 132) == 1
    assert cuda_lib.dense_decode_splits(8, 4096, False, 132) == 32
    assert cuda_lib.dense_decode_splits(64, 0, False, 132) == 1
    assert cuda_lib.dense_decode_splits(64, 576, True, 132) == 1
    # The runs of the longest walk: equal whole steps.
    assert cuda_lib.split_runs(64, 32, 132, 2) == 5          # 5 x 7 steps
    assert cuda_lib.split_runs(4, 6, 132) == 6
    assert cuda_lib.split_runs(1000, 32, 132) == 1
