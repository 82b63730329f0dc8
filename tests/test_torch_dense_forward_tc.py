"""The facts the tensor-core dense forward (``csrc/dense_attention_tc.cu``)
rests on, checked on the CPU, and the plain versions its checks use.

* Every value of the H-FA rail's ``exp2_hfa_rail`` is exact in bf16, so
  P.V on bf16 tensor cores with f32 accumulation is exact on that rail
  apart from summation order.  The integer form of the rail the kernel
  runs (``quant_rail_int``, ``exp2_hfa_rail_tab`` in ``hfa_rail.cuh``),
  emulated here in numpy, equals the plain rail on every rail value.
* On the FA-2 rail p is split into bf16 hi + lo: the pair reconstructs p
  within 2^-16 of p, and a forward whose P.V runs on the two halves
  stays within 1e-5 of the f32 plain version (the card's check).
* The plain H-FA walk fed precomputed scores (``ref_hfa_walk``), fed the
  tile oracle's own bf16 scores, is the tile oracle bit for bit; and
  ``hfa_forward_plain`` still equals the reference's ``hfa_pallas``
  (interpret mode) to 1e-6, as ``test_torch_dense_attention.py`` holds.
* The dyadic-grid inputs of the card's H-FA check give the same f32
  scores in any summation order, and at bound 0.5 the same f32 sum of p
  over each tile.
"""
import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.kernels import bitmath as jbit
from repro.kernels import hfa as jhfa
from repro_torch.core import lns
from repro_torch.kernels import bitmath as tbit
from repro_torch.kernels import fa2 as tfa2
from repro_torch.kernels import hfa as thfa
from repro_torch.kernels import ref as tref

RAILS = np.arange(-2770, 1, dtype=np.int64)     # all that quant_rail returns


def _f32(x):
    return np.asarray(x, np.float32)


def test_every_rail_value_is_exact_in_bf16():
    rail = torch.tensor(RAILS, dtype=torch.float32)
    p = tbit.exp2_hfa_rail(rail)
    assert torch.equal(p.to(torch.bfloat16).to(torch.float32), p)
    # ... and these are the reference's values.
    want = np.asarray(jbit.exp2_hfa_rail(jnp.asarray(RAILS, jnp.float32)))
    assert np.array_equal(p.numpy().view(np.int32), want.view(np.int32))
    # At most 7 significant bits: p * 2^k is an integer below 2^7 + 1.
    mant, _ = np.frexp(p.numpy().astype(np.float64))
    assert np.all(mant * 2 ** 8 == np.round(mant * 2 ** 8))
    assert p.min().item() == pytest.approx(3.05e-7, rel=1e-2)
    # quant_rail's range is exactly these rails.
    x = torch.linspace(-20.0, 5.0, 1_000_003)
    assert torch.equal(torch.unique(tbit.quant_rail(x)), rail)


def _quant_rail_int(x):
    """numpy emulation of hfa_rail.cuh's quant_rail_int."""
    d = np.minimum(np.maximum(_f32(x), np.float32(-15)), np.float32(0))
    y = (d * np.float32(lns.LOG2E)).astype(np.float32) * np.float32(128)
    return (y + np.float32(12582912.0)).astype(np.float32).view(
        np.int32).astype(np.int64) - 0x4B400000


def _exp2_hfa_rail_tab(rail):
    """numpy emulation of hfa_rail.cuh's pwl_table_word (the table) and
    exp2_hfa_rail_tab (one byte per f7, packed into the float's bits)."""
    tab = lns.pwl_lut16().astype(np.int64)
    f7 = np.arange(128)
    g7 = ((((tab[f7 >> 4] * f7) >> 7) + tab[8 + (f7 >> 4)]) + 128) >> 8
    assert g7.min() == 64 and g7.max() == 128
    words = (2 * (g7 - 64)).reshape(32, 4) << (8 * np.arange(4))
    words = words.sum(1)
    d = -rail
    m = ((words[(d & 127) >> 2] >> (8 * (d & 3))) & 0xFF) << 16
    return (((126 - (d >> 7)) << 23) + m).astype(np.int32).view(np.float32)


def test_integer_rail_form_matches_plain_rail():
    want = tbit.exp2_hfa_rail(torch.tensor(RAILS, dtype=torch.float32))
    assert np.array_equal(_exp2_hfa_rail_tab(RAILS).view(np.int32),
                          want.numpy().view(np.int32))
    bits = (torch.arange(1 << 16, dtype=torch.int32) << 16).view(
        torch.float32)
    for x in (bits[torch.isfinite(bits)], torch.linspace(-20, 5, 1_000_003)):
        assert np.array_equal(_quant_rail_int(x.numpy()).astype(np.float32),
                              tbit.quant_rail(x).numpy())


def _split(p):
    hi = p.to(torch.bfloat16).to(torch.float32)
    return hi, (p - hi).to(torch.bfloat16).to(torch.float32)


def test_hi_lo_split_reconstructs_p():
    rng = np.random.default_rng(0)
    p = torch.from_numpy(np.concatenate([
        rng.random(1_000_000), np.exp(-rng.random(100_000) * 80),
        [1.0, 0.5, 2.0 ** -20, np.nextafter(1.0, 0.0)]]).astype(np.float32))
    p = p[p > 0]
    hi, lo = _split(p)
    assert torch.all((hi + lo - p).abs() <= 2.0 ** -16 * p)


def _fa2_split_pv(q, k, v, *, causal, terms=2, block_kv=128):
    """FA-2 forward as the tensor-core kernel sums it: f32 scores and
    softmax, P.V on the bf16 hi and lo halves of p (products exact in
    f32; ``terms=1`` drops lo), l from the unsplit p."""
    bh, lq, d = q.shape
    lkv = k.shape[1]
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    m = torch.full((bh, lq), -1e30)
    l = torch.zeros(bh, lq)
    acc = torch.zeros(bh, lq, d)
    q_ids = (lkv - lq) + torch.arange(lq)[:, None]
    for k0 in range(0, lkv, block_kv):
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + block_kv]) \
            * d ** -0.5
        kv_ids = k0 + torch.arange(s.shape[-1])[None, :]
        mask = kv_ids <= q_ids if causal else torch.ones_like(s[0], dtype=bool)
        s = torch.where(mask, s, torch.full_like(s, -1e30))
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(torch.clamp(m - m_new, max=0.0))
        p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        hi, lo = _split(p)
        vb = vf[:, k0:k0 + block_kv]
        acc = acc * alpha[..., None] + torch.einsum("bqk,bkd->bqd", hi, vb)
        if terms == 2:
            acc = acc + torch.einsum("bqk,bkd->bqd", lo, vb)
        m = m_new
    return acc / l[..., None]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [64, 128])
def test_split_pv_forward_within_1e5_of_plain(d, causal):
    rng = np.random.default_rng(d)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, n, d)).astype(
        np.float32)).to(torch.bfloat16) for n in (256, 384, 384))
    got = _fa2_split_pv(q, k, v, causal=causal)
    want, _ = tfa2.fa2_forward_plain(q, k, v, causal=causal)
    assert (got - want).abs().max().item() <= 1e-5
    # A single bf16 P would not hold the check.
    hi_only = _fa2_split_pv(q, k, v, causal=causal, terms=1)
    assert (hi_only - want).abs().max().item() > 1e-4


# (bh, lq, lkv, d, kv_len, q_offset)
WALK_SHAPES = [(2, 100, 200, 64, None, None), (3, 128, 384, 32, None, None),
               (2, 200, 320, 128, 300, 100), (2, 128, 128, 64, 100, -5)]


def _bf16_inputs(shape, seed):
    bh, lq, lkv, d = shape[:4]
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(
        torch.bfloat16) for s in ((bh, lq, d), (bh, lkv, d), (bh, lkv, d))]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_walk_fed_its_own_scores_is_the_tile_oracle(shape, causal):
    q, k, v = _bf16_inputs(shape, 5)
    d, kv_len, q_offset = shape[3:]
    kw = dict(causal=causal, kv_len=kv_len, q_offset=q_offset)
    s = (torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * d ** -0.5) \
        .to(torch.bfloat16)
    want = thfa.hfa_forward_plain(q, k, v, **kw)
    got = thfa.hfa_forward_plain_from_scores(s, v, **kw)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if kv_len is None:
        assert torch.equal(tref.ref_hfa_walk(s, v, causal=causal,
                                             q_offset=q_offset),
                           tref.ref_hfa_mxu(q, k, v, causal=causal,
                                            q_offset=q_offset))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(1, 128, 128, 64), (2, 128, 256, 64)])
def test_hfa_forward_plain_still_matches_pallas(shape, causal):
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in
            ((shape[0], shape[1], shape[3]), (shape[0], shape[2], shape[3]),
             (shape[0], shape[2], shape[3]))]
    jo = jhfa.hfa_pallas(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                         causal=causal, block_q=128, block_kv=128)
    to = thfa.hfa_forward_plain(*(torch.from_numpy(a).to(torch.bfloat16)
                                  for a in arrs), causal=causal)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo, np.float32),
                               atol=1e-6, rtol=0)


def test_dyadic_scores_are_order_independent():
    gen = torch.Generator().manual_seed(0)
    q = thfa.dyadic_bf16((2, 64, 128), gen).float().numpy()
    k = thfa.dyadic_bf16((2, 96, 128), gen).float().numpy()
    assert set(np.unique(q)) <= {x / 4 for x in range(-8, 9)}
    prods = q[:, :, None, :] * k[:, None, :, :]            # exact in f32

    def ordered(terms):
        acc = np.zeros(terms.shape[:-1], np.float32)
        for i in range(terms.shape[-1]):
            acc = (acc + terms[..., i]).astype(np.float32)
        return acc
    forward = ordered(prods)
    backward = ordered(prods[..., ::-1])
    blocked = ordered(np.stack([ordered(prods[..., j:j + 16])
                                for j in range(0, 128, 16)], -1))
    exact = np.einsum("bqd,bkd->bqk", q.astype(np.float64),
                      k.astype(np.float64))
    for got in (backward, blocked):
        assert np.array_equal(got, forward)
    assert np.array_equal(forward.astype(np.float64), exact)


def test_score_errors_holds_scores_to_one_ulp():
    """The card's score check: the plain version's own bf16 scores pass,
    a score moved by one bf16 step in the visible region is caught, the
    same move above the causal diagonal is not counted."""
    q, k, _ = _bf16_inputs((2, 100, 200, 64), 6)
    s = (torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * 64 ** -0.5) \
        .to(torch.bfloat16)
    n_vis, n_differ, n_beyond, _, worst = thfa.score_errors(q, k, s,
                                                           causal=True)
    assert n_vis == 2 * sum(min(200, 100 + i + 1) for i in range(100))
    assert (n_differ, n_beyond) == (0, 0) and worst <= 0.5
    # Two bf16 steps on the largest visible score of row 50 (where one
    # ulp, not the f32 summation term, sets the bound).
    bumped = s.float()
    j = int(bumped[1, 50, :151].abs().argmax())
    _, e = torch.frexp(bumped[1, 50, j].abs())
    bumped[1, 50, j] += 2.0 ** (e.item() - 8) * 2
    bumped[0, 0, 199] += 1.0                          # above the diagonal
    bumped = bumped.to(torch.bfloat16)
    assert thfa.score_errors(q, k, bumped, causal=True)[2] == 1


@pytest.mark.parametrize("d", [64, 128])
def test_dyadic_tile_sums_of_p_are_order_independent(d):
    """At bound 0.5 every score is within 2.9 of its row max, so every p
    is at least 2^-9 with 7 significant bits and a tile's 128 of them sum
    exactly in f32: l, and the LogDiv finalize, do not depend on the
    summation order."""
    gen = torch.Generator().manual_seed(d)
    q = thfa.dyadic_bf16((4, 128, d), gen, bound=0.5).float()
    k = thfa.dyadic_bf16((4, 128, d), gen, bound=0.5).float()
    s = (torch.einsum("bqd,bkd->bqk", q, k) * d ** -0.5).to(
        torch.bfloat16).float()
    assert (s.amax(-1) - s.amin(-1)).max() <= 2 * 2.9
    p = tbit.exp2_hfa_rail(tbit.quant_rail(s - s.amax(-1, keepdim=True)))
    assert p.min() >= 2.0 ** -9

    def ordered(terms):
        acc = torch.zeros(terms.shape[:-1])
        for i in range(terms.shape[-1]):
            acc = acc + terms[..., i]
        return acc
    exact = p.double().sum(-1)
    for got in (ordered(p), ordered(p.flip(-1)), p.sum(-1)):
        assert torch.equal(got.double(), exact)
