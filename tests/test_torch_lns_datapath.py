"""The port's LNS datapath, H-FA emulation and per-element datapath
kernel (plain version) against the reference, on the same numpy inputs.

Bit for bit:
* ``bf16_bits``/``bits_bf16``, ``blinn_log2`` over all 65,536 bf16 bit
  patterns; ``lns_to_bf16`` over all 65,536 FIX16 rail values, both
  signs; ``lns_add`` over signed pairs on a dense rail grid;
  ``quant_scorediff`` over a sweep of score differences.
* ``core.hfa`` (``hfa_partial``, ``acc_merge``, ``hfa_attention``,
  ``hfa_blockparallel``), ``ref_hfa_datapath`` and ``hfa_datapath``'s
  plain version against the reference's emulation and against
  ``hfa_datapath_pallas`` in interpret mode, causal and not, Lq < Lkv.
  q and k sit on a dyadic grid, where the f32 scores are exact in any
  summation order; v is random normal.  On random normal q and k the
  two packages' matmuls may round a score to the other bf16 neighbour,
  so there every row whose bf16 scores agree must agree bit for bit.

``lns_value_hw`` is held to 1e-5 relative: the reference's f32 ``exp2``
(XLA on the CPU) is an approximation a few ulps off 2^I, flushed to zero
below 2^-126, where the port's is exact.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from repro.core import hfa as jhfa
from repro.core import lns as jlns
from repro.core import numerics as jnum
from repro.kernels import hfa_datapath as jdp
from repro.kernels import ref as jref
from repro_torch.core import hfa as thfa
from repro_torch.core import lns as tlns
from repro_torch.core import numerics as tnum
from repro_torch.kernels import hfa_datapath as tdp
from repro_torch.kernels import ref as tref

U16 = np.arange(1 << 16, dtype=np.uint32).astype(np.uint16)
RAIL = np.arange(-32768, 32768, dtype=np.float32)


def _bf16_pair(bits: np.ndarray):
    """The same bf16 values in both packages, from uint16 patterns."""
    return (jax.lax.bitcast_convert_type(jnp.asarray(bits), jnp.bfloat16),
            torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16))


def _same_bits(want, got: torch.Tensor):
    want = np.asarray(want)
    got = got.numpy()
    assert want.shape == got.shape and want.dtype.itemsize == got.dtype.itemsize
    w = want.view(np.uint32 if want.dtype.itemsize == 4 else np.uint16)
    g = got.view(w.dtype)
    bad = w != g
    assert not bad.any(), f"{bad.sum()} differ: {want[bad][:4]} vs {got[bad][:4]}"


def test_bf16_bit_helpers_bit_exact():
    jv, tv = _bf16_pair(U16)
    _same_bits(jnum.bf16_bits(jv), tnum.bf16_bits(tv))
    bits = U16.astype(np.int32)
    want = jnum.bits_bf16(jnp.asarray(bits))
    got = tnum.bits_bf16(torch.from_numpy(bits))
    _same_bits(jax.lax.bitcast_convert_type(want, jnp.uint16).astype(jnp.int32),
               got.view(torch.int16).to(torch.int32) & 0xFFFF)
    x = np.linspace(-3.0, 3.0, 10_001).astype(np.float32)
    _same_bits(jnum.to_bf16(jnp.asarray(x)).astype(jnp.float32),
               tnum.to_bf16(torch.from_numpy(x)).to(torch.float32))


def test_blinn_log2_every_bf16_pattern():
    jv, tv = _bf16_pair(U16)
    js, jr = jlns.blinn_log2(jv)
    ts, tr = tlns.blinn_log2(tv)
    _same_bits(js, ts)
    _same_bits(jr, tr)
    js, jr = jlns.lns_from_bf16(jv)
    ts, tr = tlns.lns_from_bf16(tv)
    _same_bits(js, ts)
    _same_bits(jr, tr)


@pytest.mark.parametrize("sign", [0, 1])
def test_lns_to_bf16_every_rail_value(sign):
    s = np.full(RAIL.shape, sign, np.int32)
    want = jlns.lns_to_bf16(jnp.asarray(s), jnp.asarray(RAIL))
    got = tlns.lns_to_bf16(torch.from_numpy(s), torch.from_numpy(RAIL))
    _same_bits(want.astype(jnp.float32), got.to(torch.float32))


def test_lns_value_hw_matches():
    for sign in (0, 1):
        s = np.full(RAIL.shape, sign, np.int32)
        want = np.asarray(jlns.lns_value_hw(jnp.asarray(s), jnp.asarray(RAIL)))
        got = tlns.lns_value_hw(torch.from_numpy(s),
                                torch.from_numpy(RAIL)).numpy()
        normal = np.isfinite(want) & (np.abs(want) >= 2.0 ** -126)
        np.testing.assert_allclose(got[normal], want[normal], rtol=1e-5)
        assert np.array_equal(np.isinf(got), np.isinf(want))
        assert np.all(np.abs(got[~normal & np.isfinite(got)]) < 2.0 ** -125)


def test_lns_add_dense_grid_bit_exact():
    grid = np.concatenate([np.arange(-900, 900, 1, dtype=np.float32),
                           np.array([-32768, -32767, -20000, 20000, 32700,
                                     32767], np.float32)])
    a, b = (x.ravel() for x in np.meshgrid(grid, grid, indexing="ij"))
    for sa in (0, 1):
        for sb in (0, 1):
            ja = np.full(a.shape, sa, np.int32)
            jb = np.full(a.shape, sb, np.int32)
            js, jr = jlns.lns_add(jnp.asarray(ja), jnp.asarray(a),
                                  jnp.asarray(jb), jnp.asarray(b))
            ts, tr = tlns.lns_add(*map(torch.from_numpy, (ja, a, jb, b)))
            _same_bits(js, ts)
            _same_bits(jr, tr)


def test_quant_scorediff_and_clamp_rail_bit_exact():
    x = np.concatenate([np.linspace(-20.0, 2.0, 400_001),
                        [-1e30, -np.inf, 0.0, -0.0, 1e30]]).astype(np.float32)
    _same_bits(jlns.quant_scorediff(jnp.asarray(x)),
               tlns.quant_scorediff(torch.from_numpy(x)))
    r = np.linspace(-70000, 70000, 100_001).astype(np.float32)
    _same_bits(jlns.clamp_rail(jnp.asarray(r)),
               tlns.clamp_rail(torch.from_numpy(r)))


# ---------------------------------------------------------------- core.hfa
# (bh, lq, lkv, d): square, suffix queries (Lq < Lkv), a 64-wide head.
SHAPES = [(2, 24, 24, 32), (3, 12, 40, 64)]


def _inputs(shape, seed, dyadic=True):
    """q, k on a dyadic grid (multiples of 1/4 in [-2, 2]: exact f32
    scores) or random normal; v random normal."""
    bh, lq, lkv, d = shape
    rng = np.random.default_rng(seed)
    if dyadic:
        q = rng.integers(-8, 9, (bh, lq, d)).astype(np.float32) / 4
        k = rng.integers(-8, 9, (bh, lkv, d)).astype(np.float32) / 4
    else:
        q = rng.standard_normal((bh, lq, d)).astype(np.float32)
        k = rng.standard_normal((bh, lkv, d)).astype(np.float32)
    v = rng.standard_normal((bh, lkv, d)).astype(np.float32)
    return ([jnp.asarray(x, jnp.bfloat16) for x in (q, k, v)],
            [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)])


def _bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(jax.lax.bitcast_convert_type(x, jnp.int16))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=["square", "suffix"])
def test_hfa_attention_and_datapath_bit_exact(shape, causal):
    j, t = _inputs(shape, 0)
    want = _bits(jhfa.hfa_attention(*j, causal=causal))
    np.testing.assert_array_equal(_bits(thfa.hfa_attention(*t, causal=causal)),
                                  want)
    np.testing.assert_array_equal(
        _bits(tref.ref_hfa_datapath(*t, causal=causal)),
        _bits(jref.ref_hfa_datapath(*j, causal=causal)))
    # The datapath kernel's plain version against the Pallas kernel.
    np.testing.assert_array_equal(
        _bits(tdp.hfa_datapath(*t, causal=causal)),
        _bits(jdp.hfa_datapath_pallas(*j, causal=causal, interpret=True)))


@pytest.mark.parametrize("causal", [False, True])
def test_hfa_datapath_kv_len_mask_bit_exact(causal):
    j, t = _inputs((2, 10, 40, 32), 1)
    np.testing.assert_array_equal(
        _bits(tdp.hfa_datapath(*t, causal=causal, kv_len=27)),
        _bits(jdp.hfa_datapath_pallas(*j, causal=causal, kv_len=27,
                                      interpret=True)))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("num_blocks", [2, 4])
def test_hfa_blockparallel_bit_exact(num_blocks, causal):
    j, t = _inputs((2, 12, 48, 32), 2)
    np.testing.assert_array_equal(
        _bits(thfa.hfa_blockparallel(*t, num_blocks=num_blocks,
                                     causal=causal)),
        _bits(jhfa.hfa_blockparallel(*j, num_blocks=num_blocks,
                                     causal=causal)))


def test_hfa_partial_state_and_acc_merge_bit_exact():
    j, t = _inputs((2, 6, 32, 32), 3)
    jm = jnp.asarray(np.random.default_rng(4).random((6, 16)) < 0.7)
    tm = torch.from_numpy(np.array(jm))
    parts = []
    for sl in (slice(0, 16), slice(16, 32)):
        jp = jhfa.hfa_partial(j[0], j[1][:, sl], j[2][:, sl], mask=jm)
        tp = thfa.hfa_partial(t[0], t[1][:, sl], t[2][:, sl], mask=tm)
        for a, b in zip(jp, tp):
            _same_bits(a, b)
        parts.append((jp, tp))
    jmerged = jhfa.acc_merge(parts[0][0], parts[1][0])
    tmerged = thfa.acc_merge(parts[0][1], parts[1][1])
    for a, b in zip(jmerged, tmerged):
        _same_bits(a, b)
    np.testing.assert_array_equal(_bits(thfa.logdiv(tmerged)),
                                  _bits(jhfa.logdiv(jmerged)))


@pytest.mark.parametrize("causal", [False, True])
def test_hfa_attention_random_rows_with_equal_scores_bit_exact(causal):
    """Random normal q, k: every row whose bf16 scores both packages form
    alike has identical output bits (and nearly every row does)."""
    shape = (3, 16, 48, 64)
    j, t = _inputs(shape, 5, dyadic=False)
    want = _bits(jhfa.hfa_attention(*j, causal=causal))
    got = _bits(thfa.hfa_attention(*t, causal=causal))
    d = shape[-1]
    js = np.asarray((jnp.einsum("bqd,bkd->bqk", j[0].astype(jnp.float32),
                                j[1].astype(jnp.float32)) * d ** -0.5)
                    .astype(jnp.bfloat16).astype(jnp.float32))
    ts = (torch.einsum("bqd,bkd->bqk", t[0].float(), t[1].float())
          * d ** -0.5).to(torch.bfloat16).float().numpy()
    agree = (js == ts).all(-1)
    assert agree.mean() > 0.9
    np.testing.assert_array_equal(got[agree], want[agree])
