"""The LNS ablations of the paper's Table III (``lns.LNSConfig``) and the
float bit tricks of ``kernels/bitmath.py`` against the reference, on
numpy inputs from a seed.

Every config - DEFAULT, EXACT and each single switch - goes through
``lns_from_bf16`` over all 65,536 bf16 patterns, ``quant_scorediff``,
``pwl_exp2_frac``, ``exp2_neg``, ``lns_add`` and ``lns_to_bf16``, bit for
bit.  One exception, stated where it is held: under EXACT (exact_quant
with exact_mitchell and exact_pwl) the rail is not rounded, so where
XLA's CPU ``pow`` or ``log`` sits an ulp from the port's (``lns.py``'s
docstring) the rail keeps it: ``lns_from_bf16`` within 2 ulps of f32
(4 magnitudes), ``lns_add``'s corrections and the exact PWL within 4.
``core.hfa.hfa_attention`` and ``hfa_blockparallel`` at a small size:
bit for bit on every config but EXACT, and EXACT within one rail step
(2^(1/128) - 1 of each output's magnitude).  ``exp2_mitchell_f32``,
``pwl_exp2_frac_f32`` bit for bit, and ``lns_value_f32`` bit for bit
below 2^127.5 and within 4 ulps above it.
"""
import dataclasses

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from repro.core import hfa as jhfa
from repro.core import lns as jlns
from repro.kernels import bitmath as jbm
from repro_torch.core import hfa as thfa
from repro_torch.core import lns
from repro_torch.kernels import bitmath as tbm
from test_torch_engine_common import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CFGS = [lns.DEFAULT, lns.EXACT, lns.LNSConfig(exact_quant=True),
        lns.LNSConfig(exact_mitchell=True), lns.LNSConfig(exact_pwl=True)]
IDS = [c.tag for c in CFGS]
RAIL_STEP = 2.0 ** (1 / 128) - 1


def _jcfg(cfg):
    return jlns.LNSConfig(**dataclasses.asdict(cfg))


def _np(x):
    return np.asarray(x)


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


def _same(got, want, ulps: int = 0, name: str = ""):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if ulps == 0 or got.dtype.kind == "i":
        np.testing.assert_array_equal(got, want, err_msg=name)
        return
    both_nan = np.isnan(got) & np.isnan(want)
    dist = np.abs(_bits(got) - _bits(want))
    assert (dist[~both_nan] <= ulps).all(), (name, int(dist.max()))


def _unrounded(cfg) -> bool:
    """EXACT: an unrounded rail fed by a transcendental."""
    return cfg.exact_quant and (cfg.exact_mitchell or cfg.exact_pwl)


def test_config_tags_match_reference():
    for cfg in CFGS:
        assert cfg.tag == _jcfg(cfg).tag
    assert lns.DEFAULT == lns.LNSConfig() and lns.EXACT.tag == \
        "exact-quant+exact-mitchell+exact-pwl"


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_lns_from_bf16_every_pattern(cfg):
    bits = np.arange(65536, dtype=np.uint32).astype(np.uint16)
    v = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    jv = jnp.asarray(bits).view(jnp.bfloat16)
    sgn, raw = lns.lns_from_bf16(v, cfg)
    jsgn, jraw = jlns.lns_from_bf16(jv, _jcfg(cfg))
    finite = np.isfinite(v.to(torch.float32).numpy())
    _same(sgn.numpy()[finite], _np(jsgn)[finite], name="sign")
    # EXACT: XLA's f32 log of 4 of the positive normal magnitudes is an
    # ulp from lns.log_f32's, 2 after the scaling, and the unrounded
    # rail keeps it.
    ulps = 2 if _unrounded(cfg) else 0
    _same(raw.numpy()[finite], _np(jraw)[finite], ulps, "raw")


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_scalar_blocks_match_reference(cfg):
    rng = np.random.default_rng(0)
    diff = np.concatenate([-rng.exponential(3.0, 4096), [0.0, -15.0, -16.0,
                                                         -1e30, -np.inf]])
    diff = diff.astype(np.float32)
    jc = _jcfg(cfg)
    _same(lns.quant_scorediff(torch.from_numpy(diff), cfg).numpy(),
          _np(jlns.quant_scorediff(jnp.asarray(diff), jc)), name="quant")
    # The fraction rail: every integer f7, and unrounded values.
    frac = np.concatenate([np.arange(128), rng.random(2048) * 128]).astype(
        np.float32)
    ulps = 4 if _unrounded(cfg) else 0
    _same(lns.pwl_exp2_frac(torch.from_numpy(frac), cfg).numpy(),
          _np(jlns.pwl_exp2_frac(jnp.asarray(frac), jc)), ulps, "pwl")
    d = np.concatenate([np.arange(0, 2048), rng.random(4096) * 4096,
                        [60 * 128.0, 1e4]]).astype(np.float32)
    _same(lns.exp2_neg(torch.from_numpy(d), cfg).numpy(),
          _np(jlns.exp2_neg(jnp.asarray(d), jc)), ulps, "exp2_neg")


def _lns_operands(rng, n, integer: bool):
    raw = rng.integers(-3000, 3000, (2, n)).astype(np.float32)
    if not integer:
        raw += rng.random((2, n)).astype(np.float32)
    raw[:, :64] = -32768.0                          # zero operands
    raw[1, 64:128] = raw[0, 64:128]                 # ties: cancel / double
    sgn = rng.integers(0, 2, (2, n)).astype(np.int32)
    return sgn, raw


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_lns_add_matches_reference(cfg):
    rng = np.random.default_rng(1)
    jc = _jcfg(cfg)
    for integer in (True, False):
        sgn, raw = _lns_operands(rng, 8192, integer)
        got = lns.lns_add(torch.from_numpy(sgn[0]), torch.from_numpy(raw[0]),
                          torch.from_numpy(sgn[1]), torch.from_numpy(raw[1]),
                          cfg)
        want = jlns.lns_add(*(jnp.asarray(x) for x in (sgn[0], raw[0],
                                                       sgn[1], raw[1])), jc)
        _same(got[0].numpy(), _np(want[0]), name="sign")
        _same(got[1].numpy(), _np(want[1]), 4 if _unrounded(cfg) else 0,
              "raw")


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
def test_lns_to_bf16_matches_reference(cfg):
    rng = np.random.default_rng(2)
    raw = np.concatenate([np.arange(-32768, 32768, 7),
                          rng.random(4096) * 4000 - 2000]).astype(np.float32)
    sgn = rng.integers(0, 2, raw.shape).astype(np.int32)
    got = lns.lns_to_bf16(torch.from_numpy(sgn), torch.from_numpy(raw), cfg)
    want = jlns.lns_to_bf16(jnp.asarray(sgn), jnp.asarray(raw), _jcfg(cfg))
    _same(got.to(torch.float32).numpy(),
          _np(want.astype(jnp.float32)), name="bf16")


def _qkv(seed, b=2, lq=8, lkv=16, d=64):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, n, d)).astype(np.float32)
            for n in (lq, lkv, lkv)]


def _hold_attention(got, want, cfg):
    got = got.to(torch.float32).numpy()
    want = _np(want.astype(jnp.float32))
    if not _unrounded(cfg):
        np.testing.assert_array_equal(got, want)
        return
    # One rail step of each output's magnitude (an output of exactly 0 on
    # one side may be a rail value flushed on the other).
    tol = RAIL_STEP * np.maximum(np.abs(want), np.abs(got)) * 1.0001
    assert (np.abs(got - want) <= tol).all(), float(np.abs(got - want).max())


@pytest.mark.parametrize("cfg", CFGS, ids=IDS)
@pytest.mark.parametrize("causal", [False, True])
def test_hfa_attention_and_blockparallel_match_reference(cfg, causal):
    q, k, v = _qkv(3 + causal)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    jc = _jcfg(cfg)
    _hold_attention(thfa.hfa_attention(tq, tk, tv, causal=causal, cfg=cfg),
                    jhfa.hfa_attention(jq, jk, jv, causal=causal, cfg=jc),
                    cfg)
    _hold_attention(
        thfa.hfa_blockparallel(tq, tk, tv, num_blocks=4, causal=causal,
                               cfg=cfg),
        jhfa.hfa_blockparallel(jq, jk, jv, num_blocks=4, causal=causal,
                               cfg=jc), cfg)


def test_float_bit_tricks_match_reference():
    rng = np.random.default_rng(4)
    y = np.concatenate([rng.random(8192) * 300 - 150, np.arange(-130, 130),
                        [-126.0, -126.5, 127.99, 0.0]]).astype(np.float32)
    _same(tbm.exp2_mitchell_f32(torch.from_numpy(y)).numpy(),
          _np(jbm.exp2_mitchell_f32(jnp.asarray(y))), name="exp2_mitchell")
    f = np.concatenate([rng.random(8192), np.arange(8) / 8.0]).astype(
        np.float32)
    _same(tbm.pwl_exp2_frac_f32(torch.from_numpy(f)).numpy(),
          _np(jbm.pwl_exp2_frac_f32(jnp.asarray(f))), name="pwl_f32")
    raw = np.concatenate([np.arange(-32768, 32768),
                          rng.random(8192) * 8000 - 4000]).astype(np.float32)
    sgn = rng.integers(0, 2, raw.shape).astype(np.int32)
    got = lns.lns_value_f32(torch.from_numpy(sgn),
                            torch.from_numpy(raw)).numpy()
    want = _np(jlns.lns_value_f32(jnp.asarray(sgn), jnp.asarray(raw)))
    # Bit for bit below 2^127.5; in the top binade XLA's exp reduces its
    # argument otherwise (a few values an ulp or two apart).
    top = raw >= 127.5 * 128
    _same(got[~top], want[~top], name="lns_value_f32")
    _same(got[top], want[top], 4, "lns_value_f32 top binade")
