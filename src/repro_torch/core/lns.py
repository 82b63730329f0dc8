"""The FIX16 log-number-system datapath of the H-FA paper (Sec. IV-V).

The reference's ``src/repro/core/lns.py``, with the ``LNSConfig``
ablations of the paper's Table III:

* ``quant_scorediff`` - Eq. (14b/c): clamp a natural-domain score
  difference to [-15, 0], times log2(e), quantized to the FIX16 rail.
* ``blinn_log2``      - Eq. (18): BF16 -> (sign, rail log2 magnitude) by
  reinterpreting the exponent/mantissa bits.
* ``exp2_neg``        - Eq. (19), below.
* ``lns_add``         - Eq. (10)+(17): signed LNS addition with
  Mitchell's log2(1 +- 2^-D) ~= +-2^-D.
* ``lns_to_bf16``     - Eq. (22): rail value back to BF16 (bit packing).

LNS numbers are (sign, raw) pairs: ``sign`` int32 in {0, 1}, ``raw`` a
float32 tensor holding log2|x| * 2^7; ``raw <= LOG_ZERO`` encodes 0.

``exp2_neg`` is Eq. (19): 2^{-D} = (2^{-f}) >> p through an 8-segment
piecewise-linear LUT whose coefficients are fitted in numpy when this
module is imported and quantized to Q1.15.  The fit is recomputed here
exactly as the reference does it, so the table - and every value the
rail produces - is bit-identical; the CUDA kernels receive the same 16
numbers as a launch argument (see :func:`pwl_lut16`).  As a function of
the integer D it is also a table of 1,024 bytes, 0 beyond
(:func:`exp2_neg_table`), which the datapath kernel looks up.

Rail values are float32 tensors holding log2|x| * 2^7.  In the default
configuration they stay integer-valued, so float32 is exact; the
table shortcuts (``exp2_neg_table``, ``pwl_lut16``, ``rail_rescale``)
hold only there.  ``LNSConfig`` switches each approximation off, as the
reference's float rail does:

  exact_quant    - keep score differences and corrections unrounded (the
                   rail is no longer integer-valued)
  exact_mitchell - true log2(1 +- x) instead of Mitchell's +-x, and true
                   log2 instead of Blinn's bit trick
  exact_pwl      - true 2^-f instead of the 8-segment PWL

The ablations' transcendentals follow the reference as XLA's CPU
backend evaluates it, the same on any device: ``jnp.log2`` is XLA's f32
log (Cephes' polynomial with fused multiply-adds, :func:`log_f32`)
times the f32 reciprocal of ln 2, ``jnp.exp2`` XLA's f32 exp
(:func:`exp_f32`), a subnormal reads as zero (XLA flushes them), and
``2 ** x`` is taken in f64 and rounded once.  Where the rail rounds
(every switch but exact_quant) that gives the reference's bits; on the
unrounded rail of ``exact_quant`` with ``exact_mitchell`` or
``exact_pwl`` XLA's f32 ``pow`` (and, for 4 of the 32,512 positive
normal bf16 magnitudes, its ``log``) can sit an ulp from this one.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.numerics import (BF16_BIAS, FIX_MAX, FIX_MIN,
                                      FRAC_BITS, FRAC_ONE, LOG_ZERO,
                                      bf16_bits)

LOG2E = float(np.log2(np.e))
# Natural-domain score differences below -15 contribute e^-15 ~ 3e-7 and are
# clamped (paper Sec. IV-B).
DIFF_CLAMP_NAT = -15.0

_NUM_SEGMENTS = 8
_COEF_FRAC_BITS = 15  # Q1.15 LUT coefficients


def _fit_pwl_exp2() -> tuple[np.ndarray, np.ndarray]:
    """Least-squares fit of 2^{-f} on 8 uniform segments of [0, 1),
    quantized to Q1.15 so the hardware LUT stays pure fixed point."""
    slopes = np.zeros(_NUM_SEGMENTS)
    intercepts = np.zeros(_NUM_SEGMENTS)
    for seg in range(_NUM_SEGMENTS):
        f = np.linspace(seg / _NUM_SEGMENTS, (seg + 1) / _NUM_SEGMENTS, 257)
        y = 2.0 ** (-f)
        a, b = np.polyfit(f, y, 1)
        slopes[seg] = a
        intercepts[seg] = b
    scale = 1 << _COEF_FRAC_BITS
    return (
        np.round(slopes * scale).astype(np.float32),
        np.round(intercepts * scale).astype(np.float32),
    )


_PWL_A, _PWL_B = _fit_pwl_exp2()
PWL_SLOPES_Q15 = tuple(float(x) for x in _PWL_A)
PWL_INTERCEPTS_Q15 = tuple(float(x) for x in _PWL_B)


def pwl_lut16() -> np.ndarray:
    """The 8 slopes then the 8 intercepts, float32 - the table the CUDA
    kernels take as a launch argument."""
    return np.concatenate([_PWL_A, _PWL_B]).astype(np.float32)


def _lut8(seg: torch.Tensor, table: tuple[float, ...]) -> torch.Tensor:
    """8-way select chain with literal coefficients (the hardware LUT
    mux): entry i wins where ``seg >= i``."""
    segf = seg.to(torch.float32)
    out = torch.full_like(segf, table[0])
    for i in range(1, _NUM_SEGMENTS):
        out = torch.where(segf >= i, torch.full_like(segf, table[i]), out)
    return out


@dataclasses.dataclass(frozen=True)
class LNSConfig:
    """Ablation switches for the three approximation sources (Table III)."""

    exact_quant: bool = False
    exact_mitchell: bool = False
    exact_pwl: bool = False

    @property
    def tag(self) -> str:
        parts = [name for name, on in (("exact-quant", self.exact_quant),
                                       ("exact-mitchell", self.exact_mitchell),
                                       ("exact-pwl", self.exact_pwl)) if on]
        return "+".join(parts) if parts else "full"


DEFAULT = LNSConfig()
EXACT = LNSConfig(exact_quant=True, exact_mitchell=True, exact_pwl=True)
# f32(1 / f32(ln 2)): XLA turns jnp.log2's divide by log(2) into this
# product.
_INV_LN2 = float(np.float32(1.0) / np.float32(np.log(np.float32(2.0))))
_F32_TINY = 2.0 ** -126     # below it XLA's CPU reads an f32 as zero


def _round_rail(x: torch.Tensor, cfg: LNSConfig) -> torch.Tensor:
    """Round a rail value to the 7-fraction-bit grid unless quant is
    ablated."""
    return x if cfg.exact_quant else torch.round(x)


def fma_f32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c rounded once to f32 (the product is exact in f64)."""
    return (a.to(torch.float64) * b + c).to(torch.float32)


# XLA's CPU log for a normal f32 (Cephes' polynomial on [sqrt(1/2),
# sqrt(2)), with fused multiply-adds): within an ulp of the reference's
# log, and the same on any device.
_LOG_POLY = (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
             -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
             2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1)


def log_f32(x: torch.Tensor) -> torch.Tensor:
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF).to(torch.float32) - 126.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # [.5, 1)
    low = m < 0.707106781186547524
    e = e - low.to(torch.float32)
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    m2 = m * m
    m3 = m2 * m
    c = [float(np.float32(v)) for v in _LOG_POLY]
    y = fma_f32(m, c[0], c[1])
    y1 = fma_f32(m, c[3], c[4])
    y2 = fma_f32(m, c[6], c[7])
    y = fma_f32(y, m, c[2])
    y1 = fma_f32(y1, m, c[5])
    y2 = fma_f32(y2, m, c[8])
    y = fma_f32(y, m3, y1)
    y = fma_f32(y, m3, y2) * m3
    y = y + e * float(np.float32(-2.12194440e-4))
    m = m - 0.5 * m2
    return (m + y) + e * 0.693359375


def _log2(x: torch.Tensor) -> torch.Tensor:
    """``jnp.log2`` of a positive normal f32: log(x) times f32(1 / ln 2),
    the product XLA makes of the divide by log(2)."""
    return log_f32(x) * _INV_LN2


def _pow2(y: torch.Tensor) -> torch.Tensor:
    """``2.0 ** y`` in f32, taken in f64 and rounded once."""
    return torch.exp2(y.to(torch.float64)).to(torch.float32)


def pwl_exp2_frac(f_rail: torch.Tensor,
                  cfg: LNSConfig = DEFAULT) -> torch.Tensor:
    """2^{-f} for f = f_rail/128 in [0,1), on the fraction rail ([64,128]).

    8-segment PWL LUT indexed by the top 3 fraction bits (Eq. 19).
    """
    if cfg.exact_pwl:
        return _round_rail(_pow2(-(f_rail / FRAC_ONE)) * FRAC_ONE,
                           cfg)
    seg = torch.clamp(torch.floor(f_rail / (FRAC_ONE / _NUM_SEGMENTS)), 0,
                      _NUM_SEGMENTS - 1)
    a = _lut8(seg, PWL_SLOPES_Q15)
    b = _lut8(seg, PWL_INTERCEPTS_Q15)
    # g_q15 = a*f + b with f = f_rail/128; hardware: (a*f7 >> 7) + b.
    g_q15 = torch.floor(a * f_rail / FRAC_ONE) + b
    # Round from Q1.15 down to the 7-bit fraction rail (round-half-up, as a
    # truncating adder-with-carry-in would).
    down = 1 << (_COEF_FRAC_BITS - FRAC_BITS)
    if cfg.exact_quant:
        return g_q15 / down
    return torch.floor((g_q15 + down // 2) / down)


def exp2_neg(raw_d: torch.Tensor, cfg: LNSConfig = DEFAULT) -> torch.Tensor:
    """2^{-D} for non-negative rail D, result on the fraction rail.

    Split D = p + f (integer/fraction): 2^{-D} = 2^{-f} >> p  (Eq. 19).
    """
    p = torch.floor(raw_d / FRAC_ONE)
    f = raw_d - p * FRAC_ONE
    g = pwl_exp2_frac(f, cfg)
    shifted = g * torch.exp2(-torch.clamp(p, max=60.0))
    if cfg.exact_quant:
        return shifted
    # Hardware right shift truncates.
    return torch.floor(shifted)


# exp2_neg(d) is floor(g(f) 2^-p) with p = d >> 7, f = d & 127 and g <= 128:
# a function of the integer d alone, 0 for every d >= 1024 (p >= 8).
EXP2_NEG_TABLE = 1024


def exp2_neg_table() -> np.ndarray:
    """exp2_neg(d) for d = 0 .. 1023 as uint8 (the last entry, and every
    d beyond, is 0): the table the datapath kernel looks the Mitchell
    correction up in, built from :func:`exp2_neg` itself."""
    d = torch.arange(EXP2_NEG_TABLE, dtype=torch.float32)
    return exp2_neg(d).numpy().astype(np.uint8)


def clamp_rail(raw: torch.Tensor) -> torch.Tensor:
    """Saturate a rail value to the FIX16 range."""
    return torch.clamp(raw, FIX_MIN, FIX_MAX)


def quant_scorediff(diff_nat: torch.Tensor,
                    cfg: LNSConfig = DEFAULT) -> torch.Tensor:
    """Eq. (14b/c): the rail value of a non-positive natural-domain score
    difference times log2(e); -inf-like values hit the clamp."""
    diff = torch.clamp(diff_nat.to(torch.float32), DIFF_CLAMP_NAT, 0.0)
    return _round_rail(diff * LOG2E * FRAC_ONE, cfg)


def blinn_log2(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (18): BF16 -> (sign, rail log2 magnitude) by bit
    reinterpretation: raw = (bits & 0x7FFF) - (bias << 7); v == 0 maps
    to LOG_ZERO."""
    bits = bf16_bits(v)
    sign = (bits >> 15) & 1
    mag = bits & 0x7FFF
    raw = (mag - (BF16_BIAS << FRAC_BITS)).to(torch.float32)
    raw = torch.where(mag == 0, torch.full_like(raw, float(LOG_ZERO)), raw)
    return sign, clamp_rail(raw)


def exact_log2(v: torch.Tensor, cfg: LNSConfig = DEFAULT
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Ablation counterpart of :func:`blinn_log2`: the true log2, then the
    rail's rounding.  A subnormal magnitude (XLA's CPU reads it as zero)
    maps to LOG_ZERO with sign 0, as in the reference."""
    vf = v.to(torch.float32)
    mag = torch.abs(vf)
    zero = mag < _F32_TINY
    sign = ((vf < 0) & ~zero).to(torch.int32)
    raw = _round_rail(_log2(torch.clamp(mag, min=_F32_TINY)) * FRAC_ONE, cfg)
    raw = torch.where(zero, torch.full_like(raw, float(LOG_ZERO)), raw)
    return sign, clamp_rail(raw)


def lns_from_bf16(v: torch.Tensor, cfg: LNSConfig = DEFAULT
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Float -> LNS: Blinn's trick is a Mitchell approximation (Eq. 18)."""
    if cfg.exact_mitchell:
        return exact_log2(v, cfg)
    return blinn_log2(v)


def rail_rescale(raw: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """raw + q on the rail for q <= 0 and rail values raw: the reference's
    saturated add that keeps a zero (LOG_ZERO) zero is max(raw + q,
    LOG_ZERO) - the form the datapath kernel computes."""
    return torch.clamp(raw + q, min=float(LOG_ZERO))


def lns_add(sign_a: torch.Tensor, raw_a: torch.Tensor, sign_b: torch.Tensor,
            raw_b: torch.Tensor, cfg: LNSConfig = DEFAULT
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (10) + (17): signed LNS addition c = a + b, with a =
    (-1)^sign_a 2^(raw_a/128) and likewise b.  Returns (sign_c, raw_c)."""
    zero = torch.full_like(raw_a, float(LOG_ZERO))
    a_is_zero = raw_a <= LOG_ZERO
    b_is_zero = raw_b <= LOG_ZERO
    big = torch.maximum(raw_a, raw_b)
    d = torch.abs(raw_a - raw_b)
    same_sign = sign_a == sign_b
    if cfg.exact_mitchell:
        x = _pow2(-(d / FRAC_ONE))
        corr_pos = _round_rail(_log2(1.0 + x) * FRAC_ONE, cfg)
        xm = torch.clamp(x, max=1.0 - 2.0 ** -24)
        corr_neg = _round_rail(-_log2(1.0 - xm) * FRAC_ONE, cfg)
    else:
        # Mitchell: log2(1 +- 2^-D) ~= +- 2^-D
        corr_pos = corr_neg = exp2_neg(d, cfg)
    raw_c = torch.where(same_sign, big + corr_pos, big - corr_neg)
    # Sign follows the larger magnitude; ties (B >= A) take B (14d).
    sign_c = torch.where(raw_a > raw_b, sign_a, sign_b)
    # Zero-operand bypasses.
    raw_c = torch.where(a_is_zero, raw_b, raw_c)
    sign_c = torch.where(a_is_zero, sign_b, sign_c)
    raw_c = torch.where(b_is_zero, torch.where(a_is_zero, zero, raw_a), raw_c)
    sign_c = torch.where(b_is_zero, torch.where(a_is_zero,
                                                torch.zeros_like(sign_a),
                                                sign_a), sign_c)
    # Exact cancellation (same magnitude, opposite sign) -> zero.
    cancel = ~same_sign & (d == 0) & ~a_is_zero & ~b_is_zero
    raw_c = torch.where(cancel, zero, raw_c)
    sign_c = torch.where(cancel, torch.zeros_like(sign_c), sign_c)
    return sign_c.to(torch.int32), clamp_rail(raw_c)


def lns_to_bf16(sign: torch.Tensor, raw: torch.Tensor,
                cfg: LNSConfig = DEFAULT) -> torch.Tensor:
    """Eq. (22): (sign, rail log2 magnitude) -> BFloat16, |x| = 2^I (1+F).
    For integer rail values this is the hardware bit packing: underflow
    flushes to zero, overflow saturates to the largest finite BF16.  With
    ``exact_mitchell`` the true 2^(raw/128) instead (ablation).

    The lowest binade (I = -126) also reads as zero, as in the
    reference: there XLA's f32 ``exp2`` returns 2^-126 as a subnormal,
    which the CPU flushes to zero.  The port keeps that rule so both
    packages agree on every bit pattern."""
    i_part = torch.floor(raw / FRAC_ONE)
    f_part = raw / FRAC_ONE - i_part
    is_zero = raw <= LOG_ZERO
    # The bit packing's lowest binade reads as zero (above); the exact
    # 2^(raw/128) of exact_mitchell keeps it, as the reference's does.
    underflow = (i_part + BF16_BIAS) <= (0 if cfg.exact_mitchell else 1)
    overflow = (i_part + BF16_BIAS) >= 255
    i_safe = torch.clamp(i_part, 1 - BF16_BIAS, 254 - BF16_BIAS)
    if cfg.exact_mitchell:
        mag = exp_f32((i_safe + f_part) * _LN2)
    else:
        mag = torch.exp2(i_safe) * (1.0 + f_part)
    mag = torch.where(underflow | is_zero, torch.zeros_like(mag), mag)
    max_finite = 2.0 ** 127 * (1.0 + 127.0 / 128.0)
    mag = torch.where(overflow & ~is_zero, torch.full_like(mag, max_finite),
                      mag)
    return torch.where(sign == 1, -mag, mag).to(torch.bfloat16)


# XLA's CPU exp for f32 (Cephes' polynomial, with fused multiply-adds),
# which jnp.exp2(x) = exp(x * f32(ln 2)) reaches: the reference's value
# bit for bit, on any device.
_LN2 = float(np.float32(np.log(2.0)))
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def exp_f32(x: torch.Tensor) -> torch.Tensor:
    big = x > 88.72283935546875                 # above log(FLT_MAX): inf
    x = torch.clamp(x, -88.3762626647949, 88.72283935546875)
    fx = torch.floor(fma_f32(x, float(np.float32(1.44269504088896341)), 0.5))
    r = fma_f32(fx, float(np.float32(-0.693359375)), x)
    r = fma_f32(fx, float(np.float32(2.12194440e-4)), r)
    z = r * r
    y = torch.full_like(r, float(np.float32(_EXP_POLY[0])))
    for c in _EXP_POLY[1:]:
        y = fma_f32(y, r, float(np.float32(c)))
    y = fma_f32(y, z, r) + 1.0
    # y * 2^fx in two exact steps (2^128 alone would overflow), and a
    # subnormal result flushed to zero, as XLA's CPU does.
    half = torch.floor(fx * 0.5)
    out = y * torch.exp2(half) * torch.exp2(fx - half)
    out = torch.where(out < _F32_TINY, torch.zeros_like(out), out)
    return torch.where(big, torch.full_like(out, float("inf")), out)


def lns_value_f32(sign: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Debug helper: the value under *true* log semantics, 2^(raw/128)."""
    mag = torch.where(raw <= LOG_ZERO, torch.zeros_like(raw),
                      exp_f32((raw / FRAC_ONE) * _LN2))
    return torch.where(sign == 1, -mag, mag)


def lns_value_hw(sign: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Value under hardware semantics, 2^I (1+F) in float32 (Blinn's
    forward conversion and this inverse cancel exactly)."""
    i_part = torch.floor(raw / FRAC_ONE)
    f_part = raw / FRAC_ONE - i_part
    mag = torch.exp2(i_part) * (1.0 + f_part)
    mag = torch.where(raw <= LOG_ZERO, torch.zeros_like(mag), mag)
    return torch.where(sign == 1, -mag, mag)
