"""The FIX16 log-number-system datapath of the H-FA paper (Sec. IV-V).

The reference's ``src/repro/core/lns.py`` in its default configuration
(the ``LNSConfig`` ablations of the paper's Table III are not ported):

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

Rail values are float32 tensors holding log2|x| * 2^7; they stay
integer-valued, so float32 is exact.
"""
from __future__ import annotations

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


def pwl_exp2_frac(f_rail: torch.Tensor) -> torch.Tensor:
    """2^{-f} for f = f_rail/128 in [0,1), on the fraction rail ([64,128]).

    8-segment PWL LUT indexed by the top 3 fraction bits (Eq. 19).
    """
    seg = torch.clamp(torch.floor(f_rail / (FRAC_ONE / _NUM_SEGMENTS)), 0,
                      _NUM_SEGMENTS - 1)
    a = _lut8(seg, PWL_SLOPES_Q15)
    b = _lut8(seg, PWL_INTERCEPTS_Q15)
    # g_q15 = a*f + b with f = f_rail/128; hardware: (a*f7 >> 7) + b.
    g_q15 = torch.floor(a * f_rail / FRAC_ONE) + b
    # Round from Q1.15 down to the 7-bit fraction rail (round-half-up, as a
    # truncating adder-with-carry-in would).
    down = 1 << (_COEF_FRAC_BITS - FRAC_BITS)
    return torch.floor((g_q15 + down // 2) / down)


def exp2_neg(raw_d: torch.Tensor) -> torch.Tensor:
    """2^{-D} for non-negative rail D, result on the fraction rail.

    Split D = p + f (integer/fraction): 2^{-D} = 2^{-f} >> p  (Eq. 19).
    """
    p = torch.floor(raw_d / FRAC_ONE)
    f = raw_d - p * FRAC_ONE
    g = pwl_exp2_frac(f)
    shifted = g * torch.exp2(-torch.clamp(p, max=60.0))
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


def quant_scorediff(diff_nat: torch.Tensor) -> torch.Tensor:
    """Eq. (14b/c): the rail value of a non-positive natural-domain score
    difference times log2(e); -inf-like values hit the clamp."""
    diff = torch.clamp(diff_nat.to(torch.float32), DIFF_CLAMP_NAT, 0.0)
    return torch.round(diff * LOG2E * FRAC_ONE)


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


def lns_from_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Float -> LNS: Blinn's trick is a Mitchell approximation (Eq. 18)."""
    return blinn_log2(v)


def rail_rescale(raw: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """raw + q on the rail for q <= 0 and rail values raw: the reference's
    saturated add that keeps a zero (LOG_ZERO) zero is max(raw + q,
    LOG_ZERO) - the form the datapath kernel computes."""
    return torch.clamp(raw + q, min=float(LOG_ZERO))


def lns_add(sign_a: torch.Tensor, raw_a: torch.Tensor, sign_b: torch.Tensor,
            raw_b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Eq. (10) + (17): signed LNS addition c = a + b, with a =
    (-1)^sign_a 2^(raw_a/128) and likewise b.  Returns (sign_c, raw_c)."""
    zero = torch.full_like(raw_a, float(LOG_ZERO))
    a_is_zero = raw_a <= LOG_ZERO
    b_is_zero = raw_b <= LOG_ZERO
    big = torch.maximum(raw_a, raw_b)
    d = torch.abs(raw_a - raw_b)
    same_sign = sign_a == sign_b
    corr = exp2_neg(d)        # Mitchell: log2(1 +- 2^-D) ~= +- 2^-D
    raw_c = torch.where(same_sign, big + corr, big - corr)
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


def lns_to_bf16(sign: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Eq. (22): (sign, rail log2 magnitude) -> BFloat16, |x| = 2^I (1+F).
    For integer rail values this is the hardware bit packing: underflow
    flushes to zero, overflow saturates to the largest finite BF16.

    The lowest binade (I = -126) also reads as zero, as in the
    reference: there XLA's f32 ``exp2`` returns 2^-126 as a subnormal,
    which the CPU flushes to zero.  The port keeps that rule so both
    packages agree on every bit pattern."""
    i_part = torch.floor(raw / FRAC_ONE)
    f_part = raw / FRAC_ONE - i_part
    is_zero = raw <= LOG_ZERO
    underflow = (i_part + BF16_BIAS) <= 1
    overflow = (i_part + BF16_BIAS) >= 255
    i_safe = torch.clamp(i_part, 1 - BF16_BIAS, 254 - BF16_BIAS)
    mag = torch.exp2(i_safe) * (1.0 + f_part)
    mag = torch.where(underflow | is_zero, torch.zeros_like(mag), mag)
    max_finite = 2.0 ** 127 * (1.0 + 127.0 / 128.0)
    mag = torch.where(overflow & ~is_zero, torch.full_like(mag, max_finite),
                      mag)
    return torch.where(sign == 1, -mag, mag).to(torch.bfloat16)


def lns_value_hw(sign: torch.Tensor, raw: torch.Tensor) -> torch.Tensor:
    """Value under hardware semantics, 2^I (1+F) in float32 (Blinn's
    forward conversion and this inverse cancel exactly)."""
    i_part = torch.floor(raw / FRAC_ONE)
    f_part = raw / FRAC_ONE - i_part
    mag = torch.exp2(i_part) * (1.0 + f_part)
    mag = torch.where(raw <= LOG_ZERO, torch.zeros_like(mag), mag)
    return torch.where(sign == 1, -mag, mag)
