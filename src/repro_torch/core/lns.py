"""The parts of the FIX16 log-number-system datapath the H-FA rail uses.

``exp2_neg`` is Eq. (19): 2^{-D} = (2^{-f}) >> p through an 8-segment
piecewise-linear LUT whose coefficients are fitted in numpy when this
module is imported and quantized to Q1.15.  The fit is recomputed here
exactly as the reference does it, so the table - and every value the
rail produces - is bit-identical; the CUDA kernels receive the same 16
numbers as a launch argument (see :func:`pwl_lut16`).

Rail values are float32 tensors holding log2|x| * 2^7; they stay
integer-valued, so float32 is exact.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.numerics import FRAC_BITS, FRAC_ONE

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
