"""Bit-trick float math of the H-FA rail, as plain torch.

These are the plain versions of the device functions in
``csrc/paged_attention.cu`` (``quant_rail``, ``exp2_hfa_rail``,
``recip_logdiv``): every step is exact or a single correctly rounded
float32 operation, so the CUDA kernels and these functions agree bit for
bit.  Rounding is half-to-even everywhere (``torch.round`` here,
``rintf`` in CUDA).

Each rail function carries the reference's straight-through estimator
(STE): the forward is the hardware value, the gradient is that of a
smooth surrogate (``_ste``).  The quantize/PWL/floor chain has zero
derivative almost everywhere, so training through the H-FA numerics
uses the standard QAT surrogate.
"""
from __future__ import annotations

import torch

from repro_torch.core import lns
from repro_torch.core.numerics import FRAC_ONE

F32_BIAS = 127
F32_MANT = 23


def exp2_int(p: torch.Tensor) -> torch.Tensor:
    """Exact 2^p for integer-valued float/int p via exponent-field packing."""
    pi = torch.clamp(p.to(torch.int32), -126, 127)
    bits = torch.bitwise_left_shift(pi + F32_BIAS, F32_MANT)
    return bits.view(torch.float32)


def log2_mitchell_f32(x: torch.Tensor) -> torch.Tensor:
    """Blinn/Mitchell log2 of |x| for float32 x (Eq. 18 on f32 bits):
    log2(x) ~= E + M - one bitcast, one int subtract, one scale."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    mag = torch.bitwise_and(bits, 0x7FFFFFFF)
    return (mag - (F32_BIAS << F32_MANT)).to(torch.float32) * (2.0 ** -F32_MANT)


def exp2_mitchell_f32(y: torch.Tensor) -> torch.Tensor:
    """Inverse Mitchell 2^y ~= the bit pack of (I + bias, F) for f32 y;
    0 below 2^-126.  (The integer part is clamped before its int32
    conversion, which saturates in the reference.)"""
    yi = torch.floor(y)
    f = y - yi
    pi = torch.clamp(torch.clamp(yi, -127.0, 128.0).to(torch.int32),
                     -126, 127)
    bits = torch.bitwise_left_shift(pi + F32_BIAS, F32_MANT) + torch.round(
        f * (1 << F32_MANT)).to(torch.int32)
    out = bits.view(torch.float32)
    return torch.where(y < -126.0, torch.zeros_like(out), out)


def pwl_exp2_frac_f32(f: torch.Tensor) -> torch.Tensor:
    """The paper's 8-segment PWL 2^{-f}, f in [0, 1), on float values,
    with the FIX16 datapath's Q1.15 coefficients (:mod:`repro_torch.core.
    lns`)."""
    seg = torch.clamp(torch.floor(f * 8.0), 0, 7)
    av = lns._lut8(seg, lns.PWL_SLOPES_Q15)
    bv = lns._lut8(seg, lns.PWL_INTERCEPTS_Q15)
    return (av * f + bv) * (2.0 ** -15)


def _ste(hw: torch.Tensor, x: torch.Tensor, smooth) -> torch.Tensor:
    """Straight-through estimator: forward = ``hw`` (bit for bit), grad =
    that of ``smooth()`` with respect to the input ``x``.  The surrogate
    is built only where autograd records ``x``; elsewhere (inference,
    the kernels' plain versions) the function returns ``hw`` itself."""
    if not (torch.is_grad_enabled() and x.requires_grad):
        return hw
    s = smooth()
    return hw + (s - s.detach())


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip`` as the reference's autograd sees it: max then min,
    each splitting the gradient in half on a tie (torch.clamp would pass
    it whole at the bounds, where attention's row max sits: s - m = 0).
    The bounds are filled on the device (``new_tensor`` would copy them
    from the host and synchronise)."""
    return torch.minimum(torch.maximum(x, x.new_full((), lo)),
                         x.new_full((), hi))


def exp2_hfa_rail(rail: torch.Tensor) -> torch.Tensor:
    """H-FA hardware 2^{rail/128} for a non-positive FIX16 rail value:
    PWL for the fractional 2^{-f}, exponent packing for the 2^{-p} shift,
    the PWL output quantized to the 7-bit rail like the FIX16 datapath.
    STE backward: d/drail 2^{rail/128}."""
    r = rail.detach()
    d = -r  # non-negative
    p = torch.floor(d / FRAC_ONE)
    f7 = d - p * FRAC_ONE
    g7 = lns.pwl_exp2_frac(f7)          # fraction rail in [64, 128]
    hw = (g7 * (1.0 / FRAC_ONE)) * exp2_int(-p)
    return _ste(hw, rail, lambda: torch.exp2(rail * (1.0 / FRAC_ONE)))


def quant_rail(diff_nat: torch.Tensor) -> torch.Tensor:
    """quant[(.)*log2 e] to the FIX16 rail (Eq. 14b/c).  Adding 0.0
    folds a rounded -0.0 into +0.0, the zero the reference yields.
    STE backward: the gradient of the unrounded rail value."""
    diff = _clip(diff_nat, lns.DIFF_CLAMP_NAT, 0.0)
    hw = torch.round(diff.detach() * lns.LOG2E * FRAC_ONE) + 0.0
    return _ste(hw, diff_nat, lambda: diff * lns.LOG2E * FRAC_ONE)


def recip_logdiv(ell: torch.Tensor) -> torch.Tensor:
    """1/ell without a divider: Blinn log2, rail negate, inverse bit-pack
    (the LogDiv unit's division-free normalization on a float
    accumulator, quantized to the 7-bit fraction rail).  STE backward:
    the gradient of 1/ell."""
    rail = torch.round(log2_mitchell_f32(ell.detach()) * FRAC_ONE)
    neg = -rail
    i_part = torch.floor(neg / FRAC_ONE)
    f_part = neg / FRAC_ONE - i_part
    hw = exp2_int(i_part) * (1.0 + f_part)
    return _ste(hw, ell, lambda: 1.0 / ell)
