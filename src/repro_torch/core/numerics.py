"""FIX16 log-domain format constants and bf16 bit helpers shared by the
H-FA rail and the LNS datapath.

The bit layouts follow IEEE BFloat16: 1 sign | 8 exponent (bias 127) |
7 mantissa bits.  The rail carries the raw fixed-point value (value *
2^7) in a float32 tensor; every value on it is integer-valued, so the
emulation is exact.
"""
from __future__ import annotations

import torch

BF16_BIAS = 127
BF16_MANT_BITS = 7
BF16_EXP_BITS = 8

# FIX16 log-domain format from the paper: 9 integer bits, 7 fraction bits,
# two's complement.
FRAC_BITS = 7
FRAC_ONE = 1 << FRAC_BITS  # 128
FIX_MAX = (1 << 15) - 1    # 32767
FIX_MIN = -(1 << 15)       # -32768
LOG_ZERO = FIX_MIN         # encoding of log2(0) = -inf in the datapath


def bf16_bits(x: torch.Tensor) -> torch.Tensor:
    """Bitcast to bfloat16 bit patterns (rounding x to bf16 first), as
    int32 in [0, 65535]."""
    bits = x.to(torch.bfloat16).contiguous().view(torch.int16)
    return bits.to(torch.int32) & 0xFFFF


def bits_bf16(bits: torch.Tensor) -> torch.Tensor:
    """uint16 patterns (given as int32) back to bfloat16."""
    b = (bits & 0xFFFF).to(torch.int32)
    b = torch.where(b >= 0x8000, b - 0x10000, b)      # as signed int16
    return b.to(torch.int16).view(torch.bfloat16)


def to_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round to bfloat16 (round-to-nearest-even, what the datapath sees)."""
    return x.to(torch.bfloat16)
