"""FIX16 log-domain format constants shared by the H-FA rail.

The bit layouts follow IEEE BFloat16: 1 sign | 8 exponent (bias 127) |
7 mantissa bits.  The rail carries the raw fixed-point value (value *
2^7) in a float32 tensor; every value on it is integer-valued, so the
emulation is exact.
"""
from __future__ import annotations

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
