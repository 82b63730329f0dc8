// The FIX16 log-number-system datapath as CUDA device functions.
//
// quant_scorediff, blinn_log2, exp2_neg, lns_add and lns_to_bf16 are
// bit-equal to the plain torch versions in repro_torch/core/lns.py (the
// reference's src/repro/core/lns.py in its default configuration).  Every
// rail value is an integer held in an f32 (|x| < 2^17), so the adds,
// subtracts, compares and the PWL's products are exact; the one rounding
// step, the score difference times log2 e, is written with __fmul_rn and
// rintf (half to even) as in hfa_rail.cuh.  2^-p and 2^I are ldexpf,
// exact for the normal results they give here.
#pragma once

#include <cuda_bf16.h>

#include "hfa_rail.cuh"

constexpr float kLogZero = -32768.0f;   // FIX16 minimum: log2(0)
constexpr float kFixMax = 32767.0f;

__device__ __forceinline__ float clamp_rail(float raw) {
  return fminf(fmaxf(raw, kLogZero), kFixMax);
}

// Eq. (14b/c): rail value of a non-positive natural-domain score
// difference; unlike quant_rail the -0 of a rounded tiny value is kept,
// as the reference keeps it (a rail -0 and +0 read the same everywhere).
__device__ __forceinline__ float quant_scorediff(float x) {
  const float d = fminf(fmaxf(x, kClampNat), 0.0f);
  return rintf(__fmul_rn(__fmul_rn(d, kLog2e), 128.0f));
}

// Eq. (18): bf16 bit pattern -> (sign, rail log2 magnitude).
__device__ __forceinline__ void blinn_log2(unsigned bits, int& sign, float& raw) {
  sign = (bits >> 15) & 1;
  const int mag = bits & 0x7FFF;
  raw = mag == 0 ? kLogZero : clamp_rail((float)(mag - (127 << 7)));
}

// Eq. (19): 2^-D for a non-negative rail D, on the fraction rail,
// truncated: the PWL 2^-f of the fraction, shifted right by the integer.
__device__ __forceinline__ float exp2_neg(float d, const Lut& lut) {
  const float p = floorf(__fmul_rn(d, 0.0078125f));
  const float f7 = __fsub_rn(d, __fmul_rn(p, 128.0f));
  const float seg = fminf(fmaxf(floorf(__fmul_rn(f7, 0.0625f)), 0.0f), 7.0f);
  const float a = lut8(seg, lut.a);
  const float b = lut8(seg, lut.b);
  const float g_q15 = __fadd_rn(floorf(__fmul_rn(__fmul_rn(a, f7), 0.0078125f)), b);
  const float g7 = floorf(__fmul_rn(__fadd_rn(g_q15, 128.0f), 0.00390625f));
  return floorf(ldexpf(g7, -(int)fminf(p, 60.0f)));
}

// Eq. (10) + (17): signed LNS addition c = a + b with Mitchell's
// log2(1 +- 2^-D) ~= +-2^-D; the larger magnitude gives the sign and a
// tie goes to b; zero operands bypass; exact cancellation gives zero.
__device__ __forceinline__ void lns_add(int sa, float ra, int sb, float rb, const Lut& lut,
                                        int& sc, float& rc) {
  const bool a_zero = ra <= kLogZero;
  const bool b_zero = rb <= kLogZero;
  const float big = fmaxf(ra, rb);
  const float d = fabsf(__fsub_rn(ra, rb));
  const bool same = sa == sb;
  const float corr = exp2_neg(d, lut);
  rc = same ? __fadd_rn(big, corr) : __fsub_rn(big, corr);
  sc = ra > rb ? sa : sb;
  if (a_zero) {
    rc = rb;
    sc = sb;
  }
  if (b_zero) {
    rc = a_zero ? kLogZero : ra;
    sc = a_zero ? 0 : sa;
  }
  if (!same && d == 0.0f && !a_zero && !b_zero) {
    rc = kLogZero;
    sc = 0;
  }
  rc = clamp_rail(rc);
}

// raw + q on the rail, saturated; a zero stays zero.
__device__ __forceinline__ float rail_rescale(float raw, float q) {
  return raw <= kLogZero ? kLogZero : clamp_rail(__fadd_rn(raw, q));
}

// Eq. (22): (sign, rail) -> bf16 bits, |x| = 2^I (1 + F).  Underflow
// (I <= -126, the reference's lowest binade included) flushes to zero,
// overflow saturates to the largest finite bf16.
__device__ __forceinline__ unsigned short lns_to_bf16(int sign, float raw) {
  const float ip = floorf(__fmul_rn(raw, 0.0078125f));
  const float fp = __fsub_rn(__fmul_rn(raw, 0.0078125f), ip);
  const bool is_zero = raw <= kLogZero;
  float mag;
  if (is_zero || ip + 127.0f <= 1.0f) {
    mag = 0.0f;
  } else if (ip + 127.0f >= 255.0f) {
    mag = 3.3895313892515355e38f;          // 2^127 (1 + 127/128)
  } else {
    mag = ldexpf(__fadd_rn(1.0f, fp), (int)ip);
  }
  return __bfloat16_as_ushort(__float2bfloat16_rn(sign == 1 ? -mag : mag));
}
