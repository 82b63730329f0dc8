// The FIX16 log-number-system datapath as CUDA device functions.
//
// quant_scorediff, blinn_log2, exp2_neg, lns_add and lns_to_bf16 are
// bit-equal to the plain torch versions in repro_torch/core/lns.py (the
// reference's src/repro/core/lns.py in its default configuration).  Every
// rail value is an integer of 16 bits, so the rail runs in int32 here,
// where the reference holds the same integers in f32: every add, compare
// and select gives the same integer.  The one rounding step, the score
// difference times log2 e, is written with __fmul_rn and rounded half to
// even (__float2int_rn) as in hfa_rail.cuh.
//
// exp2_neg (Eq. 19, the Mitchell correction) is a table: the reference
// defines it as floor(g(f) 2^-p) with p = d >> 7, f = d & 127 and g an
// integer of at most 128 (the 8-segment PWL 2^-f on the fraction rail),
// so it depends on d alone and is 0 for every d >= 1024 (p >= 8).  The
// host builds the 1,024 values from the plain version
// (core/lns.py::exp2_neg_table) and passes them by value as a
// CorrTable; a kernel copies them to shared memory.
#pragma once

#include <cuda_bf16.h>

#include "hfa_rail.cuh"

constexpr int kLogZero = -32768;   // FIX16 minimum: log2(0)
constexpr int kFixMax = 32767;
constexpr int kCorrTab = 1024;     // exp2_neg(d) for d < 1024; 0 beyond

struct CorrTable {
  unsigned char v[kCorrTab];
};

__device__ __forceinline__ int clamp_rail(int raw) { return min(max(raw, kLogZero), kFixMax); }

// Eq. (14b/c): rail value of a non-positive natural-domain score
// difference (the reference keeps the -0 of a rounded tiny value; as an
// integer it is 0, which no rail step tells apart).
__device__ __forceinline__ int quant_scorediff(float x) {
  const float d = fminf(fmaxf(x, kClampNat), 0.0f);
  return __float2int_rn(__fmul_rn(__fmul_rn(d, kLog2e), 128.0f));
}

// Eq. (18): bf16 bit pattern -> (sign, rail log2 magnitude).  A non-zero
// magnitude gives a raw in [-16255, 16511], inside the rail.
__device__ __forceinline__ void blinn_log2(unsigned bits, int& sign, int& raw) {
  sign = (bits >> 15) & 1;
  const int mag = bits & 0x7FFF;
  raw = mag == 0 ? kLogZero : mag - (127 << 7);
}

// Eq. (19): 2^-d on the fraction rail, truncated, for a rail d >= 0.
__device__ __forceinline__ int exp2_neg(int d, const unsigned char* tab) {
  return tab[min(d, kCorrTab - 1)];
}

// raw + q on the rail for q <= 0: the reference's clamp(raw + q), with a
// zero (LOG_ZERO) kept zero, is max(raw + q, LOG_ZERO) for every rail raw.
__device__ __forceinline__ int rail_rescale(int raw, int q) { return max(raw + q, kLogZero); }

// Eq. (10) + (17): signed LNS addition c = a + b with Mitchell's
// log2(1 +- 2^-D) ~= +-2^-D; the larger magnitude gives the sign and a
// tie goes to b; zero operands bypass; exact cancellation gives zero.
__device__ __forceinline__ void lns_add(int sa, int ra, int sb, int rb, const unsigned char* tab,
                                        int& sc, int& rc) {
  const bool a_zero = ra <= kLogZero;
  const bool b_zero = rb <= kLogZero;
  const int big = max(ra, rb);
  const int d = abs(ra - rb);
  const bool same = sa == sb;
  const int corr = exp2_neg(d, tab);
  int r = same ? big + corr : big - corr;
  int s = ra > rb ? sa : sb;
  if (a_zero) {
    r = rb;
    s = sb;
  }
  if (b_zero) {
    r = a_zero ? kLogZero : ra;
    s = a_zero ? 0 : sa;
  }
  if (!same && d == 0 && !a_zero && !b_zero) {
    r = kLogZero;
    s = 0;
  }
  rc = clamp_rail(r);
  sc = s;
}

// Eq. (22): (sign, rail) -> bf16 bits, |x| = 2^I (1 + F).  Underflow
// (I <= -126, the reference's lowest binade included) flushes to zero,
// overflow saturates to the largest finite bf16.
__device__ __forceinline__ unsigned short lns_to_bf16(int sign, int raw_i) {
  const float raw = (float)raw_i;
  const float ip = floorf(__fmul_rn(raw, 0.0078125f));
  const float fp = __fsub_rn(__fmul_rn(raw, 0.0078125f), ip);
  const bool is_zero = raw_i <= kLogZero;
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
