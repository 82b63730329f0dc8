// The H-FA rail as CUDA device functions, shared by every kernel source.
//
// quant_rail, exp2_hfa_rail and recip_logdiv are bit-equal to the plain
// torch versions in repro_torch/kernels/bitmath.py (the reference's
// src/repro/kernels/bitmath.py): every step is exact or a single correctly
// rounded f32 operation, written with __fmul_rn/__fadd_rn so nvcc cannot
// contract them into FMAs, and rounding is half-to-even (rintf), as
// jnp.round and torch.round are.  The 8-segment PWL table reaches the
// kernels as a Lut launch argument (kernels/cuda_lib.py fills it from
// core/lns.py).
#pragma once

#include <cuda_runtime.h>
#include <string.h>

constexpr float kNegInf = -1e30f;                 // finite, as the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;     // f32, as the reference rounds it
constexpr float kClampNat = -15.0f;

struct Lut {        // 8-segment PWL 2^-f, Q1.15 slopes then intercepts
  float a[8];
  float b[8];
};

__device__ __forceinline__ float lut8(float seg, const float* t) {
  float out = t[0];
#pragma unroll
  for (int i = 1; i < 8; ++i) out = (seg >= (float)i) ? t[i] : out;
  return out;
}

__device__ __forceinline__ float exp2_int(float p) {
  int pi = (int)p;
  pi = min(max(pi, -126), 127);
  return __int_as_float((pi + 127) << 23);
}

// quant[(.)*log2 e] to the FIX16 rail (Eq. 14b/c); +0.0 folds -0 into +0.
__device__ __forceinline__ float quant_rail(float x) {
  const float d = fminf(fmaxf(x, kClampNat), 0.0f);
  return __fadd_rn(rintf(__fmul_rn(__fmul_rn(d, kLog2e), 128.0f)), 0.0f);
}

// 2^(rail/128) for a non-positive rail value: PWL 2^-f, exponent packing.
__device__ __forceinline__ float exp2_hfa_rail(float rail, const Lut& lut) {
  const float d = -rail;
  const float p = floorf(__fmul_rn(d, 0.0078125f));
  const float f7 = __fsub_rn(d, __fmul_rn(p, 128.0f));
  const float seg = fminf(fmaxf(floorf(__fmul_rn(f7, 0.0625f)), 0.0f), 7.0f);
  const float a = lut8(seg, lut.a);
  const float b = lut8(seg, lut.b);
  const float g_q15 = __fadd_rn(floorf(__fmul_rn(__fmul_rn(a, f7), 0.0078125f)), b);
  const float g7 = floorf(__fmul_rn(__fadd_rn(g_q15, 128.0f), 0.00390625f));
  return __fmul_rn(__fmul_rn(g7, 0.0078125f), exp2_int(-p));
}

// LogDiv: 1/x by Blinn log2 on the f32 bits, rail negate, bit-pack.
__device__ __forceinline__ float recip_logdiv(float x) {
  const int mag = __float_as_int(x) & 0x7FFFFFFF;
  const float lg = __fmul_rn(__int2float_rn(mag - (127 << 23)), 1.1920928955078125e-07f);
  const float rail = rintf(__fmul_rn(lg, 128.0f));
  const float neg = -rail;
  const float ip = floorf(__fmul_rn(neg, 0.0078125f));
  const float fp = __fsub_rn(__fmul_rn(neg, 0.0078125f), ip);
  return __fmul_rn(exp2_int(ip), __fadd_rn(1.0f, fp));
}

// The same rail in integer arithmetic, for the inner loop of the
// tensor-core forward (dense_attention_tc.cu).  quant_rail_int(x) equals
// quant_rail(x) as an int, and for every rail value r in [-2770, 0] (all
// that quant_rail returns) exp2_hfa_rail_tab(r, tab) equals
// exp2_hfa_rail(r, lut).  The PWL output g7 depends on the 7 fraction
// bits f7 alone, so tab holds it for all 128 of them, as bytes
// 2 (g7 - 64) in [0, 128], four to a word (pwl_table_word): one load per
// value, from 32 words that sit in 32 banks of shared memory, so no
// index pattern conflicts.  The result is packed from the bits:
// g7/128 2^-p has exponent field 126 - p and mantissa (g7 - 64) 2^17
// (g7 = 128 carries into the exponent: 2^-p).  Every step is exact:
// rounding to an integer by adding 1.5 * 2^23 (|y| < 2^22), the PWL's
// floors as arithmetic shifts of exact integer products.
__device__ __forceinline__ int quant_rail_int(float x) {
  const float d = fminf(fmaxf(x, kClampNat), 0.0f);
  const float y = __fmul_rn(__fmul_rn(d, kLog2e), 128.0f);
  return __float_as_int(__fadd_rn(y, 12582912.0f)) - 0x4B400000;
}

// Word j of the table: g7 for f7 = 4 j .. 4 j + 3, from the Lut.
__device__ __forceinline__ unsigned pwl_table_word(int j, const Lut& lut) {
  unsigned w = 0;
  for (int u = 0; u < 4; ++u) {
    const int f7 = 4 * j + u;
    const float seg = (float)(f7 >> 4);
    const int a = (int)lut8(seg, lut.a), b = (int)lut8(seg, lut.b);
    const int g7 = ((((a * f7) >> 7) + b) + 128) >> 8;   // [64, 128]
    w |= (unsigned)(2 * (g7 - 64)) << (8 * u);
  }
  return w;
}

__device__ __forceinline__ float exp2_hfa_rail_tab(int rail, const unsigned* tab) {
  const int d = -rail;                  // [0, 2770]: p = d >> 7, f7 = d & 127
  const unsigned m = __byte_perm(tab[(d & 127) >> 2], 0, 0x4044 | ((d & 3) << 8));
  return __int_as_float(((126 - (d >> 7)) << 23) + (int)m);
}

namespace {  // one copy per source, so each source's rail can be checked

__global__ void rail_eval_kernel(const float* x, float* rail, float* pexp, float* recip,
                                 int n, const Lut lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float r = quant_rail(x[i]);
  rail[i] = r;
  pexp[i] = exp2_hfa_rail(r, lut);
  recip[i] = recip_logdiv(x[i]);
}

// Launch rail_eval_kernel over n values; returns cudaGetLastError().
inline int rail_eval(const void* x, void* rail, void* pexp, void* recip, int n,
                     const void* lut_host, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  rail_eval_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(rail), static_cast<float*>(pexp),
      static_cast<float*>(recip), n, lut);
  return (int)cudaGetLastError();
}

}  // namespace
