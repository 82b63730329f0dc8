// Dense flash-decode for Hopper (sm_90a): the G query heads that share one
// KV head against a contiguous KV cache, on the fa2 or the H-FA rail.
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/decode.py  _decode_kernel -> dense_decode_fwd
// For each (sequence, KV head) it streams 128-key tiles (the reference's
// block_kv) with the Alg. 2 online update and returns the unnormalized
// triplet: o~ (G, D) f32, m and l (G) f32.  Keys at or past kv_len are
// masked: their scores are NEG_INF and their p is 0, as in the reference.
//
// Design.  The TPU kernel walks the tiles along a sequential grid axis
// with its accumulators in VMEM, over a (BHkv, S, D) copy of the cache
// padded to 128.  Here one block of 128 threads owns one (sequence, KV
// head) and loops over the tiles, reading the serving ring (B, S, Hkv, D)
// in place through its strides: no copy, no padding; the loop stops at
// the last tile that holds a key below kv_len, which is exact (a fully
// masked tile leaves m unchanged, so alpha is 1 and p is 0 on both rails).
// Per tile: each warp forms the scores of 32 keys (lanes split the D
// products, a shuffle sum per query head) into shared memory; the tile's
// row maxima are warp reductions; thread j turns key j's scores into p
// (exp, or the FIX16 rail of hfa_rail.cuh: quant_rail then exp2_hfa_rail,
// scores not rounded to bf16); thread c accumulates output column c over
// the tile's keys (V rows read coalesced), and l = l * alpha + sum(p).
// D is 32, 64, 96 or 128: at D 32 four threads share a column (each a
// quarter of the keys, summed in order at the end), at D 64 two, and at
// D 96 threads 96 .. 127 own no column.
//
// What bounds it: bytes.  One query token per head does 2 flops per K/V
// byte, far below the card's ridge, so the least time is the live K/V
// rows over the memory rate: 18.9 MB, 5.6 us, at the dense-serve decode
// (B 8, Hkv 8, G 2, kv_len 576, D 128, bf16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "hfa_rail.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 128;   // keys per tile: the reference's block_kv
constexpr int kMaxG = 8;     // query heads per KV head

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct DecodeParams {
  const void* q;   // (N0, N1, G, D) contiguous
  const void* k;   // element (n0, n1, s, c) at n0 * s0 + n1 * s1 + s * ss + c
  const void* v;   // same strides as k
  float* o;        // (N0, N1, G, D)
  float* m;        // (N0, N1, G)
  float* l;        // (N0, N1, G)
  long long s0, s1, ss;
  int N1, G, S, kv_len;
  float scale;
};

template <typename T, int D, bool HFA>
__global__ void __launch_bounds__(kThreads) dense_decode_kernel(const DecodeParams p,
                                                                const Lut lut) {
  constexpr int EPL = D / 32;           // row elements per lane (scores)
  constexpr int NSPLIT = kThreads / D;  // threads per output column: 4, 2, 1, 1
  __shared__ float ps[kMaxG][kTile];    // scores, then p
  __shared__ float red[kMaxG];          // tile max, then tile sum of p
  // o~ of key parts 1 .. NSPLIT - 1 of each column (NSPLIT > 1)
  __shared__ float part[NSPLIT > 1 ? NSPLIT - 1 : 1][kMaxG][D];
  const int n0 = blockIdx.y, n1 = blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int G = p.G;
  const size_t row = (size_t)n0 * p.N1 + n1;
  const T* qg = static_cast<const T*>(p.q) + row * G * D;
  const T* kg = static_cast<const T*>(p.k) + n0 * p.s0 + n1 * p.s1;
  const T* vg = static_cast<const T*>(p.v) + n0 * p.s0 + n1 * p.s1;

  float qr[kMaxG][EPL];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g)
#pragma unroll
    for (int e = 0; e < EPL; ++e) qr[g][e] = g < G ? to_f32(qg[g * D + lane + 32 * e]) : 0.f;

  float m[kMaxG], l[kMaxG], acc[kMaxG];
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  // Thread t owns column col for keys half, half + NSPLIT, ...; at D 96
  // threads 96 .. 127 own none.
  const int col = t % D, half = t / D;
  const bool owner = half < NSPLIT;
  const int limit = min(p.kv_len, p.S);

  for (int t0 = 0; t0 < limit; t0 += kTile) {
    const int n = min(kTile, limit - t0);  // keys of this tile below kv_len
    __syncthreads();  // the previous tile's p and sums are consumed
    for (int j = warp; j < kTile; j += kWarps) {
      float dot[kMaxG];
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) dot[g] = 0.f;
      if (j < n) {
        const T* kr = kg + (t0 + j) * p.ss;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const float kv = to_f32(kr[lane + 32 * e]);
#pragma unroll
          for (int g = 0; g < kMaxG; ++g) dot[g] = fmaf(qr[g][e], kv, dot[g]);
        }
      }
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) {
        if (g >= G) break;
        float x = dot[g];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if (lane == 0) ps[g][j] = j < n ? __fmul_rn(x, p.scale) : kNegInf;
      }
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // tile row max
      float x = kNegInf;
      for (int j = lane; j < kTile; j += 32) x = fmaxf(x, ps[g][j]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
      if (lane == 0) red[g] = x;
    }
    __syncthreads();
    float m_new[kMaxG], alpha[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      m_new[g] = fmaxf(m[g], g < G ? red[g] : kNegInf);
      const float dm = fminf(__fsub_rn(m[g], m_new[g]), 0.f);
      alpha[g] = HFA ? exp2_hfa_rail(quant_rail(dm), lut) : expf(dm);
    }
    // Thread t turns key t's scores into p (kThreads == kTile).
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g >= G) break;
      const float x = __fsub_rn(ps[g][t], m_new[g]);
      const float pv = HFA ? exp2_hfa_rail(quant_rail(x), lut) : expf(x);
      ps[g][t] = (t < n && m_new[g] != kNegInf) ? pv : 0.f;
    }
    __syncthreads();
    for (int g = warp; g < G; g += kWarps) {  // tile sum of p
      float x = 0.f;
      for (int j = lane; j < kTile; j += 32) x += ps[g][j];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
      if (lane == 0) red[g] = x;
    }
    // o~ column col over this thread's keys of the tile.
    float pv_acc[kMaxG];
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) pv_acc[g] = 0.f;
    for (int j = half; owner && j < n; j += NSPLIT) {
      const float vv = to_f32(vg[(t0 + j) * p.ss + col]);
#pragma unroll
      for (int g = 0; g < kMaxG; ++g) pv_acc[g] = fmaf(g < G ? ps[g][j] : 0.f, vv, pv_acc[g]);
    }
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) acc[g] = __fadd_rn(__fmul_rn(acc[g], alpha[g]), pv_acc[g]);
    __syncthreads();
#pragma unroll
    for (int g = 0; g < kMaxG; ++g) {
      if (g < G) l[g] = __fadd_rn(__fmul_rn(l[g], alpha[g]), red[g]);
      m[g] = m_new[g];
    }
  }

  if (NSPLIT > 1) {  // D 32 / 64: the key parts of each column meet, in order
    __syncthreads();
    if (half >= 1)
#pragma unroll
      for (int g = 0; g < kMaxG; ++g)
        if (g < G) part[half - 1][g][col] = acc[g];
    __syncthreads();
    if (half == 0)
#pragma unroll
      for (int i = 0; i < NSPLIT - 1; ++i)
#pragma unroll
        for (int g = 0; g < kMaxG; ++g)
          if (g < G) acc[g] += part[i][g][col];
  }
  if (half != 0) return;
#pragma unroll
  for (int g = 0; g < kMaxG; ++g) {
    if (g >= G) break;
    p.o[(row * G + g) * D + col] = acc[g];
    if (t == 0) {
      p.m[row * G + g] = m[g];
      p.l[row * G + g] = l[g];
    }
  }
}

template <typename T, int D>
int launch(const DecodeParams& p, const Lut& lut, int N0, int use_hfa, cudaStream_t s) {
  const dim3 grid(p.N1, N0);
  if (use_hfa) dense_decode_kernel<T, D, true><<<grid, kThreads, 0, s>>>(p, lut);
  else dense_decode_kernel<T, D, false><<<grid, kThreads, 0, s>>>(p, lut);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const DecodeParams& p, const Lut& lut, int N0, int D, int use_hfa, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, lut, N0, use_hfa, s);
    case 64: return launch<T, 64>(p, lut, N0, use_hfa, s);
    case 96: return launch<T, 96>(p, lut, N0, use_hfa, s);
    default: return launch<T, 128>(p, lut, N0, use_hfa, s);
  }
}

}  // namespace

// q (N0, N1, G, D) contiguous; k and v share the element strides s0, s1
// (leading dims) and ss (keys), with the D values of a key contiguous;
// bf16 (bf16 = 1) or f32.  o (N0, N1, G, D), m and l (N0, N1, G) f32.
// Returns the first CUDA error of the launch (0 = ok).
extern "C" int dense_decode_fwd(const void* q, const void* k, const void* v, void* o, void* m,
                                void* l, int N0, int N1, int G, int S, int D, long long s0,
                                long long s1, long long ss, int kv_len, float scale,
                                int use_hfa, int bf16, const void* lut_host, void* stream) {
  if (N0 <= 0 || N0 > 65535 || N1 <= 0 || G <= 0 || G > kMaxG || S <= 0 ||
      (D != 32 && D != 64 && D != 96 && D != 128))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.s0 = s0; p.s1 = s1; p.ss = ss;
  p.N1 = N1; p.G = G; p.S = S; p.kv_len = kv_len;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(p, lut, N0, D, use_hfa, s)
              : launch_d<float>(p, lut, N0, D, use_hfa, s);
}

// The rail device functions as compiled in this source (hfa_rail.cuh).
extern "C" int decode_rail_eval(const void* x, void* rail, void* pexp, void* recip, int n,
                                const void* lut_host, void* stream) {
  return rail_eval(x, rail, pexp, recip, n, lut_host, stream);
}
