// What the bandwidth-bound decode kernels share: the v2 paged decode and
// verify (paged_attention_tc.cu) and the dense decode (dense_decode.cu).
//
//  * The ring: cp.async copies of 16-byte chunks of key rows into
//    shared memory (zero-filled where the source is past the walk's
//    end), and of 4-byte row scales, committed as groups and waited on,
//    and the widening of a 16-byte chunk of bf16, f32 or int8 values to
//    f32 - an int8 value times its row's scale, one rounded multiply
//    (the int8 page codec's decode), the others as they are.
//  * The split walk's merge.  A walk split across blocks into runs
//    writes one triplet per run and row to a workspace; each block then
//    counts itself in the (slot, head) counter with atomicInc, which
//    wraps at splits - 1, so the last block to finish sees splits - 1,
//    leaves the counter at 0 for the next launch (no reset to order) and
//    merges every run by Eq. 16 in run order: m = max m_s, then
//    l = fmaf(l_s, f_s, l) and o = fmaf(o_s, f_s, o) with
//    f_s = exp(min(m_s - m, 0)).  A run with no live key is the neutral
//    triplet (0, NEG_INF, 0) and merges to no NaN.  Launches that share
//    counters must run one at a time (one stream).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hfa_rail.cuh"

namespace {

__device__ __forceinline__ uint32_t dc_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared address dst; src_bytes 0 zero-fills.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
// 4 bytes (one row scale) from src to shared address dst; src_bytes 0
// zero-fills.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 4 f32 values from 16 bytes of shared memory.
__device__ __forceinline__ void widen8(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
// 16 bytes of a padded shared-memory row as f32: 8 bf16 or 4 f32 values.
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* o) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void widen16(const float* p, float* o) { widen8(p, o); }
// 16 bytes of a padded shared-memory row as f32, the row's scale applied
// to int8 values (16 of them) and ignored for bf16 and f32.
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float* o, float) { widen16(p, o); }
__device__ __forceinline__ void widen16(const float* p, float* o, float) { widen8(p, o); }
__device__ __forceinline__ void widen16(const int8_t* p, float* o, float s) {
  const int4 u = *reinterpret_cast<const int4*>(p);
  const int w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const char4 c = *reinterpret_cast<const char4*>(&w[i]);
    o[4 * i] = __fmul_rn((float)c.x, s);
    o[4 * i + 1] = __fmul_rn((float)c.y, s);
    o[4 * i + 2] = __fmul_rn((float)c.z, s);
    o[4 * i + 3] = __fmul_rn((float)c.w, s);
  }
}

__device__ __forceinline__ float dc_f32(float x) { return x; }
__device__ __forceinline__ float dc_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// Scores of one key for RPT rows: for each row four interleaved fmaf
// chains over D, then ((d0 + d1) + (d2 + d3)).  q0 is the first f32 row
// (rows q_stride apart), kr a padded key row of T; both in shared memory,
// 16-byte aligned; ksc the key row's scale (int8 rows only).  The key's
// chunk is read once for all RPT rows.
template <typename T, int D, int RPT>
__device__ __forceinline__ void dc_dots(const float* q0, int q_stride, const T* kr,
                                        float (&out)[RPT], float ksc = 1.f) {
  constexpr int VPE = 16 / (int)sizeof(T);   // key values per 16-byte load
  float d[RPT][4];
#pragma unroll
  for (int i = 0; i < RPT; ++i) d[i][0] = d[i][1] = d[i][2] = d[i][3] = 0.f;
#pragma unroll
  for (int c = 0; c < D; c += VPE) {
    float kf[VPE];
    widen16(kr + c, kf, ksc);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      float qf[VPE];
#pragma unroll
      for (int u = 0; u < VPE; u += 4) widen8(q0 + i * q_stride + c + u, qf + u);
#pragma unroll
      for (int u = 0; u < VPE; u += 4) {
        d[i][0] = fmaf(qf[u], kf[u], d[i][0]);
        d[i][1] = fmaf(qf[u + 1], kf[u + 1], d[i][1]);
        d[i][2] = fmaf(qf[u + 2], kf[u + 2], d[i][2]);
        d[i][3] = fmaf(qf[u + 3], kf[u + 3], d[i][3]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) out[i] = (d[i][0] + d[i][1]) + (d[i][2] + d[i][3]);
}

// Two adjacent values of a padded shared-memory row as f32.
__device__ __forceinline__ float2 dc_pair(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 dc_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
// The same with the row's scale: applied to int8 values, ignored else.
template <typename T>
__device__ __forceinline__ float2 dc_pair(const T* p, float) { return dc_pair(p); }
__device__ __forceinline__ float2 dc_pair(const int8_t* p, float s) {
  const char2 c = *reinterpret_cast<const char2*>(p);
  return make_float2(__fmul_rn((float)c.x, s), __fmul_rn((float)c.y, s));
}

// After a block wrote its runs' triplets: true (in every thread) in the
// last block of the (slot, head) to finish.  Every thread must call it.
__device__ __forceinline__ bool dc_last_run(unsigned* counter, int splits) {
  __shared__ int last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicInc(counter, (unsigned)splits - 1) == (unsigned)splits - 1;
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// Eq. 16 over the runs of one row: run s's triplet at w0 + s * stride
// (o~ in D floats, then m, l).  cols[c] is an output column this thread
// owns, or -1; o[c] gets that column's merged o~.
template <int NCOL>
__device__ __forceinline__ void dc_merge(const float* w0, size_t stride, int splits, int D,
                                         const int (&cols)[NCOL], float& m, float& l,
                                         float (&o)[NCOL]) {
  m = kNegInf;
  for (int s = 0; s < splits; ++s) m = fmaxf(m, __ldcg(w0 + s * stride + D));
  l = 0.f;
#pragma unroll
  for (int c = 0; c < NCOL; ++c) o[c] = 0.f;
  for (int s = 0; s < splits; ++s) {
    const float* w = w0 + s * stride;
    const float f = expf(fminf(__ldcg(w + D) - m, 0.f));
    l = fmaf(__ldcg(w + D + 1), f, l);
#pragma unroll
    for (int c = 0; c < NCOL; ++c)
      if (cols[c] >= 0) o[c] = fmaf(__ldcg(w + cols[c]), f, o[c]);
  }
}

}  // namespace
