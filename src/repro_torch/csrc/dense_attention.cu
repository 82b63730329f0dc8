// Dense attention for Hopper (sm_90a) on the CUDA cores: the FA-2
// forward for f32 inputs, its dq and dk/dv backward for an f32 output
// cotangent, and the H-FA forward for f32 inputs, over (BH, L, D) slabs.
// On bf16 - every full-width path - the forward is dense_attention_tc.cu's
// tensor-core kernel and the backward (bf16 inputs and cotangent)
// dense_attention_bwd_tc.cu's; these kernels serve the reduced f32 model
// and bf16 inputs with an f32 cotangent.
//
// Replaces four Pallas TPU kernels of the reference package:
//   src/repro/kernels/fa2.py      _fa2_kernel   -> dense_attn_fwd (fa2 rail, f32)
//   src/repro/kernels/fa2_bwd.py  _dq_kernel    -> dense_attn_dq (f32 cotangent)
//   src/repro/kernels/fa2_bwd.py  _dkv_kernel   -> dense_attn_dkv (f32 cotangent)
//   src/repro/kernels/hfa.py      _hfa_kernel   -> dense_attn_fwd (H-FA rail, f32)
// Masks, as in the reference: key j is visible to query row i when
// j < kv_len (the padding ops.py adds) and, if causal, j <= i + q_offset.
//
// Design.  The TPU kernels carry their accumulators in VMEM across a
// sequential grid axis; Hopper blocks run in no order, so that axis
// becomes a loop inside one block, and no sum crosses blocks (no atomics,
// results are deterministic).  One block of 256 threads owns 64 query
// rows (forward, dq) or 64 key rows (dk/dv) of one (batch, head) and
// loops over tiles of the other side staged in shared memory as f32.
// Every product is an f32 FMA on the CUDA cores, as the Pallas kernels
// compute in f32; thread (ty, tx) owns output rows ty + 16 i (i < 4) and
// columns tx + 16 j, so a row's 16 owners are one half-warp and row max
// / sum are half-warp shuffles.
//
// Forward: 128-key tiles (the reference's block_kv).  The H-FA rail must
// take each row max over exactly the reference's tiles before it
// quantizes p, because a key's weight is a product of quantized
// exponentials; tiles past kv_len or above the diagonal are skipped,
// which is exact because a fully masked tile leaves m unchanged, so
// alpha is exactly 1 on both rails and p is 0.  Scores are rounded to
// bf16 after the scale on the H-FA rail (__float2bfloat16_rn); fully
// masked rows give O = 0 and LSE = NEG_INF + ln 1 (fa2), recip = 0 (hfa).
// Backward: 64-row tiles; p = exp(s - LSE) is recomputed, masked p is 0
// before ds is formed, delta = rowsum(dO * O) comes from the caller.
//
// What bounds these kernels: arithmetic.  At the training shape (BH 64,
// L 2048, D 128, causal) the forward does 4 BH L^2 D / 2 = 6.9e10 flops
// on 100 MB of inputs, far right of the card's ridge.  They run on the
// CUDA cores in f32 (about 67 TFLOP/s peak, not the tensor cores' 989 in
// bf16) with plain loads, as the f32 numerics they serve ask.  The
// running sum l = l alpha + sum p is rounded twice (__fmul_rn,
// __fadd_rn), as the plain version and the tensor-core kernel round it:
// on the H-FA rail an FMA's last-bit difference in l can cross a LogDiv
// rounding boundary and move a row by a rail step.  D is 32, 64, 96 or
// 128 (a thread owns D / 16 output columns of a row).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include <type_traits>

#include "hfa_rail.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // query rows (fwd, dq) or key rows (dk/dv) per block
constexpr int kFwdTile = 128;  // keys per forward tile: the reference's block_kv
constexpr int kBwdTile = 64;   // rows per backward tile

struct DenseParams {
  const void* q;       // (BH, Lq, D) in T
  const void* k;       // (BH, Lkv, D) in T
  const void* v;       // (BH, Lkv, D) in T
  const float* dout;   // (BH, Lq, D) f32, backward
  const float* lse;    // (BH, Lq), backward
  const float* delta;  // (BH, Lq), backward
  float* o;            // (BH, Lq, D), forward
  float* lse_out;      // (BH, Lq), forward (fa2 rail)
  void* dq;            // (BH, Lq, D) in T
  void* dk;            // (BH, Lkv, D) in T
  void* dv;            // (BH, Lkv, D) in T
  int Lq, Lkv, kv_len, q_offset, causal;
  float scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// Rows [r0, r0 + n) of an (L, D) slab into shared memory as f32 with row
// stride D + 1 (odd, so 16 consecutive rows read at one column hit 16
// banks); rows past L are zero.
template <int D, typename T>
__device__ __forceinline__ void stage(float* dst, const T* src, int r0, int n, int L) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx % D;
    const int row = r0 + r;
    dst[r * (D + 1) + c] = row < L ? to_f32(src[(size_t)row * D + c]) : 0.f;
  }
}

// acc[i][j] += sum_k A(ty + 16 i, k) * B(k, tx + 16 j) over shared memory:
// A(r, k) = a[AT ? k * LDA + r : r * LDA + k], B(k, c) = b[BT ? c * LDB + k : k * LDB + c].
template <int NC, int K, int LDA, int LDB, bool AT, bool BT>
__device__ __forceinline__ void mma_tile(float (&acc)[4][NC], const float* a, const float* b,
                                         int ty, int tx) {
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[NC];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = AT ? a[k * LDA + ty + 16 * i] : a[(ty + 16 * i) * LDA + k];
#pragma unroll
    for (int j = 0; j < NC; ++j) bv[j] = BT ? b[(tx + 16 * j) * LDB + k] : b[k * LDB + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

template <int NC>
__device__ __forceinline__ void zero(float (&acc)[4][NC]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
}

// Reductions over the 16 lanes of a half-warp (the owners of one row).
__device__ __forceinline__ float half_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float half_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ bool visible(const DenseParams& p, int kv, int qpos) {
  return kv < p.kv_len && kv < p.Lkv && (!p.causal || kv <= qpos);
}

// Keys a block of query rows [q0, q0 + kRows) can see: [0, end).
__device__ __forceinline__ int kv_end(const DenseParams& p, int q0) {
  int end = min(p.kv_len, p.Lkv);
  if (p.causal) end = min(end, q0 + kRows + p.q_offset);
  return end;
}

template <int D>
constexpr int fwd_smem_floats() { return (kRows + kFwdTile) * (D + 1) + kRows * (kFwdTile + 1); }
template <int D>
constexpr int dq_smem_floats() { return 4 * kRows * (D + 1) + kRows * (kBwdTile + 1); }
template <int D>
constexpr int dkv_smem_floats() {
  return 4 * kRows * (D + 1) + 2 * kBwdTile * (kRows + 1) + 2 * kBwdTile;
}

// ----------------------------------------------------------------- forward
template <typename T, int D, bool HFA>
__global__ void __launch_bounds__(kThreads) dense_fwd_kernel(const DenseParams p, const Lut lut) {
  constexpr int LD = D + 1, LP = kFwdTile + 1;
  constexpr int NS = kFwdTile / 16, NO = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                   // kRows x LD
  float* kv_s = q_s + kRows * LD;      // kFwdTile x LD: K, then V, of one tile
  float* p_s = kv_s + kFwdTile * LD;   // kRows x LP
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;  // longest causal rows first
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kg = static_cast<const T*>(p.k) + (size_t)bh * p.Lkv * D;
  const T* vg = static_cast<const T*>(p.v) + (size_t)bh * p.Lkv * D;
  stage<D>(q_s, static_cast<const T*>(p.q) + (size_t)bh * p.Lq * D, q0, kRows, p.Lq);

  float m[4], l[4], o[4][NO];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
    qpos[i] = q0 + ty + 16 * i + p.q_offset;
  }
  zero(o);

  const int end = kv_end(p, q0);
  for (int t0 = 0; t0 < end; t0 += kFwdTile) {
    __syncthreads();  // the previous tile's V and P are consumed (and q_s is written)
    stage<D>(kv_s, kg, t0, kFwdTile, p.Lkv);
    __syncthreads();
    float s[4][NS];
    zero(s);
    mma_tile<NS, D, LD, LD, false, true>(s, q_s, kv_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float x = __fmul_rn(s[i][j], p.scale);
        if (HFA) x = __bfloat162float(__float2bfloat16_rn(x));  // BF16 score datapath
        s[i][j] = visible(p, t0 + tx + 16 * j, qpos[i]) ? x : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_max(mx));
      const float alpha = HFA ? exp2_hfa_rail(quant_rail(fminf(m[i] - m_new, 0.f)), lut)
                              : expf(fminf(m[i] - m_new, 0.f));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        float pv = HFA ? exp2_hfa_rail(quant_rail(s[i][j] - m_new), lut) : expf(s[i][j] - m_new);
        pv = (visible(p, t0 + tx + 16 * j, qpos[i]) && m_new != kNegInf) ? pv : 0.f;
        ps += pv;
        p_s[(ty + 16 * i) * LP + tx + 16 * j] = pv;
      }
      l[i] = __fadd_rn(__fmul_rn(l[i], alpha), half_sum(ps));   // two roundings, no FMA
#pragma unroll
      for (int c = 0; c < NO; ++c) o[i][c] *= alpha;
      m[i] = m_new;
    }
    __syncthreads();  // K is consumed, P is written
    stage<D>(kv_s, vg, t0, kFwdTile, p.Lkv);
    __syncthreads();
    mma_tile<NO, kFwdTile, LP, LD, false, false>(o, p_s, kv_s, ty, tx);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Lq) continue;
    const size_t r = (size_t)bh * p.Lq + row;
    if (HFA) {  // LogDiv finalize; nothing visible -> 0
      const float recip = l[i] <= 0.f ? 0.f : recip_logdiv(l[i]);
#pragma unroll
      for (int c = 0; c < NO; ++c) p.o[r * D + tx + 16 * c] = o[i][c] * recip;
    } else {    // float divide; LSE = m + ln l is the backward's residual
      const float safe = l[i] == 0.f ? 1.f : l[i];
#pragma unroll
      for (int c = 0; c < NO; ++c) p.o[r * D + tx + 16 * c] = o[i][c] / safe;
      if (tx == 0) p.lse_out[r] = m[i] + logf(safe);
    }
  }
}

// ---------------------------------------------------------------------- dq
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dense_dq_kernel(const DenseParams p) {
  constexpr int LD = D + 1, LS = kBwdTile + 1;
  constexpr int NS = kBwdTile / 16, NO = D / 16;
  extern __shared__ float smem[];
  float* q_s = smem;                 // kRows x LD
  float* do_s = q_s + kRows * LD;    // kRows x LD
  float* k_s = do_s + kRows * LD;    // kBwdTile x LD
  float* v_s = k_s + kBwdTile * LD;  // kBwdTile x LD
  float* ds_s = v_s + kBwdTile * LD; // kRows x LS
  const int bh = blockIdx.y;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* kg = static_cast<const T*>(p.k) + (size_t)bh * p.Lkv * D;
  const T* vg = static_cast<const T*>(p.v) + (size_t)bh * p.Lkv * D;
  stage<D>(q_s, static_cast<const T*>(p.q) + (size_t)bh * p.Lq * D, q0, kRows, p.Lq);
  stage<D>(do_s, p.dout + (size_t)bh * p.Lq * D, q0, kRows, p.Lq);

  float lse[4], delta[4], dq[4][NO];
  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool ok = row < p.Lq;
    lse[i] = ok ? p.lse[(size_t)bh * p.Lq + row] : 0.f;
    delta[i] = ok ? p.delta[(size_t)bh * p.Lq + row] : 0.f;
    qpos[i] = row + p.q_offset;
  }
  zero(dq);

  const int end = kv_end(p, q0);
  for (int t0 = 0; t0 < end; t0 += kBwdTile) {
    __syncthreads();
    stage<D>(k_s, kg, t0, kBwdTile, p.Lkv);
    stage<D>(v_s, vg, t0, kBwdTile, p.Lkv);
    __syncthreads();
    float s[4][NS], dp[4][NS];
    zero(s);
    zero(dp);
    mma_tile<NS, D, LD, LD, false, true>(s, q_s, k_s, ty, tx);
    mma_tile<NS, D, LD, LD, false, true>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const float pv = visible(p, t0 + tx + 16 * j, qpos[i])
                             ? expf(__fmul_rn(s[i][j], p.scale) - lse[i]) : 0.f;
        ds_s[(ty + 16 * i) * LS + tx + 16 * j] = pv * (dp[i][j] - delta[i]);
      }
    __syncthreads();
    mma_tile<NO, kBwdTile, LS, LD, false, false>(dq, ds_s, k_s, ty, tx);
  }

  T* dqg = static_cast<T*>(p.dq) + (size_t)bh * p.Lq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= p.Lq) continue;
#pragma unroll
    for (int c = 0; c < NO; ++c) store(dqg + (size_t)row * D + tx + 16 * c, dq[i][c] * p.scale);
  }
}

// -------------------------------------------------------------------- dk/dv
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dense_dkv_kernel(const DenseParams p) {
  constexpr int LD = D + 1, LS = kRows + 1;
  constexpr int NS = kRows / 16, NO = D / 16;
  extern __shared__ float smem[];
  float* k_s = smem;                     // kRows x LD
  float* v_s = k_s + kRows * LD;         // kRows x LD
  float* q_s = v_s + kRows * LD;         // kBwdTile x LD
  float* do_s = q_s + kBwdTile * LD;     // kBwdTile x LD
  float* p_s = do_s + kBwdTile * LD;     // kBwdTile x LS: p[q][kv]
  float* ds_s = p_s + kBwdTile * LS;     // kBwdTile x LS: ds[q][kv]
  float* lse_s = ds_s + kBwdTile * LS;   // kBwdTile
  float* delta_s = lse_s + kBwdTile;     // kBwdTile
  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kRows;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const T* qg = static_cast<const T*>(p.q) + (size_t)bh * p.Lq * D;
  const float* dog = p.dout + (size_t)bh * p.Lq * D;
  stage<D>(k_s, static_cast<const T*>(p.k) + (size_t)bh * p.Lkv * D, k0, kRows, p.Lkv);
  stage<D>(v_s, static_cast<const T*>(p.v) + (size_t)bh * p.Lkv * D, k0, kRows, p.Lkv);

  float dk[4][NO], dv[4][NO];
  zero(dk);
  zero(dv);
  // Causal: query row r sees this block's keys only if r + q_offset >= k0.
  int q_begin = 0;
  if (p.causal) q_begin = max(0, k0 - p.q_offset) / kBwdTile * kBwdTile;
  const int q_end = k0 < min(p.kv_len, p.Lkv) ? p.Lq : 0;
  for (int q0 = q_begin; q0 < q_end; q0 += kBwdTile) {
    __syncthreads();
    stage<D>(q_s, qg, q0, kBwdTile, p.Lq);
    stage<D>(do_s, dog, q0, kBwdTile, p.Lq);
    if (threadIdx.x < kBwdTile) {
      const int row = q0 + threadIdx.x;
      const bool ok = row < p.Lq;
      lse_s[threadIdx.x] = ok ? p.lse[(size_t)bh * p.Lq + row] : 0.f;
      delta_s[threadIdx.x] = ok ? p.delta[(size_t)bh * p.Lq + row] : 0.f;
    }
    __syncthreads();
    // Score tile: rows = queries ty + 16 i, columns = keys tx + 16 j.
    float s[4][NS], dp[4][NS];
    zero(s);
    zero(dp);
    mma_tile<NS, D, LD, LD, false, true>(s, q_s, k_s, ty, tx);
    mma_tile<NS, D, LD, LD, false, true>(dp, do_s, v_s, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty + 16 * i;
      const int row = q0 + qr;
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        const bool vis = row < p.Lq && visible(p, k0 + tx + 16 * j, row + p.q_offset);
        const float pv = vis ? expf(__fmul_rn(s[i][j], p.scale) - lse_s[qr]) : 0.f;
        p_s[qr * LS + tx + 16 * j] = pv;
        ds_s[qr * LS + tx + 16 * j] = pv * (dp[i][j] - delta_s[qr]);
      }
    }
    __syncthreads();
    mma_tile<NO, kBwdTile, LS, LD, true, false>(dv, p_s, do_s, ty, tx);   // p^T do
    mma_tile<NO, kBwdTile, LS, LD, true, false>(dk, ds_s, q_s, ty, tx);   // ds^T q
  }

  T* dkg = static_cast<T*>(p.dk) + (size_t)bh * p.Lkv * D;
  T* dvg = static_cast<T*>(p.dv) + (size_t)bh * p.Lkv * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= p.Lkv) continue;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      store(dkg + (size_t)row * D + tx + 16 * c, dk[i][c] * p.scale);
      store(dvg + (size_t)row * D + tx + 16 * c, dv[i][c]);
    }
  }
}

// ------------------------------------------------------------------ launch
template <typename K, typename... Args>
int launch_with_smem(K kernel, dim3 grid, int smem_floats, cudaStream_t s, Args... args) {
  const int bytes = smem_floats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

bool bad_shape(int BH, int Lq, int Lkv, int D) {
  return BH <= 0 || BH > 65535 || Lq <= 0 || Lkv <= 0 ||
         (D != 32 && D != 64 && D != 96 && D != 128);
}

// Run f.template operator()<D>() for the runtime head dim D (32, 64, 96, 128).
template <typename F>
int by_head_dim(int D, F&& f) {
  switch (D) {
    case 32: return f(std::integral_constant<int, 32>());
    case 64: return f(std::integral_constant<int, 64>());
    case 96: return f(std::integral_constant<int, 96>());
    default: return f(std::integral_constant<int, 128>());
  }
}

template <typename T, int D>
int fwd_t(const DenseParams& p, const Lut& lut, int BH, int use_hfa, cudaStream_t s) {
  const dim3 grid((p.Lq + kRows - 1) / kRows, BH);
  if (use_hfa) return launch_with_smem(dense_fwd_kernel<T, D, true>, grid, fwd_smem_floats<D>(), s, p, lut);
  return launch_with_smem(dense_fwd_kernel<T, D, false>, grid, fwd_smem_floats<D>(), s, p, lut);
}

template <typename T, int D>
int dq_t(const DenseParams& p, int BH, cudaStream_t s) {
  const dim3 grid((p.Lq + kRows - 1) / kRows, BH);
  return launch_with_smem(dense_dq_kernel<T, D>, grid, dq_smem_floats<D>(), s, p);
}

template <typename T, int D>
int dkv_t(const DenseParams& p, int BH, cudaStream_t s) {
  const dim3 grid((p.Lkv + kRows - 1) / kRows, BH);
  return launch_with_smem(dense_dkv_kernel<T, D>, grid, dkv_smem_floats<D>(), s, p);
}

DenseParams make_params(const void* q, const void* k, const void* v, int Lq, int Lkv,
                        int kv_len, int q_offset, int causal, float scale) {
  DenseParams p;
  memset(&p, 0, sizeof(p));
  p.q = q; p.k = k; p.v = v;
  p.Lq = Lq; p.Lkv = Lkv; p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.scale = scale;
  return p;
}

}  // namespace

// Each entry point returns the first CUDA error of its launch (0 = ok).
// Inputs q (BH, Lq, D), k and v (BH, Lkv, D) are f32, or bf16 (bf16 = 1)
// for the backward.

// O (BH, Lq, D) f32 from f32 inputs (bf16 inputs go to dense_attn_fwd_tc);
// lse (BH, Lq) f32 on the fa2 rail (may be null on hfa).
extern "C" int dense_attn_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                              int BH, int Lq, int Lkv, int D, int kv_len, int q_offset,
                              int causal, float scale, int use_hfa, const void* lut_host,
                              void* stream) {
  if (bad_shape(BH, Lq, Lkv, D) || (!use_hfa && lse == nullptr))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  DenseParams p = make_params(q, k, v, Lq, Lkv, kv_len, q_offset, causal, scale);
  p.o = static_cast<float*>(o);
  p.lse_out = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto d) { return fwd_t<float, decltype(d)::value>(p, lut, BH, use_hfa, s); });
}

// dq (BH, Lq, D) in the input dtype; dout f32, lse and delta (BH, Lq) f32.
extern "C" int dense_attn_dq(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, void* dq, int BH, int Lq,
                             int Lkv, int D, int kv_len, int q_offset, int causal, float scale,
                             int bf16, void* stream) {
  if (bad_shape(BH, Lq, Lkv, D)) return (int)cudaErrorInvalidValue;
  DenseParams p = make_params(q, k, v, Lq, Lkv, kv_len, q_offset, causal, scale);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dq = dq;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return bf16 ? dq_t<__nv_bfloat16, kD>(p, BH, s) : dq_t<float, kD>(p, BH, s);
  });
}

// dk, dv (BH, Lkv, D) in the input dtype.
extern "C" int dense_attn_dkv(const void* q, const void* k, const void* v, const void* dout,
                              const void* lse, const void* delta, void* dk, void* dv, int BH,
                              int Lq, int Lkv, int D, int kv_len, int q_offset, int causal,
                              float scale, int bf16, void* stream) {
  if (bad_shape(BH, Lq, Lkv, D)) return (int)cudaErrorInvalidValue;
  DenseParams p = make_params(q, k, v, Lq, Lkv, kv_len, q_offset, causal, scale);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.dk = dk;
  p.dv = dv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return bf16 ? dkv_t<__nv_bfloat16, kD>(p, BH, s) : dkv_t<float, kD>(p, BH, s);
  });
}

// The rail device functions as compiled in this source (hfa_rail.cuh).
extern "C" int dense_rail_eval(const void* x, void* rail, void* pexp, void* recip, int n,
                               const void* lut_host, void* stream) {
  return rail_eval(x, rail, pexp, recip, n, lut_host, stream);
}
