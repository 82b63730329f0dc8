// The per-element H-FA datapath (the paper's FAU, Fig. 3) for Hopper
// (sm_90a), over (BH, L, D) slabs.
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/hfa_datapath.py  _datapath_kernel -> hfa_datapath_fwd
// Key j is visible to query row i when j < kv_len and, if causal,
// j <= i + q_offset.  For each row the kernel streams the visible keys in
// order through the FIX16 LNS state O = [l, o] of width D + 1 (V_j =
// [1, v_j]): m_new = max(m, s_j); A = O + quant(m - m_new); B = blinn(V_j)
// + quant(s_j - m_new); O = lns_add(A, B); then LogDiv (o - l on the rail)
// and the bit packing back to bf16 (lns_rail.cuh).  Scores are the f32
// dot product of q and k, times the scale, rounded to bf16.
//
// Design.  The TPU kernel holds one (batch, head) slab in VMEM and loops
// over the keys for all rows at once.  Here one block of D + 1 active
// threads owns one (bh, query row): thread c carries column c of that
// row's state in registers (column 0 is l), so the columns run in
// parallel and the keys run in order, as the hardware clocks them in.
// The row's scores are computed first, a chunk of keys at a time, by
// warps (one key per warp step, the D products split over the lanes,
// then a shuffle sum) into shared memory, where every column thread reads
// them.  Keys past the row's last visible key are not streamed at all,
// which is exact: a masked key leaves the state unchanged.
//
// What bounds it: the LNS updates, one per (visible pair, column), about
// 2.2e9 per layer at the dense-serve prefill (BH 128, L 512, D 128,
// causal).  They are integer-valued f32 adds, compares and a PWL lookup
// with no tensor-core form, so they run on the CUDA cores; the bytes
// (q, k, v read, the output written) are 67 MB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

#include "lns_rail.cuh"

namespace {

constexpr int kChunk = 1024;   // scores staged per pass

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ unsigned bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ unsigned bf16_bits(__nv_bfloat16 x) { return __bfloat16_as_ushort(x); }

struct DatapathParams {
  const void* q;         // (BH, Lq, D)
  const void* k;         // (BH, Lkv, D)
  const void* v;         // (BH, Lkv, D)
  unsigned short* out;   // (BH, Lq, D) bf16 bits
  int Lq, Lkv, kv_len, q_offset, causal;
  float scale;
};

template <typename T, int D>
__global__ void hfa_datapath_kernel(const DatapathParams p, const Lut lut) {
  constexpr int EPL = D / 32;  // elements of a row per lane
  __shared__ float s_s[kChunk];
  __shared__ float l_s[2];     // column 0's final (sign, raw)
  const int row = blockIdx.x, bh = blockIdx.y;
  const int c = threadIdx.x;
  const int lane = c & 31, warp = c >> 5, nwarps = blockDim.x >> 5;
  const T* qg = static_cast<const T*>(p.q) + ((size_t)bh * p.Lq + row) * D;
  const T* kg = static_cast<const T*>(p.k) + (size_t)bh * p.Lkv * D;
  const T* vg = static_cast<const T*>(p.v) + (size_t)bh * p.Lkv * D;

  float qr[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) qr[e] = to_f32(qg[lane + 32 * e]);

  int n_keys = min(p.kv_len, p.Lkv);
  if (p.causal) n_keys = min(n_keys, row + p.q_offset + 1);

  float m = kNegInf, raw = kLogZero;
  int sgn = 0;
  for (int c0 = 0; c0 < n_keys; c0 += kChunk) {
    const int n = min(kChunk, n_keys - c0);
    __syncthreads();  // the previous chunk's scores are consumed
    for (int j = warp; j < n; j += nwarps) {
      const T* kr = kg + (size_t)(c0 + j) * D;
      float acc = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc = fmaf(qr[e], to_f32(kr[lane + 32 * e]), acc);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0) s_s[j] = __bfloat162float(__float2bfloat16_rn(__fmul_rn(acc, p.scale)));
    }
    __syncthreads();
    if (c > D) continue;  // only columns 0..D carry state
    for (int j = 0; j < n; ++j) {
      const float s = s_s[j];
      const float m_new = fmaxf(m, s);
      if (!(m_new > kNegInf * 0.5f)) continue;  // not live: state kept
      const float a_raw = rail_rescale(raw, quant_scorediff(__fsub_rn(m, m_new)));
      int sv;
      float rv;
      blinn_log2(c == 0 ? 0x3F80u : bf16_bits(vg[(size_t)(c0 + j) * D + c - 1]), sv, rv);
      const float b_raw = rail_rescale(rv, quant_scorediff(__fsub_rn(s, m_new)));
      lns_add(sgn, a_raw, sv, b_raw, lut, sgn, raw);
      m = m_new;
    }
  }

  // LogDiv (Eq. 15) and the bit packing (Eq. 22): o / l = o - l on the rail.
  __syncthreads();
  if (c == 0) {
    l_s[0] = (float)sgn;
    l_s[1] = raw;
  }
  __syncthreads();
  if (c == 0 || c > D) return;
  const float raw_l = l_s[1];
  const int sgn_l = (int)l_s[0];
  const bool empty = raw_l <= kLogZero || raw <= kLogZero;
  const float raw_attn = empty ? kLogZero : clamp_rail(__fsub_rn(raw, raw_l));
  p.out[((size_t)bh * p.Lq + row) * D + c - 1] = lns_to_bf16(sgn ^ sgn_l, raw_attn);
}

template <typename T, int D>
int launch(const DatapathParams& p, const Lut& lut, int BH, cudaStream_t s) {
  const dim3 grid(p.Lq, BH);
  const int threads = (D + 1 + 31) / 32 * 32;
  hfa_datapath_kernel<T, D><<<grid, threads, 0, s>>>(p, lut);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const DatapathParams& p, const Lut& lut, int BH, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32>(p, lut, BH, s);
    case 64: return launch<T, 64>(p, lut, BH, s);
    case 96: return launch<T, 96>(p, lut, BH, s);
    default: return launch<T, 128>(p, lut, BH, s);
  }
}

__global__ void lns_eval_kernel(const int* sa, const float* ra, const int* sb, const float* rb,
                                const float* x, const int* bits, int* sc, float* rc,
                                float* quant, int* bsign, float* braw, unsigned short* packed,
                                int n, const Lut lut) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  lns_add(sa[i], ra[i], sb[i], rb[i], lut, sc[i], rc[i]);
  quant[i] = quant_scorediff(x[i]);
  blinn_log2((unsigned)bits[i] & 0xFFFFu, bsign[i], braw[i]);
  packed[i] = lns_to_bf16(sa[i], ra[i]);
}

}  // namespace

// out (BH, Lq, D) bf16; q (BH, Lq, D), k and v (BH, Lkv, D) bf16 (bf16 = 1)
// or f32, contiguous; D is 32, 64, 96 or 128.  Returns the first CUDA error of the launch (0 = ok).
extern "C" int hfa_datapath_fwd(const void* q, const void* k, const void* v, void* out, int BH,
                                int Lq, int Lkv, int D, int kv_len, int q_offset, int causal,
                                float scale, int bf16, const void* lut_host, void* stream) {
  if (BH <= 0 || BH > 65535 || Lq <= 0 || Lkv <= 0 ||
      (D != 32 && D != 64 && D != 96 && D != 128))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  DatapathParams p;
  p.q = q; p.k = k; p.v = v;
  p.out = static_cast<unsigned short*>(out);
  p.Lq = Lq; p.Lkv = Lkv; p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16 ? launch_d<__nv_bfloat16>(p, lut, BH, D, s) : launch_d<float>(p, lut, BH, D, s);
}

// The LNS device functions over n elements, for the bit-equality checks:
// (sc, rc) = lns_add(sa, ra, sb, rb); quant = quant_scorediff(x);
// (bsign, braw) = blinn_log2(bits); packed = lns_to_bf16(sa, ra).
extern "C" int lns_eval(const void* sa, const void* ra, const void* sb, const void* rb,
                        const void* x, const void* bits, void* sc, void* rc, void* quant,
                        void* bsign, void* braw, void* packed, int n, const void* lut_host,
                        void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  lns_eval_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sa), static_cast<const float*>(ra), static_cast<const int*>(sb),
      static_cast<const float*>(rb), static_cast<const float*>(x), static_cast<const int*>(bits),
      static_cast<int*>(sc), static_cast<float*>(rc), static_cast<float*>(quant),
      static_cast<int*>(bsign), static_cast<float*>(braw), static_cast<unsigned short*>(packed),
      n, lut);
  return (int)cudaGetLastError();
}
