// Dense flash-decode for Hopper (sm_90a): the G query heads that share one
// KV head against a contiguous KV cache, on the fa2 or the H-FA rail.
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/decode.py  _decode_kernel -> dense_decode_fwd_v2
// For each (sequence, KV head) it walks the cache in 128-key tiles (the
// reference's block_kv) with the Alg. 2 online update and returns the
// unnormalized triplet: o~ (G, D) f32, m and l (G) f32.  Keys at or past
// kv_len are masked: their scores are NEG_INF and their p is 0, as in the
// reference.  A tile wholly past kv_len is not walked, which is exact (it
// would leave m unchanged, so alpha 1, and add p = 0 on both rails).
//
// What bounds it: bytes.  One query token per head does 2 flops per K/V
// byte, far below the card's ridge, so the least time is the live K/V
// rows over the memory rate: 18.9 MB, 5.6 us, at the dense-serve decode
// (B 8, Hkv 8, G 2, kv_len 576, D 128, bf16).
//
// Design.  The TPU kernel walks the tiles along a sequential grid axis
// with its accumulators in VMEM, over a (BHkv, S, D) copy of the cache
// padded to 128.  Here the serving ring (B, S, Hkv, D) is read in place
// through its strides: no copy, no padding.  Rows sized to G: a block of
// 128 G threads, thread (row, key) scoring one key of the tile for one
// query head (four interleaved fmaf chains over D, as the paged kernels)
// and then owning one output
// column pair of that row over a contiguous part of the tile's keys (2,
// 4 and 8 parts at D 128 / 96, 64 and 32, summed in order at the end; at
// D 96 threads 96 .. 127 own none), reading V two columns and p four
// keys a load.  A tile's row
// max and sum of p are warp butterflies and four partials in shared
// memory; then l = l alpha + sum p and acc = acc alpha + sum_k p v, each
// rounded twice, as the plain version.  Key rows arrive by cp.async, 16
// bytes a copy, each key's D values contiguous (a ring whose strides or
// base are not 16-byte aligned is refused), into one K and one V tile
// buffer staggered as a ring: the next tile's K loads while this tile's
// P V runs, its V while the next scores run.  On the FA-2 rail the walk
// is split across blocks into runs of whole tiles (the count from the
// host's kv_len, so no sync: about two blocks an SM, at most one run a
// tile), and the last block of a (sequence, KV head) to finish merges the
// runs by Eq. 16 (decode_common.cuh).  The H-FA rail walks unsplit: its
// rescales must fall every 128 keys from key 0, where the reference's do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "hfa_rail.cuh"

namespace {

constexpr int kTile = 128;   // keys per tile: the reference's block_kv
constexpr int kMaxG = 8;     // query heads per KV head
constexpr int kRowWarps = kTile / 32;

struct DecodeParams {
  const void* q;        // (N0, N1, G, D) contiguous
  const void* k;        // element (n0, n1, s, c) at n0 * s0 + n1 * s1 + s * ss + c
  const void* v;        // same strides as k
  float* o;             // (N0, N1, G, D)
  float* m;             // (N0, N1, G)
  float* l;             // (N0, N1, G)
  float* ws;            // (N0 N1, splits, G, D + 2) run triplets, splits > 1
  unsigned* counters;   // (N0 N1) runs finished, 0 between launches
  long long s0, s1, ss;
  int N1, G, S, kv_len, splits;
  float scale;
};

template <typename T, int D>
struct DdLayout {
  static constexpr int kRow = D * (int)sizeof(T) + 16;   // padded smem row, bytes
  static constexpr int kTileBytes = kTile * kRow;
  static constexpr int kChunks = D * (int)sizeof(T) / 16;
  static constexpr int kPairs = D / 2;                   // output column pairs a row
  static constexpr int kParts = kTile / kPairs;          // threads a pair: 8, 4, 2, 2
  // K tile, V tile, q (f32), p (f32), row max and sum partials, key parts.
  static constexpr int bytes(int G) {
    return 2 * kTileBytes + G * D * 4 + G * kTile * 4 + 2 * G * kRowWarps * 4 +
           (kParts - 1) * G * D * 4;
  }
};

template <typename T, int D, bool HFA>
__global__ void __launch_bounds__(kTile * kMaxG) dense_decode_v2_kernel(const DecodeParams p,
                                                                       const Lut lut) {
  using Lay = DdLayout<T, D>;
  constexpr int VPE = 16 / (int)sizeof(T);
  constexpr int kParts = Lay::kParts, kPairs = Lay::kPairs;
  constexpr int kPartKeys = kTile / kParts;              // keys a part: 16, 32, 64, 64
  constexpr int kRowT = Lay::kRow / (int)sizeof(T);      // padded row, elements
  extern __shared__ __align__(16) uint8_t dd_smem[];
  uint8_t* k_s = dd_smem;
  uint8_t* v_s = k_s + Lay::kTileBytes;
  float* q_s = reinterpret_cast<float*>(v_s + Lay::kTileBytes);   // [G][D]
  float* p_s = q_s + p.G * D;                    // [G][kTile]
  float* red_max = p_s + p.G * kTile;            // [G][kRowWarps]
  float* red_sum = red_max + p.G * kRowWarps;    // [G][kRowWarps]
  float* part = red_sum + p.G * kRowWarps;       // [kParts - 1][G][D]

  const int sp = blockIdx.x, n1 = blockIdx.y, n0 = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int r = tid / kTile, k = tid % kTile, lane = tid & 31;   // (row, key of the tile)
  // In P V thread (row, k) owns the column pair 2 cp, 2 cp + 1 over one
  // contiguous part of the tile's keys (at D 96 threads 96 .. 127 none).
  const int cp = k % kPairs, kpart = k / kPairs;
  const bool owner = kpart < kParts;
  const size_t row = (size_t)n0 * p.N1 + n1;     // (sequence, KV head)
  const T* kg = static_cast<const T*>(p.k) + n0 * p.s0 + n1 * p.s1;
  const T* vg = static_cast<const T*>(p.v) + n0 * p.s0 + n1 * p.s1;

  const int n_kv = max(0, min(p.kv_len, p.S));
  const int n_tiles = (n_kv + kTile - 1) / kTile;
  const int per = (n_tiles + p.splits - 1) / p.splits;
  const int t_begin = min(sp * per, n_tiles), t_end = min(t_begin + per, n_tiles);

  const T* qg = static_cast<const T*>(p.q) + row * p.G * D;
  for (int i = tid; i < p.G * D; i += nthreads) q_s[i] = dc_f32(qg[i]);

  // cp.async of tile t of src into dst; keys at or past n_kv zero-filled.
  auto load_tile = [&](uint8_t* dst, const T* src, int t) {
    const int k0 = t * kTile;
    const uint32_t base = dc_smem_addr(dst);
    for (int idx = tid; idx < kTile * Lay::kChunks; idx += nthreads) {
      const int key = idx / Lay::kChunks, c = idx % Lay::kChunks;
      const bool live = k0 + key < n_kv;
      const T* g = src + (live ? (long long)(k0 + key) * p.ss : 0) + c * VPE;
      cp_async16(base + key * Lay::kRow + c * 16, g, live ? 16 : 0);
    }
  };
  if (t_begin < t_end) {
    load_tile(k_s, kg, t_begin);
    cp_async_commit();
    load_tile(v_s, vg, t_begin);
    cp_async_commit();
  }

  float m_run = kNegInf, l_run = 0.f, acc[2] = {0.f, 0.f};
  const float* pr = p_s + r * kTile;
  // Committed groups, in order: K(t), V(t), then per tile K(t + 1) after
  // its scores and V(t + 1) after its P V (empty past the run's end), so
  // "all but the newest one done" is first K(t), then V(t).
  for (int t = t_begin; t < t_end; ++t) {
    const int n = min(kTile, n_kv - t * kTile);   // keys of this tile below kv_len
    cp_async_wait<1>();
    __syncthreads();   // K(t) (and q_s) visible; the last tile's sums consumed
    const bool vis = k < n;
    float dot[1];
    dc_dots<T, D, 1>(q_s + r * D, D, reinterpret_cast<const T*>(k_s + k * Lay::kRow), dot);
    const float s = vis ? __fmul_rn(dot[0], p.scale) : kNegInf;
    float mx = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red_max[r * kRowWarps + k / 32] = mx;
    __syncthreads();   // every score read K(t)
    if (t + 1 < t_end) load_tile(k_s, kg, t + 1);
    cp_async_commit();
    const float* rm = red_max + r * kRowWarps;
    const float m_new = fmaxf(m_run, fmaxf(fmaxf(rm[0], rm[1]), fmaxf(rm[2], rm[3])));
    const float dm = fminf(__fsub_rn(m_run, m_new), 0.f);
    const float alpha = HFA ? exp2_hfa_rail(quant_rail(dm), lut) : expf(dm);
    const float x = __fsub_rn(s, m_new);
    float pv = HFA ? exp2_hfa_rail(quant_rail(x), lut) : expf(x);
    pv = (vis && m_new != kNegInf) ? pv : 0.f;
    p_s[r * kTile + k] = pv;
    float ps = pv;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
    if (lane == 0) red_sum[r * kRowWarps + k / 32] = ps;
    cp_async_wait<1>();
    __syncthreads();   // V(t), p and the sum partials visible
    const float* rs = red_sum + r * kRowWarps;
    const float tsum = (rs[0] + rs[1]) + (rs[2] + rs[3]);
    // o~ columns 2 cp, 2 cp + 1 over this thread's keys of the tile, four
    // keys' p at a time (keys past n have p 0 and zero-filled V).
    float pv_acc[2] = {0.f, 0.f};
    if (owner) {
      const T* vt = reinterpret_cast<const T*>(v_s) + 2 * cp;
      const int j_end = min(kpart * kPartKeys + kPartKeys, n);
      for (int j = kpart * kPartKeys; j < j_end; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(pr + j);
        const float pk[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float2 vv = dc_pair(vt + (j + u) * kRowT);
          pv_acc[0] = fmaf(pk[u], vv.x, pv_acc[0]);
          pv_acc[1] = fmaf(pk[u], vv.y, pv_acc[1]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) acc[c] = __fadd_rn(__fmul_rn(acc[c], alpha), pv_acc[c]);
    l_run = __fadd_rn(__fmul_rn(l_run, alpha), tsum);
    m_run = m_new;
    __syncthreads();   // V(t) and p consumed
    if (t + 1 < t_end) load_tile(v_s, vg, t + 1);
    cp_async_commit();
  }
  cp_async_wait<0>();

  // The key parts of each column pair meet, in order.
  if (kpart >= 1 && owner)
#pragma unroll
    for (int c = 0; c < 2; ++c) part[((kpart - 1) * p.G + r) * D + 2 * cp + c] = acc[c];
  __syncthreads();
  if (kpart == 0)
#pragma unroll
    for (int i = 0; i < kParts - 1; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) acc[c] += part[(i * p.G + r) * D + 2 * cp + c];
  const bool writer = kpart == 0;
  const int cols[2] = {writer ? 2 * cp : -1, writer ? 2 * cp + 1 : -1};
  const size_t orow = row * p.G + r;
  if (p.splits == 1) {
    if (writer) *reinterpret_cast<float2*>(p.o + orow * D + 2 * cp) = make_float2(acc[0], acc[1]);
    if (k == 0) {
      p.m[orow] = m_run;
      p.l[orow] = l_run;
    }
    return;
  }
  // Split walk: this run's triplets to the workspace; the last block of
  // the (sequence, KV head) merges all of them.
  const size_t stride = (size_t)p.G * (D + 2);
  float* w = p.ws + (row * p.splits + sp) * stride + (size_t)r * (D + 2);
  if (writer) {
    w[2 * cp] = acc[0];
    w[2 * cp + 1] = acc[1];
  }
  if (k == 0) {
    w[D] = m_run;
    w[D + 1] = l_run;
  }
  if (!dc_last_run(&p.counters[row], p.splits)) return;
  float mm, ll, oo[2];
  dc_merge(p.ws + row * p.splits * stride + (size_t)r * (D + 2), stride, p.splits, D, cols, mm,
           ll, oo);
  if (writer) *reinterpret_cast<float2*>(p.o + orow * D + 2 * cp) = make_float2(oo[0], oo[1]);
  if (k == 0) {
    p.m[orow] = mm;
    p.l[orow] = ll;
  }
}

template <typename T, int D, bool HFA>
int launch_rail(const DecodeParams& p, const Lut& lut, int N0, cudaStream_t s) {
  using Lay = DdLayout<T, D>;
  auto kernel = dense_decode_v2_kernel<T, D, HFA>;
  static bool ready = false;   // the shared-memory attribute is set
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::bytes(kMaxG));
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<dim3(p.splits, p.N1, N0), kTile * p.G, Lay::bytes(p.G), s>>>(p, lut);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch(const DecodeParams& p, const Lut& lut, int N0, int use_hfa, cudaStream_t s) {
  return use_hfa ? launch_rail<T, D, true>(p, lut, N0, s) : launch_rail<T, D, false>(p, lut, N0, s);
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

static_assert(DdLayout<float, 128>::bytes(kMaxG) <= 232448, "227 KB a block");
static_assert(DdLayout<float, 32>::bytes(kMaxG) <= 232448, "227 KB a block");

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// q (N0, N1, G, D) contiguous; k and v share the element strides s0, s1
// (leading dims) and ss (keys), with the D values of a key contiguous,
// 16-byte aligned base and strides; bf16 (bf16 = 1) or f32; G <= 8.
// splits > 1 (FA-2 rail only) splits each walk into that many runs of
// 128-key tiles, with ws (N0 N1 splits G (D + 2) f32) and counters (N0 N1
// uint32, zero, and left zero); launches that share counters run one at a
// time (one stream).  o (N0, N1, G, D), m and l (N0, N1, G) f32.  Returns
// the first CUDA error of the launch (0 = ok).
extern "C" int dense_decode_fwd_v2(const void* q, const void* k, const void* v, void* o, void* m,
                                   void* l, void* ws, void* counters, int N0, int N1, int G,
                                   int S, int D, long long s0, long long s1, long long ss,
                                   int kv_len, int splits, float scale, int use_hfa, int bf16,
                                   const void* lut_host, void* stream) {
  const long long es = bf16 ? 2 : 4;
  if (N0 <= 0 || N0 > 65535 || N1 <= 0 || N1 > 65535 || G <= 0 || G > kMaxG || S <= 0 ||
      splits <= 0 || (D != 32 && D != 64 && D != 96 && D != 128) || !aligned16(k) ||
      !aligned16(v) || (s0 * es) % 16 != 0 || (s1 * es) % 16 != 0 || (ss * es) % 16 != 0 ||
      (splits > 1 && (use_hfa || ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  DecodeParams p;
  p.q = q; p.k = k; p.v = v;
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<unsigned*>(counters);
  p.s0 = s0; p.s1 = s1; p.ss = ss;
  p.N1 = N1; p.G = G; p.S = S; p.kv_len = kv_len; p.splits = splits;
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
