// Paged attention for Hopper (sm_90a): decode, chunked prefill and
// speculative verify over a paged KV block pool, on the fa2 rail (exp,
// float divide later) or the H-FA rail (FIX16 quantized exponentials).
//
// Replaces the three Pallas TPU kernels of the reference package:
//   src/repro/kernels/paged_decode.py   _paged_decode_kernel
//   src/repro/kernels/paged_prefill.py  _paged_prefill_kernel
//   src/repro/kernels/paged_verify.py   _paged_verify_kernel
// All three share one body: walk a slot's page table, stream each KV tile
// through the Alg. 2 online update and emit the unnormalized triplet
// (o~, m, l) per query row.  They differ only in how many query rows a
// (slot, kv head) has and in the mask, so here they are one kernel with
// three C entry points.
//
// Query row r of a (slot b, kv head h) sits at local position l = r % L
// (rows are the flattened (G, L) block, kv-head major).  With per-slot
// numbers `base` and `limit` it sees KV positions kv with
//     kv <= base + l  and  kv < limit:
//   decode  (L = 1): base = kv_lens - 1,  limit = kv_lens
//   prefill (L = chunk): base = start_pos, limit = kv_lens
//   verify  (L = K): base = seq_lens, limit = seq_lens + chunk_lens
//
// Design.  One block of 128 threads takes one (slot, kv head, tile of 16
// query rows).  The TPU kernel's sequential page axis becomes a loop
// inside the block over KV tiles; the block reads its own page ids from
// the page table.  The loop stops at the last position any of its rows
// can see - exact, not an approximation: a fully masked tile leaves m
// unchanged, so alpha is exp(0) = 1 on the fa2 rail and
// exp2_hfa_rail(quant_rail(0)) = 1 on the hfa rail, and p = 0.
// Each warp owns 4 rows as two row pairs; in a pair, lanes 0-15 take row
// one and lanes 16-31 row two, lane k of a half scoring KV position k of
// each 16-key chunk of the tile and owning accumulator columns {k, k+16,
// ...}.  Everything is f32 (pools are decoded to f32 as their tiles load),
// p included, as in the Pallas kernel.
//
// The rescale step.  On the fa2 rail the online update (m_new, alpha, p,
// l, acc) runs once per 16-key tile at any page size: where it falls
// moves only rounding.  On the H-FA rail the output depends on where the
// rescales fall, and the reference rescales once a page, so this body
// does too, in page order, at every page size up to kHfaMaxPage:
//   * page 16: the 16-key tile is the page (the arithmetic of the fa2
//     rail's tile, bit-equal to the v2 decode and verify);
//   * page below 16: the tile is page * floor(16 / page) keys (16 for 1,
//     2, 4 and 8; 15 for 3 and 5; 14 for 7; the page itself for 9-15), so
//     no tile straddles a page.  Each page's max comes from a butterfly
//     over the tile's 16 lanes in which the other pages' lanes hold
//     NEG_INF, and the update then runs page by page: l = fma(l, alpha_g,
//     sum_g p), acc = fma(acc, alpha_g, P_g V_g);
//   * page above 16: a kernel of its own, paged_attention_page_kernel,
//     walks page by page and stages each page in chunks of 64 keys.
//     Pass one stages K a chunk at a time and writes every score of the
//     page to shared memory (16 rows x (page + 16) f32: 16 KB at page
//     256); the page's max is taken over all of them; alpha is applied
//     once; pass two stages V a chunk at a time and forms p from the
//     stored scores, P V as an fmaf chain over the page's keys in order
//     and each lane's sum of p over its keys in order (then the 16-lane
//     butterfly), so pages of 17-64 keys keep the arithmetic the body
//     had when it staged a whole page, and larger pages extend it.  The
//     score buffer is sized from the page at launch; shared memory holds
//     it up to page kHfaMaxPage (2048: 207.6 KB of the 227 KB a block at
//     d 128), above which a launch is refused (kernels/cuda_lib.py says
//     so first).
//
// Pools.  q is bf16 or f32 (TQ); the pools (TKV) are in q's dtype, bf16
// under an f32 q (a log16 pool's bits at f32 compute), or int8 with one
// f32 scale a row (the int8 page codec): each 4-value load of an int8 row
// reads its row's scale through the same page-table row and writes
// __fmul_rn(value, scale) to the f32 tile in shared memory, which is
// Int8Codec.decode bit for bit.  Everything after the tile load is the
// same for every pool type.
//
// What bounds it: the bytes of the live K/V pages (every page is read
// once per 16-row tile, once per block from device memory and the rest
// from L2).  It uses CUDA cores, plain loads and no split of the page
// walk across blocks.  Decode, verify with at most 16 rows a (slot, kv
// head) and bf16 prefill at page 16 run the redesigned kernels of
// paged_attention_tc.cu (paged_decode_fwd_v2, paged_verify_fwd_v2,
// paged_prefill_fwd_tc); this body stays for verify with more rows, for
// prefill with an f32 q, int8 pools, d 32 / 96 or other page sizes, and
// for decode and verify on the H-FA rail at a page size other than 16
// (the rules are in kernels/cuda_lib.py), and paged_decode_fwd for the
// checks.  D is 32, 64, 96 or 128.  The scale is one rounded multiply
// and l and acc are updated with explicit FMAs, so the v2 decode and
// verify, which repeat this order, are bit-equal to it.
//
// The H-FA rail (quant_rail, exp2_hfa_rail, recip_logdiv) comes from
// hfa_rail.cuh, bit-equal to the plain torch versions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hfa_rail.cuh"

namespace {

constexpr int kTile = 16;                         // KV positions a lane half scores at once
constexpr int kStage = 64;                        // keys of a page staged at once (page > 16)
constexpr int kHfaMaxPage = 2048;                 // the H-FA rail's largest page (shared memory)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;                   // two row pairs
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;
constexpr int kSmemMax = 232448;                  // shared memory a block can use

struct Params {
  const void* q;      // (B, Hkv, R, D), TQ
  const void* k;      // (P, page, Hkv, D), TKV
  const void* v;      // (P, page, Hkv, D), TKV
  const float* ks;    // (P, page, Hkv) int8 scales, else null
  const float* vs;
  const int* pt;      // (B, J)
  const int* lens_a;  // (B,)
  const int* lens_b;  // (B,) or null (decode)
  float* o;           // (B, Hkv, R, D)
  float* m;           // (B, Hkv, R)
  float* l;           // (B, Hkv, R)
  int R, L, J, page, hkv, mode;
  float scale;
};

// ------------------------------------------------------------------ loads
// Four values of a row as f32: q rows, and K/V rows through KvLoad.
template <typename T>
struct Load4;

template <>
struct Load4<float> {
  static __device__ __forceinline__ void run(const float* p, float* o) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <>
struct Load4<__nv_bfloat16> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p, float* o) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};

// Values c..c+3 of pool row `row` (D values a row), decoded to f32: a
// plain widening, or for int8 the value times the row's scale, one
// rounded multiply (Int8Codec.decode).
template <typename T>
struct KvLoad {
  static __device__ __forceinline__ void run(const T* pool, const float*, size_t row, int D,
                                             int c, float* o) {
    Load4<T>::run(pool + row * D + c, o);
  }
};

template <>
struct KvLoad<int8_t> {
  static __device__ __forceinline__ void run(const int8_t* pool, const float* sc, size_t row,
                                             int D, int c, float* o) {
    const char4 v = *reinterpret_cast<const char4*>(pool + row * D + c);
    const float s = sc[row];
    o[0] = __fmul_rn((float)v.x, s); o[1] = __fmul_rn((float)v.y, s);
    o[2] = __fmul_rn((float)v.z, s); o[3] = __fmul_rn((float)v.w, s);
  }
};

// ------------------------------------------------------------ the walk
// Keys of one tile: the rescale step (see the header).
__host__ __device__ inline int tile_keys(int page, bool hfa) {
  if (!hfa || page == kTile) return kTile;
  return page * (kTile / page);
}

// What both kernels set up: the rows of the block, the walk's length
// and q in shared memory.
struct Walk {
  int limit, n_kv;
  int rloc[2], qpos[2];
  bool rvalid[2];
};

template <typename TQ, int D>
__device__ __forceinline__ Walk walk_setup(const Params& p, float (*q_s)[D + 16]) {
  Walk w;
  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x, warp = tid >> 5, half = (tid & 31) >> 4;
  const int a = p.lens_a[b];
  int base;
  if (p.mode == 0) {
    base = a - 1; w.limit = a;
  } else if (p.mode == 1) {
    base = a; w.limit = p.lens_b[b];
  } else {
    base = a; w.limit = a + p.lens_b[b];
  }
  // Furthest position any row of this block can see, within the table.
  const int last_row = min(row0 + kRowsPerBlock, p.R) - 1;
  const int max_l = (last_row / p.L != row0 / p.L) ? p.L - 1 : last_row % p.L;
  w.n_kv = max(0, min(min(base + max_l + 1, w.limit), p.J * p.page));

  const size_t bh = (size_t)b * p.hkv + h;
  const TQ* q = static_cast<const TQ*>(p.q) + bh * p.R * D;
  for (int idx = tid * 4; idx < kRowsPerBlock * D; idx += kThreads * 4) {
    const int r = idx / D, c = idx % D;
    float t4[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < p.R) Load4<TQ>::run(q + (size_t)(row0 + r) * D + c, t4);
#pragma unroll
    for (int i = 0; i < 4; ++i) q_s[r][c + i] = t4[i];
  }
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    w.rloc[pr] = warp * kRowsPerWarp + pr * 2 + half;
    const int row = row0 + w.rloc[pr];
    w.rvalid[pr] = row < p.R;
    w.qpos[pr] = base + row % p.L;
  }
  return w;
}

// Four interleaved fmaf chains over D, then ((d0 + d1) + (d2 + d3)).
template <int D>
__device__ __forceinline__ float dot_row(const float* qr, const float* kr) {
  float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 8
  for (int i = 0; i < D; i += 4) {
    d0 = fmaf(qr[i], kr[i], d0);
    d1 = fmaf(qr[i + 1], kr[i + 1], d1);
    d2 = fmaf(qr[i + 2], kr[i + 2], d2);
    d3 = fmaf(qr[i + 3], kr[i + 3], d3);
  }
  return (d0 + d1) + (d2 + d3);
}

template <int D>
__device__ __forceinline__ void write_triplet(const Params& p, const Walk& w,
                                              const float (&m_run)[2], const float (&l_run)[2],
                                              const float (&acc)[2][D / 16]) {
  const size_t bh = (size_t)blockIdx.z * p.hkv + blockIdx.y;
  const int kk = threadIdx.x & 15;
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    if (!w.rvalid[pr]) continue;
    const size_t orow = bh * p.R + blockIdx.x * kRowsPerBlock + w.rloc[pr];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) p.o[orow * D + c * 16 + kk] = acc[pr][c];
    if (kk == 0) {
      p.m[orow] = m_run[pr];
      p.l[orow] = l_run[pr];
    }
  }
}

// 16-key tiles: the FA-2 rail at every page size, the H-FA rail at page
// 16 and below (a tile of whole pages, one update a page).
template <typename TQ, typename TKV, int D, bool HFA>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p, const Lut lut) {
  constexpr int DK = D + 1;    // odd stride: the 16 score lanes hit 16 banks
  constexpr int DQ = D + 16;   // the two rows of a pair sit 16 banks apart
  constexpr int VPL = D / 16;  // accumulator columns per lane per row
  __shared__ float q_s[kRowsPerBlock][DQ];
  __shared__ float k_s[kTile][DK];
  __shared__ float v_s[kTile][D];

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int half = (tid & 31) >> 4;
  const int kk = tid & 15;
  // Keys a tile holds, and keys a rescale takes (the page on the H-FA
  // rail below 16; the tile otherwise).
  const int tk = tile_keys(p.page, HFA);
  const int gs = (HFA && p.page < kTile) ? p.page : tk;
  const Walk w = walk_setup<TQ, D>(p, q_s);

  float m_run[2], l_run[2], acc[2][VPL];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    m_run[pr] = kNegInf;
    l_run[pr] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) acc[pr][c] = 0.f;
  }

  const TKV* kpool = static_cast<const TKV*>(p.k);
  const TKV* vpool = static_cast<const TKV*>(p.v);
  const int* ptb = p.pt + (size_t)blockIdx.z * p.J;
  for (int t0 = 0; t0 < w.n_kv; t0 += tk) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int idx = tid * 4; idx < tk * D; idx += kThreads * 4) {
      const int r = idx / D, c = idx % D;
      const int kv = t0 + r;
      float kt[4] = {0.f, 0.f, 0.f, 0.f}, vt[4] = {0.f, 0.f, 0.f, 0.f};
      if (kv < w.n_kv) {
        const size_t row = ((size_t)ptb[kv / p.page] * p.page + kv % p.page) * p.hkv + h;
        KvLoad<TKV>::run(kpool, p.ks, row, D, c, kt);
        KvLoad<TKV>::run(vpool, p.vs, row, D, c, vt);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        k_s[r][c + i] = kt[i];
        v_s[r][c + i] = vt[i];
      }
    }
    __syncthreads();

#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
      const int kv = t0 + kk;  // the key of the tile this lane scores
      const bool vis = w.rvalid[pr] && kk < tk && kv < w.n_kv && kv <= w.qpos[pr] &&
                       kv < w.limit;
      const float dot = dot_row<D>(q_s[w.rloc[pr]], k_s[kk]);
      const float s = vis ? __fmul_rn(dot, p.scale) : kNegInf;
      // One online update per group of gs keys (a page on the H-FA rail
      // below 16; the whole tile otherwise), in key order.
      for (int g0 = 0; g0 < tk; g0 += gs) {
        const bool mine = gs == tk || (kk >= g0 && kk < g0 + gs);
        float mx = mine ? s : kNegInf;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[pr], mx);
        float alpha, pv;
        if (HFA) {
          alpha = exp2_hfa_rail(quant_rail(fminf(m_run[pr] - m_new, 0.f)), lut);
          pv = exp2_hfa_rail(quant_rail(s - m_new), lut);
        } else {
          alpha = expf(fminf(m_run[pr] - m_new, 0.f));
          pv = expf(s - m_new);
        }
        pv = (vis && mine && m_new != kNegInf) ? pv : 0.f;
        float ps = pv;
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[pr] = fmaf(l_run[pr], alpha, ps);
        float pvacc[VPL];
#pragma unroll
        for (int c = 0; c < VPL; ++c) pvacc[c] = 0.f;
#pragma unroll
        for (int j = 0; j < kTile; ++j) {
          if (j < g0 || j >= g0 + gs) continue;  // warp-uniform: another group's key
          const float pj = __shfl_sync(0xffffffffu, pv, (half << 4) + j);
#pragma unroll
          for (int c = 0; c < VPL; ++c) pvacc[c] = fmaf(pj, v_s[j][c * 16 + kk], pvacc[c]);
        }
#pragma unroll
        for (int c = 0; c < VPL; ++c) acc[pr][c] = fmaf(acc[pr][c], alpha, pvacc[c]);
        m_run[pr] = m_new;
      }
    }
  }
  write_triplet<D>(p, w, m_run, l_run, acc);
}

// Dynamic shared memory of the page kernel: a K and a V stage of 64 keys
// (K at an odd stride), then the page's scores, 16 rows x (page + 16).
template <int D>
constexpr int page_smem_bytes(int page) {
  return (kStage * ((D + 1) + D) + kRowsPerBlock * (page + 16)) * (int)sizeof(float);
}

// The H-FA rail at a page above 16: one update a page, the page staged
// in chunks of kStage keys (see the header).
template <typename TQ, typename TKV, int D>
__global__ void __launch_bounds__(kThreads)
paged_attention_page_kernel(const Params p, const Lut lut) {
  constexpr int DK = D + 1;
  constexpr int DQ = D + 16;
  constexpr int VPL = D / 16;
  constexpr int NCH = kStage / kTile;      // 16-key chunks a stage holds
  __shared__ float q_s[kRowsPerBlock][DQ];
  extern __shared__ float smem[];
  float (*k_s)[DK] = reinterpret_cast<float (*)[DK]>(smem);
  float (*v_s)[D] = reinterpret_cast<float (*)[D]>(smem + kStage * DK);
  float* s_s = smem + kStage * (DK + D);  // [row][page + 16]: a row pair 16 banks apart
  const int sp = p.page + 16;

  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int half = (tid & 31) >> 4;
  const int kk = tid & 15;
  const Walk w = walk_setup<TQ, D>(p, q_s);

  float m_run[2], l_run[2], acc[2][VPL];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    m_run[pr] = kNegInf;
    l_run[pr] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) acc[pr][c] = 0.f;
  }

  const TKV* kpool = static_cast<const TKV*>(p.k);
  const TKV* vpool = static_cast<const TKV*>(p.v);
  const int* ptb = p.pt + (size_t)blockIdx.z * p.J;
  // Stage `keys` keys of the page from key c0 (zero past them) into st.
  auto stage = [&](const TKV* pool, const float* sc, float* st, int stride, size_t row0,
                   int c0, int keys) {
    for (int idx = tid * 4; idx < kStage * D; idx += kThreads * 4) {
      const int r = idx / D, c = idx % D;
      float t4[4] = {0.f, 0.f, 0.f, 0.f};
      if (c0 + r < keys) KvLoad<TKV>::run(pool, sc, row0 + (size_t)(c0 + r) * p.hkv, D, c, t4);
#pragma unroll
      for (int i = 0; i < 4; ++i) st[r * stride + c + i] = t4[i];
    }
  };
  for (int pg0 = 0; pg0 < w.n_kv; pg0 += p.page) {
    const int keys = min(p.page, w.n_kv - pg0);   // keys of the page the walk reaches
    const size_t row0 = (size_t)ptb[pg0 / p.page] * p.page * p.hkv + h;
    // Pass one: every score of the page, and each lane's max of its keys.
    float mx[2] = {kNegInf, kNegInf};
    for (int c0 = 0; c0 < keys; c0 += kStage) {
      __syncthreads();  // the previous stage is consumed (and q_s written)
      stage(kpool, p.ks, &k_s[0][0], DK, row0, c0, keys);
      __syncthreads();
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int jj = c0 + ch * kTile + kk;   // key of the page this lane scores
          const int kv = pg0 + jj;
          const bool vis = w.rvalid[pr] && jj < keys && kv <= w.qpos[pr] && kv < w.limit;
          const float dot = dot_row<D>(q_s[w.rloc[pr]], k_s[ch * kTile + kk]);
          const float s = vis ? __fmul_rn(dot, p.scale) : kNegInf;
          if (jj < keys) s_s[w.rloc[pr] * sp + jj] = s;
          mx[pr] = fmaxf(mx[pr], s);
        }
      }
    }
    float m_new[2], alpha[2], ps[2] = {0.f, 0.f}, pvacc[2][VPL];
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx[pr] = fmaxf(mx[pr], __shfl_xor_sync(0xffffffffu, mx[pr], off));
      m_new[pr] = fmaxf(m_run[pr], mx[pr]);
      alpha[pr] = exp2_hfa_rail(quant_rail(fminf(m_run[pr] - m_new[pr], 0.f)), lut);
#pragma unroll
      for (int c = 0; c < VPL; ++c) pvacc[pr][c] = 0.f;
    }
    // Pass two: p from the stored scores, P V over the page's keys in
    // order, a chunk of V at a time.
    for (int c0 = 0; c0 < keys; c0 += kStage) {
      __syncthreads();
      stage(vpool, p.vs, &v_s[0][0], D, row0, c0, keys);
      __syncthreads();
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        float pv[NCH];
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int jj = c0 + ch * kTile + kk;
          const int kv = pg0 + jj;
          const bool vis = w.rvalid[pr] && jj < keys && kv <= w.qpos[pr] && kv < w.limit;
          const float s = jj < keys ? s_s[w.rloc[pr] * sp + jj] : kNegInf;
          const float e = exp2_hfa_rail(quant_rail(s - m_new[pr]), lut);
          pv[ch] = (vis && m_new[pr] != kNegInf) ? e : 0.f;
          ps[pr] += pv[ch];
        }
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            if (c0 + ch * kTile + j >= keys) break;   // warp-uniform: past the walk
            const float pj = __shfl_sync(0xffffffffu, pv[ch], (half << 4) + j);
#pragma unroll
            for (int c = 0; c < VPL; ++c)
              pvacc[pr][c] = fmaf(pj, v_s[ch * kTile + j][c * 16 + kk], pvacc[pr][c]);
          }
        }
      }
    }
#pragma unroll
    for (int pr = 0; pr < 2; ++pr) {
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        ps[pr] += __shfl_xor_sync(0xffffffffu, ps[pr], off);
      l_run[pr] = fmaf(l_run[pr], alpha[pr], ps[pr]);
#pragma unroll
      for (int c = 0; c < VPL; ++c) acc[pr][c] = fmaf(acc[pr][c], alpha[pr], pvacc[pr][c]);
      m_run[pr] = m_new[pr];
    }
  }
  write_triplet<D>(p, w, m_run, l_run, acc);
}

template <typename TQ, typename TKV, int D>
int launch_d(const Params& p, const Lut& lut, int B, int use_hfa, cudaStream_t s) {
  const dim3 grid((p.R + kRowsPerBlock - 1) / kRowsPerBlock, p.hkv, B);
  if (use_hfa && p.page > kTile) {
    const int smem = page_smem_bytes<D>(p.page);
    auto kernel = paged_attention_page_kernel<TQ, TKV, D>;
    if (smem > 48 * 1024) {
      const cudaError_t err =
          cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    kernel<<<grid, kThreads, smem, s>>>(p, lut);
  } else if (use_hfa) {
    paged_attention_kernel<TQ, TKV, D, true><<<grid, kThreads, 0, s>>>(p, lut);
  } else {
    paged_attention_kernel<TQ, TKV, D, false><<<grid, kThreads, 0, s>>>(p, lut);
  }
  return (int)cudaGetLastError();
}

template <typename TQ, typename TKV>
int launch_kv(const Params& p, const Lut& lut, int B, int D, int use_hfa, cudaStream_t s) {
  switch (D) {
    case 32: return launch_d<TQ, TKV, 32>(p, lut, B, use_hfa, s);
    case 64: return launch_d<TQ, TKV, 64>(p, lut, B, use_hfa, s);
    case 96: return launch_d<TQ, TKV, 96>(p, lut, B, use_hfa, s);
    default: return launch_d<TQ, TKV, 128>(p, lut, B, use_hfa, s);
  }
}

static_assert(page_smem_bytes<128>(kHfaMaxPage) + kRowsPerBlock * (128 + 16) * 4 <= kSmemMax,
              "the page kernel's shared memory at the largest page");

// kv: the pools beside q - 0 q's dtype, 1 int8 with scales, 2 bf16 under
// an f32 q (kernels/cuda_lib.py KV_SAME, KV_INT8, KV_BF16).
int launch(const Params& p, int B, int D, int use_hfa, int bf16, int kv, const void* lut_host,
           void* stream) {
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || p.R <= 0 || p.L <= 0 || p.J <= 0 || p.page <= 0 || p.hkv <= 0 ||
      (D != 32 && D != 64 && D != 96 && D != 128) || (use_hfa && p.page > kHfaMaxPage) ||
      kv < 0 || kv > 2 || (kv == 1) != (p.ks != nullptr && p.vs != nullptr) ||
      (kv == 2 && bf16))
    return (int)cudaErrorInvalidValue;
  if (bf16) {
    if (kv == 1) return launch_kv<__nv_bfloat16, int8_t>(p, lut, B, D, use_hfa, s);
    return launch_kv<__nv_bfloat16, __nv_bfloat16>(p, lut, B, D, use_hfa, s);
  }
  if (kv == 1) return launch_kv<float, int8_t>(p, lut, B, D, use_hfa, s);
  if (kv == 2) return launch_kv<float, __nv_bfloat16>(p, lut, B, D, use_hfa, s);
  return launch_kv<float, float>(p, lut, B, D, use_hfa, s);
}

Params make_params(const void* q, const void* k, const void* v, const void* ks, const void* vs,
                   const void* pt, const void* lens_a, const void* lens_b, void* o, void* m,
                   void* l, int R, int L, int J, int page, int hkv, int mode, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.pt = static_cast<const int*>(pt);
  p.lens_a = static_cast<const int*>(lens_a);
  p.lens_b = static_cast<const int*>(lens_b);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.R = R; p.L = L; p.J = J; p.page = page; p.hkv = hkv; p.mode = mode;
  p.scale = scale;
  return p;
}

}  // namespace

// Each entry point returns cudaGetLastError() after its launch (0 = ok).
// q bf16 (bf16 = 1) or f32; the pools as `kv` says (see launch), with
// ks / vs the (P, page, Hkv) f32 row scales of int8 pools, else null.
extern "C" int paged_decode_fwd(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* pt, const void* kv_lens, void* o,
                                void* m, void* l, int B, int hkv, int G, int D, int J, int page,
                                float scale, int use_hfa, int bf16, int kv, const void* lut,
                                void* stream) {
  const Params p = make_params(q, k, v, ks, vs, pt, kv_lens, nullptr, o, m, l, G, 1, J, page,
                               hkv, 0, scale);
  return launch(p, B, D, use_hfa, bf16, kv, lut, stream);
}

extern "C" int paged_prefill_fwd(const void* q, const void* k, const void* v, const void* ks,
                                 const void* vs, const void* pt, const void* start_pos,
                                 const void* kv_lens, void* o, void* m, void* l, int B, int hkv,
                                 int G, int L, int D, int J, int page, float scale, int use_hfa,
                                 int bf16, int kv, const void* lut, void* stream) {
  const Params p = make_params(q, k, v, ks, vs, pt, start_pos, kv_lens, o, m, l, G * L, L, J,
                               page, hkv, 1, scale);
  return launch(p, B, D, use_hfa, bf16, kv, lut, stream);
}

extern "C" int paged_verify_fwd(const void* q, const void* k, const void* v, const void* ks,
                                const void* vs, const void* pt, const void* seq_lens,
                                const void* chunk_lens, void* o, void* m, void* l, int B, int hkv,
                                int G, int K, int D, int J, int page, float scale, int use_hfa,
                                int bf16, int kv, const void* lut, void* stream) {
  const Params p = make_params(q, k, v, ks, vs, pt, seq_lens, chunk_lens, o, m, l, G * K, K, J,
                               page, hkv, 2, scale);
  return launch(p, B, D, use_hfa, bf16, kv, lut, stream);
}

// The rail device functions as compiled in this source (hfa_rail.cuh),
// elementwise: rail = quant_rail(x), pexp = exp2_hfa_rail(rail),
// recip = recip_logdiv(x).
extern "C" int hfa_rail_eval(const void* x, void* rail, void* pexp, void* recip, int n,
                             const void* lut_host, void* stream) {
  return rail_eval(x, rail, pexp, recip, n, lut_host, stream);
}
