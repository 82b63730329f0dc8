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
// ...}.  Everything is f32 (pools are read as bf16 or f32 and widened), p
// included, as in the Pallas kernel.
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
//   * page 17-64: the tile is the page (NCH = 4 chunks of 16 keys, K and
//     V of 64 keys in dynamic shared memory: 66 KB at d 128).  Each lane
//     forms its chunks' scores, 16 keys at a time, into registers; the
//     page's max is taken over all of them before any p.
// A larger page on the H-FA rail is refused (kernels/cuda_lib.py says so
// before the launch).
//
// What bounds it: the bytes of the live K/V pages (every page is read
// once per 16-row tile, once per block from device memory and the rest
// from L2).  It uses CUDA cores, plain loads and no split of the page
// walk across blocks.  Decode, verify with at most 16 rows a (slot, kv
// head) and bf16 prefill at page 16 run the redesigned kernels of
// paged_attention_tc.cu (paged_decode_fwd_v2, paged_verify_fwd_v2,
// paged_prefill_fwd_tc); this body stays for verify with more rows, for
// prefill with f32 pools, d 32 / 96 or other page sizes, and for decode
// and verify on the H-FA rail at a page size other than 16 (the rules are
// in kernels/cuda_lib.py), and paged_decode_fwd for the checks.  D is
// 32, 64, 96 or 128.  The scale is one rounded multiply and l and acc are
// updated with explicit FMAs, so the v2 decode and verify, which repeat
// this order, are bit-equal to it.
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
constexpr int kHfaMaxPage = 64;                   // the H-FA rail's largest page (4 chunks)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;                   // two row pairs
constexpr int kRowsPerBlock = kWarps * kRowsPerWarp;

struct Params {
  const void* q;      // (B, Hkv, R, D), compute dtype
  const void* k;      // (P, page, Hkv, D)
  const void* v;      // (P, page, Hkv, D)
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

// ----------------------------------------------------------------- kernel
// Keys of one tile: the rescale step (see the header).
__host__ __device__ inline int tile_keys(int page, bool hfa) {
  if (!hfa || page == kTile) return kTile;
  return page < kTile ? page * (kTile / page) : page;
}

// Dynamic shared memory of a launch: K (odd stride) and V of one tile.
template <int D>
constexpr int kv_smem_bytes(int nch) {
  return kTile * nch * ((D + 1) + D) * (int)sizeof(float);
}

// NCH: 16-key chunks a tile holds (1, or 4 for H-FA pages of 17-64 keys).
template <typename T, int D, bool HFA, int NCH>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const Params p, const Lut lut) {
  constexpr int DK = D + 1;    // odd stride: the 16 score lanes hit 16 banks
  constexpr int DQ = D + 16;   // the two rows of a pair sit 16 banks apart
  constexpr int VPL = D / 16;  // accumulator columns per lane per row
  constexpr int TK = kTile * NCH;
  __shared__ float q_s[kRowsPerBlock][DQ];
  extern __shared__ float kv_s[];
  float (*k_s)[DK] = reinterpret_cast<float (*)[DK]>(kv_s);
  float (*v_s)[D] = reinterpret_cast<float (*)[D]>(kv_s + TK * DK);

  const int b = blockIdx.z;
  const int h = blockIdx.y;
  const int row0 = blockIdx.x * kRowsPerBlock;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int half = lane >> 4;
  const int kk = lane & 15;
  // Keys a tile holds, and keys a rescale takes (the page on the H-FA
  // rail below 16; the tile otherwise).
  const int tk = tile_keys(p.page, HFA);
  const int gs = (HFA && p.page < kTile) ? p.page : tk;

  const int a = p.lens_a[b];
  int base, limit;
  if (p.mode == 0) {
    base = a - 1; limit = a;
  } else if (p.mode == 1) {
    base = a; limit = p.lens_b[b];
  } else {
    base = a; limit = a + p.lens_b[b];
  }
  // Furthest position any row of this block can see, within the table.
  const int last_row = min(row0 + kRowsPerBlock, p.R) - 1;
  const int max_l = (last_row / p.L != row0 / p.L) ? p.L - 1 : last_row % p.L;
  const int n_kv = max(0, min(min(base + max_l + 1, limit), p.J * p.page));

  const size_t bh = (size_t)b * p.hkv + h;
  const T* q = static_cast<const T*>(p.q) + bh * p.R * D;
  for (int idx = tid * 4; idx < kRowsPerBlock * D; idx += kThreads * 4) {
    const int r = idx / D, c = idx % D;
    float t4[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < p.R) Load4<T>::run(q + (size_t)(row0 + r) * D + c, t4);
#pragma unroll
    for (int i = 0; i < 4; ++i) q_s[r][c + i] = t4[i];
  }

  float m_run[2], l_run[2], acc[2][VPL];
  int qpos[2], rloc[2];
  bool rvalid[2];
#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    rloc[pr] = warp * kRowsPerWarp + pr * 2 + half;
    const int row = row0 + rloc[pr];
    rvalid[pr] = row < p.R;
    qpos[pr] = base + row % p.L;
    m_run[pr] = kNegInf;
    l_run[pr] = 0.f;
#pragma unroll
    for (int c = 0; c < VPL; ++c) acc[pr][c] = 0.f;
  }

  const T* kpool = static_cast<const T*>(p.k);
  const T* vpool = static_cast<const T*>(p.v);
  const int* ptb = p.pt + (size_t)b * p.J;
  for (int t0 = 0; t0 < n_kv; t0 += tk) {
    __syncthreads();  // the previous tile is consumed (and q_s written)
    for (int idx = tid * 4; idx < tk * D; idx += kThreads * 4) {
      const int r = idx / D, c = idx % D;
      const int kv = t0 + r;
      float kt[4] = {0.f, 0.f, 0.f, 0.f}, vt[4] = {0.f, 0.f, 0.f, 0.f};
      if (kv < n_kv) {
        const int page_id = ptb[kv / p.page];
        const size_t off = (((size_t)page_id * p.page + kv % p.page) * p.hkv + h) * D + c;
        Load4<T>::run(kpool + off, kt);
        Load4<T>::run(vpool + off, vt);
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
      const float* qr = q_s[rloc[pr]];
      float s[NCH];
      bool vis[NCH];
#pragma unroll
      for (int ch = 0; ch < NCH; ++ch) {
        const int jj = ch * kTile + kk;  // key of the tile this lane scores
        const int kv = t0 + jj;
        vis[ch] = rvalid[pr] && jj < tk && kv < n_kv && kv <= qpos[pr] && kv < limit;
        const float* kr = k_s[jj];
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 8
        for (int i = 0; i < D; i += 4) {
          d0 = fmaf(qr[i], kr[i], d0);
          d1 = fmaf(qr[i + 1], kr[i + 1], d1);
          d2 = fmaf(qr[i + 2], kr[i + 2], d2);
          d3 = fmaf(qr[i + 3], kr[i + 3], d3);
        }
        s[ch] = vis[ch] ? __fmul_rn((d0 + d1) + (d2 + d3), p.scale) : kNegInf;
      }
      // One online update per group of gs keys (a page on the H-FA rail
      // below 16; the whole tile otherwise), in key order.
      for (int g0 = 0; g0 < tk; g0 += gs) {
        bool mine[NCH];
        float mx = kNegInf;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          const int jj = ch * kTile + kk;
          mine[ch] = gs == tk || (jj >= g0 && jj < g0 + gs);
          mx = ch == 0 ? (mine[0] ? s[0] : kNegInf) : fmaxf(mx, mine[ch] ? s[ch] : kNegInf);
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        const float m_new = fmaxf(m_run[pr], mx);
        float alpha, pv[NCH];
        if (HFA) {
          alpha = exp2_hfa_rail(quant_rail(fminf(m_run[pr] - m_new, 0.f)), lut);
        } else {
          alpha = expf(fminf(m_run[pr] - m_new, 0.f));
        }
        float ps = 0.f;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
          pv[ch] = HFA ? exp2_hfa_rail(quant_rail(s[ch] - m_new), lut) : expf(s[ch] - m_new);
          pv[ch] = (vis[ch] && mine[ch] && m_new != kNegInf) ? pv[ch] : 0.f;
          ps = ch == 0 ? pv[0] : ps + pv[ch];
        }
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          ps += __shfl_xor_sync(0xffffffffu, ps, off);
        l_run[pr] = fmaf(l_run[pr], alpha, ps);
        float pvacc[VPL];
#pragma unroll
        for (int c = 0; c < VPL; ++c) pvacc[c] = 0.f;
#pragma unroll
        for (int ch = 0; ch < NCH; ++ch) {
#pragma unroll
          for (int j = 0; j < kTile; ++j) {
            const int jj = ch * kTile + j;
            if (jj < g0 || jj >= g0 + gs) continue;  // warp-uniform: another group's key
            const float pj = __shfl_sync(0xffffffffu, pv[ch], (half << 4) + j);
#pragma unroll
            for (int c = 0; c < VPL; ++c) pvacc[c] = fmaf(pj, v_s[jj][c * 16 + kk], pvacc[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < VPL; ++c) acc[pr][c] = fmaf(acc[pr][c], alpha, pvacc[c]);
        m_run[pr] = m_new;
      }
    }
  }

#pragma unroll
  for (int pr = 0; pr < 2; ++pr) {
    if (!rvalid[pr]) continue;
    const size_t orow = bh * p.R + row0 + rloc[pr];
#pragma unroll
    for (int c = 0; c < VPL; ++c) p.o[orow * D + c * 16 + kk] = acc[pr][c];
    if (kk == 0) {
      p.m[orow] = m_run[pr];
      p.l[orow] = l_run[pr];
    }
  }
}

template <typename T, int D, bool HFA, int NCH>
void launch_t(const Params& p, const Lut& lut, int B, cudaStream_t s) {
  const dim3 grid((p.R + kRowsPerBlock - 1) / kRowsPerBlock, p.hkv, B);
  const int smem = kv_smem_bytes<D>(NCH);
  auto kernel = paged_attention_kernel<T, D, HFA, NCH>;
  if (smem > 48 * 1024) cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  kernel<<<grid, kThreads, smem, s>>>(p, lut);
}

template <typename T, int D>
void launch_rail(const Params& p, const Lut& lut, int B, int use_hfa, cudaStream_t s) {
  if (!use_hfa)
    launch_t<T, D, false, 1>(p, lut, B, s);
  else if (p.page <= kTile)
    launch_t<T, D, true, 1>(p, lut, B, s);
  else
    launch_t<T, D, true, kHfaMaxPage / kTile>(p, lut, B, s);
}

template <typename T>
void launch_d(const Params& p, const Lut& lut, int B, int D, int use_hfa, cudaStream_t s) {
  switch (D) {
    case 32: launch_rail<T, 32>(p, lut, B, use_hfa, s); break;
    case 64: launch_rail<T, 64>(p, lut, B, use_hfa, s); break;
    case 96: launch_rail<T, 96>(p, lut, B, use_hfa, s); break;
    default: launch_rail<T, 128>(p, lut, B, use_hfa, s); break;
  }
}

int launch(const Params& p, int B, int D, int use_hfa, int bf16, const void* lut_host,
           void* stream) {
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B <= 0 || p.R <= 0 || p.L <= 0 || p.J <= 0 || p.page <= 0 || p.hkv <= 0 ||
      (D != 32 && D != 64 && D != 96 && D != 128) || (use_hfa && p.page > kHfaMaxPage))
    return (int)cudaErrorInvalidValue;
  if (bf16) launch_d<__nv_bfloat16>(p, lut, B, D, use_hfa, s);
  else launch_d<float>(p, lut, B, D, use_hfa, s);
  return (int)cudaGetLastError();
}

Params make_params(const void* q, const void* k, const void* v, const void* pt,
                   const void* lens_a, const void* lens_b, void* o, void* m, void* l,
                   int R, int L, int J, int page, int hkv, int mode, float scale) {
  Params p;
  p.q = q; p.k = k; p.v = v;
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
extern "C" int paged_decode_fwd(const void* q, const void* k, const void* v, const void* pt,
                                const void* kv_lens, void* o, void* m, void* l, int B,
                                int hkv, int G, int D, int J, int page, float scale,
                                int use_hfa, int bf16, const void* lut, void* stream) {
  const Params p = make_params(q, k, v, pt, kv_lens, nullptr, o, m, l, G, 1, J, page, hkv, 0,
                               scale);
  return launch(p, B, D, use_hfa, bf16, lut, stream);
}

extern "C" int paged_prefill_fwd(const void* q, const void* k, const void* v, const void* pt,
                                 const void* start_pos, const void* kv_lens, void* o, void* m,
                                 void* l, int B, int hkv, int G, int L, int D, int J, int page,
                                 float scale, int use_hfa, int bf16, const void* lut,
                                 void* stream) {
  const Params p = make_params(q, k, v, pt, start_pos, kv_lens, o, m, l, G * L, L, J, page,
                               hkv, 1, scale);
  return launch(p, B, D, use_hfa, bf16, lut, stream);
}

extern "C" int paged_verify_fwd(const void* q, const void* k, const void* v, const void* pt,
                                const void* seq_lens, const void* chunk_lens, void* o, void* m,
                                void* l, int B, int hkv, int G, int K, int D, int J, int page,
                                float scale, int use_hfa, int bf16, const void* lut,
                                void* stream) {
  const Params p = make_params(q, k, v, pt, seq_lens, chunk_lens, o, m, l, G * K, K, J, page,
                               hkv, 2, scale);
  return launch(p, B, D, use_hfa, bf16, lut, stream);
}

// The rail device functions as compiled in this source (hfa_rail.cuh),
// elementwise: rail = quant_rail(x), pexp = exp2_hfa_rail(rail),
// recip = recip_logdiv(x).
extern "C" int hfa_rail_eval(const void* x, void* rail, void* pexp, void* recip, int n,
                             const void* lut_host, void* stream) {
  return rail_eval(x, rail, pexp, recip, n, lut_host, stream);
}
