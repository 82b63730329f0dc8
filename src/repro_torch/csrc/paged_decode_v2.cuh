// The v2 paged decode and verify (paged_decode_v2_kernel), shared by the
// two sources that instantiate it: paged_attention_tc.cu (pools in q's
// dtype or bf16 pools under an f32 q, and the entry points
// paged_decode_fwd_v2 / paged_verify_fwd_v2) and paged_decode_v2_codec.cu
// (int8 pools under a bf16 or f32 q: launch_dc_codec), compiled in
// parallel.  The design and the arithmetic order are described in
// paged_attention_tc.cu.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "hfa_rail.cuh"

// Decode and verify, one body.  Row r of a (slot b, kv head h) - the
// flattened (G, L) block, kv-head major - sits at local position r % L
// and sees KV positions kv <= base + r % L and kv < limit:
//   decode (L = 1, lens_b null): base = lens_a - 1, limit = lens_a
//   verify (L = K):              base = lens_a, limit = lens_a + lens_b
struct DcParams {
  const void* q;        // (B, Hkv, R, D), TQ
  const void* k;        // (P, page, Hkv, D), TKV
  const void* v;
  const float* ks;      // (P, page, Hkv) row scales of int8 pools, else null
  const float* vs;
  const int* pt;        // (B, J)
  const int* lens_a;    // (B,) decode: kv_lens; verify: seq_lens
  const int* lens_b;    // (B,) verify: chunk_lens; null for decode
  float* o;             // (B, Hkv, R, D)
  float* m;             // (B, Hkv, R)
  float* l;
  float* ws;            // (B Hkv, splits, R, D + 2) run triplets, splits > 1
  unsigned* counters;   // (B Hkv row_blocks) runs finished, 0 between launches
  int R, L, RB, J, page, hkv, splits;   // RB: rows a block (R / row_blocks)
  float scale;
};

// The v2 walk of int8 pools (paged_decode_v2_codec.cu), q bf16 if bf16
// else f32.
int launch_dc_codec(const DcParams& p, const Lut& lut, int B, int D, int use_hfa, int bf16,
                    cudaStream_t s);

namespace {

// ================================================================= decode
constexpr int kDcTile = 16;                    // keys per tile: the rescale step
constexpr int kDcMaxRows = 16;                 // query rows a block
constexpr int kDcSmallRows = 4;                // rows the register-rich variant takes

constexpr int kDcRing = 2;                     // steps in the cp.async ring

// TILES: 16-key tiles a compute step takes; RPT: rows a thread takes.  A
// block has 16 TILES ceil(RB / RPT) threads: TILES 4 for the split walk
// (whose blocks share an SM), 8 for the unsplit bf16 walk at RB <= 2 (one
// block an SM: twice the keys in flight and twice the warps to hide the
// step's latency); RPT 2 above 4 rows on the FA-2 rail, so that each key
// chunk and each V pair read from shared memory serves two rows, and on
// the H-FA rail, whose longer rail per score wants the warps more, 1 up
// to 8 rows and 2 above (the variants dc_rpt1 and dc_hfa_rpt2 of
// paged_tc_variants.py, and PERF.md, have the times).
template <typename T, int D, int TILES, int RPT>
struct DcLayout {
  static constexpr int kRow = D * (int)sizeof(T) + 16;     // padded smem row, bytes
  static constexpr int kTileBytes = kDcTile * kRow;
  static constexpr int kStep = kDcTile * TILES;            // keys a step
  static constexpr int kRingBytes = kDcRing * TILES * kTileBytes;   // K or V
  static constexpr int kChunks = D * (int)sizeof(T) / 16;  // 16-byte copies per key row
  // int8 rows: the K and V row scales of the ring's keys, f32.
  static constexpr bool kScaled = sizeof(T) == 1;
  static constexpr int kScaleBytes = kScaled ? kDcRing * kStep * 4 : 0;   // K or V
  __host__ __device__ static constexpr int rows(int rb) { return (rb + RPT - 1) / RPT * RPT; }
  // K ring, V ring, q (f32), p (f32), per (row, tile) max, alpha, sum,
  // then the K and V scale rings.
  static constexpr int bytes(int rb) {
    return 2 * kRingBytes + rows(rb) * D * 4 + rows(rb) * kStep * 4 +
           3 * rows(rb) * TILES * 4 + 2 * kScaleBytes;
  }
};

// MAXT: the block size the registers are budgeted for - 256 threads (up
// to 255 registers a thread) for RB <= 4, 512 (up to 128) for more rows.
template <typename TQ, typename T, int D, bool HFA, int MAXT, int TILES, int RPT>
__global__ void __launch_bounds__(MAXT) paged_decode_v2_kernel(const DcParams p, const Lut lut) {
  using Lay = DcLayout<T, D, TILES, RPT>;
  constexpr int kDcStep = Lay::kStep;
  constexpr int VPE = 16 / (int)sizeof(T);       // values per 16-byte load
  constexpr int kRowT = Lay::kRow / (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t dc_smem[];
  uint8_t* k_ring = dc_smem;
  uint8_t* v_ring = k_ring + Lay::kRingBytes;
  const int rows = Lay::rows(p.RB);
  float* q_s = reinterpret_cast<float*>(v_ring + Lay::kRingBytes);   // [rows][D]
  float* p_s = q_s + rows * D;                   // [rows][16 TILES]
  float* tmax = p_s + rows * kDcStep;            // [rows][TILES]
  float* talpha = tmax + rows * TILES;           // [rows][TILES]
  float* tsum = talpha + rows * TILES;           // [rows][TILES]
  float* ksc = tsum + rows * TILES;              // [kDcRing][kStep] int8 K row scales
  float* vsc = ksc + Lay::kScaleBytes / 4;       // [kDcRing][kStep] V

  const int sp = blockIdx.x % p.splits, rb = blockIdx.x / p.splits;
  const int h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, nthreads = blockDim.x;
  // Thread (rows r0 .. r0 + RPT - 1 of the block, key kk of the step); in
  // P V it owns the output column pair 2 kk, 2 kk + 1 of those rows.
  const int r0 = tid / kDcStep * RPT, kk = tid % kDcStep;
  const int tj = kk / kDcTile, lane16 = kk % kDcTile;
  const bool owner = 2 * kk < D;
  const size_t bh = (size_t)b * p.hkv + h;
  const int row0 = rb * p.RB;                    // first row of the block

  const int a = p.lens_a[b];
  const int base = p.lens_b == nullptr ? a - 1 : a;
  const int limit = p.lens_b == nullptr ? a : a + p.lens_b[b];
  bool valid[RPT];
  int qpos[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    valid[i] = r0 + i < p.RB;
    qpos[i] = base + (row0 + r0 + i) % p.L;
  }
  // The furthest position a row of this block sees bounds the walk.
  const int last = row0 + p.RB - 1;
  const int max_l = (last / p.L != row0 / p.L) ? p.L - 1 : last % p.L;
  const int n_kv = max(0, min(min(base + max_l + 1, limit), p.J * p.page));
  const int n_tiles = (n_kv + kDcTile - 1) / kDcTile;
  const int per = (n_tiles + p.splits - 1) / p.splits;
  const int t_begin = min(sp * per, n_tiles), t_end = min(t_begin + per, n_tiles);
  const int n_steps = (t_end - t_begin + TILES - 1) / TILES;

  const TQ* qg = static_cast<const TQ*>(p.q) + (bh * p.R + row0) * D;
  for (int i = tid; i < rows * D; i += nthreads) q_s[i] = i < p.RB * D ? dc_f32(qg[i]) : 0.f;

  const T* kpool = static_cast<const T*>(p.k);
  const T* vpool = static_cast<const T*>(p.v);
  const int* ptb = p.pt + (size_t)b * p.J;
  const uint32_t k_base = dc_smem_addr(k_ring), v_base = dc_smem_addr(v_ring);
  const uint32_t ks_base = dc_smem_addr(ksc), vs_base = dc_smem_addr(vsc);
  // cp.async of the tiles of step st into ring slot st % kDcRing (and of
  // int8 rows' scales into the scale rings); keys at or past n_kv are
  // zero-filled (their p is 0, and 0 * 0 adds nothing).
  auto load_step = [&](int st) {
    const int tile0 = t_begin + st * TILES;
    const int nt = min(TILES, t_end - tile0);
    const uint32_t slot = (uint32_t)(st % kDcRing) * TILES * Lay::kTileBytes;
    for (int idx = tid; idx < nt * kDcTile * Lay::kChunks; idx += nthreads) {
      const int key = idx / Lay::kChunks, c = idx % Lay::kChunks;
      const int kv = tile0 * kDcTile + key;
      const bool live = kv < n_kv;
      const size_t prow = live ? (size_t)ptb[kv / p.page] * p.page + kv % p.page : 0;
      const size_t off = (prow * p.hkv + h) * D + c * VPE;
      const uint32_t dst = slot + key * Lay::kRow + c * 16;
      cp_async16(k_base + dst, kpool + off, live ? 16 : 0);
      cp_async16(v_base + dst, vpool + off, live ? 16 : 0);
      if (Lay::kScaled && c == 0) {
        const uint32_t sdst = ((uint32_t)(st % kDcRing) * kDcStep + key) * 4;
        const size_t srow = prow * p.hkv + h;
        cp_async4(ks_base + sdst, p.ks + srow, live ? 4 : 0);
        cp_async4(vs_base + sdst, p.vs + srow, live ? 4 : 0);
      }
    }
  };

  float m_run[RPT], l_run[RPT], acc[RPT][2];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m_run[i] = kNegInf;
    l_run[i] = 0.f;
    acc[i][0] = acc[i][1] = 0.f;
  }
  __syncthreads();   // q_s written

#pragma unroll
  for (int st = 0; st < kDcRing - 1; ++st) {
    if (st < n_steps) load_step(st);
    cp_async_commit();
  }
  for (int st = 0; st < n_steps; ++st) {
    if (st + kDcRing - 1 < n_steps) load_step(st + kDcRing - 1);   // the slot step st-1 freed
    cp_async_commit();
    cp_async_wait<kDcRing - 1>();
    __syncthreads();   // step st has landed
    const int tile0 = t_begin + st * TILES;
    const int nt = min(TILES, t_end - tile0);
    const uint32_t slot = (uint32_t)(st % kDcRing) * TILES * Lay::kTileBytes;
    // Scores: thread (rows, kk) takes key kk of the step for each of its
    // rows, as the CUDA-core kernel's lane does (four interleaved chains
    // over D).
    const int kv = (tile0 + tj) * kDcTile + lane16;
    const bool key_live = tj < nt && kv < n_kv && kv < limit;
    float dot[RPT];
    const float* ks_step = ksc + (st % kDcRing) * kDcStep;
    const float* vs_step = vsc + (st % kDcRing) * kDcStep;
    dc_dots<T, D, RPT>(q_s + r0 * D, D,
                       reinterpret_cast<const T*>(k_ring + slot + kk * Lay::kRow), dot,
                       Lay::kScaled ? ks_step[kk] : 1.f);
    float s[RPT];
    bool vis[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      vis[i] = valid[i] && key_live && kv <= qpos[i];
      s[i] = vis[i] ? __fmul_rn(dot[i], p.scale) : kNegInf;
      float mx = s[i];
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane16 == 0) tmax[(r0 + i) * TILES + tj] = mx;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = r0 + i;
      // The row's running max through the step's tiles, in order; this
      // thread's tile takes m before it and m_new after it.
      float m_prev = m_run[i], m_new = m_run[i];
      for (int j = 0; j < nt; ++j) {
        m_prev = m_new;
        m_new = fmaxf(m_prev, tmax[r * TILES + j]);
        if (j == tj) break;
      }
      float alpha, pv;
      if (HFA) {
        alpha = exp2_hfa_rail(quant_rail(fminf(m_prev - m_new, 0.f)), lut);
        pv = exp2_hfa_rail(quant_rail(s[i] - m_new), lut);
      } else {
        alpha = expf(fminf(m_prev - m_new, 0.f));
        pv = expf(s[i] - m_new);
      }
      pv = (vis[i] && m_new != kNegInf) ? pv : 0.f;
      float ps = pv;
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, off);
      p_s[r * kDcStep + kk] = pv;
      if (lane16 == 0 && tj < nt) {
        talpha[r * TILES + tj] = alpha;
        tsum[r * TILES + tj] = ps;
      }
    }
    __syncthreads();
    // Each tile's sum_k p v (an fmaf chain over its 16 keys; the tiles'
    // chains are independent), then tile by tile acc = acc alpha_j + that
    // sum, l = l alpha_j + sum p; m after the step's last tile.  A V pair
    // read once serves every row of the thread, four keys' p at a time.
    float pvacc[TILES][RPT][2];
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) pvacc[j][i][0] = pvacc[j][i][1] = 0.f;
      if (owner && j < nt) {
        const T* vt = reinterpret_cast<const T*>(v_ring + slot + j * Lay::kTileBytes) + 2 * kk;
#pragma unroll
        for (int k4 = 0; k4 < kDcTile; k4 += 4) {
          float4 p4[RPT];
#pragma unroll
          for (int i = 0; i < RPT; ++i)
            p4[i] = *reinterpret_cast<const float4*>(p_s + (r0 + i) * kDcStep + j * kDcTile + k4);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 vv = dc_pair(vt + (k4 + u) * kRowT,
                                      Lay::kScaled ? vs_step[j * kDcTile + k4 + u] : 1.f);
#pragma unroll
            for (int i = 0; i < RPT; ++i) {
              const float pk = u == 0 ? p4[i].x : u == 1 ? p4[i].y : u == 2 ? p4[i].z : p4[i].w;
              pvacc[j][i][0] = fmaf(pk, vv.x, pvacc[j][i][0]);
              pvacc[j][i][1] = fmaf(pk, vv.y, pvacc[j][i][1]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < TILES; ++j) {
      if (j >= nt) break;
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = r0 + i;
        const float al = talpha[r * TILES + j];
        acc[i][0] = fmaf(acc[i][0], al, pvacc[j][i][0]);
        acc[i][1] = fmaf(acc[i][1], al, pvacc[j][i][1]);
        l_run[i] = fmaf(l_run[i], al, tsum[r * TILES + j]);
        m_run[i] = fmaxf(m_run[i], tmax[r * TILES + j]);
      }
    }
    __syncthreads();   // step st consumed before its slot is refilled
  }
  cp_async_wait<0>();

  const int cols[2] = {owner ? 2 * kk : -1, owner ? 2 * kk + 1 : -1};
  const size_t stride = (size_t)p.R * (D + 2);
  if (p.splits == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (!valid[i]) continue;
      const size_t orow = bh * p.R + row0 + r0 + i;
      if (owner) *reinterpret_cast<float2*>(p.o + orow * D + 2 * kk) = make_float2(acc[i][0], acc[i][1]);
      if (kk == 0) {
        p.m[orow] = m_run[i];
        p.l[orow] = l_run[i];
      }
    }
    return;
  }
  // Split walk: this block's triplets to the workspace; the last block of
  // the (slot, kv head, row block) merges all of them.
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!valid[i]) continue;
    float* wsr = p.ws + (bh * p.splits + sp) * stride + (size_t)(row0 + r0 + i) * (D + 2);
    if (owner) {
      wsr[2 * kk] = acc[i][0];
      wsr[2 * kk + 1] = acc[i][1];
    }
    if (kk == 0) {
      wsr[D] = m_run[i];
      wsr[D + 1] = l_run[i];
    }
  }
  if (!dc_last_run(&p.counters[bh * (p.R / p.RB) + rb], p.splits)) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!valid[i]) continue;
    const size_t row = row0 + r0 + i, orow = bh * p.R + row;
    float mm, ll, oo[2];
    dc_merge(p.ws + bh * p.splits * stride + row * (D + 2), stride, p.splits, D, cols, mm, ll,
             oo);
    if (owner) *reinterpret_cast<float2*>(p.o + orow * D + 2 * kk) = make_float2(oo[0], oo[1]);
    if (kk == 0) {
      p.m[orow] = mm;
      p.l[orow] = ll;
    }
  }
}

template <typename TQ, typename T, int D, bool HFA, int MAXT, int TILES, int RPT>
int launch_dc(const DcParams& p, const Lut& lut, int B, cudaStream_t s) {
  using Lay = DcLayout<T, D, TILES, RPT>;
  auto kernel = paged_decode_v2_kernel<TQ, T, D, HFA, MAXT, TILES, RPT>;
  static bool ready = false;   // the shared-memory attribute is set
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Lay::bytes(MAXT / Lay::kStep * RPT));
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const int threads = Lay::kStep * ((p.RB + RPT - 1) / RPT);
  kernel<<<dim3(p.splits * (p.R / p.RB), p.hkv, B), threads, Lay::bytes(p.RB), s>>>(p, lut);
  return (int)cudaGetLastError();
}

template <typename TQ, typename T, int D>
int launch_dc_rail(const DcParams& p, const Lut& lut, int B, int use_hfa, cudaStream_t s) {
  constexpr int kSmall = 64 * kDcSmallRows, kWide = 64 * kDcMaxRows / 2;
  if (p.RB > kDcSmallRows) {
    if (!use_hfa) return launch_dc<TQ, T, D, false, kWide, 4, 2>(p, lut, B, s);
    return p.RB > kWide / 64 ? launch_dc<TQ, T, D, true, kWide, 4, 2>(p, lut, B, s)
                             : launch_dc<TQ, T, D, true, kWide, 4, 1>(p, lut, B, s);
  }
  // The unsplit bf16 or int8 walk at RB <= 2 takes 8-tile steps (f32
  // rows would not fit twice the ring).
  constexpr int kWideStep = sizeof(T) <= 2 ? 8 : 4;
  if (p.splits == 1 && p.RB <= 2)
    return use_hfa ? launch_dc<TQ, T, D, true, kSmall, kWideStep, 1>(p, lut, B, s)
                   : launch_dc<TQ, T, D, false, kSmall, kWideStep, 1>(p, lut, B, s);
  return use_hfa ? launch_dc<TQ, T, D, true, kSmall, 4, 1>(p, lut, B, s)
                 : launch_dc<TQ, T, D, false, kSmall, 4, 1>(p, lut, B, s);
}

template <typename TQ, typename T>
int launch_dc_d(const DcParams& p, const Lut& lut, int B, int D, int use_hfa, cudaStream_t s) {
  switch (D) {
    case 32: return launch_dc_rail<TQ, T, 32>(p, lut, B, use_hfa, s);
    case 64: return launch_dc_rail<TQ, T, 64>(p, lut, B, use_hfa, s);
    case 96: return launch_dc_rail<TQ, T, 96>(p, lut, B, use_hfa, s);
    default: return launch_dc_rail<TQ, T, 128>(p, lut, B, use_hfa, s);
  }
}

static_assert(DcLayout<float, 128, 4, 2>::bytes(kDcMaxRows) <= 232448, "227 KB a block");
static_assert(DcLayout<__nv_bfloat16, 128, 8, 1>::bytes(2) <= 232448, "227 KB a block");

// The v2 walk of decode (lens_b null, L 1) or verify: checks, then launch.

}  // namespace
