// Dense attention forward on Hopper's tensor cores (sm_90a), both rails,
// for bf16 inputs over (BH, L, D) slabs.
//
// Replaces two Pallas TPU kernels of the reference package:
//   src/repro/kernels/fa2.py  _fa2_kernel  -> dense_attn_fwd_tc (fa2 rail)
//   src/repro/kernels/hfa.py  _hfa_kernel  -> dense_attn_fwd_tc (H-FA rail)
// It computes what dense_attn_fwd (dense_attention.cu) computes, which
// now takes f32 inputs only: the same masks (key j visible to query row
// i when j < kv_len, j < Lkv and, if causal, j <= i + q_offset), the
// same 128-key tiles from key 0 with tiles past kv_len or above the
// diagonal skipped, the H-FA row max over exactly those tiles, the score
// rounded to bf16 after the scale (__float2bfloat16_rn), alpha and p
// through quant_rail -> exp2_hfa_rail and the recip_logdiv finalize
// (hfa_rail.cuh); on the FA-2 rail expf, the divide and LSE = m + ln l.
// Dead rows give O = 0, LSE = NEG_INF (fa2) and recip 0 (hfa).
//
// What bounds it on this card.  At the training shape (BH 64, L 2048,
// D 128, causal) the two products are 4 BH L^2 D / 2 = 6.9e10 flops:
// 0.07 ms at the bf16 tensor-core peak, against 100 MB of inputs (0.03
// ms), so the products bound the FA-2 rail (which runs P V twice, on
// the hi and lo halves of p).  The H-FA rail adds its rail arithmetic on
// the CUDA cores for each of the 1.3e8 visible scores: 59 instructions
// in the select-chain form of hfa_rail.cuh (0.24 ms at 33.5e12
// instructions/s), 20 in the integer form this kernel runs
// (quant_rail_int, exp2_hfa_rail_tab: one conflict-free table load from
// shared memory, the float packed from its bits; bit for bit the same
// values), 0.08 ms, which then bounds it.
//
// Design.  One block per (bh, 128 query rows), launched longest causal
// rows first (grid.x = BH, grid.y = query tiles in reverse): two
// warpgroups of 64 query rows each, 256 threads, one block per SM.
// Loads are TMA (tensor maps over (BH, L, D) bf16 with 128-byte swizzle;
// rows past L arrive as zeros): Q (128 x D) once, K and V tiles (128
// keys x D) through a 3-stage ring guarded by mbarriers (at D 128: 32 KB
// Q + 192 KB ring).  Thread 0 fills the ring at the start; after that
// the last of the 8 warps to finish with a stage refills it, so no
// thread waits to issue a load.  There is no producer warp: a ninth warp
// puts three warps on one of the SM's four register files (16 K
// registers each) and caps every thread at 168 registers, and ptxas
// allocates no more than that after setmaxnreg.inc; this kernel needs
// more (S and O accumulators, 64 floats each at D 128, and P; ptxas
// uses 253-255 with no spills), which 8 warps allow.  Per tile i a
// warpgroup runs
//   S_i = Q K_i^T      wgmma m64n128k16, Q and K from shared memory
//                      (K-major), issued beside
//   O += P_{i-1} V_{i-1}  wgmma m64nDk16, P in registers as bf16, V
//                      from shared memory (MN-major);
//   the rail of S_i    on the accumulator fragment in registers (each
//                      thread holds 2 rows x 32 keys; row max and sum
//                      are quad shuffles) while that P V runs;
//   O *= alpha_i       once the P V is done.
// O sees the same operations in the same order as a tile-at-a-time loop
// (FA3's intra-warpgroup overlap).  The two warpgroups take turns to
// issue their wgmmas (ping-pong on named barriers), so that one's rail
// runs beside the other's products.
// A bf16 x bf16 product is exact in f32, so S holds the same products as
// the f32 kernel, summed in another order.  On the H-FA rail every p is
// g7/128 * 2^-k with g7 an integer in [64, 128] (at most 7 significant
// bits), so bf16 P is exact and P V differs from the f32 kernel only in
// summation order.  On the FA-2 rail p = exp(s - m) is a full f32 value:
// it is split into hi = bf16(p) and lo = bf16(p - hi) and both go through
// the tensor cores against the same V tile (the residual is below 2^-16
// of p).  l is summed in f32 from the unsplit p.  The tensor maps are
// encoded on the host with cuTensorMapEncodeTiled, taken from the driver
// through cudaGetDriverEntryPoint(ByVersion), so the library links no
// -lcuda.
//
// A scores-out instantiation (H-FA only) also writes each score it forms
// - after the scale and the bf16 rounding - to a (BH, Lq, Lkv) bf16
// buffer; only the checks launch it.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hfa_rail.cuh"
#include "tc_common.cuh"

namespace {

constexpr int kTcRows = 128;     // query rows per block: two warpgroups of 64
constexpr int kTcTile = 128;     // keys per tile: the reference's block_kv
constexpr int kTcStages = 3;     // depth of the K/V ring
constexpr int kTcThreads = 256;  // two warpgroups

struct TcParams {
  float* o;                // (BH, Lq, D)
  float* lse;              // (BH, Lq), fa2 rail
  __nv_bfloat16* scores;   // (BH, Lq, Lkv), scores-out variant
  int Lq, Lkv, kv_lim, q_offset, causal, n_qtiles;
  float scale;
};

template <int D>
__host__ __device__ constexpr int tc_tile_bytes() { return kTcTile * D * 2; }
// 1024 bytes of slack to align the tiles for the 128-byte swizzle, Q,
// the K and V rings, then TcBarriers.  At D 128: 225 KB of the 227 a
// block may use.
template <int D>
__host__ __device__ constexpr int tc_smem_bytes() {
  return 1024 + kTcRows * D * 2 + 2 * kTcStages * tc_tile_bytes<D>() + 256;
}

// Per-block state in shared memory after Q and the K/V ring.
struct TcBarriers {
  uint64_t full_q;
  uint64_t full_k[kTcStages], full_v[kTcStages];
  int released[kTcStages];   // warps done with the tile a stage holds
  unsigned tab[32];          // PWL g7 table of exp2_hfa_rail_tab
};
static_assert(sizeof(TcBarriers) <= 256, "tc_smem_bytes reserves 256 bytes for TcBarriers");
static_assert(tc_smem_bytes<128>() <= 232448, "a block may use 227 KB of shared memory");

// Issue the TMA loads of tile `tile` (K and V, 128 keys) into ring stage s.
template <int D>
__device__ __forceinline__ void load_tile(uint8_t* k_s, uint8_t* v_s, TcBarriers* bar,
                                          const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                          int tile, int bh) {
  constexpr uint32_t kTile = tc_tile_bytes<D>(), kHalf = kTcTile * 128;
  const int s = tile % kTcStages;
  mbar_expect_tx(&bar->full_k[s], kTile);
  for (int h = 0; h < D / kSwzCols; ++h)
    tma_load(k_s + s * kTile + h * kHalf, tm_k, &bar->full_k[s], h * kSwzCols, tile * kTcTile, bh);
  mbar_expect_tx(&bar->full_v[s], kTile);
  for (int h = 0; h < D / kSwzCols; ++h)
    tma_load(v_s + s * kTile + h * kHalf, tm_v, &bar->full_v[s], h * kSwzCols, tile * kTcTile, bh);
}

// One tile's rail on the S accumulator fragment (64 scores per thread),
// in place: scale, bf16 rounding (H-FA), masks, row max over the tile,
// alpha, p (left in sc as f32) and l.
//
// Accumulator fragment of wgmma m64nN (f32): thread (warp w, lane 4g + t)
// holds, for each 8-column block nb, element e at row 16 w + g + 8 (e / 2),
// column 8 nb + 2 t + (e % 2).  Elements 2 kc .. 2 kc + 1 of S, read in
// that order, are the register A fragment of keys 16 kc .. 16 kc + 15.
template <bool HFA, bool SOUT>
__device__ __forceinline__ void rail_tile(float (&sc)[64], float (&m)[2], float (&l)[2],
                                          float (&alpha)[2], const TcParams& p,
                                          const unsigned* tab, int bh, int t0, int row0, int t,
                                          const int (&qpos)[2], bool full) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int h = (e / 2) % 2, col = 8 * (e / 4) + 2 * t + (e % 2);
    float x = __fmul_rn(sc[e], p.scale);
    if (HFA) x = __bfloat162float(__float2bfloat16_rn(x));   // BF16 score datapath
    if (SOUT) {
      const int row = row0 + 8 * h;
      if (row < p.Lq && t0 + col < p.Lkv)
        p.scores[((size_t)bh * p.Lq + row) * p.Lkv + t0 + col] = __float2bfloat16_rn(x);
    }
    if (!full) {
      const int kv = t0 + col;
      if (!(kv < p.kv_lim && (!p.causal || kv <= qpos[h]))) x = kNegInf;
    }
    sc[e] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float m_new[2], ps[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m_new[h] = fmaxf(m[h], quad_max(mx[h]));
    alpha[h] = HFA ? exp2_hfa_rail_tab(quant_rail_int(fminf(m[h] - m_new[h], 0.f)), tab)
                   : expf(fminf(m[h] - m_new[h], 0.f));
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int h = (e / 2) % 2, kv = t0 + 8 * (e / 4) + 2 * t + (e % 2);
    const float x = HFA ? exp2_hfa_rail_tab(quant_rail_int(sc[e] - m_new[h]), tab)
                        : expf(sc[e] - m_new[h]);
    const bool vis = full || (kv < p.kv_lim && (!p.causal || kv <= qpos[h]));
    sc[e] = (vis && m_new[h] != kNegInf) ? x : 0.f;
    ps[h] += sc[e];
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {   // two roundings, as the plain version (no FMA)
    l[h] = __fadd_rn(__fmul_rn(l[h], alpha[h]), quad_sum(ps[h]));
    m[h] = m_new[h];
  }
}

// p (f32, in the S fragment) packed pairwise into the register A
// fragments of the 8 key chunks: exact on the H-FA rail; hi + lo on the
// FA-2 rail.
template <bool HFA>
__device__ __forceinline__ void pack_p(const float (&sc)[64], uint32_t (&p_hi)[32],
                                       uint32_t (&p_lo)[HFA ? 1 : 32]) {
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    p_hi[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
    if constexpr (!HFA) {
      const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&p_hi[j]);
      p_lo[j] = pack_bf16(sc[2 * j] - __low2float(hb), sc[2 * j + 1] - __high2float(hb));
    }
  }
}

// S = Q K^T for one warpgroup's 64 rows against the tile in stage s.
template <int D>
__device__ __forceinline__ void issue_qk(float (&sc)[64], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * (kTcRows * 128) + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * (kTcTile * 128) + (kk % 4) * 32;
    wgmma_ss_m64n128(sc, sw128_desc(q_addr + off, 16, 1024), sw128_desc(k_addr + koff, 16, 1024),
                     kk > 0);
  }
}

// O += P V for the tile in stage s (V MN-major: 64-column halves 16 KB apart).
template <int D, bool HFA>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&p_hi)[32],
                                         const uint32_t (&p_lo)[HFA ? 1 : 32], uint32_t v_addr) {
#pragma unroll
  for (int kc = 0; kc < kTcTile / 16; ++kc) {
    const uint64_t db = sw128_desc(v_addr + kc * 16 * 128, kTcTile * 128, 1024);
    if constexpr (D == 128) {
      wgmma_rs_m64n128(o, &p_hi[4 * kc], db);
      if constexpr (!HFA) wgmma_rs_m64n128(o, &p_lo[4 * kc], db);
    } else {
      wgmma_rs_m64n64(o, &p_hi[4 * kc], db);
      if constexpr (!HFA) wgmma_rs_m64n64(o, &p_lo[4 * kc], db);
    }
  }
}

template <int D, bool HFA, bool SOUT>
__global__ void __launch_bounds__(kTcThreads, 1)
    dense_fwd_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, const TcParams p, const Lut lut) {
  constexpr uint32_t kTile = tc_tile_bytes<D>();
  constexpr int NO = D / 2;                      // O accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                            ~static_cast<uintptr_t>(1023));
  uint8_t* k_s = q_s + kTcRows * D * 2;
  uint8_t* v_s = k_s + kTcStages * kTile;
  TcBarriers* bar = reinterpret_cast<TcBarriers*>(v_s + kTcStages * kTile);

  const int bh = blockIdx.x;
  const int q0 = (p.n_qtiles - 1 - blockIdx.y) * kTcRows;   // longest causal rows first
  int end = p.kv_lim;
  if (p.causal) end = min(end, q0 + kTcRows + p.q_offset);
  const int n_tiles = end > 0 ? (end + kTcTile - 1) / kTcTile : 0;

  if (threadIdx.x < 32) bar->tab[threadIdx.x] = pwl_table_word(threadIdx.x, lut);
  if (threadIdx.x == 0) {
    mbar_init(&bar->full_q, 1);
    for (int s = 0; s < kTcStages; ++s) {
      mbar_init(&bar->full_k[s], 1);
      mbar_init(&bar->full_v[s], 1);
      bar->released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // Q, and the first tiles into the empty ring
    mbar_expect_tx(&bar->full_q, kTcRows * D * 2);
    for (int h = 0; h < D / kSwzCols; ++h)
      tma_load(q_s + h * (kTcRows * 128), &tm_q, &bar->full_q, h * kSwzCols, q0, bh);
    for (int i = 0; i < min(kTcStages, n_tiles); ++i)
      load_tile<D>(k_s, v_s, bar, &tm_k, &tm_v, i, bh);
  }

  const int cw = threadIdx.x / 128;              // warpgroup: rows 64 cw ..
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;   // elements 0, 1; +8 for 2, 3
  const int wg_q = q0 + cw * 64 + p.q_offset;    // causal position of the warpgroup's first row
  const int qpos[2] = {row0 + p.q_offset, row0 + 8 + p.q_offset};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[2], o[NO], sc[64];
  uint32_t p_hi[32], p_lo[HFA ? 1 : 32];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s) + cw * 64 * 128;
  // Every row of this warpgroup sees every key of the tile from t0?
  auto full_tile = [&](int t0) {
    return t0 + kTcTile <= p.kv_lim && (!p.causal || t0 + kTcTile - 1 <= wg_q);
  };
  // This warp is done with the tile in stage s; the last of the 8 warps
  // to get there refills the stage with tile `next`.
  auto release = [&](int s, int next) {
    if (lane == 0 && atomicAdd(&bar->released[s], 1) == 7) {
      bar->released[s] = 0;
      if (next < n_tiles) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load_tile<D>(k_s, v_s, bar, &tm_k, &tm_v, next, bh);
      }
    }
  };
  // Ping-pong: the warpgroups take turns to issue their wgmmas, so that
  // one's rail runs while the other's products do (named barrier 1 + w
  // is warpgroup w's turn).  Each takes n_tiles + 1 turns - the first
  // S, one per loop step, the last P V - warpgroup 0 first; warpgroup 1
  // signals after every turn but its last, so every barrier completes.
  auto turn = [&]() { named_sync(1 + cw); };
  auto pass_turn = [&](bool last) {
    if (!(last && cw == 1)) named_arrive(2 - cw);
  };
  if (cw == 1 && n_tiles > 0) named_arrive(1);
  mbar_wait(&bar->full_q, 0);

  // Software pipeline (FA3's intra-warpgroup overlap): S of tile i runs on
  // the tensor cores beside P V of tile i - 1, and the rail of tile i
  // beside that P V.  O sees the same operations in the same order as a
  // tile-at-a-time loop: += P_{i-1} V_{i-1}, *= alpha_i, += P_i V_i.
  if (n_tiles > 0) {
    mbar_wait(&bar->full_k[0], 0);
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] = 0.f;
    fence_regs(sc);
    turn();
    wgmma_fence();
    issue_qk<D>(sc, q_addr, smem_u32(k_s));
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<0>();
    fence_regs(sc);
    rail_tile<HFA, SOUT>(sc, m, l, alpha, p, bar->tab, bh, 0, row0, t, qpos, full_tile(0));
    pack_p<HFA>(sc, p_hi, p_lo);
  }
  for (int i = 1; i < n_tiles; ++i) {
    const int s = i % kTcStages, sp = (i - 1) % kTcStages;
    mbar_wait(&bar->full_k[s], (i / kTcStages) & 1);
    mbar_wait(&bar->full_v[sp], ((i - 1) / kTcStages) & 1);
    // Every register the two wgmmas read is defined before the fence
    // and pinned there: S restarts from zeros, and the compiler may not
    // sink O's rescale or P's packing into the pipeline stage.
#pragma unroll
    for (int e = 0; e < 64; ++e) sc[e] = 0.f;
    fence_regs(sc);
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    turn();
    wgmma_fence();
    issue_qk<D>(sc, q_addr, smem_u32(k_s + s * kTile));
    wgmma_commit();
    wgmma_fence();
    issue_pv<D, HFA>(o, p_hi, p_lo, smem_u32(v_s + sp * kTile));
    wgmma_commit();
    pass_turn(false);
    wgmma_wait<1>();
    fence_regs(sc);
    rail_tile<HFA, SOUT>(sc, m, l, alpha, p, bar->tab, bh, i * kTcTile, row0, t, qpos,
                         full_tile(i * kTcTile));
    wgmma_wait<0>();
    fence_regs(o);
#pragma unroll
    for (int c = 0; c < NO; ++c) o[c] *= alpha[(c / 2) % 2];
    release(sp, i - 1 + kTcStages);
    // P_i is written only now that P_{i-1} V_{i-1} is done: written
    // while that wgmma still reads P, ptxas would serialize the two.
    pack_p<HFA>(sc, p_hi, p_lo);
  }
  if (n_tiles > 0) {
    const int sp = (n_tiles - 1) % kTcStages;
    mbar_wait(&bar->full_v[sp], ((n_tiles - 1) / kTcStages) & 1);
    fence_regs(o);
    fence_regs(p_hi);
    fence_regs(p_lo);
    turn();
    wgmma_fence();
    issue_pv<D, HFA>(o, p_hi, p_lo, smem_u32(v_s + sp * kTile));
    wgmma_commit();
    pass_turn(true);
    wgmma_wait<0>();
    fence_regs(o);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= p.Lq) continue;
    const size_t r = (size_t)bh * p.Lq + row;
    float* orow = p.o + r * D;
    if (HFA) {   // LogDiv finalize; nothing visible -> 0
      const float recip = l[h] <= 0.f ? 0.f : recip_logdiv(l[h]);
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<float2*>(orow + 8 * nb + 2 * t) =
            make_float2(o[4 * nb + 2 * h] * recip, o[4 * nb + 2 * h + 1] * recip);
    } else {     // float divide; LSE = m + ln l is the backward's residual
      const float safe = l[h] == 0.f ? 1.f : l[h];
#pragma unroll
      for (int nb = 0; nb < D / 8; ++nb)
        *reinterpret_cast<float2*>(orow + 8 * nb + 2 * t) =
            make_float2(o[4 * nb + 2 * h] / safe, o[4 * nb + 2 * h + 1] / safe);
      if (t == 0) p.lse[r] = m[h] + logf(safe);
    }
  }
}

// ------------------------------------------------------------------ launch
template <int D, bool HFA, bool SOUT>
int launch_tc(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const TcParams& p,
              const Lut& lut, int BH, cudaStream_t s) {
  auto kernel = dense_fwd_tc_kernel<D, HFA, SOUT>;
  constexpr int bytes = tc_smem_bytes<D>();
  static bool ready = false;   // the shared-memory attribute is set
  if (!ready) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<dim3(BH, p.n_qtiles), kTcThreads, bytes, s>>>(mq, mk, mv, p, lut);
  return (int)cudaGetLastError();
}

template <int D>
int fwd_tc_d(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
             const TcParams& p, const Lut& lut, int BH, int use_hfa, cudaStream_t s) {
  if (p.scores != nullptr) return launch_tc<D, true, true>(mq, mk, mv, p, lut, BH, s);
  if (use_hfa) return launch_tc<D, true, false>(mq, mk, mv, p, lut, BH, s);
  return launch_tc<D, false, false>(mq, mk, mv, p, lut, BH, s);
}

// The rail as the kernel computes it (integer form, table in shared
// memory), for the bit-equality checks against the plain torch rail.
__global__ void tc_rail_eval_kernel(const float* x, float* rail, float* pexp, float* recip, int n,
                                    const Lut lut) {
  __shared__ unsigned tab[32];
  if (threadIdx.x < 32) tab[threadIdx.x] = pwl_table_word(threadIdx.x, lut);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int r = quant_rail_int(x[i]);
  rail[i] = __int2float_rn(r);
  pexp[i] = exp2_hfa_rail_tab(r, tab);
  recip[i] = recip_logdiv(x[i]);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

}  // namespace

// Returns the first CUDA error of the launch (0 = ok).  q (BH, Lq, D),
// k and v (BH, Lkv, D) bf16, contiguous and 16-byte aligned; O (BH, Lq,
// D) f32; lse (BH, Lq) f32 on the fa2 rail (may be null on hfa); scores
// (BH, Lq, Lkv) bf16 or null - non-null launches the scores-out variant
// (H-FA rail only).  D is 64 or 128.
extern "C" int dense_attn_fwd_tc(const void* q, const void* k, const void* v, void* o, void* lse,
                                 void* scores, int BH, int Lq, int Lkv, int D, int kv_len,
                                 int q_offset, int causal, float scale, int use_hfa,
                                 const void* lut_host, void* stream) {
  const int n_qtiles = Lq > 0 ? (Lq + kTcRows - 1) / kTcRows : 0;
  if (BH <= 0 || Lq <= 0 || Lkv <= 0 || (D != 64 && D != 128) || n_qtiles > 65535 ||
      (!use_hfa && lse == nullptr) || (scores != nullptr && !use_hfa) || !aligned16(q) ||
      !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, Lq, D, kTcRows) || !make_map(&mk, k, BH, Lkv, D, kTcTile) ||
      !make_map(&mv, v, BH, Lkv, D, kTcTile))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  TcParams p;
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.scores = static_cast<__nv_bfloat16*>(scores);
  p.Lq = Lq;
  p.Lkv = Lkv;
  p.kv_lim = kv_len < Lkv ? kv_len : Lkv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.n_qtiles = n_qtiles;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? fwd_tc_d<64>(mq, mk, mv, p, lut, BH, use_hfa, s)
                 : fwd_tc_d<128>(mq, mk, mv, p, lut, BH, use_hfa, s);
}

// The rail device functions as compiled in this source.
extern "C" int dense_tc_rail_eval(const void* x, void* rail, void* pexp, void* recip, int n,
                                  const void* lut_host, void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  tc_rail_eval_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(rail), static_cast<float*>(pexp),
      static_cast<float*>(recip), n, lut);
  return (int)cudaGetLastError();
}
