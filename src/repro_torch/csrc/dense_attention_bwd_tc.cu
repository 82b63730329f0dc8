// FA-2 backward on Hopper's tensor cores (sm_90a), for bf16 inputs and a
// bf16 output cotangent over (BH, L, D) slabs.
//
// Replaces two Pallas TPU kernels of the reference package:
//   src/repro/kernels/fa2_bwd.py  _dq_kernel   -> dense_attn_dq_tc
//   src/repro/kernels/fa2_bwd.py  _dkv_kernel  -> dense_attn_dkv_tc
// They compute what those kernels (and dense_attention.cu's CUDA-core
// dq and dk/dv, which now serve f32 cotangents) compute: p = exp(s *
// scale - LSE) recomputed from the forward's LSE, ds = p (dO V^T -
// delta) with delta = rowsum(dO O) from the caller, dq = sum ds k scale,
// dv = sum p^T dO, dk = sum ds^T q scale.  Masks as in the reference:
// key j is visible to query row i when j < kv_len, j < Lkv and, if
// causal, j <= i + q_offset.  Tiles no row of a warpgroup can see are
// skipped; scores are masked one by one only in diagonal and edge tiles.
// No sum crosses blocks: no atomics, deterministic results.
//
// What bounds them on this card.  At the training shape (BH 64, L 2048,
// D 128, causal: 1.34e8 visible pairs) dq runs three products of 2 D
// flops a pair (S, dP, dQ) and dk/dv four (S, dP, dV, dK): 1.03e11 and
// 1.37e11 flops, 0.104 and 0.139 ms at the bf16 tensor-core peak,
// against 169 and 202 MB of inputs and outputs (0.050 and 0.060 ms at
// 3.35 TB/s).  The products bound both.
//
// Design.  Two warpgroups (256 threads, one block per SM) own 128 rows
// of one bh: query rows (dq) or key rows (dk/dv), 64 a warpgroup.  Those
// rows' two operand tiles are loaded once by TMA (tensor maps over (BH,
// L, D) bf16, 128-byte swizzle, rows past L arrive as zeros) and stay in
// shared memory; 64-row tiles of the other side stream through a
// 3-stage ring guarded by mbarriers, refilled by the last of the 8 warps
// to release a stage (as in dense_attention_tc.cu: no producer warp,
// so each thread may hold 255 registers).  Per streamed tile a warpgroup
// runs
//   dk/dv (keys k, query tile j, LSE and delta of j in the same stage):
//     S^T = K Q_j^T, dP^T = V dO_j^T   wgmma m64n64k16, both operands
//                                      from shared memory, K-major;
//     P^T, dS^T                        on the accumulator fragments;
//     dV += P^T dO_j, dK += dS^T Q_j   wgmma m64nDk16, A from registers
//                                      (the fragment packed as bf16), B
//                                      the same swizzled Q_j / dO_j
//                                      tiles read MN-major;
//   dq (query rows, key tile j; LSE and delta of its two rows in
//   registers):
//     S = Q K_j^T, dP = dO V_j^T       m64n64k16 from shared memory;
//     P, dS                            on the fragments;
//     dQ += dS K_j                     A from registers, B = K_j MN-major.
// P is formed while dP is still on the tensor cores, and dK's operand
// while dV is.  Registers at D 128: the dK and dV accumulators are 64
// floats each a thread, S and dP 32 each, the packed P and dS 16 each;
// dq holds 64 + 64 + 16.  Both fit 255 without spills, so no smaller
// block was needed.
//
// Numerics.  A bf16 x bf16 product is exact in f32, so S and dP differ
// from the plain version only in summation order.  P and dS enter their
// products as single bf16 values (FA3's choice), each within 2^-9 of
// its f32 value; the outputs are bf16 themselves (2^-9 of each value).
// dS is formed from the f32 P.  p keeps the plain version's
// expf(__fmul_rn(s, scale) - lse).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tc_common.cuh"

namespace {

constexpr int kBwdRows = 128;     // rows a block owns: two warpgroups of 64
constexpr int kBwdTile = 64;      // rows of a streamed tile
constexpr int kBwdStages = 3;     // depth of the ring
constexpr int kBwdThreads = 256;  // two warpgroups

struct BwdParams {
  __nv_bfloat16* dq;    // (BH, Lq, D)
  __nv_bfloat16* dk;    // (BH, Lkv, D)
  __nv_bfloat16* dv;    // (BH, Lkv, D)
  const float* lse;     // (BH, Lq)
  const float* delta;   // (BH, Lq)
  int Lq, Lkv, kv_lim, q_offset, causal, n_blocks;
  float scale;
};

// Per-block state in shared memory after the tiles.
struct BwdBarriers {
  uint64_t full_res;                 // the resident tiles
  uint64_t full[kBwdStages];         // a stage's streamed tiles
  int released[kBwdStages];          // warps done with the tile a stage holds
};

template <int D>
__host__ __device__ constexpr int res_bytes() { return kBwdRows * D * 2; }
template <int D>
__host__ __device__ constexpr int tile_bytes() { return kBwdTile * D * 2; }
// dk/dv stage: Q_j, dO_j, then LSE and delta of j (256 bytes each),
// padded to keep every stage 1024-byte aligned for the swizzle.
template <int D>
__host__ __device__ constexpr int dkv_stage_bytes() { return 2 * tile_bytes<D>() + 1024; }
// dq stage: K_j, V_j.
template <int D>
__host__ __device__ constexpr int dq_stage_bytes() { return 2 * tile_bytes<D>(); }
// 1024 bytes of slack to align the tiles, two resident tiles, the ring,
// the barriers.  At D 128: 165 KB (dk/dv) and 162 KB (dq).
template <int D, int STAGE>
__host__ __device__ constexpr int bwd_smem_bytes() {
  return 1024 + 2 * res_bytes<D>() + kBwdStages * STAGE + 256;
}
static_assert(sizeof(BwdBarriers) <= 256, "bwd_smem_bytes reserves 256 bytes for BwdBarriers");
static_assert(bwd_smem_bytes<128, dkv_stage_bytes<128>()>() <= 232448, "227 KB a block");
static_assert(bwd_smem_bytes<128, dq_stage_bytes<128>()>() <= 232448, "227 KB a block");

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// The two resident 128-row tiles of this block (rows r0 .. r0 + 127).
template <int D>
__device__ __forceinline__ void load_resident(uint8_t* a_s, uint8_t* b_s, uint64_t* bar,
                                              const CUtensorMap* tm_a, const CUtensorMap* tm_b,
                                              int r0, int bh) {
  mbar_expect_tx(bar, 2 * res_bytes<D>());
  for (int h = 0; h < D / kSwzCols; ++h) {
    tma_load(a_s + h * (kBwdRows * 128), tm_a, bar, h * kSwzCols, r0, bh);
    tma_load(b_s + h * (kBwdRows * 128), tm_b, bar, h * kSwzCols, r0, bh);
  }
}

// Two streamed 64-row tiles (rows r0 .. r0 + 63) into a stage.
template <int D>
__device__ __forceinline__ void load_pair(uint8_t* st, uint64_t* bar, const CUtensorMap* tm_a,
                                          const CUtensorMap* tm_b, int r0, int bh) {
  for (int h = 0; h < D / kSwzCols; ++h) {
    tma_load(st + h * (kBwdTile * 128), tm_a, bar, h * kSwzCols, r0, bh);
    tma_load(st + tile_bytes<D>() + h * (kBwdTile * 128), tm_b, bar, h * kSwzCols, r0, bh);
  }
}

// acc (64 x 64) = A (this warpgroup's 64 rows of a resident 128-row
// tile) * B (a streamed 64-row tile)^T, both K-major over D.
template <int D>
__device__ __forceinline__ void issue_scores(float (&acc)[32], uint32_t a_addr, uint32_t b_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t aoff = (kk / 4) * (kBwdRows * 128) + (kk % 4) * 32;
    const uint32_t boff = (kk / 4) * (kBwdTile * 128) + (kk % 4) * 32;
    wgmma_ss_m64n64(acc, sw128_desc(a_addr + aoff, 16, 1024), sw128_desc(b_addr + boff, 16, 1024),
                    kk > 0);
  }
}

// acc (64 x D) += A (64 x 64 bf16, registers: the packed fragment) * B
// (a streamed 64-row tile, 64 x D, read MN-major: 64-column halves 8 KB
// apart).
template <int D>
__device__ __forceinline__ void issue_acc(float (&acc)[D / 2], const uint32_t (&a)[16],
                                          uint32_t b_addr) {
#pragma unroll
  for (int kc = 0; kc < kBwdTile / 16; ++kc) {
    const uint64_t db = sw128_desc(b_addr + kc * 16 * 128, kBwdTile * 128, 1024);
    if constexpr (D == 128) {
      wgmma_rs_m64n128(acc, &a[4 * kc], db);
    } else {
      wgmma_rs_m64n64(acc, &a[4 * kc], db);
    }
  }
}

// The f32 fragment (64 x 64) packed pairwise into the register A
// fragments of its 4 16-column chunks.
__device__ __forceinline__ void pack_frag(const float (&x)[32], uint32_t (&out)[16]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) out[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
}

template <int N>
__device__ __forceinline__ void zero_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// This warp is done with the tile in stage s; the last of the 8 warps to
// get there refills the stage with tile `next` (fill(next) issues it).
template <typename Fill>
__device__ __forceinline__ void release(BwdBarriers* bar, int s, int next, int n_tiles, int lane,
                                        Fill fill) {
  __syncwarp();
  if (lane == 0 && atomicAdd(&bar->released[s], 1) == 7) {
    bar->released[s] = 0;
    if (next < n_tiles) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      fill(next);
    }
  }
}

// Accumulator (64 x D) rows of this thread, times `mul`, to bf16 rows
// of a (.., D) slab: element 4 nb + 2 h + c is row + 8 h, column
// 8 nb + 2 t + c.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, const float (&acc)[D / 2], int row,
                                           int L, int t, float mul) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (row + 8 * h >= L) continue;
    __nv_bfloat16* out = base + (size_t)(row + 8 * h) * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * nb + 2 * t) = __floats2bfloat162_rn(
          __fmul_rn(acc[4 * nb + 2 * h], mul), __fmul_rn(acc[4 * nb + 2 * h + 1], mul));
  }
}

// ------------------------------------------------------------------- dk/dv
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dense_dkv_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_do,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_lse,
                        const __grid_constant__ CUtensorMap tm_delta, const BwdParams p) {
  constexpr int kStage = dkv_stage_bytes<D>();
  constexpr int NA = D / 2;                        // dK, dV accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* k_s = align1024(smem_raw);
  uint8_t* v_s = k_s + res_bytes<D>();
  uint8_t* ring = v_s + res_bytes<D>();
  BwdBarriers* bar = reinterpret_cast<BwdBarriers*>(ring + kBwdStages * kStage);

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kBwdRows;            // first key tiles (most query rows) first
  // Causal: query row i sees this block's keys only if i + q_offset >= k0.
  const int q_begin = p.causal ? max(0, k0 - p.q_offset) / kBwdTile * kBwdTile : 0;
  const int q_end = k0 < p.kv_lim ? p.Lq : 0;
  const int n_tiles = q_end > q_begin ? (q_end - q_begin + kBwdTile - 1) / kBwdTile : 0;

  auto fill = [&](int i) {   // query tile i of the walk into stage i % kBwdStages
    const int s = i % kBwdStages, q0 = q_begin + i * kBwdTile;
    uint8_t* st = ring + s * kStage;
    mbar_expect_tx(&bar->full[s], 2 * tile_bytes<D>() + 2 * kBwdTile * 4);
    load_pair<D>(st, &bar->full[s], &tm_q, &tm_do, q0, bh);
    tma_load_1d(st + 2 * tile_bytes<D>(), &tm_lse, &bar->full[s], bh * p.Lq + q0);
    tma_load_1d(st + 2 * tile_bytes<D>() + kBwdTile * 4, &tm_delta, &bar->full[s],
                bh * p.Lq + q0);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar->full_res, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&bar->full[s], 1);
      bar->released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    load_resident<D>(k_s, v_s, &bar->full_res, &tm_k, &tm_v, k0, bh);
    for (int i = 0; i < min(kBwdStages, n_tiles); ++i) fill(i);
  }

  const int cw = threadIdx.x / 128;                // warpgroup: keys k0 + 64 cw ..
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int wg_k = k0 + cw * 64;
  const int key0 = wg_k + warp * 16 + lane / 4;    // fragment rows h = 0; + 8 for h = 1
  const uint32_t k_addr = smem_u32(k_s) + cw * 64 * 128;
  const uint32_t v_addr = smem_u32(v_s) + cw * 64 * 128;
  float dk[NA], dv[NA], s[32], dp[32];
  uint32_t pb[16], db[16];
  zero_regs(dk);
  zero_regs(dv);
  if (n_tiles > 0) mbar_wait(&bar->full_res, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st_i = i % kBwdStages, q0 = q_begin + i * kBwdTile;
    // No key of this warpgroup is visible to any row of the tile?
    const bool skip = wg_k >= p.kv_lim || (p.causal && q0 + kBwdTile - 1 + p.q_offset < wg_k);
    // A warpgroup waits for every tile, the ones it skips too: a warp may
    // not release a stage's next tile before the stage holds it.
    mbar_wait(&bar->full[st_i], (i / kBwdStages) & 1);
    if (!skip) {
      uint8_t* st = ring + st_i * kStage;
      const uint32_t q_addr = smem_u32(st), do_addr = q_addr + tile_bytes<D>();
      const float* lse_s = reinterpret_cast<const float*>(st + 2 * tile_bytes<D>());
      const float* delta_s = lse_s + kBwdTile;
      // S^T and dP^T restart from zeros, defined and pinned before the fence.
      zero_regs(s);
      zero_regs(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D>(s, k_addr, q_addr);
      wgmma_commit();
      issue_scores<D>(dp, v_addr, do_addr);
      wgmma_commit();
      wgmma_wait<1>();                             // S^T done, dP^T may run on
      fence_regs(s);
      const bool full = wg_k + 63 < p.kv_lim && q0 + kBwdTile <= p.Lq &&
                        (!p.causal || wg_k + 63 <= q0 + p.q_offset);
#pragma unroll
      for (int e = 0; e < 32; ++e) {   // P^T: row = key, column = query
        const int col = 8 * (e / 4) + 2 * t + (e % 2), q = q0 + col;
        const int kv = key0 + 8 * ((e / 2) % 2);
        const float x = expf(__fmul_rn(s[e], p.scale) - lse_s[col]);
        const bool vis = full || (q < p.Lq && kv < p.kv_lim && (!p.causal || kv <= q + p.q_offset));
        s[e] = vis ? x : 0.f;
      }
      pack_frag(s, pb);
      fence_regs(pb);
      fence_regs(dv);
      wgmma_fence();
      issue_acc<D>(dv, pb, do_addr);               // dV += P^T dO_j
      wgmma_commit();
      wgmma_wait<1>();                             // dP^T done, dV may run on
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) {   // dS^T from the f32 P^T
        const int col = 8 * (e / 4) + 2 * t + (e % 2);
        dp[e] = s[e] * (dp[e] - delta_s[col]);
      }
      pack_frag(dp, db);
      fence_regs(db);
      fence_regs(dk);
      wgmma_fence();
      issue_acc<D>(dk, db, q_addr);                // dK += dS^T Q_j
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
    }
    release(bar, st_i, i + kBwdStages, n_tiles, lane, fill);
  }

  const size_t slab = (size_t)bh * p.Lkv * D;
  store_rows<D>(p.dk + slab, dk, key0, p.Lkv, t, p.scale);
  store_rows<D>(p.dv + slab, dv, key0, p.Lkv, t, 1.f);
}

// ---------------------------------------------------------------------- dq
template <int D>
__global__ void __launch_bounds__(kBwdThreads, 1)
    dense_dq_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                       const __grid_constant__ CUtensorMap tm_do,
                       const __grid_constant__ CUtensorMap tm_k,
                       const __grid_constant__ CUtensorMap tm_v, const BwdParams p) {
  constexpr int kStage = dq_stage_bytes<D>();
  constexpr int NA = D / 2;                        // dQ accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = align1024(smem_raw);
  uint8_t* do_s = q_s + res_bytes<D>();
  uint8_t* ring = do_s + res_bytes<D>();
  BwdBarriers* bar = reinterpret_cast<BwdBarriers*>(ring + kBwdStages * kStage);

  const int bh = blockIdx.x;
  const int q0 = (p.n_blocks - 1 - blockIdx.y) * kBwdRows;   // most keys first
  int end = p.kv_lim;
  if (p.causal) end = min(end, q0 + kBwdRows + p.q_offset);
  const int n_tiles = end > 0 ? (end + kBwdTile - 1) / kBwdTile : 0;

  auto fill = [&](int i) {   // key tile i into stage i % kBwdStages
    const int s = i % kBwdStages;
    mbar_expect_tx(&bar->full[s], 2 * tile_bytes<D>());
    load_pair<D>(ring + s * kStage, &bar->full[s], &tm_k, &tm_v, i * kBwdTile, bh);
  };
  if (threadIdx.x == 0) {
    mbar_init(&bar->full_res, 1);
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&bar->full[s], 1);
      bar->released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    load_resident<D>(q_s, do_s, &bar->full_res, &tm_q, &tm_do, q0, bh);
    for (int i = 0; i < min(kBwdStages, n_tiles); ++i) fill(i);
  }

  const int cw = threadIdx.x / 128;                // warpgroup: rows q0 + 64 cw ..
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int row0 = q0 + cw * 64 + warp * 16 + lane / 4;   // fragment rows h = 0; + 8 for h = 1
  const int wg_q = q0 + cw * 64 + p.q_offset;      // causal position of the warpgroup's first row
  float lse[2], delta[2];
  int qpos[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    const bool ok = row < p.Lq;
    lse[h] = ok ? p.lse[(size_t)bh * p.Lq + row] : 0.f;
    delta[h] = ok ? p.delta[(size_t)bh * p.Lq + row] : 0.f;
    qpos[h] = row + p.q_offset;
  }
  const uint32_t q_addr = smem_u32(q_s) + cw * 64 * 128;
  const uint32_t do_addr = smem_u32(do_s) + cw * 64 * 128;
  float dq[NA], s[32], dp[32];
  uint32_t db[16];
  zero_regs(dq);
  if (n_tiles > 0) mbar_wait(&bar->full_res, 0);

  for (int i = 0; i < n_tiles; ++i) {
    const int st_i = i % kBwdStages, t0 = i * kBwdTile;
    // Every key of the tile past this warpgroup's last row?
    const bool skip = p.causal && t0 > wg_q + 63;
    mbar_wait(&bar->full[st_i], (i / kBwdStages) & 1);   // skipped tiles too, as above
    if (!skip) {
      const uint32_t k_addr = smem_u32(ring + st_i * kStage), v_addr = k_addr + tile_bytes<D>();
      zero_regs(s);
      zero_regs(dp);
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_scores<D>(s, q_addr, k_addr);          // S = Q K_j^T
      wgmma_commit();
      issue_scores<D>(dp, do_addr, v_addr);        // dP = dO V_j^T
      wgmma_commit();
      wgmma_wait<1>();                             // S done, dP may run on
      fence_regs(s);
      const bool full = t0 + kBwdTile <= p.kv_lim && (!p.causal || t0 + kBwdTile - 1 <= wg_q);
#pragma unroll
      for (int e = 0; e < 32; ++e) {   // P: row = query, column = key
        const int h = (e / 2) % 2, kv = t0 + 8 * (e / 4) + 2 * t + (e % 2);
        const float x = expf(__fmul_rn(s[e], p.scale) - lse[h]);
        const bool vis = full || (kv < p.kv_lim && (!p.causal || kv <= qpos[h]));
        s[e] = vis ? x : 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
#pragma unroll
      for (int e = 0; e < 32; ++e) dp[e] = s[e] * (dp[e] - delta[(e / 2) % 2]);
      pack_frag(dp, db);
      fence_regs(db);
      fence_regs(dq);
      wgmma_fence();
      issue_acc<D>(dq, db, k_addr);                // dQ += dS K_j
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dq);
    }
    release(bar, st_i, i + kBwdStages, n_tiles, lane, fill);
  }

  store_rows<D>(p.dq + (size_t)bh * p.Lq * D, dq, row0, p.Lq, t, p.scale);
}

// ------------------------------------------------------------------ launch
template <typename K, typename... Args>
int launch_bwd(K kernel, int bytes, bool& ready, dim3 grid, cudaStream_t s,
               const Args&... args) {
  if (!ready) {   // the shared-memory attribute is set once per kernel
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  kernel<<<grid, kBwdThreads, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int D>
int dq_tc_d(const CUtensorMap& mq, const CUtensorMap& mdo, const CUtensorMap& mk,
            const CUtensorMap& mv, const BwdParams& p, int BH, cudaStream_t s) {
  static bool ready = false;
  return launch_bwd(dense_dq_tc_kernel<D>, bwd_smem_bytes<D, dq_stage_bytes<D>()>(), ready,
                    dim3(BH, p.n_blocks), s, mq, mdo, mk, mv, p);
}

template <int D>
int dkv_tc_d(const CUtensorMap& mq, const CUtensorMap& mdo, const CUtensorMap& mk,
             const CUtensorMap& mv, const CUtensorMap& mlse, const CUtensorMap& mdelta,
             const BwdParams& p, int BH, cudaStream_t s) {
  static bool ready = false;
  return launch_bwd(dense_dkv_tc_kernel<D>, bwd_smem_bytes<D, dkv_stage_bytes<D>()>(), ready,
                    dim3(BH, p.n_blocks), s, mq, mdo, mk, mv, mlse, mdelta, p);
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// What neither kernel takes: bad shapes, blocks past the grid, 1-D
// coordinates past int32, unaligned pointers.
bool bad_args(int BH, int Lq, int Lkv, int D, const void* const* ptrs, int n) {
  if (BH <= 0 || Lq <= 0 || Lkv <= 0 || (D != 64 && D != 128)) return true;
  if ((Lq + kBwdRows - 1) / kBwdRows > 65535 || (Lkv + kBwdRows - 1) / kBwdRows > 65535) return true;
  if ((long long)BH * Lq >= (1ll << 31)) return true;
  for (int i = 0; i < n; ++i)
    if (ptrs[i] == nullptr || !aligned16(ptrs[i])) return true;
  return false;
}

BwdParams make_params(const void* lse, const void* delta, int Lq, int Lkv, int kv_len,
                      int q_offset, int causal, float scale, int n_blocks) {
  BwdParams p;
  p.dq = p.dk = p.dv = nullptr;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.Lq = Lq;
  p.Lkv = Lkv;
  p.kv_lim = kv_len < Lkv ? kv_len : Lkv;
  p.q_offset = q_offset;
  p.causal = causal;
  p.n_blocks = n_blocks;
  p.scale = scale;
  return p;
}

}  // namespace

// Each entry point returns the first CUDA error of its launch (0 = ok).
// q, dout (BH, Lq, D), k, v (BH, Lkv, D) bf16, contiguous and 16-byte
// aligned; lse, delta (BH, Lq) f32, 16-byte aligned; outputs bf16.  D is
// 64 or 128.

// dq (BH, Lq, D).
extern "C" int dense_attn_dq_tc(const void* q, const void* k, const void* v, const void* dout,
                                const void* lse, const void* delta, void* dq, int BH, int Lq,
                                int Lkv, int D, int kv_len, int q_offset, int causal, float scale,
                                void* stream) {
  const void* ptrs[7] = {q, k, v, dout, lse, delta, dq};
  if (bad_args(BH, Lq, Lkv, D, ptrs, 7)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mdo, mk, mv;
  if (!make_map(&mq, q, BH, Lq, D, kBwdRows) || !make_map(&mdo, dout, BH, Lq, D, kBwdRows) ||
      !make_map(&mk, k, BH, Lkv, D, kBwdTile) || !make_map(&mv, v, BH, Lkv, D, kBwdTile))
    return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(lse, delta, Lq, Lkv, kv_len, q_offset, causal, scale,
                            (Lq + kBwdRows - 1) / kBwdRows);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? dq_tc_d<64>(mq, mdo, mk, mv, p, BH, s) : dq_tc_d<128>(mq, mdo, mk, mv, p, BH, s);
}

// dk, dv (BH, Lkv, D).
extern "C" int dense_attn_dkv_tc(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dk, void* dv, int BH,
                                 int Lq, int Lkv, int D, int kv_len, int q_offset, int causal,
                                 float scale, void* stream) {
  const void* ptrs[8] = {q, k, v, dout, lse, delta, dk, dv};
  if (bad_args(BH, Lq, Lkv, D, ptrs, 8)) return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mdo, mk, mv, mlse, mdelta;
  if (!make_map(&mq, q, BH, Lq, D, kBwdTile) || !make_map(&mdo, dout, BH, Lq, D, kBwdTile) ||
      !make_map(&mk, k, BH, Lkv, D, kBwdRows) || !make_map(&mv, v, BH, Lkv, D, kBwdRows) ||
      !make_map_f32(&mlse, lse, BH * Lq, kBwdTile) ||
      !make_map_f32(&mdelta, delta, BH * Lq, kBwdTile))
    return (int)cudaErrorInvalidValue;
  BwdParams p = make_params(lse, delta, Lq, Lkv, kv_len, q_offset, causal, scale,
                            (Lkv + kBwdRows - 1) / kBwdRows);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return D == 64 ? dkv_tc_d<64>(mq, mdo, mk, mv, mlse, mdelta, p, BH, s)
                 : dkv_tc_d<128>(mq, mdo, mk, mv, mlse, mdelta, p, BH, s);
}
