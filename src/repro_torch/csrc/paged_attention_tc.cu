// Paged chunked prefill on Hopper's tensor cores, and paged decode and
// speculative verify as one bandwidth kernel (sm_90a), on the fa2 rail
// (exp, float divide later) or the H-FA rail (FIX16 quantized
// exponentials, hfa_rail.cuh).
//
// Replaces three Pallas TPU kernels of the reference package:
//   src/repro/kernels/paged_prefill.py  _paged_prefill_kernel -> paged_prefill_fwd_tc
//   src/repro/kernels/paged_decode.py   _paged_decode_kernel  -> paged_decode_fwd_v2
//   src/repro/kernels/paged_verify.py   _paged_verify_kernel  -> paged_verify_fwd_v2
// All emit the unnormalized triplet (o~, m, l) per query row, as the
// CUDA-core body of paged_attention.cu does, which stays for f32 pools
// and d 32 / 96 in prefill, other page sizes in prefill, verify with
// more than 16 rows a (slot, kv head), and decode and verify on the H-FA
// rail at a page size other than 16 (the reference rescales once a page;
// these kernels' 16-key tiles are the pages at page 16 only).
//
// ---------------------------------------------------------------- prefill
// What it computes.  A chunk of L positions from start_pos, G query heads
// per KV head: query row (g, l) of slot b sees KV positions kv <=
// start_pos[b] + l and kv < kv_lens[b].  As in the reference's page grid
// axis, the online update runs page by page (16 keys): for each page in
// order, m_new, alpha, p, l = l alpha + sum p, acc = acc alpha + P V.
// On the H-FA rail the output depends on where those rescales fall, so
// they fall exactly there.  A masked key gives p = 0; a page no row of a
// warpgroup can see is skipped, which is exact (m unchanged, alpha 1, p 0);
// a row that sees nothing is the neutral triplet (0, NEG_INF, 0).
//
// What bounds it.  At the kernels-phase chunks of chip_smoke.py (B 2,
// Hkv 8, G 2, L 512 at start 520 and 1000, d 128) the least time is the
// bytes of q, the live pages and the triplet (6.7 us at 3.35 TB/s); the
// products alone take 6.1 us at the bf16 peak.  What holds this design
// back is the rail on the CUDA cores: every score of a 64-key stage is
// scaled, masked and exponentiated by the warpgroup that holds it, with
// 8 warps an SM to hide the latency of that chain, and the longest walk
// (1,300 keys) runs 21 stages in one block (paged_tc_variants.py times
// the parts).
//
// Design.  One block of two warpgroups (256 threads) per (slot, kv head,
// pair of units), where a unit is 64 chunk positions of one query head:
// at G 2 the block holds both heads of one kv head at the same positions,
// 128 rows, so every K/V tile feeds all of them and every row of a
// warpgroup has the same causal limit.  Blocks launch with the latest
// positions (the longest walks) first.  Q arrives by TMA as one 64-row box
// per warpgroup from the (B Hkv G, L, D) view of q.  K and V pages arrive
// by TMA, one (16, 64-column) box per page and column half, from a 3-D
// tensor map over the pool (D, Hkv, P page) with 128-byte swizzle; the
// block reads its walk's page ids from the page table into shared memory
// once, so a refill waits on no load from device memory.  A ring of 4 stages of 64
// keys (4 pages) keeps the next tiles loading while the current one
// computes; the last of the 8 warps done with a stage refills it.  Per
// stage a warpgroup runs S = Q K^T as wgmma m64n64k16 (Q and K from shared
// memory, K-major); the products of bf16 inputs are exact in f32, so S
// differs from the reference's f32 dot only in summation order.  Then the
// rail on the S fragment in registers, page by page in order (each thread
// holds 2 rows x 4 keys of a page; row max and sum are quad shuffles; a
// key's mask is one compare with its row's key limit, no branch), and
// O += P_page V_page as one
// m64nDk16 wgmma a page with P in registers: exact bf16 on the H-FA rail
// (every p is g7/128 2^-k), hi + lo bf16 halves on the FA-2 rail (within
// 2^-18 of p).  O is rescaled by the page's alpha between those wgmmas,
// on every page (skipping the rescale where every alpha of a warpgroup is
// exactly 1 was measured slower: the vote costs more than the waits it
// saves, PERF.md).  l is summed in f32 from the unsplit p and rounded
// twice, l alpha then + sum p, as the plain version.
//
// ------------------------------------------------------ decode and verify
// What they compute.  Verify scores K = 1 + spec_k tokens a slot: the
// G K rows of a (slot, kv head), flattened kv-head major, where row r
// sits at seq_lens[b] + r % K and sees kv <= seq_lens[b] + r % K and
// kv < seq_lens[b] + chunk_lens[b] (a free slot, chunk_lens 0, sees
// nothing: the neutral triplet).  Decode is verify with K = 1 at
// seq_lens = kv_lens - 1, chunk_lens = 1: its G rows see kv < kv_lens[b].
// So one body takes both, with a per-row causal limit min(base + r % K +
// 1, limit), base and limit per slot as in paged_attention.cu's mode
// switch.  It keeps the arithmetic order of the CUDA-core kernel
// everywhere: 16-key tiles, each score four interleaved fmaf chains over
// D then ((d0 + d1) + (d2 + d3)) times the scale, max and sum of p as xor
// butterflies over a tile's 16 lanes, P V as an fmaf chain over the
// tile's 16 keys and then acc = fmaf(acc, alpha, pv), l = fmaf(l, alpha,
// sum p).  An unsplit walk is therefore bit-equal to paged_decode_fwd and
// paged_verify_fwd on both rails: a tile a row cannot see leaves its
// triplet unchanged bit for bit (alpha is exactly 1, p 0), so where a
// block's walk stops - at the furthest position one of its rows sees -
// does not matter.
//
// What bounds them: bytes.  One decode token does 2 flops per K/V byte,
// a verify row the same, so even verify's 10 rows (G 2, K 5) do 20 flops
// per byte, far below the card's ridge; the least time is the live K/V
// pages over 3.35 TB/s (8.6 us for decode and 11.6 us for verify at
// B 8, Hkv 8, kv up to 2048, d 128, bf16).
//
// Design.  Rows sized to the work (not 16): a block takes RB of the G K
// rows (RB <= 16), thread (rows, key) scoring one key of a 4-tile
// (64-key) step for one row (RB <= 4, and RB <= 8 on the H-FA rail: 64
// RB threads) or for two (more rows: 64 ceil(RB / 2) threads, each key
// chunk read from shared memory once for both); the unsplit bf16 walk at RB <= 2 takes 8-tile steps
// with 128 RB threads (one block an SM, twice the warps to hide a step's
// latency).  The per-tile
// online update then runs in tile order over the step's 4 tiles (the
// row's prefix max from shared memory), and a thread that owns the
// output column pair 2 key, 2 key + 1 of its rows applies acc = acc
// alpha_j + sum_k p v tile by tile, reading V two columns and p four keys
// a load.  Tiles arrive by cp.async (16 bytes a thread,
// rows padded by 16 bytes so the score loads hit distinct banks) into a
// ring of two steps, so the next 32 KB (d 128 bf16) load while a step
// computes.  On the FA-2 rail the page walk is split across blocks into
// contiguous runs of tiles, so that the grid fills the card, and the last
// block of a (slot, kv head) to finish merges the runs by Eq. 16
// (decode_common.cuh).  The H-FA rail stays unsplit: a split moves the
// rescale points, and the result would no longer be the reference's
// walk.  Its parallelism can come from the rows instead: row_blocks > 1
// gives each block R / row_blocks of the rows (one query head's K rows,
// say), every block walking the whole table - no row's arithmetic
// changes, and the second read of a page comes from L2.
//
// Pools.  q is bf16 or f32 (TQ) and the pools (T) are in q's dtype, bf16
// under an f32 q (a log16 pool's bits at f32 compute), or int8 with one
// f32 scale a row (the int8 page codec).  int8 rows ride the same ring, 16
// values a 16-byte chunk (D 32-128 are all whole chunks), and a ring of
// the step's K and V row scales beside it, filled by 4-byte cp.async; a
// key chunk is widened and multiplied by its key's scale (dc_dots), a V
// pair by its key's scale (dc_pair), each one rounded multiply, before
// the unchanged fmaf chains - so the int8 walk is bit-equal to the
// CUDA-core body's, which decodes each row as it loads it, and the split
// merge is untouched.  The prefill here takes bf16 pools only (a log16
// pool's bf16 view included); int8 prefill runs on the CUDA cores.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "hfa_rail.cuh"
#include "paged_decode_v2.cuh"
#include "tc_common.cuh"

namespace {

// ================================================================ prefill
constexpr int kPfRows = 64;                    // chunk positions of a unit (one warpgroup)
constexpr int kPfPage = 16;                    // keys per page: the rescale step
constexpr int kPfStageKeys = 64;               // keys per ring stage: 4 pages
constexpr int kPfPages = kPfStageKeys / kPfPage;
constexpr int kPfStages = 4;                   // depth of the K/V ring
constexpr int kPfUnits = 2;                    // warpgroups (units) a block
constexpr int kPfThreads = 128 * kPfUnits;

struct PfParams {
  const int* pt;        // (B, J) page ids
  const int* start;     // (B,) chunk start position
  const int* kv_lens;   // (B,) positions written
  float* o;             // (B, Hkv, G, L, D)
  float* m;             // (B, Hkv, G, L)
  float* l;             // (B, Hkv, G, L)
  int L, G, J, hkv, n_units;
  float scale;
};

template <int D>
__host__ __device__ constexpr int pf_stage_bytes() { return kPfStageKeys * D * 2; }
template <int D>
__host__ __device__ constexpr int pf_q_bytes() { return kPfRows * D * 2; }
// 1024 bytes of slack to align the tiles for the 128-byte swizzle, the two
// warpgroups' Q, the K and V rings, PfBarriers, then the slot's page ids
// (4 bytes each, up to kPfMaxPages).  At D 128: 161 KB and the ids.
constexpr int kPfMaxPages = 16384;
template <int D>
__host__ __device__ constexpr int pf_smem_bytes(int pages) {
  return 1024 + kPfUnits * pf_q_bytes<D>() + 2 * kPfStages * pf_stage_bytes<D>() + 256 +
         4 * pages;
}

struct PfBarriers {
  uint64_t full_q;
  uint64_t full_k[kPfStages], full_v[kPfStages];
  int released[kPfStages];   // warps done with the stage's tile
  unsigned tab[32];          // PWL g7 table of exp2_hfa_rail_tab
};
static_assert(sizeof(PfBarriers) <= 256, "pf_smem_bytes reserves 256 bytes for PfBarriers");
static_assert(pf_smem_bytes<128>(kPfMaxPages) <= 232448, "a block may use 227 KB of shared memory");

// One box of 64 columns x 16 rows of a pool's kv head `h` at pool row `row`.
__device__ __forceinline__ void tma_page(void* dst, const CUtensorMap* map, uint64_t* bar, int col,
                                         int h, int row) {
  tma_load(dst, map, bar, col, h, row);   // coordinates {col, h, row}
}

// Issue the TMA loads of stage i (pages 4 i .. of the slot's walk, those
// below n_pages; ids from shared memory) into ring slot i % kPfStages.
template <int D>
__device__ __forceinline__ void pf_load_stage(uint8_t* k_s, uint8_t* v_s, PfBarriers* bar,
                                              const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                              const int* ptb, int i, int n_pages, int h) {
  constexpr uint32_t kStage = pf_stage_bytes<D>(), kHalf = kPfStageKeys * 128;
  constexpr uint32_t kPageBox = kPfPage * 128;
  const int s = i % kPfStages;
  const int p0 = kPfPages * i, np = min(kPfPages, n_pages - p0);
  const uint32_t bytes = (uint32_t)np * kPfPage * D * 2;
  mbar_expect_tx(&bar->full_k[s], bytes);
  mbar_expect_tx(&bar->full_v[s], bytes);
  for (int j = 0; j < np; ++j) {
    const int row = ptb[p0 + j] * kPfPage;
    for (int hh = 0; hh < D / kSwzCols; ++hh) {
      const uint32_t off = s * kStage + hh * kHalf + j * kPageBox;
      tma_page(k_s + off, tm_k, &bar->full_k[s], hh * kSwzCols, h, row);
      tma_page(v_s + off, tm_v, &bar->full_v[s], hh * kSwzCols, h, row);
    }
  }
}

// S = Q K^T for one warpgroup's 64 rows against the 64 keys of a stage.
template <int D>
__device__ __forceinline__ void pf_issue_qk(float (&sc)[32], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk / 4) * (kPfRows * 128) + (kk % 4) * 32;
    const uint32_t koff = (kk / 4) * (kPfStageKeys * 128) + (kk % 4) * 32;
    wgmma_ss_m64n64(sc, sw128_desc(q_addr + off, 16, 1024), sw128_desc(k_addr + koff, 16, 1024),
                    kk > 0);
  }
}

// O += P V for page j of the stage whose V sits at v_addr (MN-major,
// 64-column halves kPfStageKeys * 128 bytes apart).
template <int D, bool HFA>
__device__ __forceinline__ void pf_issue_pv(float (&o)[D / 2], const uint32_t (&ph)[4],
                                            const uint32_t (&pl)[4], uint32_t v_addr, int j) {
  const uint64_t db = sw128_desc(v_addr + j * kPfPage * 128, kPfStageKeys * 128, 1024);
  if constexpr (D == 128) {
    wgmma_rs_m64n128(o, ph, db);
    if constexpr (!HFA) wgmma_rs_m64n128(o, pl, db);
  } else {
    wgmma_rs_m64n64(o, ph, db);
    if constexpr (!HFA) wgmma_rs_m64n64(o, pl, db);
  }
}

// The rail of a stage's pages on the S fragment, page by page in order:
// scale, masks, each page's row max, m after each page, alpha, p
// (packed into the register A fragment of the page's 16 keys: bf16 on
// H-FA, hi + lo on FA-2) and l.  Row h of this thread sees the keys below
// lim[h] (its position + 1, clipped to kv_lim and to the warpgroup's walk
// end): one compare an element, with no branch (nvcc turns && and || into
// a branch an element, which serializes the exponentials behind it).
// Pages past the walk end (their smem may be stale) are masked whole, so
// they leave m unchanged, alpha is exactly 1 and p 0.  The pages' maxima,
// exponentials and sums are independent of one another, so they are
// formed together; only m and l are chained page to page.
//
// Accumulator fragment of wgmma m64n64 (f32): thread (warp w, lane 4 g + t)
// holds element e at row 16 w + g + 8 ((e / 2) % 2), column 8 (e / 4) +
// 2 t + (e % 2).  Page j is elements 8 j .. 8 j + 7; read in that order and
// packed pairwise they are the A fragment of its 16 keys.
template <bool HFA>
__device__ __forceinline__ void pf_rail_stage(float (&sc)[32], float (&m)[2], float (&l)[2],
                                              float (&alpha)[kPfPages][2],
                                              uint32_t (&ph)[kPfPages][4],
                                              uint32_t (&pl)[kPfPages][4], const unsigned* tab,
                                              float scale, int key_s, int t,
                                              const int (&lim)[2]) {
  float mx[kPfPages][2];
#pragma unroll
  for (int j = 0; j < kPfPages; ++j) {
    const int rel[2] = {lim[0] - key_s - j * kPfPage - 2 * t,
                        lim[1] - key_s - j * kPfPage - 2 * t};
    mx[j][0] = mx[j][1] = kNegInf;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int h = (u / 2) % 2;
      const float x = 8 * (u / 4) + (u % 2) < rel[h] ? __fmul_rn(sc[8 * j + u], scale) : kNegInf;
      sc[8 * j + u] = x;
      mx[j][h] = fmaxf(mx[j][h], x);
    }
  }
  float m_new[kPfPages][2], ps[kPfPages][2];
#pragma unroll
  for (int j = 0; j < kPfPages; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float prev = j ? m_new[j - 1][h] : m[h];
      m_new[j][h] = fmaxf(prev, quad_max(mx[j][h]));
      alpha[j][h] = HFA ? exp2_hfa_rail_tab(quant_rail_int(fminf(prev - m_new[j][h], 0.f)), tab)
                        : expf(fminf(prev - m_new[j][h], 0.f));
      ps[j][h] = 0.f;
    }
#pragma unroll
  for (int j = 0; j < kPfPages; ++j) {
    const int rel[2] = {lim[0] - key_s - j * kPfPage - 2 * t,
                        lim[1] - key_s - j * kPfPage - 2 * t};
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int h = (u / 2) % 2;
      const float x = sc[8 * j + u] - m_new[j][h];
      const float e = HFA ? exp2_hfa_rail_tab(quant_rail_int(x), tab) : expf(x);
      const bool keep = (8 * (u / 4) + (u % 2) < rel[h]) & (m_new[j][h] != kNegInf);
      sc[8 * j + u] = keep ? e : 0.f;
      ps[j][h] += sc[8 * j + u];
    }
  }
#pragma unroll
  for (int j = 0; j < kPfPages; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) ps[j][h] = quad_sum(ps[j][h]);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
#pragma unroll
    for (int j = 0; j < kPfPages; ++j)   // two roundings a page, as the plain version (no FMA)
      l[h] = __fadd_rn(__fmul_rn(l[h], alpha[j][h]), ps[j][h]);
    m[h] = m_new[kPfPages - 1][h];
  }
#pragma unroll
  for (int j = 0; j < kPfPages; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      ph[j][q] = pack_bf16(sc[8 * j + 2 * q], sc[8 * j + 2 * q + 1]);
      if constexpr (!HFA) {
        const __nv_bfloat162 hb = *reinterpret_cast<const __nv_bfloat162*>(&ph[j][q]);
        pl[j][q] = pack_bf16(sc[8 * j + 2 * q] - __low2float(hb),
                             sc[8 * j + 2 * q + 1] - __high2float(hb));
      }
    }
}

template <int D, bool HFA>
__global__ void __launch_bounds__(kPfThreads, 1)
    paged_prefill_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const PfParams p,
                            const Lut lut) {
  constexpr uint32_t kStage = pf_stage_bytes<D>();
  constexpr int NO = D / 2;                      // O accumulator floats per thread
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                            ~static_cast<uintptr_t>(1023));
  uint8_t* k_s = q_s + kPfUnits * pf_q_bytes<D>();
  uint8_t* v_s = k_s + kPfStages * kStage;
  PfBarriers* bar = reinterpret_cast<PfBarriers*>(v_s + kPfStages * kStage);

  const int h = blockIdx.x, b = blockIdx.y;
  const int blk = gridDim.z - 1 - blockIdx.z;    // latest positions (longest walks) first
  const int start = p.start[b];
  const int kv_lim = max(0, min(p.kv_lens[b], p.J * kPfPage));
  // Keys unit u's rows can see: [0, end(u)); its positions are chunk
  // (u / G) * 64 .. of query head u % G.
  auto unit_end = [&](int u) {
    if (u >= p.n_units) return 0;
    return max(0, min(start + min((u / p.G) * kPfRows + kPfRows, p.L), kv_lim));
  };
  int end = 0;
  for (int w = 0; w < kPfUnits; ++w) end = max(end, unit_end(kPfUnits * blk + w));
  const int n_pages = (end + kPfPage - 1) / kPfPage;
  const int n_stages = (n_pages + kPfPages - 1) / kPfPages;
  // The walk's page ids, read once into shared memory: a refill then
  // waits on no load from device memory.
  int* ptb = reinterpret_cast<int*>(bar + 1);
  for (int j = threadIdx.x; j < n_pages; j += kPfThreads) ptb[j] = p.pt[(size_t)b * p.J + j];

  if (threadIdx.x < 32) bar->tab[threadIdx.x] = pwl_table_word(threadIdx.x, lut);
  if (threadIdx.x == 0) {
    mbar_init(&bar->full_q, 1);
    for (int s = 0; s < kPfStages; ++s) {
      mbar_init(&bar->full_k[s], 1);
      mbar_init(&bar->full_v[s], 1);
      bar->released[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {   // Q of the block's units, and the first stages into the ring
    const int nq = min(kPfUnits, p.n_units - kPfUnits * blk);
    mbar_expect_tx(&bar->full_q, nq * pf_q_bytes<D>());
    for (int w = 0; w < nq; ++w) {
      const int u = kPfUnits * blk + w;
      const int slab = ((b * p.hkv + h) * p.G + u % p.G);
      for (int hh = 0; hh < D / kSwzCols; ++hh)
        tma_load(q_s + w * pf_q_bytes<D>() + hh * (kPfRows * 128), &tm_q, &bar->full_q,
                 hh * kSwzCols, (u / p.G) * kPfRows, slab);
    }
    for (int i = 0; i < min(kPfStages, n_stages); ++i)
      pf_load_stage<D>(k_s, v_s, bar, &tm_k, &tm_v, ptb, i, n_pages, h);
  }

  const int cw = threadIdx.x / 128;              // warpgroup: unit kPfUnits blk + cw
  const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int unit = kPfUnits * blk + cw;
  const bool active = unit < p.n_units;
  const int g = active ? unit % p.G : 0;
  const int l0 = active ? (unit / p.G) * kPfRows : 0;
  const int my_end = unit_end(unit);
  const int lrow = l0 + warp * 16 + lane / 4;    // chunk position of elements 0, 1; +8 for 2, 3
  // Keys below lim[h] are visible to row h of this thread (elements 0, 1
  // and 2, 3): its position + 1, within kv_lim and the warpgroup's walk.
  const int lim[2] = {min(start + lrow + 1, my_end), min(start + lrow + 9, my_end)};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f}, alpha[kPfPages][2], o[NO], sc[32];
  uint32_t ph[kPfPages][4], pl[kPfPages][4];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  const uint32_t q_addr = smem_u32(q_s + cw * pf_q_bytes<D>());
  // This warp is done with the stage in slot s; the last of the block's
  // 4 kPfUnits warps to get there refills the slot with stage `next`.
  auto release = [&](int s, int next) {
    if (lane == 0 && atomicAdd(&bar->released[s], 1) == 4 * kPfUnits - 1) {
      bar->released[s] = 0;
      if (next < n_stages) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        pf_load_stage<D>(k_s, v_s, bar, &tm_k, &tm_v, ptb, next, n_pages, h);
      }
    }
  };
  if (active) mbar_wait(&bar->full_q, 0);   // no block exits with a copy in flight

  for (int i = 0; i < n_stages; ++i) {
    const int s = i % kPfStages;
    const int parity = (i / kPfStages) & 1;
    // Every warp waits for every stage, used or not: an early release of a
    // later round of the same slot would count towards the wrong refill.
    mbar_wait(&bar->full_k[s], parity);
    mbar_wait(&bar->full_v[s], parity);
    const int key_s = i * kPfStageKeys;
    if (active && key_s < my_end) {              // warpgroup-uniform
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] = 0.f;
      fence_regs(sc);
      wgmma_fence();
      pf_issue_qk<D>(sc, q_addr, smem_u32(k_s + s * kStage));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sc);
      const int n_pg = min(kPfPages, (my_end - key_s + kPfPage - 1) / kPfPage);
      pf_rail_stage<HFA>(sc, m, l, alpha, ph, pl, bar->tab, p.scale, key_s, t, lim);
      const uint32_t v_addr = smem_u32(v_s + s * kStage);
      // O waits for the previous page's P V and is rescaled by this page's
      // alpha before its own P V, page by page as the plain version.
#pragma unroll
      for (int j = 0; j < kPfPages; ++j) {
        if (j >= n_pg) break;                    // warpgroup-uniform
        fence_regs(ph[j]);
        if constexpr (!HFA) fence_regs(pl[j]);
        wgmma_wait<0>();
        fence_regs(o);
#pragma unroll
        for (int c = 0; c < NO; ++c) o[c] *= alpha[j][(c / 2) % 2];
        fence_regs(o);
        wgmma_fence();
        pf_issue_pv<D, HFA>(o, ph[j], pl[j], v_addr, j);
        wgmma_commit();
      }
      wgmma_wait<0>();
      fence_regs(o);
    }
    release(s, i + kPfStages);
  }

  if (!active) return;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = lrow + 8 * hr;
    if (row >= p.L) continue;
    const size_t r = (((size_t)b * p.hkv + h) * p.G + g) * p.L + row;
    float* orow = p.o + r * D;
#pragma unroll
    for (int nb = 0; nb < D / 8; ++nb)
      *reinterpret_cast<float2*>(orow + 8 * nb + 2 * t) =
          make_float2(o[4 * nb + 2 * hr], o[4 * nb + 2 * hr + 1]);
    if (t == 0) {
      p.m[r] = m[hr];
      p.l[r] = l[hr];
    }
  }
}

// The pool (P, page, Hkv, D) bf16 as boxes of 64 columns x 16 rows of one
// kv head, 128-byte swizzled: dims (D, Hkv, P page).
inline bool make_pool_map(CUtensorMap* map, const void* base, int rows, int hkv, int D) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)hkv, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)hkv * D * 2};
  const cuuint32_t box[3] = {kSwzCols, 1, kPfPage};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, bool HFA>
int launch_pf(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv,
              const PfParams& p, const Lut& lut, int B, cudaStream_t s) {
  auto kernel = paged_prefill_tc_kernel<D, HFA>;
  const int bytes = pf_smem_bytes<D>(p.J);
  static bool ready = false;   // the shared-memory attribute is set
  if (!ready) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, pf_smem_bytes<D>(kPfMaxPages));
    if (err != cudaSuccess) return (int)err;
    ready = true;
  }
  const dim3 grid(p.hkv, B, (p.n_units + kPfUnits - 1) / kPfUnits);
  kernel<<<grid, kPfThreads, bytes, s>>>(mq, mk, mv, p, lut);
  return (int)cudaGetLastError();
}

bool aligned16(const void* ptr) { return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0; }

// kv: the pools beside q - 0 q's dtype, 1 int8 with row scales ks / vs,
// 2 bf16 under an f32 q (kernels/cuda_lib.py KV_SAME, KV_INT8, KV_BF16).
int run_dc(const void* q, const void* k, const void* v, const void* ks, const void* vs,
           const void* pt, const void* lens_a, const void* lens_b, void* o, void* m, void* l,
           void* ws, void* counters, int B, int hkv, int R, int L, int row_blocks, int D, int J,
           int page, int splits, float scale, int use_hfa, int bf16, int kv,
           const void* lut_host, void* stream) {
  if (B <= 0 || B > 65535 || hkv <= 0 || hkv > 65535 || R <= 0 || L <= 0 || row_blocks <= 0 ||
      R % row_blocks != 0 || R / row_blocks > kDcMaxRows || J <= 0 || page <= 0 ||
      splits <= 0 || (long long)splits * row_blocks > 65535 ||
      (D != 32 && D != 64 && D != 96 && D != 128) || !aligned16(k) || !aligned16(v) ||
      (splits > 1 && (use_hfa || ws == nullptr || counters == nullptr)) || kv < 0 || kv > 2 ||
      (kv == 1) != (ks != nullptr && vs != nullptr) || (kv == 2 && bf16))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  DcParams p;
  p.q = q; p.k = k; p.v = v;
  p.ks = static_cast<const float*>(ks);
  p.vs = static_cast<const float*>(vs);
  p.pt = static_cast<const int*>(pt);
  p.lens_a = static_cast<const int*>(lens_a);
  p.lens_b = static_cast<const int*>(lens_b);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<unsigned*>(counters);
  p.R = R; p.L = L; p.RB = R / row_blocks;
  p.J = J; p.page = page; p.hkv = hkv; p.splits = splits;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kv == 1) return launch_dc_codec(p, lut, B, D, use_hfa, bf16, s);
  if (kv == 2) return launch_dc_d<float, __nv_bfloat16>(p, lut, B, D, use_hfa, s);
  return bf16 ? launch_dc_d<__nv_bfloat16, __nv_bfloat16>(p, lut, B, D, use_hfa, s)
              : launch_dc_d<float, float>(p, lut, B, D, use_hfa, s);
}

}  // namespace

// Each entry point returns the first CUDA error of its launch (0 = ok).
//
// q (B, Hkv, G, L, D) bf16; pools (P, page, Hkv, D) bf16, page 16; all
// 16-byte aligned and contiguous; D is 64 or 128.  o (B, Hkv, G, L, D), m
// and l (B, Hkv, G, L) f32.
extern "C" int paged_prefill_fwd_tc(const void* q, const void* k, const void* v, const void* pt,
                                    const void* start_pos, const void* kv_lens, void* o, void* m,
                                    void* l, int B, int hkv, int G, int L, int D, int J, int page,
                                    int num_pages, float scale, int use_hfa, const void* lut_host,
                                    void* stream) {
  const int n_units = G * ((L + kPfRows - 1) / kPfRows);
  if (B <= 0 || B > 65535 || hkv <= 0 || G <= 0 || L <= 0 || J <= 0 || num_pages <= 0 ||
      page != kPfPage || J > kPfMaxPages || (D != 64 && D != 128) || (n_units + kPfUnits - 1) / kPfUnits > 65535 ||
      !aligned16(q) ||
      !aligned16(k) || !aligned16(v))
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, B * hkv * G, L, D, kPfRows) ||
      !make_pool_map(&mk, k, num_pages * page, hkv, D) ||
      !make_pool_map(&mv, v, num_pages * page, hkv, D))
    return (int)cudaErrorInvalidValue;
  Lut lut;
  memcpy(&lut, lut_host, sizeof(Lut));
  PfParams p;
  p.pt = static_cast<const int*>(pt);
  p.start = static_cast<const int*>(start_pos);
  p.kv_lens = static_cast<const int*>(kv_lens);
  p.o = static_cast<float*>(o);
  p.m = static_cast<float*>(m);
  p.l = static_cast<float*>(l);
  p.L = L; p.G = G; p.J = J; p.hkv = hkv; p.n_units = n_units;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return use_hfa ? launch_pf<64, true>(mq, mk, mv, p, lut, B, s)
                   : launch_pf<64, false>(mq, mk, mv, p, lut, B, s);
  return use_hfa ? launch_pf<128, true>(mq, mk, mv, p, lut, B, s)
                 : launch_pf<128, false>(mq, mk, mv, p, lut, B, s);
}

// q (B, Hkv, G, D), bf16 (bf16 = 1) or f32; pools (P, page, Hkv, D) as
// kv says (see run_dc), contiguous, 16-byte aligned, with ks / vs (P,
// page, Hkv) f32 for int8 pools; D is 32, 64, 96 or 128; G <= 16.  splits >
// 1 (FA-2 rail only) splits each walk into that many runs of 16-key
// tiles, with ws (B Hkv splits G (D + 2) f32) and counters (B Hkv uint32,
// zero, and left zero) for the merge; launches that share counters run
// one at a time (one stream).  o (B, Hkv, G, D), m and l (B, Hkv, G) f32.
extern "C" int paged_decode_fwd_v2(const void* q, const void* k, const void* v, const void* ks,
                                   const void* vs, const void* pt, const void* kv_lens, void* o,
                                   void* m, void* l, void* ws, void* counters, int B, int hkv,
                                   int G, int D, int J, int page, int splits, float scale,
                                   int use_hfa, int bf16, int kv, const void* lut_host,
                                   void* stream) {
  return run_dc(q, k, v, ks, vs, pt, kv_lens, nullptr, o, m, l, ws, counters, B, hkv, G, 1, 1,
                D, J, page, splits, scale, use_hfa, bf16, kv, lut_host, stream);
}

// Verify: q (B, Hkv, G, K, D), the G K rows of a (slot, kv head) in
// row_blocks blocks of G K / row_blocks rows (at most 16); row (g, i)
// sees kv <= seq_lens[b] + i and kv < seq_lens[b] + chunk_lens[b].  ws
// (B Hkv splits G K (D + 2) f32) and counters (B Hkv row_blocks uint32)
// as for decode.  o (B, Hkv, G, K, D), m and l (B, Hkv, G, K) f32.
extern "C" int paged_verify_fwd_v2(const void* q, const void* k, const void* v, const void* ks,
                                   const void* vs, const void* pt, const void* seq_lens,
                                   const void* chunk_lens, void* o, void* m, void* l, void* ws,
                                   void* counters, int B, int hkv, int G, int K, int D, int J,
                                   int page, int splits, int row_blocks, float scale,
                                   int use_hfa, int bf16, int kv, const void* lut_host,
                                   void* stream) {
  if (G <= 0 || K <= 0 || chunk_lens == nullptr) return (int)cudaErrorInvalidValue;
  return run_dc(q, k, v, ks, vs, pt, seq_lens, chunk_lens, o, m, l, ws, counters, B, hkv, G * K,
                K, row_blocks, D, J, page, splits, scale, use_hfa, bf16, kv, lut_host, stream);
}
