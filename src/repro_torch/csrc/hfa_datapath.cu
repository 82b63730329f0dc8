// The per-element H-FA datapath (the paper's FAU, Fig. 3) for Hopper
// (sm_90a), over (BH, L, D) slabs.
//
// Replaces the Pallas TPU kernel of the reference package
//   src/repro/kernels/hfa_datapath.py  _datapath_kernel -> hfa_datapath_fwd
// Key j is visible to query row i when j < kv_len and, if causal,
// j <= i + q_offset, so a row's visible keys are a prefix.  For each row
// the FAU streams them in order through the FIX16 LNS state O = [l, o] of
// width D + 1 (V_j = [1, v_j]): m_new = max(m, s_j); A = O +
// quant(m - m_new); B = blinn(V_j) + quant(s_j - m_new); O = lns_add(A,
// B); then LogDiv (o - l on the rail) and the bit packing back to bf16
// (lns_rail.cuh).  Scores are the f32 dot product of q and k, times the
// scale with one rounded multiply, rounded to bf16.
//
// What bounds it: the LNS updates, one per (visible pair, column), 2.17e9
// per layer at the dense-serve prefill (BH 128, L 512, D 128, causal).
// They are integer adds, compares, selects and a table lookup with no
// tensor-core form, so they run on the CUDA cores; the reference's
// definition of one update takes some 20 instructions at the least
// (chip_smoke.py _datapath_bound itemizes them), 1.3 ms of the card's
// 33.5e12 instructions a second.  The bytes (q, k, v read, the output
// written) are 67 MB, 0.02 ms.
//
// Design.  One block owns kRows query rows of one bh and streams the keys
// they see through shared memory in tiles of kKeys, by cp.async into a
// two-stage ring (decode_common.cuh), so the next tile loads while this
// one computes.  Per tile, three passes, each quantity computed once for
// all the block's rows and columns that use it:
//   A. every thread: the tile's scores for the block's rows (dc_dots,
//      the decode kernels' dot order) and V's LNS form, blinn_log2 per
//      (key, column) packed as raw << 1 | sign;
//   B. one thread a row: the running max through the tile, q_dm =
//      quant(m - m_new) and q_ds = quant(s - m_new) as an int2 per (row,
//      key) (q_dm = 1, a value no live key gives, marks a key the row does
//      not see), and column 0 (l), whose V is blinn(1.0) = (0, 0);
//   C. D column threads for each group of kRpt rows: a thread owns one
//      column for kRpt rows, kRpt independent lns_add chains that overlap,
//      and reads per key its column's packed V and one int4 of the rows'
//      (q_dm, q_ds) pairs (a broadcast: a warp's lanes share the rows).
// Column 0 and every rescale are the reference's; the update of pass C
// uses what its operands cannot be: B = blinn(v) + q_ds is never zero and
// never clamped when v != 0 (raw >= -16255, q_ds >= -2770), which leaves
// only the cancellation and the top clamp (fau_step); v == 0 is a branch
// of its own (fau_step_zero_v).  The Mitchell correction exp2_neg(d) is
// a 1,024-entry table in shared memory (0 beyond), built on the host
// from the plain version.  A tile in which every row sees every key runs
// pass C with no mask; a tile on the causal diagonal skips, per row and
// warp-uniformly, the keys a row does not see - exact, as a masked key
// leaves the state unchanged.  Causal row tiles stop at their last
// visible key and are launched longest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "lns_rail.cuh"

namespace {

constexpr int kRows = 16;    // query rows a block owns
constexpr int kRpt = 4;      // rows a column thread carries: independent chains
constexpr int kGroups = kRows / kRpt;
constexpr int kKeys = 32;    // keys a tile streams
constexpr int kDead = 1;     // q_dm of a (row, key) the row does not see (live ones are <= 0)

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
  unsigned short* out;   // (BH, Lq, D) bf16 bits; the scores (BH, Lq, Lkv) in scores mode
  int Lq, Lkv, kv_len, q_offset, causal;
  float scale;
};

// Byte offsets of the dynamic shared memory: the ring (2 stages of a K
// and a V tile) from 0, then each region from its offset.
template <typename T, int D>
struct Smem {
  static constexpr int kRowBytes = D * (int)sizeof(T) + 16;  // a key row: an odd count of 16-byte chunks
  static constexpr int kTileBytes = kKeys * kRowBytes;
  static constexpr int kQ = 4 * kTileBytes;                  // q rows, f32 [row][D]
  static constexpr int kVl = kQ + kRows * D * 4;             // V's raw << 1 | sign [key][D]
  static constexpr int kS = kVl + kKeys * D * 4;             // scores, f32 [row][key]
  static constexpr int kW = kS + kRows * kKeys * 4;          // (q_dm, q_ds) int2 [key][row]
  static constexpr int kL = kW + kKeys * kRows * 8;          // column 0's final (sign, raw) [row]
  static constexpr int kTab = kL + kRows * 8;                // the correction table
  static constexpr int kBytes = kTab + kCorrTab;
};

// Pass C's update of one live (row, key) on a column whose V is not zero:
// the reference's rail_rescale of both operands and lns_add, where B =
// rv + q_ds lies in [-19025, 16511] - never zero, never clamped - so that
// of lns_add's bypasses only the cancellation is left (a zero A gives d >=
// 13743 and so corr 0, sign and raw from B: the bypass's result) and only
// the top of the clamp (big - corr >= -19153).
__device__ __forceinline__ void fau_step(int& sa, int& ra, int sv, int rv, int q_dm, int q_ds,
                                         const unsigned char* tab) {
  const int a = rail_rescale(ra, q_dm);
  const int b = rv + q_ds;
  const int big = max(a, b);
  const int d = big - min(a, b);
  const int corr = exp2_neg(d, tab);
  const bool same = sa == sv;
  int rc = same ? big + corr : big - corr;
  int sc = a > b ? sa : sv;
  if (!same && d == 0) {
    rc = kLogZero;
    sc = 0;
  }
  ra = min(rc, kFixMax);
  sa = sc;
}

// The same where V is zero: B is zero, so lns_add gives A, with sign 0
// where A is zero too.
__device__ __forceinline__ void fau_step_zero_v(int& sa, int& ra, int q_dm) {
  ra = rail_rescale(ra, q_dm);
  if (ra == kLogZero) sa = 0;
}

// Pass C over keys 0..nk of the tile for this thread's kRpt rows.
template <int D, bool MASKED>
__device__ __forceinline__ void column_pass(const int* vl, const int2* w, int nk, int (&sa)[kRpt],
                                            int (&ra)[kRpt], const unsigned char* tab) {
  for (int j = 0; j < nk; ++j) {
    const int vw = vl[j * D];
    const int sv = vw & 1, rv = vw >> 1;
    int q_dm[kRpt], q_ds[kRpt];
#pragma unroll
    for (int i = 0; i < kRpt; i += 2) {
      const int4 pr = *reinterpret_cast<const int4*>(w + j * kRows + i);
      q_dm[i] = pr.x;
      q_ds[i] = pr.y;
      q_dm[i + 1] = pr.z;
      q_ds[i + 1] = pr.w;
    }
    if (rv == kLogZero) {
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        if (!MASKED || q_dm[i] != kDead) fau_step_zero_v(sa[i], ra[i], q_dm[i]);
    } else {
#pragma unroll
      for (int i = 0; i < kRpt; ++i)
        if (!MASKED || q_dm[i] != kDead) fau_step(sa[i], ra[i], sv, rv, q_dm[i], q_ds[i], tab);
    }
  }
}

// SCORES: write the tile's bf16 scores to p.out (BH, Lq, Lkv) and stop
// there - the same score code, for the checks.
template <typename T, int D, bool SCORES>
__global__ void __launch_bounds__(D * kGroups)
hfa_datapath_kernel(const DatapathParams p, const CorrTable tab_in) {
  using S = Smem<T, D>;
  constexpr int NT = D * kGroups;
  constexpr int CPR = D * (int)sizeof(T) / 16;     // 16-byte chunks of a key row
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + S::kQ);
  int* vl_s = reinterpret_cast<int*>(smem + S::kVl);
  float* s_s = reinterpret_cast<float*>(smem + S::kS);
  int2* w_s = reinterpret_cast<int2*>(smem + S::kW);
  int2* l_s = reinterpret_cast<int2*>(smem + S::kL);
  unsigned char* tab = smem + S::kTab;

  const int bh = blockIdx.x;
  const int r0 = (p.causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y) * kRows;  // longest first
  const int tid = threadIdx.x;
  // The keys a row sees are a prefix, longer for a later row: n_hi for
  // the block's last row, n_r for this thread's (the row pass's) row.
  const int n_all = max(0, min(p.kv_len, p.Lkv));
  const int last = min(r0 + kRows, p.Lq) - 1;
  const int n_hi = p.causal ? max(0, min(n_all, last + p.q_offset + 1)) : n_all;
  const int my_row = r0 + tid;
  const int n_r = my_row >= p.Lq ? 0
                  : p.causal ? max(0, min(n_all, my_row + p.q_offset + 1)) : n_all;

  const T* qg = static_cast<const T*>(p.q) + (size_t)bh * p.Lq * D;
  for (int idx = tid; idx < kRows * D; idx += NT) {
    const int row = r0 + idx / D;
    q_s[idx] = row < p.Lq ? to_f32(qg[(size_t)row * D + idx % D]) : 0.f;
  }
  if (!SCORES)
    for (int i = tid; i < kCorrTab; i += NT) tab[i] = tab_in.v[i];

  // Ring: tile t's K then V in stage t & 1; keys at or past n_hi zero-filled.
  const T* kg = static_cast<const T*>(p.k) + (size_t)bh * p.Lkv * D;
  const T* vg = static_cast<const T*>(p.v) + (size_t)bh * p.Lkv * D;
  const int n_tiles = (n_hi + kKeys - 1) / kKeys;
  auto issue = [&](int t) {
    unsigned char* st = smem + (t & 1) * 2 * S::kTileBytes;
    constexpr int kChunks = (SCORES ? 1 : 2) * kKeys * CPR;
    for (int i = tid; i < kChunks; i += NT) {
      const int which = i / (kKeys * CPR), j = (i / CPR) % kKeys, ch = i % CPR;
      const int key = t * kKeys + j;
      const bool ok = key < n_hi;
      const T* src = (which ? vg : kg) + (size_t)(ok ? key : 0) * D + ch * (16 / (int)sizeof(T));
      cp_async16(dc_smem_addr(st + which * S::kTileBytes + j * S::kRowBytes + ch * 16), src,
                 ok ? 16 : 0);
    }
    cp_async_commit();
  };

  // Row state (threads below kRows): the running max and column 0.
  float m = kNegInf;
  int ls = 0, lr = kLogZero;
  // Column state: column c of rows g kRpt .. g kRpt + kRpt - 1.
  const int c = tid % D, g = tid / D;
  int sa[kRpt], ra[kRpt];
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    sa[i] = 0;
    ra[i] = kLogZero;
  }

  if (n_tiles > 0) issue(0);
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      issue(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t landed; the previous tile's passes are done
    const int k0 = t * kKeys;
    const int nk = min(kKeys, n_hi - k0);
    const unsigned char* st = smem + (t & 1) * 2 * S::kTileBytes;

    // A: the scores of the block's rows, and V's LNS form.
    for (int idx = tid; idx < kRows * kKeys; idx += NT) {
      const int r = idx / kKeys, j = idx % kKeys;
      float dot[1];
      dc_dots<T, D, 1>(q_s + r * D, 0, reinterpret_cast<const T*>(st + j * S::kRowBytes), dot);
      const float s = __bfloat162float(__float2bfloat16_rn(__fmul_rn(dot[0], p.scale)));
      if (SCORES) {
        if (r0 + r < p.Lq && j < nk)
          p.out[((size_t)bh * p.Lq + r0 + r) * p.Lkv + k0 + j] = bf16_bits(s);
      } else {
        s_s[idx] = s;
      }
    }
    if (!SCORES)
      for (int idx = tid; idx < kKeys * D; idx += NT) {
        const T* vr = reinterpret_cast<const T*>(st + S::kTileBytes + (idx / D) * S::kRowBytes);
        int sg, rw;
        blinn_log2(bf16_bits(vr[idx % D]), sg, rw);
        vl_s[idx] = (int)((unsigned)rw << 1) | sg;
      }
    __syncthreads();  // the stage is read: the next refill may overwrite it
    if (SCORES) continue;

    // B: one thread a row.
    int dead = 0;
    if (tid < kRows) {
      for (int j = 0; j < nk; ++j) {
        const float s = s_s[tid * kKeys + j];
        const float m_new = fmaxf(m, s);
        int2 w = make_int2(kDead, 0);
        if (k0 + j < n_r && m_new > kNegInf * 0.5f) {
          w.x = quant_scorediff(__fsub_rn(m, m_new));
          w.y = quant_scorediff(__fsub_rn(s, m_new));
          lns_add(ls, rail_rescale(lr, w.x), 0, w.y, tab, ls, lr);  // V = 1.0: (0, 0)
          m = m_new;
        } else {
          dead = 1;
        }
        w_s[j * kRows + tid] = w;
      }
    }
    const int masked = __syncthreads_or(dead);

    // C: the column threads.
    if (masked)
      column_pass<D, true>(vl_s + c, w_s + g * kRpt, nk, sa, ra, tab);
    else
      column_pass<D, false>(vl_s + c, w_s + g * kRpt, nk, sa, ra, tab);
  }
  if (SCORES) return;

  // LogDiv (Eq. 15) and the bit packing (Eq. 22): o / l = o - l on the rail.
  if (tid < kRows) l_s[tid] = make_int2(ls, lr);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRpt; ++i) {
    const int row = r0 + g * kRpt + i;
    if (row >= p.Lq) continue;
    const int2 l = l_s[g * kRpt + i];
    const bool empty = l.y <= kLogZero || ra[i] <= kLogZero;
    p.out[((size_t)bh * p.Lq + row) * D + c] =
        lns_to_bf16(sa[i] ^ l.x, empty ? kLogZero : clamp_rail(ra[i] - l.y));
  }
}

template <typename T, int D, bool SCORES>
int launch(const DatapathParams& p, const CorrTable& tab, int BH, cudaStream_t s) {
  const int tiles = (p.Lq + kRows - 1) / kRows;
  if (tiles > 65535) return (int)cudaErrorInvalidValue;
  constexpr int smem = Smem<T, D>::kBytes;
  auto kernel = hfa_datapath_kernel<T, D, SCORES>;
  static bool sized = false;  // the attribute, once per instantiation
  if (!sized) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sized = true;
  }
  kernel<<<dim3(BH, tiles), D * kGroups, smem, s>>>(p, tab);
  return (int)cudaGetLastError();
}

template <typename T, bool SCORES>
int launch_d(const DatapathParams& p, const CorrTable& tab, int BH, int D, cudaStream_t s) {
  switch (D) {
    case 32: return launch<T, 32, SCORES>(p, tab, BH, s);
    case 64: return launch<T, 64, SCORES>(p, tab, BH, s);
    case 96: return launch<T, 96, SCORES>(p, tab, BH, s);
    default: return launch<T, 128, SCORES>(p, tab, BH, s);
  }
}

int run(const void* q, const void* k, const void* v, void* out, int BH, int Lq, int Lkv, int D,
        int kv_len, int q_offset, int causal, float scale, int bf16, const void* tab_host,
        void* stream, bool scores) {
  if (BH <= 0 || Lq <= 0 || Lkv <= 0 || (D != 32 && D != 64 && D != 96 && D != 128))
    return (int)cudaErrorInvalidValue;
  CorrTable tab;
  if (tab_host) memcpy(&tab, tab_host, sizeof(CorrTable));
  else memset(&tab, 0, sizeof(CorrTable));
  DatapathParams p;
  p.q = q; p.k = k; p.v = v;
  p.out = static_cast<unsigned short*>(out);
  p.Lq = Lq; p.Lkv = Lkv; p.kv_len = kv_len; p.q_offset = q_offset; p.causal = causal;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (scores)
    return bf16 ? launch_d<__nv_bfloat16, true>(p, tab, BH, D, s)
                : launch_d<float, true>(p, tab, BH, D, s);
  return bf16 ? launch_d<__nv_bfloat16, false>(p, tab, BH, D, s)
              : launch_d<float, false>(p, tab, BH, D, s);
}

__global__ void lns_eval_kernel(const int* sa, const float* ra, const int* sb, const float* rb,
                                const float* x, const int* bits, int* sc, float* rc,
                                float* quant, int* bsign, float* braw, unsigned short* packed,
                                float* corr, int n, const CorrTable tab_in) {
  __shared__ unsigned char tab[kCorrTab];
  for (int i = threadIdx.x; i < kCorrTab; i += blockDim.x) tab[i] = tab_in.v[i];
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int s, r;
  lns_add(sa[i], (int)ra[i], sb[i], (int)rb[i], tab, s, r);
  sc[i] = s;
  rc[i] = (float)r;
  quant[i] = (float)quant_scorediff(x[i]);
  blinn_log2((unsigned)bits[i] & 0xFFFFu, s, r);
  bsign[i] = s;
  braw[i] = (float)r;
  packed[i] = lns_to_bf16(sa[i], (int)ra[i]);
  corr[i] = (float)exp2_neg(bits[i] & 0xFFFF, tab);
}

}  // namespace

// out (BH, Lq, D) bf16; q (BH, Lq, D), k and v (BH, Lkv, D) bf16 (bf16 = 1)
// or f32, contiguous and 16-byte aligned; D is 32, 64, 96 or 128; tab the
// 1,024 bytes of exp2_neg.  Returns the first CUDA error of the launch (0 = ok).
extern "C" int hfa_datapath_fwd(const void* q, const void* k, const void* v, void* out, int BH,
                                int Lq, int Lkv, int D, int kv_len, int q_offset, int causal,
                                float scale, int bf16, const void* tab_host, void* stream) {
  if (!tab_host) return (int)cudaErrorInvalidValue;
  return run(q, k, v, out, BH, Lq, Lkv, D, kv_len, q_offset, causal, scale, bf16, tab_host,
             stream, false);
}

// The scores hfa_datapath_fwd forms, from the same code, for the checks:
// scores (BH, Lq, Lkv) bf16, written for every key a row tile streams
// (the keys the tile's last row sees); the rest are left as they were.
extern "C" int hfa_datapath_scores(const void* q, const void* k, void* scores, int BH, int Lq,
                                   int Lkv, int D, int kv_len, int q_offset, int causal,
                                   float scale, int bf16, void* stream) {
  return run(q, k, k, scores, BH, Lq, Lkv, D, kv_len, q_offset, causal, scale, bf16, nullptr,
             stream, true);
}

// The LNS device functions over n elements, for the bit-equality checks:
// (sc, rc) = lns_add(sa, ra, sb, rb); quant = quant_scorediff(x);
// (bsign, braw) = blinn_log2(bits); packed = lns_to_bf16(sa, ra);
// corr = exp2_neg(bits & 0xFFFF) from the table.
extern "C" int lns_eval(const void* sa, const void* ra, const void* sb, const void* rb,
                        const void* x, const void* bits, void* sc, void* rc, void* quant,
                        void* bsign, void* braw, void* packed, void* corr, int n,
                        const void* tab_host, void* stream) {
  if (n <= 0 || !tab_host) return (int)cudaErrorInvalidValue;
  CorrTable tab;
  memcpy(&tab, tab_host, sizeof(CorrTable));
  lns_eval_kernel<<<(n + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(sa), static_cast<const float*>(ra), static_cast<const int*>(sb),
      static_cast<const float*>(rb), static_cast<const float*>(x), static_cast<const int*>(bits),
      static_cast<int*>(sc), static_cast<float*>(rc), static_cast<float*>(quant),
      static_cast<int*>(bsign), static_cast<float*>(braw), static_cast<unsigned short*>(packed),
      static_cast<float*>(corr), n, tab);
  return (int)cudaGetLastError();
}
