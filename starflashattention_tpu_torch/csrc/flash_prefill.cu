// Prefill attention (FlashAttention-2 forward) for Hopper (sm_90a).
//
// Replaces: starflashattention_tpu/ops/flash_prefill.py::_prefill_kernel
// (entry flash_prefill) in the forms the model's prefill and the training
// path use: causal or not, with per-sequence lengths and q_offsets,
// optionally the per-row base-2 log-sum-exp (return_lse), and for the
// causal form the sliding window, sinks and softcap (the serving prefill,
// and with the LSE the training forward of the attention variants, whose
// backward flash_bwd.cu recomputes the same capped scores).
//
// Window and sinks (JAX _prefill_kernel :128-146, :181-184): row p attends
// col > p - window, or col < sinks. The block walks the sink tiles that lie
// below its band's first tile, then its band from the tile that holds its
// first row's band start (no tile twice); a warp skips a tile wholly below
// its own band unless it holds sinks; rows below the block's band that are
// not sinks are never loaded (zero-filled). Window and sinks are runtime
// ints behind a BAND template flag, so the unbanded prefill compiles to the
// kernel it was before them (with the band tests as runtime branches it ran
// 5-8% slower at the serving shapes). Softcap (a template flag, since it
// acts on every score in the unrolled fragment loop): the fp32 score is scaled by sm_scale,
// capped as cap * tanh(s / cap), and only then converted to base 2 (JAX
// folds sm_scale alone into q for this, :162-166, :314-316).
//
// Ring context parallelism (JAX kv_offset, :118, :134, :146, :184): k and
// v are one chunk of the sequence at global position kv_offset, and only
// the sinks' boundary is absolute (col < sinks - kv_offset, col local to
// the chunk); the causal diagonal and the band move with q_offsets. The
// wrapper passes max(sinks - kv_offset, 0) as opt.sinks, so no form of its
// own is needed. A chunk wholly in the rows' future comes with a negative
// q_offsets (kv_end <= 0 below: no tile runs) and one past a sequence's
// length with lengths clipped to 0: the rows get 0 and the LSE 3e38.
//
// q: (B, Hq, Sq, D) bf16; k, v: (B, Hkv, Skv, D) bf16 (in the model, one
// layer of the cache table, passed as a pointer into it); lengths and
// q_offsets: (B,) int32. Query row i of sequence b sits at absolute
// position q_offsets[b] + i and attends KV positions j < lengths[b], and
// with causal also j <= q_offsets[b] + i. Query head h reads KV head h / G.
// A row with no valid position gives 0; rows past Sq are never written.
//
// Scores are in base-2 units, as in the TPU kernel: s2 = scale_log2 * q.k
// with scale_log2 = sm_scale * log2(e), computed in fp32 from the fp32
// product (the TPU kernel folds the scale into q and rounds it to q's
// dtype first), and the softmax runs on exp2. With LSE the kernel also
// writes lse[b, h, i] = m2 + log2(l) (B, Hq, Sq) fp32, or 3e38 for a row
// that saw no valid position, so that the backward's exp2(s2 - lse) is 0
// there. flash_bwd.cu recomputes s2 with the same scale_log2.
//
// Bound: at the model's prefill and training shapes (thousands of rows per
// sequence, D = 128 or 256) the 4 * D operations per (query, key) pair
// under the mask bound it at the tensor-core rate; the bytes (q, the valid
// K/V prefix, the output) are small next to them. Design (flash_prefill_kernel
// <D, CAUSAL, LSE, SOFTCAP, BAND>), on mma.sync.m16n8k16 (bf16 in, fp32
// accumulate):
// - One block per (128-row q tile, query head, sequence); the longest walks
//   are numbered first (q_tile). Four row groups of 32
//   rows: a warp's rows are two m16 tiles, so each K and V fragment read
//   from shared memory (ldmatrix, K non-transposed, V .trans, rows padded
//   to D + 8 elements: no bank conflicts) feeds two mma. Q sits in shared
//   memory and is read by ldmatrix a k-step at a time; fragments of the
//   next step load before this step's mma.
// - D <= 128: one warp a row group, 4 warps, its 32 x D output accumulators
//   in registers (128 a thread at D = 128), two blocks an SM; K/V tiles of
//   64 rows at D = 64, and of 32 rows in three stages at D = 128 (64-row
//   tiles took all 255 registers and spilled). D = 256: two warps a row
//   group, 8 warps, each owning 128 output columns and the matching half
//   of the QK contraction; warp `part` owns m-tile `part`'s softmax: it
//   takes its partner's partial scores of those 16 rows through shared
//   memory (a barrier of the pair), runs the softmax, and hands back P as
//   bf16 A fragments with the rows' rescale factors (a second barrier), so
//   no score is exponentiated (or capped) twice; 32-row K/V tiles.
// - K/V tiles stream through a ring in shared memory filled by cp.async
//   (attn_tiles.cuh): K and V of a stage have an mbarrier each, so a warp
//   waits for K before QK^T and for V only before P V, and one block
//   barrier a stage (after its last reader) precedes its refill. Rows the
//   mask keeps out (past the length; with BAND below the block's band and
//   not sinks) are zero-filled by the copy (src-size 0) and never read.
// - The online softmax runs in fp32 (quad shuffles for the row max; the row
//   sum is reduced once at the end); P goes from the score accumulators to
//   the PV operand without touching memory (D <= 128). The mask is tested
//   only on tiles that cross the length, the diagonal or the band of the
//   warp's rows (elsewhere it would pass everywhere: the same bits). The block walks KV tiles only up to
//   lengths[b] (causal: and the last position of its rows); a warp whose
//   rows all precede a tile, or lie past its band, skips its arithmetic.
//   O leaves through the warp's own Q rows in shared memory, 16 bytes a
//   lane. CAUSAL, LSE, SOFTCAP and BAND are template flags, so the serving
//   prefill's instantiation carries neither the non-causal branch nor the
//   LSE store.
// Not yet: wgmma and TMA (each 64-row warpgroup tile would read K and V
// once from shared memory for its 64 rows, where mma.sync reads them once
// for 32).
//
// MLA's latent row (flash_prefill_latent_kernel: D = 640, causal, no LSE,
// no window / sinks / softcap): DeepSeek-V2's 16 query heads attend one
// 640-lane latent KV head. One warp's 16 rows x 640 fp32 accumulators
// would be 320 registers a thread, and a block of all 16 heads 512
// threads; so the output columns are cut into five 128-lane slices, one
// warp each, and a block holds 16 query rows of HB = 2 heads: 10 warps, 320
// threads. The 16 x 32 score tile of a head is computed once between its
// five warps: each takes a 128-deep slice of the 640-deep contraction
// (its Q fragments stay in registers), writes its partial scores to shared
// memory, and after a barrier every warp sums the five partials in slice
// order, so all five hold the same fp32 scores bit for bit and run the
// same online softmax; each then accumulates P @ V on its own 128 columns
// (64 accumulator registers a thread). Grid: (q tiles of 16 rows,
// Hkv * G / 2, B); the K/V tile staged in shared memory serves the block's
// 2 heads x 16 rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"

namespace {

using namespace attn;
typedef __nv_bfloat16 bf16;

constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr float LSE_EMPTY = 3e38f;  // the LSE of a row with no valid position
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NO_WINDOW = 1 << 30;  // the window argument without a window

// K5's tiles (see the header). A block: BM = 128 query rows of one head in
// four row groups of 32; SPLIT warps share a row group, each owning DP = D /
// SPLIT output columns and that slice of the QK contraction. BN KV rows a
// ring stage, STAGES stages.
template <int D>
struct Geom {
  static constexpr int SPLIT = D > 128 ? 2 : 1;
  static constexpr int GROUPS = 4;
  static constexpr int WARPS = GROUPS * SPLIT;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int BM = 32 * GROUPS;
  static constexpr int BN = D > 64 ? 32 : 64;
  static constexpr int DP = D / SPLIT;
  static constexpr int ST = D + 8;   // padded smem row (elements): conflict-free ldmatrix
  static constexpr int XS = BN + 8;  // row of a warp's partial scores (floats), SPLIT 2
  // SPLIT 2: a warp's exchange slot (floats): 16 rows of partial scores, its
  // P fragments (BN / 16 k-steps x 4 x 32 lanes) and two floats a lane
  static constexpr int XW = 16 * XS + BN / 16 * 128 + 64;
  static constexpr int STAGES = D == 128 ? 3 : 2;
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 2;
  static constexpr size_t SMEM = (size_t)(BM + STAGES * 2 * BN) * ST * sizeof(bf16) +
                                 (SPLIT > 1 ? (size_t)WARPS * XW * sizeof(float) : 0) +
                                 2 * STAGES * sizeof(uint64_t);
  static_assert(BN * D / 8 % THREADS == 0 && BM * D / 8 % THREADS == 0, "whole copies a thread");
};

struct Options {
  int window;     // row at position p attends cols > p - window; 1 << 30 for none
  int sinks;      // cols < sinks stay attendable (with a window)
  float sm_scale;       // natural units (the softcap's input)
  float scale_log2;     // sm_scale * log2(e)
  float softcap;        // > 0 with SOFTCAP
};

// One tile's scores of a lane's two rows: scale (SOFTCAP: cap * tanh(s *
// sm_scale / cap) in natural units, then base 2), mask (the length, the
// diagonal and, with BAND, the window and sinks; !MASK: a tile that holds
// no masked score of these rows, where the test would pass everywhere) and
// fold into the row maxima. col0 is the lane's first column.
template <int ST_N, bool CAUSAL, bool SOFTCAP, bool BAND, bool MASK = true>
__device__ __forceinline__ void scale_mask(float (&s)[ST_N][4], int col0, int pa, int pb, int len,
                                           const Options& opt, float& mx_a, float& mx_b) {
#pragma unroll
  for (int n = 0; n < ST_N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + n * 8 + (e & 1);
      const int pos = e < 2 ? pa : pb;
      bool valid = !MASK || (col < len && (!CAUSAL || col <= pos));
      if constexpr (BAND && MASK) valid = valid && (col > pos - opt.window || col < opt.sinks);
      float x;
      if constexpr (SOFTCAP) {
        x = opt.softcap * tanhf(s[n][e] * opt.sm_scale / opt.softcap) * LOG2E;
      } else {
        x = s[n][e] * opt.scale_log2;
      }
      s[n][e] = valid ? x : NEG_INF;
    }
    mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
    mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
  }
}

// The online softmax step of one m-tile (a lane's rows g and g + 8, at
// positions pa and pa + 8): scale and mask the tile's scores, fold them into
// the row maxima (quad shuffles), exponentiate in place and update the
// lane's share of the row sums (reduced over the quad at the end); alpha
// gets the two rows' rescale factors.
template <int NN, bool CAUSAL, bool SOFTCAP, bool BAND, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[NN][4], int col0, int pa, int len, const Options& opt,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  float mx_a = NEG_INF, mx_b = NEG_INF;
  scale_mask<NN, CAUSAL, SOFTCAP, BAND, MASK>(s, col0, pa, pa + 8, len, opt, mx_a, mx_b);
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m[0], mx_a), mn_b = fmaxf(m[1], mx_b);
  alpha[0] = exp2f(m[0] - mn_a);
  alpha[1] = exp2f(m[1] - mn_b);
  m[0] = mn_a;
  m[1] = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    s[n][0] = s[n][0] == NEG_INF ? 0.f : exp2f(s[n][0] - mn_a);
    s[n][1] = s[n][1] == NEG_INF ? 0.f : exp2f(s[n][1] - mn_a);
    s[n][2] = s[n][2] == NEG_INF ? 0.f : exp2f(s[n][2] - mn_b);
    s[n][3] = s[n][3] == NEG_INF ? 0.f : exp2f(s[n][3] - mn_b);
    sum_a += s[n][0] + s[n][1];
    sum_b += s[n][2] + s[n][3];
  }
  l[0] = l[0] * alpha[0] + sum_a;
  l[1] = l[1] * alpha[1] + sum_b;
}

// o *= the rows' rescale factors. (Skipping it when no row of the m-tile
// moved its maximum gives the same bits, but the warp vote cost more than
// it saved on the card.)
template <int NO>
__device__ __forceinline__ void rescale(float (&o)[NO][4], const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// P of one m-tile as bf16 A fragments: the score accumulators of two
// adjacent n-tiles are one 16-deep k-step of the PV product.
template <int NN>
__device__ __forceinline__ void pack_p(uint32_t (&pf)[NN / 2][4], const float (&s)[NN][4]) {
#pragma unroll
  for (int kk = 0; kk < NN / 2; ++kk) {
    pf[kk][0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
    pf[kk][1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
    pf[kk][2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
    pf[kk][3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
  }
}

// A 16-row score tile in shared memory (row stride XS floats): put, or add
// into the accumulators (the D = 256 pair's exchange of partial scores).
template <int NN, int XS>
__device__ __forceinline__ void put_scores(float* dst, const float (&s)[NN][4], int g, int t) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    float* p = dst + g * XS + n * 8 + 2 * t;
    *reinterpret_cast<float2*>(p) = make_float2(s[n][0], s[n][1]);
    *reinterpret_cast<float2*>(p + 8 * XS) = make_float2(s[n][2], s[n][3]);
  }
}

template <int NN, int XS>
__device__ __forceinline__ void add_scores(float (&s)[NN][4], const float* src, int g, int t) {
#pragma unroll
  for (int n = 0; n < NN; ++n) {
    const float* p = src + g * XS + n * 8 + 2 * t;
    const float2 x = *reinterpret_cast<const float2*>(p);
    const float2 y = *reinterpret_cast<const float2*>(p + 8 * XS);
    s[n][0] += x.x;
    s[n][1] += x.y;
    s[n][2] += y.x;
    s[n][3] += y.y;
  }
}

// A lane's P fragments, and two row values (rescale factors, or at the end
// the row sums), through shared memory lane-major: lane l of the partner
// warp reads what lane l wrote.
template <int NP>
__device__ __forceinline__ void put_frags(uint32_t* pw, const uint32_t (&pf)[NP][4], int lane) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pw[(kk * 4 + r) * 32 + lane] = pf[kk][r];
}

template <int NP>
__device__ __forceinline__ void get_frags(uint32_t (&pf)[NP][4], const uint32_t* pw, int lane) {
#pragma unroll
  for (int kk = 0; kk < NP; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) pf[kk][r] = pw[(kk * 4 + r) * 32 + lane];
}

__device__ __forceinline__ void put_pair(float* aw, const float (&x)[2], int lane) {
  *reinterpret_cast<float2*>(aw + 2 * lane) = make_float2(x[0], x[1]);
}

__device__ __forceinline__ void get_pair(float (&x)[2], const float* aw, int lane) {
  const float2 v = *reinterpret_cast<const float2*>(aw + 2 * lane);
  x[0] = v.x;
  x[1] = v.y;
}

// The block's q tile: tiles in order of blockIdx.y, from the end whose tile
// has the longer KV span in sequence 0 (the causal triangle's last q tiles;
// a ring step whose rows lie past the window, its first), so that the
// longest walks start first.
template <int BM, bool CAUSAL, bool BAND>
__device__ __forceinline__ int q_tile(const int* lengths, const int* q_offsets, int Sq, int Skv,
                                      const Options& opt) {
  const int nqt = gridDim.y, len = min(lengths[0], Skv), qoff = q_offsets[0];
  auto span = [&](int qt) {
    const int kv_end = CAUSAL ? min(len, qoff + min(qt * BM + BM, Sq)) : len;
    return kv_end - (BAND ? max(qoff + qt * BM - opt.window + 1, 0) : 0);
  };
  return span(nqt - 1) >= span(0) ? nqt - 1 - blockIdx.y : blockIdx.y;
}

template <int D, bool CAUSAL, bool LSE, bool SOFTCAP, bool BAND>
__global__ void __launch_bounds__(Geom<D>::THREADS, Geom<D>::MIN_BLOCKS)
    flash_prefill_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const int* __restrict__ lengths,
                         const int* __restrict__ q_offsets, bf16* __restrict__ out,
                         float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, const Options opt) {
  using GM = Geom<D>;
  constexpr int BM = GM::BM, BN = GM::BN, ST = GM::ST, DP = GM::DP, XS = GM::XS;
  constexpr int STAGES = GM::STAGES, THREADS = GM::THREADS;
  constexpr int NN = BN / 8;    // n-tiles of the scores
  constexpr int NO = DP / 8;    // n-tiles of the warp's output columns
  constexpr int KS = DP / 16;   // k-steps of the warp's QK slice
  constexpr int NP = BN / 16;   // pairs of score n-tiles (one K ldmatrix each); k-steps of PV
  constexpr int OP = DP / 16;   // pairs of output n-tiles (one V ldmatrix each)
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);                      // [BM][ST]
  bf16* ring = q_s + BM * ST;                                         // STAGES x (K, V) [BN][ST]
  float* xs = reinterpret_cast<float*>(ring + STAGES * 2 * BN * ST);  // [WARPS][XW], SPLIT 2
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + (GM::SPLIT > 1 ? GM::WARPS * GM::XW : 0));

  const int qt = q_tile<BM, CAUSAL, BAND>(lengths, q_offsets, Sq, Skv, opt);
  const int head = blockIdx.x % Hq, b = blockIdx.x / Hq;
  const int kvh = head / (Hq / Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % GM::GROUPS, part = warp / GM::GROUPS;
  const int lr0 = grp * 32;      // the warp's first row in the block
  const int r0 = qt * BM + lr0;  // ... and in the sequence
  const int len = min(lengths[b], Skv);
  const int qoff = q_offsets[b];
  const int warp_last = qoff + min(r0 + 31, Sq - 1);  // last position of the warp's rows
  const int W = opt.window, SK = opt.sinks;            // read only with BAND

  const int block_last_row = min(qt * BM + BM, Sq) - 1;
  const int kv_end = CAUSAL ? min(len, qoff + block_last_row + 1) : len;
  // Window: the block's lowest band start is its first row's; tiles wholly
  // below it are skipped, except the sink tiles, which come first.
  const int lo = BAND ? max(qoff + qt * BM - W + 1, 0) : 0;
  const int band0 = lo / BN * BN;
  const int sink_tiles_end = BAND ? (min(SK, band0) + BN - 1) / BN * BN : 0;
  const int warp_lo = qoff + r0 - W + 1;  // this warp's lowest band start
  auto next_tile = [&](int j0) { return j0 + BN < sink_tiles_end ? j0 + BN : max(j0 + BN, band0); };
  const int first = sink_tiles_end ? 0 : band0;

  const bf16* qh = q + ((size_t)b * Hq + head) * (size_t)Sq * D;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D;

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < 2 * STAGES; ++i) mbar_init(&bars[i], THREADS);
  }
  __syncthreads();

  // Fill a stage: K, then its barrier, V, then its. Rows past the length,
  // and rows below the block's band that are not sinks, are zero-filled and
  // never read.
  auto issue = [&](int j0, int stage) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const bf16* src = half ? v : k;
      bf16* dst = ring + (stage * 2 + half) * BN * ST;
#pragma unroll
      for (int c = 0; c < BN * D / 8 / THREADS; ++c) {
        const int i = tid + c * THREADS;
        const int row = i / (D / 8), col = (i % (D / 8)) * 8;
        const int j = j0 + row;
        const bool ok = j < len && (!BAND || j >= lo || j < SK);
        cp_async16(dst + row * ST + col, src + kv_base + (ok ? (size_t)j * D + col : 0), ok);
      }
      mbar_arrive_cp_async(&bars[2 * stage + half]);
    }
  };

  if (first < kv_end) {  // Q's rows (past Sq zero-filled), covered by the first K barrier
#pragma unroll
    for (int c = 0; c < BM * D / 8 / THREADS; ++c) {
      const int i = tid + c * THREADS;
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const bool ok = qt * BM + row < Sq;
      cp_async16(q_s + row * ST + col, qh + (ok ? (size_t)(qt * BM + row) * D + col : 0), ok);
    }
  }
  int jl = first;  // the next tile to stage
  for (int s = 0; s < STAGES && jl < kv_end; ++s) {
    issue(jl, s);
    jl = next_tile(jl);
  }

  float o[2][NO][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < NO; ++n) o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
  // per m-tile, rows g and g + 8; SPLIT 2: only the m-tile the warp owns
  // (m-tile `part`) is tracked
  float m_r[2][2], l_r[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) m_r[mt][0] = m_r[mt][1] = NEG_INF, l_r[mt][0] = l_r[mt][1] = 0.f;

  // SPLIT 2: this warp's exchange slot and its partner's (the other half
  // of the row group)
  float* mine = xs + warp * GM::XW;
  const float* theirs = xs + (warp ^ GM::GROUPS) * GM::XW;
  uint32_t* mine_p = reinterpret_cast<uint32_t*>(mine + 16 * XS);
  const uint32_t* theirs_p = reinterpret_cast<const uint32_t*>(theirs + 16 * XS);
  float* mine_a = mine + 16 * XS + NP * 128;
  const float* theirs_a = theirs + 16 * XS + NP * 128;

  // the lane's ldmatrix addresses (bytes): Q, and K / V of stage 0
  constexpr int E = sizeof(bf16), STAGE_BYTES = 2 * BN * ST * E;
  const uint32_t qa = smem_u32(q_s + (lr0 + a_row(lane)) * ST + part * DP + a_col(lane));
  const uint32_t ka = smem_u32(ring + b_row(lane) * ST + part * DP + b_col(lane));
  const uint32_t va = smem_u32(ring + BN * ST + a_row(lane) * ST + part * DP + a_col(lane));
  int it = 0;
  for (int j0 = first; j0 < kv_end; j0 = next_tile(j0), ++it) {
    const int stage = it % STAGES;
    const uint32_t par = (it / STAGES) & 1;
    // warp-uniform (and the same for the warps of a row group): the warp has
    // rows, the tile is not wholly above its diagonal, and not wholly below
    // its band unless it holds sinks. Some warp takes every tile of the walk
    // (the warps' bands join into the block's, which bounds the walk), so
    // every stage's phases are waited on before the stage is refilled.
    if (r0 < Sq && (!CAUSAL || j0 <= warp_last) && (!BAND || j0 + BN - 1 >= warp_lo || j0 < SK)) {
      mbar_wait(&bars[2 * stage], par);
      float s[2][NN][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int n = 0; n < NN; ++n) s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
      // S = Q K^T over the warp's slice of D; each K fragment serves both
      // m-tiles, and loads a step ahead of its mma
      const uint32_t kp = ka + stage * STAGE_BYTES;
      uint32_t qf[2][4], kf[2][4];
      ldmatrix_x4(kf[0], kp);
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        ldmatrix_x4(qf[0], qa + kk * 16 * E);
        ldmatrix_x4(qf[1], qa + (16 * ST + kk * 16) * E);
#pragma unroll
        for (int np = 0; np < NP; ++np) {
          const int step = kk * NP + np;
          if (step + 1 < KS * NP) {
            const int nk = (step + 1) / NP, nn = (step + 1) % NP;
            ldmatrix_x4(kf[(step + 1) & 1], kp + (nn * 16 * ST + nk * 16) * E);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(s[mt][2 * np], qf[mt], kf[step & 1][0], kf[step & 1][1]);
            mma_bf16(s[mt][2 * np + 1], qf[mt], kf[step & 1][2], kf[step & 1][3]);
          }
        }
      }
      if constexpr (GM::SPLIT > 1) {
        // the row group's two halves of the contraction: warp `part` owns
        // m-tile `part`, and takes its partner's partial scores of it
        if (part == 0) put_scores<NN, XS>(mine, s[1], g, t);
        else put_scores<NN, XS>(mine, s[0], g, t);
        named_barrier(1 + grp, 64);
        if (part == 0) add_scores<NN, XS>(s[0], theirs, g, t);
        else add_scores<NN, XS>(s[1], theirs, g, t);
      }
      // The online softmax (SPLIT 2: of the owned m-tile only), with the mask
      // tests only where the tile crosses the length, the diagonal or the
      // band of the warp's rows
      const bool need_mask = j0 + BN > len || (CAUSAL && j0 + BN - 1 > qoff + r0) ||
                             (BAND && j0 <= qoff + r0 + 31 - W);
      float alpha[2][2];
      auto softmax = [&](auto mask) {
        constexpr bool M = decltype(mask)::value;
        const int pa = qoff + r0 + g;
        if (GM::SPLIT == 1 || part == 0)
          softmax_tile<NN, CAUSAL, SOFTCAP, BAND, M>(s[0], j0 + 2 * t, pa, len, opt, m_r[0], l_r[0], alpha[0]);
        if (GM::SPLIT == 1 || part == 1)
          softmax_tile<NN, CAUSAL, SOFTCAP, BAND, M>(s[1], j0 + 2 * t, pa + 16, len, opt, m_r[1], l_r[1],
                                                     alpha[1]);
      };
      if (need_mask) softmax(std::true_type{});
      else softmax(std::false_type{});
      uint32_t pf[2][NP][4];
      if constexpr (GM::SPLIT == 1) {
        pack_p<NN>(pf[0], s[0]);
        pack_p<NN>(pf[1], s[1]);
      } else {  // P and the rescale factors of the owned m-tile, for the partner
        if (part == 0) {
          pack_p<NN>(pf[0], s[0]);
          put_frags<NP>(mine_p, pf[0], lane);
          put_pair(mine_a, alpha[0], lane);
        } else {
          pack_p<NN>(pf[1], s[1]);
          put_frags<NP>(mine_p, pf[1], lane);
          put_pair(mine_a, alpha[1], lane);
        }
        named_barrier(1 + grp, 64);
        if (part == 0) {
          get_frags<NP>(pf[1], theirs_p, lane);
          get_pair(alpha[1], theirs_a, lane);
        } else {
          get_frags<NP>(pf[0], theirs_p, lane);
          get_pair(alpha[0], theirs_a, lane);
        }
      }
      rescale<NO>(o[0], alpha[0]);
      rescale<NO>(o[1], alpha[1]);
      // O += P V on the warp's columns: each V fragment serves both m-tiles,
      // loaded a step ahead
      mbar_wait(&bars[2 * stage + 1], par);
      const uint32_t vp = va + stage * STAGE_BYTES;
      uint32_t vb[2][4];
      ldmatrix_x4_trans(vb[0], vp);
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
#pragma unroll
        for (int np = 0; np < OP; ++np) {
          const int step = kk * OP + np;
          if (step + 1 < NP * OP) {
            const int nk = (step + 1) / OP, nn = (step + 1) % OP;
            ldmatrix_x4_trans(vb[(step + 1) & 1], vp + (nk * 16 * ST + nn * 16) * E);
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            mma_bf16(o[mt][2 * np], pf[mt][kk], vb[step & 1][0], vb[step & 1][1]);
            mma_bf16(o[mt][2 * np + 1], pf[mt][kk], vb[step & 1][2], vb[step & 1][3]);
          }
        }
      }
    }
    __syncthreads();  // every reader of this stage (and of the exchange slots) is done: refill it
    if (jl < kv_end) {
      issue(jl, stage);
      jl = next_tile(jl);
    }
  }
  // Every stage's last phase has completed (all copies landed, all arrivals
  // made) before the block's shared memory is released.
#pragma unroll
  for (int s = 0; s < STAGES; ++s) {
    if (it > s) {
      const uint32_t par = ((it - 1 - s) / STAGES) & 1;
      mbar_wait(&bars[2 * s], par);
      mbar_wait(&bars[2 * s + 1], par);
    }
  }

  if (r0 >= Sq) return;  // (both warps of a row group)
  // the row sums over the quad; SPLIT 2: the owner's, passed to the partner
  float lf[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (GM::SPLIT > 1 && mt != part) continue;
    lf[mt][0] = l_r[mt][0], lf[mt][1] = l_r[mt][1];
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      lf[mt][0] += __shfl_xor_sync(0xffffffffu, lf[mt][0], off);
      lf[mt][1] += __shfl_xor_sync(0xffffffffu, lf[mt][1], off);
    }
  }
  if constexpr (GM::SPLIT > 1) {
    if (part == 0) put_pair(mine_a, lf[0], lane);
    else put_pair(mine_a, lf[1], lane);
    named_barrier(1 + grp, 64);
    if (part == 0) get_pair(lf[1], theirs_a, lane);
    else get_pair(lf[0], theirs_a, lane);
  }
  // O, normalised, into the warp's own Q rows and columns (no other warp
  // reads them), then out in 16-byte rows
  bf16* os = q_s + lr0 * ST + part * DP;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const float l_a = lf[mt][0], l_b = lf[mt][1];
    const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
    const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
    const int ra = r0 + mt * 16 + g, rb = ra + 8;
    if (LSE && t == 0 && mt % GM::SPLIT == part) {  // one lane of the quad writes its two rows
      float* lh = lse + ((size_t)b * Hq + head) * (size_t)Sq;
      if (ra < Sq) lh[ra] = l_a > 0.f ? m_r[mt][0] + log2f(l_a) : LSE_EMPTY;
      if (rb < Sq) lh[rb] = l_b > 0.f ? m_r[mt][1] + log2f(l_b) : LSE_EMPTY;
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      bf16* p = os + (mt * 16 + g) * ST + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(o[mt][n][0] * inv_a, o[mt][n][1] * inv_a);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * ST) =
          __floats2bfloat162_rn(o[mt][n][2] * inv_b, o[mt][n][3] * inv_b);
    }
  }
  __syncwarp();
  bf16* oh = out + ((size_t)b * Hq + head) * (size_t)Sq * D + part * DP;
#pragma unroll
  for (int c = 0; c < 32 * DP / 8 / 32; ++c) {
    const int i = lane + c * 32;
    const int row = i / (DP / 8), col = (i % (DP / 8)) * 8;
    if (r0 + row < Sq)
      *reinterpret_cast<uint4*>(oh + (size_t)(r0 + row) * D + col) =
          *reinterpret_cast<const uint4*>(os + row * ST + col);
  }
}

namespace latent {
constexpr int D = 640;       // the latent row
constexpr int SC = 128;      // output columns (and contraction depth) of one warp's slice
constexpr int SLICES = D / SC;
constexpr int HB = 2;        // query heads a block
constexpr int WARPS = SLICES * HB;
constexpr int THREADS = 32 * WARPS;
constexpr int BK = 32;       // KV rows a tile
constexpr int ST = D + 8;    // padded smem row (elements)
constexpr int SP = BK + 8;   // padded row of a warp's partial scores (floats): conflict-free float2
constexpr size_t SMEM = 2 * (size_t)BK * ST * sizeof(__nv_bfloat16) + (size_t)WARPS * 16 * SP * sizeof(float);
}  // namespace latent

__global__ void __launch_bounds__(latent::THREADS, 1)
    flash_prefill_latent_kernel(const __nv_bfloat16* __restrict__ q,
                                const __nv_bfloat16* __restrict__ k,
                                const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                                const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ out,
                                int Hq, int Hkv, int Sq, int Skv, const Options opt) {
  using namespace latent;
  constexpr int KT = SC / 16;    // k-steps of the slice's QK product
  constexpr int NT = SC / 8;     // n-tiles of the slice's PV product
  constexpr int ST_N = BK / 8;   // n-tiles of the QK product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][ST]
  __nv_bfloat16* v_s = k_s + BK * ST;                                 // [BK][ST]
  float* s_part = reinterpret_cast<float*>(v_s + BK * ST);            // [WARPS][16][SP]

  const int qt = blockIdx.x, b = blockIdx.z;
  const int G = Hq / Hkv, groups = G / HB;
  const int kvh = blockIdx.y / groups;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hl = warp / SLICES, slice = warp % SLICES;  // the warp's head in the block, its columns
  const int head = kvh * G + (blockIdx.y % groups) * HB + hl;
  const int col0 = slice * SC;
  const int r0 = qt * 16;  // the block's first q row (every warp holds the same 16)
  const int ra = r0 + g, rb = r0 + g + 8;
  const int len = min(lengths[b], Skv);
  const int qoff = q_offsets[b];
  const int pa = qoff + ra, pb = qoff + rb;
  const int kv_end = min(len, qoff + min(r0 + 15, Sq - 1) + 1);  // causal: through the last row

  const __nv_bfloat16* qh = q + ((size_t)b * Hq + head) * (size_t)Sq * D + col0;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * D + c) : 0u;
    qa[kk][1] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * D + c) : 0u;
    qa[kk][2] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * D + c + 8) : 0u;
    qa[kk][3] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * D + c + 8) : 0u;
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;
  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D;
  float* my_part = s_part + warp * 16 * SP;
  const float* head_parts = s_part + hl * SLICES * 16 * SP;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    for (int i = threadIdx.x; i < BK * D / 8; i += THREADS) {  // rows past the length zero-filled
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j0 + row < len) {
        kv = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)(j0 + row) * D + col);
        vv = *reinterpret_cast<const uint4*>(v + kv_base + (size_t)(j0 + row) * D + col);
      }
      *reinterpret_cast<uint4*>(k_s + row * ST + col) = kv;
      *reinterpret_cast<uint4*>(v_s + row * ST + col) = vv;
    }
    __syncthreads();

    // this warp's 128-deep share of the head's scores
    float s[ST_N][4];
#pragma unroll
    for (int n = 0; n < ST_N; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (n * 8 + g) * ST + col0 + 2 * t;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        mma_bf16(s[n], qa[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
      }
      *reinterpret_cast<float2*>(my_part + g * SP + n * 8 + 2 * t) = make_float2(s[n][0], s[n][1]);
      *reinterpret_cast<float2*>(my_part + (g + 8) * SP + n * 8 + 2 * t) = make_float2(s[n][2], s[n][3]);
    }
    __syncthreads();
    // the full scores: the head's five partials summed in slice order
#pragma unroll
    for (int n = 0; n < ST_N; ++n) {
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int sl = 0; sl < SLICES; ++sl) {
        const float* part = head_parts + sl * 16 * SP + n * 8 + 2 * t;
        const float2 a = *reinterpret_cast<const float2*>(part + g * SP);
        const float2 c = *reinterpret_cast<const float2*>(part + (g + 8) * SP);
        s[n][0] += a.x;
        s[n][1] += a.y;
        s[n][2] += c.x;
        s[n][3] += c.y;
      }
    }
    float mx_a = NEG_INF, mx_b = NEG_INF;
    scale_mask<ST_N, true, false, false>(s, j0 + 2 * t, pa, pb, len, opt, mx_a, mx_b);
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
    const float alpha_a = exp2f(m_a - mn_a), alpha_b = exp2f(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
    for (int n = 0; n < ST_N; ++n) {
      s[n][0] = s[n][0] == NEG_INF ? 0.f : exp2f(s[n][0] - mn_a);
      s[n][1] = s[n][1] == NEG_INF ? 0.f : exp2f(s[n][1] - mn_a);
      s[n][2] = s[n][2] == NEG_INF ? 0.f : exp2f(s[n][2] - mn_b);
      s[n][3] = s[n][3] == NEG_INF ? 0.f : exp2f(s[n][3] - mn_b);
      sum_a += s[n][0] + s[n][1];
      sum_b += s[n][2] + s[n][3];
    }
    l_a = l_a * alpha_a + sum_a;
    l_b = l_b * alpha_b + sum_b;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha_a;
      o[n][1] *= alpha_a;
      o[n][2] *= alpha_b;
      o[n][3] *= alpha_b;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {  // O[:, slice] += P @ V[:, slice]
      uint32_t pf[4];
      pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const int mi = lane >> 3, rr = lane & 7;
      const __nv_bfloat16* vrow = v_s + (kk * 16 + rr + (mi & 1) * 8) * ST + col0 + (mi >> 1) * 8;
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, vrow + np * 16);
        mma_bf16(o[2 * np], pf, vb[0], vb[1]);
        mma_bf16(o[2 * np + 1], pf, vb[2], vb[3]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  __nv_bfloat16* oh = out + ((size_t)b * Hq + head) * (size_t)Sq * D + col0;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)ra * D + c) =
          __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)rb * D + c) =
          __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

cudaError_t launch_latent(const void* q, const void* k, const void* v, const void* lengths,
                          const void* q_offsets, void* out, void* lse, int B, int Hq, int Hkv, int Sq,
                          int Skv, int causal, const Options& opt, cudaStream_t stream) {
  // the one form: causal, no LSE, no window / sinks / softcap, G a multiple of HB
  if (!causal || lse != nullptr || opt.window < NO_WINDOW || opt.sinks || opt.softcap > 0.f ||
      Hq % Hkv || (Hq / Hkv) % latent::HB)
    return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_latent_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(latent::SMEM));
  if (e != cudaSuccess) return e;
  dim3 grid((Sq + 15) / 16, Hq / latent::HB, B);
  flash_prefill_latent_kernel<<<grid, latent::THREADS, latent::SMEM, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(q_offsets), static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Skv, opt);
  return cudaGetLastError();
}

template <int D, bool CAUSAL, bool LSE, bool SOFTCAP, bool BAND>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   const void* q_offsets, void* out, void* lse, int B, int Hq, int Hkv, int Sq,
                   int Skv, const Options& opt, cudaStream_t stream) {
  using GM = Geom<D>;
  if (B == 0 || Hq == 0 || Sq == 0) return cudaSuccess;
  auto kernel = flash_prefill_kernel<D, CAUSAL, LSE, SOFTCAP, BAND>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(GM::SMEM));
  if (e != cudaSuccess) return e;
  // x: (head, sequence); y: q tiles, in q_tile's order
  dim3 grid(Hq * B, (Sq + GM::BM - 1) / GM::BM);
  kernel<<<grid, GM::THREADS, GM::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offsets), static_cast<bf16*>(out),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, opt);
  return cudaGetLastError();
}

// BAND and SOFTCAP instantiate for causal only, with and without the LSE
// (the serving prefill and the training forward of the variants); the
// non-causal forms take no option: 10 kernels a head_dim.
template <int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, const void* lengths,
                     const void* q_offsets, void* out, void* lse, int B, int Hq, int Hkv, int Sq,
                     int Skv, int causal, const Options& o, cudaStream_t s) {
  const bool band = o.window < NO_WINDOW, cap = o.softcap > 0.f;
  if ((band || cap) && !causal) return cudaErrorInvalidValue;
#define SFA_LAUNCH(C, L, SC, BD) \
  launch<D, C, L, SC, BD>(q, k, v, lengths, q_offsets, out, lse, B, Hq, Hkv, Sq, Skv, o, s)
  if (band && cap) return lse ? SFA_LAUNCH(true, true, true, true) : SFA_LAUNCH(true, false, true, true);
  if (band) return lse ? SFA_LAUNCH(true, true, false, true) : SFA_LAUNCH(true, false, false, true);
  if (cap) return lse ? SFA_LAUNCH(true, true, true, false) : SFA_LAUNCH(true, false, true, false);
  if (causal) return lse ? SFA_LAUNCH(true, true, false, false) : SFA_LAUNCH(true, false, false, false);
  return lse ? SFA_LAUNCH(false, true, false, false) : SFA_LAUNCH(false, false, false, false);
#undef SFA_LAUNCH
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// Dynamic shared memory a block of the head_dim-D kernel takes (bytes), 0
// for a head_dim it does not take.
int flash_prefill_smem_bytes(int D) {
  switch (D) {
    case 64:
      return static_cast<int>(Geom<64>::SMEM);
    case 128:
      return static_cast<int>(Geom<128>::SMEM);
    case 256:
      return static_cast<int>(Geom<256>::SMEM);
    case latent::D:
      return static_cast<int>(latent::SMEM);
    default:
      return 0;
  }
}

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out (B, Hq, Sq, D): bf16,
// contiguous. lengths, q_offsets: (B,) int32. lse: (B, Hq, Sq) fp32, or
// null for no LSE. D is 64, 128 or 256 with Hq / Hkv <= 8, or 640 (causal,
// no LSE and no options) with Hq / Hkv a multiple of 2. sm_scale is the
// score scale and scale_log2 = sm_scale * log2(e) (rounded by the caller as
// flash_bwd.cu's is); window (>= 1, 1 << 30 for none), sinks (>= 0), softcap (0 for
// none): causal only, with or without the LSE.
int flash_prefill(const void* q, const void* k, const void* v, const void* lengths,
                  const void* q_offsets, void* out, void* lse, int B, int Hq, int Hkv, int Sq,
                  int Skv, int D, int causal, float sm_scale, float scale_log2, int window,
                  int sinks, float softcap, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (window < 1 || sinks < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Options o{window, sinks, sm_scale, scale_log2, softcap};
  cudaError_t e;
  switch (D) {
    case 64:
      e = launch_d<64>(q, k, v, lengths, q_offsets, out, lse, B, Hq, Hkv, Sq, Skv, causal, o, s);
      break;
    case 128:
      e = launch_d<128>(q, k, v, lengths, q_offsets, out, lse, B, Hq, Hkv, Sq, Skv, causal, o, s);
      break;
    case 256:
      e = launch_d<256>(q, k, v, lengths, q_offsets, out, lse, B, Hq, Hkv, Sq, Skv, causal, o, s);
      break;
    case latent::D:
      e = launch_latent(q, k, v, lengths, q_offsets, out, lse, B, Hq, Hkv, Sq, Skv, causal, o, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
