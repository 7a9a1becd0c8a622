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
// 640-lane latent KV head; the kernel computes general D 640 attention on
// any k and v (it uses no structure of MLA's rows). Bound: 4 * 640
// operations per (query, key) pair under the mask, at the tensor-core rate.
// What stands in the way is the width: a 64-row tile's fp32 accumulators
// over 640 columns take 160 KB of registers, and a K/V tile of 32 keys 80
// KB of shared memory beside Q's 80 KB. Design:
// - A cluster of two blocks (two SMs) owns a tile of 128 rows, the (position,
//   head) pairs of one KV head, position-major: at G 16, 8 positions x 16
//   heads (latent::Rows: hb = min(G, 128) heads by 128 / hb positions; a G
//   that does not divide 128 leaves rows idle, a G past 128 splits its heads
//   over tiles). Block `rank` holds all 128 rows but only its half of the 640
//   lanes: Q's 320 columns, K's and V's, and the output's. So each K/V byte
//   is read from L2 once for 128 rows (four times fewer reads than the first
//   design's 32-row blocks), and a block's 128 x 320 fp32 accumulators are
//   the 160 registers a thread of its 8 warps can hold.
// - Both products run on wgmma (two warpgroups of 64 rows, a warp 16 of
//   them). S = Q K^T: m64n32k16 from shared memory, Q and K in the 128-byte
//   swizzle. P @ V: the warp's P (bf16, in registers as the A operand, its own
//   rows) against V (MN-major, swizzled) in two products of 192 and 128
//   columns, into the warp's 16 rows x 320 fp32. A warp's rows are its own
//   from the scores to the output: no P, rescale factor or row sum passes
//   between warps.
// - Scores once a row, over the full 640-deep contraction: a warp's 16 x 32
//   partial over its block's 320 lanes goes into the peer block's shared
//   memory by st.async (counted on the peer's mbarrier, double-buffered, the
//   warp does not wait for it) and the peer's comes back; both blocks add
//   the same two partials (a + b == b + a), so both hold the same bits and
//   run the same online softmax. Tile it + 1's scores are computed and sent
//   before tile it's P @ V, which hides the exchange.
// - K/V tiles of 32 keys (the block's 320 lanes) stream by cp.async (a warp
//   copies a row's 512 contiguous bytes) with an mbarrier a ring slot
//   (attn_tiles.cuh): K in 3 slots, since the scores run a tile ahead, V in
//   2; one block barrier a tile precedes the refills. Rows past the length
//   are zero-filled.
// - The walk runs to the tile's last position (causal); a warpgroup whose
//   rows all precede a tile skips its arithmetic (both blocks decide alike).
//   Tiles are numbered longest walk first (latent_tile).

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
// positions pa and pb): scale and mask the tile's scores, fold them into
// the row maxima (quad shuffles), exponentiate in place and update the
// lane's share of the row sums (reduced over the quad at the end); alpha
// gets the two rows' rescale factors.
template <int NN, bool CAUSAL, bool SOFTCAP, bool BAND, bool MASK>
__device__ __forceinline__ void softmax_rows(float (&s)[NN][4], int col0, int pa, int pb, int len,
                                             const Options& opt, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  float mx_a = NEG_INF, mx_b = NEG_INF;
  scale_mask<NN, CAUSAL, SOFTCAP, BAND, MASK>(s, col0, pa, pb, len, opt, mx_a, mx_b);
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

// softmax_rows of an m-tile whose rows sit at positions pa and pa + 8
template <int NN, bool CAUSAL, bool SOFTCAP, bool BAND, bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[NN][4], int col0, int pa, int len, const Options& opt,
                                             float (&m)[2], float (&l)[2], float (&alpha)[2]) {
  softmax_rows<NN, CAUSAL, SOFTCAP, BAND, MASK>(s, col0, pa, pa + 8, len, opt, m, l, alpha);
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
constexpr int D = 640;        // the latent row
constexpr int CTAS = 2;       // blocks a cluster, each holding HALF of the lanes of every row
constexpr int HALF = D / CTAS;
constexpr int ROWS = 128;     // (position, head) rows a tile
constexpr int BK = 32;        // keys a ring slot
constexpr int KSTAGES = 3;    // K tiles in flight or in use (the scores run a tile ahead of P @ V)
constexpr int VSTAGES = 2;
constexpr int WARPS = 8;      // two warpgroups of 64 rows, a warp 16 of them
constexpr int THREADS = 32 * WARPS;
constexpr int WG_ROWS = 64;   // rows of a warpgroup
constexpr int KC = HALF / 8;  // 16-byte chunks of a row's block lanes
constexpr int XF = 16 * BK;   // floats of a warp's partial scores, lane-major
constexpr int NOPOS = -(1 << 30);  // the position of an idle row: every key masked
constexpr int XBYTES = XF * sizeof(float);  // one exchange: a warp's partial scores
// Q and K in wgmma's 128-byte-swizzle K-major layout: a block of 64 lanes
// (128 bytes) of R rows takes R * 128 bytes, row r at r * 128, its 16-byte
// chunk c at (c ^ (r % 8)) * 16 (the XOR of address bits 4-6 with 7-9, so
// each 1024 bytes start 1024-aligned); the five blocks of a row's 320 lanes
// follow each other. A warp's copy of one row's 512 contiguous bytes then
// writes every bank once. Q a warpgroup's 64 rows at a time (that 40 KB is
// its O's staging after the walk), K and V a tile's 32 keys.
constexpr int SW = 64;  // lanes of a swizzled block
constexpr size_t Q_BYTES = (size_t)ROWS * HALF * sizeof(bf16);
constexpr size_t K_BYTES = (size_t)BK * HALF * sizeof(bf16);   // a K tile
constexpr size_t V_BYTES = K_BYTES;                              // a V tile, swizzled as K
constexpr size_t SMEM = 1024 /* the 1024-byte alignment of the swizzled blocks */ + Q_BYTES + KSTAGES * K_BYTES +
                        VSTAGES * V_BYTES + (size_t)2 * WARPS * XBYTES +
                        (size_t)(KSTAGES + VSTAGES + 2 * WARPS) * sizeof(uint64_t);
static_assert(Q_BYTES % 1024 == 0 && K_BYTES % 1024 == 0, "swizzled blocks stay 1024-aligned");
constexpr int N_A = 3 * SW, N_B = HALF - N_A;  // P @ V's two products: 192 and 128 columns, atom-aligned
static_assert(SMEM <= 232448, "a block's shared memory on the H100");
static_assert(BK * KC % THREADS == 0 && ROWS * KC % THREADS == 0, "whole copies a thread");

// The row map of a tile (ops/flash_prefill.py: latent_rows): hb heads by bq
// positions, nhg head groups a position tile.
struct Rows {
  int hb, bq, nhg;
  __device__ __forceinline__ Rows(int G) : hb(min(G, ROWS)), bq(ROWS / min(G, ROWS)), nhg((G + hb - 1) / hb) {}
};

// The walk's tiles of position tile qt in sequence b: BK keys each, below the
// length and the tile's last position (its last row clipped to Sq).
__device__ __forceinline__ int walk_tiles(const int* lengths, const int* q_offsets, int b, int qt, int bq,
                                          int Sq, int Skv) {
  const int end = min(min(lengths[b], Skv), q_offsets[b] + min(qt * bq + bq, Sq));
  return end > 0 ? (end + BK - 1) / BK : 0;
}

// The cluster's tile from its place y in launch order: from the end whose
// tile has the longer walk in sequence 0, so that the longest walks start
// first (ops/flash_prefill.py: latent_tile_order).
__device__ __forceinline__ int latent_tile(int y, int nT, const Rows& R, const int* lengths,
                                           const int* q_offsets, int Sq, int Skv) {
  const bool last_first = walk_tiles(lengths, q_offsets, 0, (nT - 1) / R.nhg, R.bq, Sq, Skv) >=
                          walk_tiles(lengths, q_offsets, 0, 0, R.bq, Sq, Skv);
  return last_first ? nT - 1 - y : y;
}

// Clusters, distributed shared memory and the mbarriers other blocks arrive on.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in block `rank`'s shared memory of this block's `addr`.
__device__ __forceinline__ uint32_t peer_addr(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// A wgmma shared-memory descriptor of a K-major operand in the 128-byte
// swizzle (layout type 1): 1024 bytes between 8-row groups; `addr` the
// operand's first row at its k16 step (32 bytes a step into a block).
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

// The same for an MN-major operand (V: keys along K, columns along N), 128-
// byte swizzle: 1024 bytes between 8-key groups, `atom` bytes between
// 64-column blocks.
__device__ __forceinline__ uint64_t gmma_desc_mn(uint32_t addr, uint32_t atom) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(atom >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}

// d (this warp's 16 rows x 192 fp32, n-tile j at d[j] in mma.sync's
// accumulator order) += A (the warpgroup's 64 x 16 bf16 in registers, a
// warp's 16 rows as an mma.sync A fragment) B (16 x 192 from shared memory,
// MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n192k16_ra(float (&d)[24][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3]),
        "+f"(d[16][0]), "+f"(d[16][1]), "+f"(d[16][2]), "+f"(d[16][3]),
        "+f"(d[17][0]), "+f"(d[17][1]), "+f"(d[17][2]), "+f"(d[17][3]),
        "+f"(d[18][0]), "+f"(d[18][1]), "+f"(d[18][2]), "+f"(d[18][3]),
        "+f"(d[19][0]), "+f"(d[19][1]), "+f"(d[19][2]), "+f"(d[19][3]),
        "+f"(d[20][0]), "+f"(d[20][1]), "+f"(d[20][2]), "+f"(d[20][3]),
        "+f"(d[21][0]), "+f"(d[21][1]), "+f"(d[21][2]), "+f"(d[21][3]),
        "+f"(d[22][0]), "+f"(d[22][1]), "+f"(d[22][2]), "+f"(d[22][3]),
        "+f"(d[23][0]), "+f"(d[23][1]), "+f"(d[23][2]), "+f"(d[23][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (this warp's 16 rows x 128 fp32, n-tile j at d[j] in mma.sync's
// accumulator order) += A (the warpgroup's 64 x 16 bf16 in registers, a
// warp's 16 rows as an mma.sync A fragment) B (16 x 128 from shared memory,
// MN-major, 128-byte swizzle).
__device__ __forceinline__ void wgmma_m64n128k16_ra(float (&d)[16][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The byte offset of row r's 16-byte chunk c (of HALF / 8) in a swizzled
// operand of `rows` rows.
__device__ __forceinline__ uint32_t sw_offset(int r, int c, int rows) {
  return (c / 8) * rows * 128 + r * 128 + (((c % 8) ^ (r % 8)) << 4);
}

// d (64 x 32 fp32 of the warpgroup; a warp's 16 rows in mma.sync's m16n8
// accumulator order, n-tile j at d[j]) += A (64 x 16) B (16 x 32), bf16 from
// shared memory.
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[4][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]),
        "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]),
        "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(1));
}

// 16 bytes into the peer block's shared memory at `addr`, asynchronously:
// the store counts its bytes on the peer's mbarrier at `bar` when it lands,
// and this thread does not wait for it.
__device__ __forceinline__ void st_async_peer(uint32_t addr, const float (&x)[4], uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(
                   addr),
               "f"(x[0]), "f"(x[1]), "f"(x[2]), "f"(x[3]), "r"(bar)
               : "memory");
}

// This block's arrival on its mbarrier, expecting `bytes` more to land in
// the phase (the peer's st_async_peer stores, which may land first).
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}
}  // namespace latent

__global__ void __cluster_dims__(latent::CTAS, 1, 1) __launch_bounds__(latent::THREADS, 1)
    flash_prefill_latent_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                const bf16* __restrict__ v, const int* __restrict__ lengths,
                                const int* __restrict__ q_offsets, bf16* __restrict__ out, int B, int Hq,
                                int Hkv, int Sq, int Skv, const Options opt) {
  using namespace latent;
  constexpr int NN = BK / 8;     // n-tiles of the scores
  constexpr int NP = BK / 16;    // k-steps of P @ V
  constexpr int KS = HALF / 16;  // k-steps of the block's share of Q K^T
  extern __shared__ __align__(16) unsigned char smem_base[];
  unsigned char* smem_raw = smem_base + ((1024 - (smem_u32(smem_base) & 1023)) & 1023);
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);                   // 2 x swizzled (64, HALF): Q's lanes, then O's
  bf16* k_ring = reinterpret_cast<bf16*>(smem_raw + Q_BYTES);     // KSTAGES x swizzled (BK, HALF)
  bf16* v_ring = k_ring + KSTAGES * BK * HALF;                     // VSTAGES x swizzled (BK, HALF)
  float* xs = reinterpret_cast<float*>(v_ring + VSTAGES * BK * HALF);  // [2][WARPS][XF]
  uint64_t* bars = reinterpret_cast<uint64_t*>(xs + 2 * WARPS * XF);  // K's slots, V's; then [2][WARPS] exchanges
  uint64_t* xbars = bars + KSTAGES + VSTAGES;

  const uint32_t rank = cluster_rank();
  const int G = Hq / Hkv;
  const Rows R(G);
  const int nT = (Sq + R.bq - 1) / R.bq * R.nhg;
  const int ci = blockIdx.x / CTAS;
  const int y = ci / (Hkv * B), xb = ci % (Hkv * B);
  const int kvh = xb % Hkv, b = xb / Hkv;
  const int T = latent_tile(y, nT, R, lengths, q_offsets, Sq, Skv);
  const int qt = T / R.nhg, hg = T % R.nhg;
  const int len = min(lengths[b], Skv), qoff = q_offsets[b];
  const int n_tiles = walk_tiles(lengths, q_offsets, b, qt, R.bq, Sq, Skv);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // row r: head hg * hb + r % hb of the KV head, position qt * bq + r / hb
  auto live = [&](int r) {
    const int p = r / R.hb, h = hg * R.hb + r % R.hb;
    return p < R.bq && h < G && qt * R.bq + p < Sq;
  };
  auto pos = [&](int r) { return live(r) ? qoff + qt * R.bq + r / R.hb : NOPOS; };
  auto row_index = [&](int r) {  // into (B, Hq, Sq)
    return ((size_t)b * Hq + (size_t)kvh * G + hg * R.hb + r % R.hb) * Sq + qt * R.bq + r / R.hb;
  };
  // the warpgroup's last position (the same in its warps and in both blocks)
  const int wg = warp / 4, w0 = wg * WG_ROWS;
  const int grp_hi = max(__reduce_max_sync(~0u, pos(w0 + lane)), __reduce_max_sync(~0u, pos(w0 + 32 + lane)));
  const int pa = pos(16 * warp + g), pb = pos(16 * warp + g + 8);  // the lane's two rows

  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < KSTAGES + VSTAGES; ++i) mbar_init(&bars[i], THREADS);
#pragma unroll
    for (int i = 0; i < 2 * WARPS; ++i) mbar_init(&xbars[i], 1);  // the warp's own expect_tx
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // both blocks' barriers are initialized before either arrives on the other's

  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D + rank * HALF;
  // Copy walk tile j's K (V) rows, the block's lanes, into its ring slot
  // (swizzled; a warp copies one row's 512 contiguous bytes), then arrive
  // on the slot's barrier; rows past the length zero-filled.
  auto issue = [&](int j, const bf16* src, bf16* dst, uint64_t* bar) {
#pragma unroll
    for (int c = 0; c < BK * KC / THREADS; ++c) {
      const int i = tid + c * THREADS;
      const int row = i / KC, ch = i % KC;
      const bool ok = j * BK + row < len;
      cp_async16(reinterpret_cast<unsigned char*>(dst) + sw_offset(row, ch, BK),
                 src + kv_base + (ok ? (size_t)(j * BK + row) * D + ch * 8 : 0), ok);
    }
    mbar_arrive_cp_async(bar);
  };
  auto issue_k = [&](int j) { issue(j, k, k_ring + (j % KSTAGES) * BK * HALF, &bars[j % KSTAGES]); };
  auto issue_v = [&](int j) { issue(j, v, v_ring + (j % VSTAGES) * BK * HALF, &bars[KSTAGES + j % VSTAGES]); };
  auto wait_k = [&](int j) { mbar_wait(&bars[j % KSTAGES], (j / KSTAGES) & 1); };
  auto wait_v = [&](int j) { mbar_wait(&bars[KSTAGES + j % VSTAGES], (j / VSTAGES) & 1); };
  if (n_tiles > 0) {  // Q's lanes of the live rows (others zero-filled), covered by the first K barrier
#pragma unroll 4
    for (int c = 0; c < ROWS * KC / THREADS; ++c) {
      const int i = tid + c * THREADS;
      const int row = i / KC, ch = i % KC;
      const bool ok = live(row);
      cp_async16(reinterpret_cast<unsigned char*>(q_s) + row / WG_ROWS * (WG_ROWS * HALF * 2) +
                     sw_offset(row % WG_ROWS, ch, WG_ROWS),
                 q + (ok ? row_index(row) * D + rank * HALF + ch * 8 : 0), ok);
    }
  }
  // K and V of the first tiles, in the order the walk reads them
  for (int j = 0; j < KSTAGES && j < n_tiles; ++j) {
    issue_k(j);
    if (j < VSTAGES) issue_v(j);
  }
  int k_next = min(n_tiles, KSTAGES);  // the next K tile to copy

  // the warp's 16 rows of O over the block's HALF lanes: P @ V's 192- and
  // 128-column products
  float oa[N_A / 8][4], ob[N_B / 8][4];
#pragma unroll
  for (int n = 0; n < N_A / 8; ++n) oa[n][0] = oa[n][1] = oa[n][2] = oa[n][3] = 0.f;
#pragma unroll
  for (int n = 0; n < N_B / 8; ++n) ob[n][0] = ob[n][1] = ob[n][2] = ob[n][3] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};  // rows g, g + 8 of the warp's m-tile

  // the warpgroup's Q block, K and V of slot 0 (bytes)
  const uint32_t qa = smem_u32(q_s + wg * WG_ROWS * HALF);
  const uint32_t ka = smem_u32(k_ring);
  const uint32_t va = smem_u32(v_ring);
  const uint32_t peer = rank ^ 1u;
  // The warpgroup takes a prefix of the walk: the tiles that start at or
  // below its last position (the same in its warps and in both blocks).
  const int n_take = grp_hi >= 0 ? min(n_tiles, grp_hi / BK + 1) : 0;

  // The warpgroup's 64 x 32 S for walk tile `it` over the block's HALF lanes
  // (its K landed), on wgmma from shared memory: a warp gets its m-tile
  // (rows 16 warp ..) in mma.sync's accumulator order. The cp.async copies
  // are made visible to wgmma's proxy first.
  auto scores = [&](int it, float (&s)[NN][4]) {
#pragma unroll
    for (int n = 0; n < NN; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const uint32_t kp = ka + (it % KSTAGES) * (uint32_t)K_BYTES;
    asm volatile("fence.proxy.async.shared::cta;\nwgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_m64n32k16(s, gmma_desc(qa + kk * 16 / SW * WG_ROWS * 128 + kk * 16 % SW * 2),
                      gmma_desc(kp + kk * 16 / SW * BK * 128 + kk * 16 % SW * 2));
    asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  };
  // The exchange of tile `it`'s partial scores with the peer warp (the same
  // m-tile over the other 320 lanes): store this one into the peer's buffer
  // it & 1 (st.async, counted on the peer's barrier of that buffer); later,
  // expect ours, wait for it and add the peer's (a + b in both blocks: the
  // same bits). The peer stores tile it + 2 only after this warp's tile
  // it + 1, which follows its read of tile it.
  auto push = [&](int it, const float (&s)[NN][4]) {
    const int slot = (it & 1) * WARPS + warp;
    const uint32_t remote = peer_addr(smem_u32(xs + slot * XF), peer);
    const uint32_t remote_bar = peer_addr(smem_u32(&xbars[slot]), peer);
#pragma unroll
    for (int n = 0; n < NN; ++n) st_async_peer(remote + (n * 32 + lane) * 16, s[n], remote_bar);
  };
  auto pull = [&](int it, float (&s)[NN][4]) {
    const int slot = (it & 1) * WARPS + warp;
    if (lane == 0) mbar_expect_tx(&xbars[slot], XBYTES);
    mbar_wait(&xbars[slot], (it >> 1) & 1);
#pragma unroll
    for (int n = 0; n < NN; ++n) {
      const float4 x = *reinterpret_cast<const float4*>(xs + slot * XF + (n * 32 + lane) * 4);
      s[n][0] += x.x;
      s[n][1] += x.y;
      s[n][2] += x.z;
      s[n][3] += x.w;
    }
  };

  // The pipeline: tile it + 1's scores are computed and pushed before tile
  // it's P @ V, so the exchange's latency hides behind that product.
  // Every thread waits for each K and V tile of the walk, also where its
  // warpgroup skips the tile, so no slot has copies in flight at a refill.
  float s[NN][4];
  if (n_take > 0) {
    wait_k(0);
    scores(0, s);
    push(0, s);
  } else if (n_tiles > 0) {
    wait_k(0);
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it < n_take) {
      pull(it, s);
      // the softmax of the warp's m-tile: its P is the warpgroup's A of P @ V,
      // and it rescales only its own rows of O
      float alpha[2];
      softmax_rows<NN, true, false, false, true>(s, it * BK + 2 * t, pa, pb, len, opt, m_r, l_r, alpha);
      uint32_t pf[NP][4];
      pack_p<NN>(pf, s);
      rescale<N_A / 8>(oa, alpha);
      rescale<N_B / 8>(ob, alpha);
      if (it + 1 < n_take) {
        wait_k(it + 1);
        scores(it + 1, s);
        push(it + 1, s);
      } else if (it + 1 < n_tiles) {
        wait_k(it + 1);
      }
      // O += P V on wgmma: 16 keys a step, V MN-major from its slot
      wait_v(it);
      const uint32_t vp = va + (it % VSTAGES) * (uint32_t)V_BYTES;
      asm volatile("fence.proxy.async.shared::cta;\nwgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < NP; ++kk) {
        wgmma_m64n192k16_ra(oa, pf[kk], gmma_desc_mn(vp + kk * 16 * 128, BK * 128));
        wgmma_m64n128k16_ra(ob, pf[kk], gmma_desc_mn(vp + N_A / SW * BK * 128 + kk * 16 * 128, BK * 128));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\nwgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    } else {
      if (it + 1 < n_tiles) wait_k(it + 1);
      wait_v(it);
    }
    // every reader of K tiles through it + 1 and of V tile it is done: refill
    // their slots
    __syncthreads();
    for (; k_next < n_tiles && k_next <= it + KSTAGES + 1; ++k_next) issue_k(k_next);
    if (it + VSTAGES < n_tiles) issue_v(it + VSTAGES);
  }

  // the row sums over the quad
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_r[0] += __shfl_xor_sync(0xffffffffu, l_r[0], off);
    l_r[1] += __shfl_xor_sync(0xffffffffu, l_r[1], off);
  }
  // O, normalised, into the warp's own 16 rows of its warpgroup's Q block
  // (64 rows of HALF; no warp reads Q after the walk's last block barrier),
  // then out in 16-byte rows
  constexpr int OS = HALF;
  bf16* os = q_s + (wg * WG_ROWS + (warp % 4) * 16) * OS;
  const float inv_a = 1.f / (l_r[0] == 0.f ? 1.f : l_r[0]);
  const float inv_b = 1.f / (l_r[1] == 0.f ? 1.f : l_r[1]);
  auto stage = [&](const auto& o, int col0) {
#pragma unroll
    for (int n = 0; n < static_cast<int>(sizeof(o) / sizeof(o[0])); ++n) {
      bf16* p = os + g * OS + col0 + n * 8 + 2 * t;
      *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
      *reinterpret_cast<__nv_bfloat162*>(p + 8 * OS) = __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
    }
  };
  stage(oa, 0);
  stage(ob, N_A);
  __syncwarp();
  const int r16 = wg * WG_ROWS + (warp % 4) * 16;  // the warp's first row
#pragma unroll 4
  for (int c = 0; c < 16 * KC / 32; ++c) {
    const int i = lane + c * 32;
    const int row = i / KC, col = (i % KC) * 8;
    if (live(r16 + row))
      *reinterpret_cast<uint4*>(out + row_index(r16 + row) * D + rank * HALF + col) =
          *reinterpret_cast<const uint4*>(os + row * OS + col);
  }
  cluster_sync();  // no block leaves while its peer may still write to it
}

cudaError_t launch_latent(const void* q, const void* k, const void* v, const void* lengths,
                          const void* q_offsets, void* out, void* lse, int B, int Hq, int Hkv, int Sq,
                          int Skv, int causal, const Options& opt, cudaStream_t stream) {
  // the one form: causal, no LSE, no window / sinks / softcap, an even group
  if (!causal || lse != nullptr || opt.window < NO_WINDOW || opt.sinks || opt.softcap > 0.f ||
      Hq % Hkv || (Hq / Hkv) % 2)
    return cudaErrorInvalidValue;
  if (B == 0 || Hq == 0 || Sq == 0) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(flash_prefill_latent_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(latent::SMEM));
  if (e != cudaSuccess) return e;
  const int G = Hq / Hkv, hb = G < latent::ROWS ? G : latent::ROWS, bq = latent::ROWS / hb;
  const long long tiles = (long long)(Sq + bq - 1) / bq * ((G + hb - 1) / hb);
  const long long blocks = tiles * Hkv * B * latent::CTAS;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // x: clusters in launch order, each over (KV head, sequence) before the next tile
  flash_prefill_latent_kernel<<<dim3(static_cast<unsigned>(blocks)), latent::THREADS, latent::SMEM, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<const int*>(q_offsets), static_cast<bf16*>(out), B, Hq,
      Hkv, Sq, Skv, opt);
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

// The D 640 kernel's tiles at G query heads a KV head: {rows a tile,
// keys a ring stage, heads a tile (hb), positions a tile (bq), head groups
// a position tile, blocks a cluster, dynamic shared memory bytes a block}
// (ops/flash_prefill.py: latent_geometry is its twin).
int flash_prefill_latent_geometry(int G, int* out) {
  if (G < 1) return static_cast<int>(cudaErrorInvalidValue);
  const int hb = G < latent::ROWS ? G : latent::ROWS;
  const int vals[7] = {latent::ROWS, latent::BK, hb, latent::ROWS / hb, (G + hb - 1) / hb, latent::CTAS,
                       static_cast<int>(latent::SMEM)};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
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
