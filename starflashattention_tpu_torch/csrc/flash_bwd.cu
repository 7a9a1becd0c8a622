// FlashAttention-2 backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces: starflashattention_tpu/ops/flash_bwd.py::_dq_kernel and
// ::_dkdv_kernel (entry flash_prefill_bwd, behind flash_attention's
// custom_vjp), causal or not, with per-sequence lengths and q_offsets, and
// for the causal form the sliding window, attention sinks and softcap.
// head_dim 64, 128 or 256.
//
// q, dout: (B, Hq, Sq, D) bf16; k, v: (B, Hkv, Skv, D) bf16; lse: (B, Hq,
// Sq) fp32, the base-2 LSE flash_prefill.cu wrote in the forward (3e38 for
// a row with no valid position); delta: (B, Hq, Sq) fp32, rowsum(dout * o),
// computed by the wrapper; lengths and q_offsets: (B,) int32, with the
// forward's meaning. Both kernels recompute, tile by tile, in fp32
//   s2 = scale_log2 * q.k      (scale_log2 = sm_scale * log2 e, as K5)
//   p  = 2^(s2 - lse)          (0 where the forward's mask is false)
//   dp = dout . v,  ds = p * (dp - delta)
// and accumulate, with P and dS rounded to bf16 before their products as
// the TPU kernels round them:
//   dq = sm_scale * ds @ k,  dk = sm_scale * ds^T @ q,  dv = p^T @ dout.
// dk and dv sum over the G query heads of each KV head. Every gradient
// element is written once by one thread, in a fixed order, with no atomics:
// two runs give the same bytes. Rows past Sq (dq) or Skv (dk, dv) are
// never written; rows with nothing in band get 0.
//
// The mask is the forward's (JAX _tile_mask): col < length, col <= row
// when causal, and with BAND col > row - window || col < sinks. SOFTCAP
// recomputes the forward's capped score bit for bit as flash_prefill.cu's
// scale_mask does, t = tanhf(s * sm_scale / cap) and s2 = cap * t * log2 e
// (the product rounded as K5's max saw it), so that p = 2^(s2 - lse) is the
// forward's normalised probability, and carries the tanh chain rule:
// ds = p * (dp - delta) * (1 - t^2) (JAX _tile_dots / _tile_elem).
// BAND and SOFTCAP are template flags, instantiated for causal only (as
// K5's), so the unbanded step runs the kernels it ran without them; the
// window and sinks are runtime ints. Ring context parallelism (JAX
// kv_offset, :93, :168) reaches them as flash_prefill.cu's does: the
// wrapper passes max(sinks - kv_offset, 0) as opt.sinks, and a chunk wholly
// in the rows' future (a negative q_offsets) or past the length walks no
// tile: dq, dk and dv are exact zeros (a row's LSE of 3e38 gives p = 0).
//
// Bound: 10 * D operations per (query, key) pair in band (the two
// recomputed products and the three gradient products: 5 matmuls of 2 * D
// each) at the tensor-core rate; the bytes are a few times the forward's.
// Design: both kernels run mma.sync.m16n8k16 with bf16 inputs and fp32
// accumulators, 32 rows a warp (two m16 tiles share each fragment of the
// other operand), all operands by ldmatrix from rows padded to D + 8, and
// skip tiles out of band (causal, ragged length, q offset, window) before
// any arithmetic, as the TPU's _in_band does. Each streams its moving
// operand through a cp.async ring with an mbarrier a stage and one block
// barrier a stage (attn_tiles.cuh), and each computes S and dP once per
// (q row, key) and shares P / dS through shared memory as bf16.
// - dq (flash_bwd_dq_kernel): one block per (q tile, KV head, sequence)
//   owns ROWS rows (128, 64 at D = 256): the q tile's bq = ROWS / G rows of
//   each of the G query heads of the group, head-major (rows past G * bq
//   idle), so the G heads share every K/V tile. Its Q and dO rows go to
//   shared memory once (rows past Sq zero-filled), its LSE and delta to
//   registers, and K/V tiles of 64 keys stream through the ring (3 stages,
//   2 at D = 256). The walk is dq_walk below (ops/flash_bwd.py: dq_walk):
//   with BAND the sink tiles below the block's band first, then the band
//   from the tile that holds its first row's band start; rows below the
//   band that are not sinks are zero-filled and never read. The warps of a
//   32-row group (2 at D <= 128, 4 at D = 256) first split the tile's keys:
//   S = Q K^T and dP = dO V^T (each K / V fragment serves both m16 tiles),
//   dS into shared memory as bf16 (a barrier of the row group); then the
//   same warps split the D columns of dq += dS K (the accumulator, 32 rows x
//   D / 2 or D / 4 a warp, stays in registers for the walk: 64 fp32 a thread
//   at D 128 and 256).
// - dk/dv (flash_bwd_dkdv_kernel): one block per (KV tile, KV head,
//   sequence, split): 128 KV rows (64 at D = 256) in row groups of 32, 8
//   warps. The block walks the (head, q tile) steps in band of all G heads
//   (the group sum falls out of the same walk; JAX _in_band decides each
//   tile, kv_walk below): causal, from the first q tile that reaches the KV
//   tile; with BAND up to the last q tile whose band reaches the KV tile's
//   last row, or to the end when the tile holds sinks. Each step's Q, dO,
//   LSE and delta stream through a two-stage cp.async ring with an mbarrier
//   a stage and one block barrier a stage (attn_tiles.cuh). The warps of a
//   row group (2 at D <= 128, 4 at D = 256) first split the step's q columns:
//   S^T = K Q^T and dP^T = V dO^T on 32 KV rows (each Q / dO fragment read
//   by ldmatrix serves two m16 tiles), then P^T and dS^T go to shared memory
//   as bf16 (a barrier of the row group), and the same warps split the D
//   columns of dV += P^T dO and dK += dS^T Q (the accumulators, 32 rows x
//   D / 2 or D / 4 a warp, stay in registers for the walk). S and dP are
//   computed once per (KV row, q row), at every D.
//   Each KV tile's walk is cut into pieces of `chunk` steps, one block each,
//   when the plan (ops/flash_bwd.py: dkdv_split_plan, from the static
//   shapes) finds the longest walk longer than the card's blocks can
//   balance; a tile whose walk takes one piece writes bf16 dk / dv itself,
//   and the pieces of a longer walk write fp32 sums to a workspace that
//   flash_bwd_dkdv_sum adds in piece order (no atomics, a fixed order: the
//   same bytes on every run). The blocks take the KV tiles from the end
//   whose first tile has the longer walk (the causal triangle's first KV
//   tiles; a ring step whose rows lie past the window, its last).
// dq blocks take the q tiles from the end whose tile has the longer walk in
// sequence 0 (the causal triangle's last q tiles): blocks start in index
// order, and a long block started in the last wave sets the kernel's time.
// Not yet: wgmma and TMA.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attn_tiles.cuh"

namespace {

using namespace attn;

constexpr float LSE_EMPTY = 3e38f;       // the LSE of a row with no valid position
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NO_WINDOW = 1 << 30;       // the window argument without a window

typedef __nv_bfloat16 bf16;

struct Options {
  int window;        // row at position p attends cols > p - window; 1 << 30 for none
  int sinks;         // cols < sinks stay attendable (with a window)
  float sm_scale;    // natural units: dq's and dk's factor, the softcap's input
  float scale_log2;  // sm_scale * log2(e)
  float softcap;     // > 0 with SOFTCAP
};

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *lengths, *q_offsets;
  int B, Hq, Hkv, Sq, Skv, causal;
  Options opt;
};

// P and dS of one score: `s` is the raw fp32 q.k and `dp` the fp32 dout.v
// of (query at position `pos`, key `col`); `live` is false for a query row
// past Sq (or an idle row). The mask and the scores are the forward's (see
// the header); !MASK: a tile where the mask holds everywhere, not tested.
template <bool CAUSAL, bool SOFTCAP, bool BAND, bool MASK = true>
__device__ __forceinline__ void p_ds(float s, float dp, bool live, int col, int pos, int len, float lse,
                                     float dl, const Options& o, float& p, float& ds) {
  bool valid = !MASK || (live && col < len && (!CAUSAL || col <= pos));
  if constexpr (BAND && MASK) valid = valid && (col > pos - o.window || col < o.sinks);
  if constexpr (SOFTCAP) {
    const float t = tanhf(s * o.sm_scale / o.softcap);
    p = valid ? exp2f(__fmul_rn(__fmul_rn(o.softcap, t), LOG2E) - lse) : 0.f;
    ds = p * (dp - dl) * (1.f - t * t);
  } else {
    p = valid ? exp2f(s * o.scale_log2 - lse) : 0.f;
    ds = p * (dp - dl);
  }
}

// dq tiles (see the header): a block owns ROWS rows, the q tile's bq = ROWS
// / G rows of each of the G heads of its KV head, in WR row groups of 32
// (two m16 tiles); the WC warps of a row group split the BK keys of S and
// dP between them, then the D columns of dq. ops/flash_bwd.py's
// dq_geometry is its twin.
template <int D>
struct DqGeom {
  static constexpr int ROWS = D > 128 ? 64 : 128;
  static constexpr int BK = 64;
  static constexpr int WR = ROWS / 32;
  static constexpr int WC = 8 / WR;
  static constexpr int THREADS = 256;
  static constexpr int KW = BK / WC;  // keys of a warp's S / dP
  static constexpr int DW = D / WC;   // columns of a warp's dq
  static constexpr int ST = D + 8;    // padded smem row (elements): conflict-free ldmatrix
  static constexpr int PT = BK + 8;   // padded row of dS
  static constexpr int STAGES = D > 128 ? 2 : 3;
  // a stage: K, then V (BK, ST) bf16
  static constexpr size_t STAGE = (size_t)2 * BK * ST * sizeof(bf16);
  static constexpr size_t SMEM = (size_t)2 * ROWS * ST * sizeof(bf16) + STAGES * STAGE +
                                 (size_t)ROWS * PT * sizeof(bf16) + STAGES * sizeof(uint64_t);
  static_assert(KW % 16 == 0 && DW % 16 == 0 && STAGE % 16 == 0, "whole ldmatrix tiles");
  static_assert(BK * D / 8 % THREADS == 0 && ROWS * D / 8 % THREADS == 0, "whole copies a thread");
};

// The KV walk of q tile qt (rows qt * bq .. of each head) of sequence b
// (JAX _in_band): the tiles of BK keys below the length and, causal, below
// the tile's last row (qt * bq + bq - 1, not clipped to Sq); with a window,
// the sink tiles below the tile's first row's band start first (`ns` tiles
// from 0), then the tiles from the one that holds that band start (`bt`).
// ops/flash_bwd.py's dq_walk is its twin.
struct KvWalk {
  int ns, bt, n;  // sink tiles, first band tile, tiles in all
  __device__ __forceinline__ int tile(int it) const { return it < ns ? it : bt + it - ns; }
};

template <int BK>
__device__ __forceinline__ KvWalk dq_walk(const Args& a, int b, int qt, int bq, bool causal, bool band) {
  const int len = min(a.lengths[b], a.Skv), qoff = a.q_offsets[b];
  const int end = causal ? min(len, qoff + (qt + 1) * bq) : len;
  const int nk = end > 0 ? (end + BK - 1) / BK : 0;
  int ns = 0, bt = 0;
  if (band) {
    bt = max(qoff + qt * bq - a.opt.window + 1, 0) / BK;
    ns = min((min(a.opt.sinks, bt * BK) + BK - 1) / BK, nk);
  }
  return KvWalk{ns, bt, ns + max(nk - bt, 0)};
}

// The block's q tile: tiles in order of blockIdx.y, from the end whose tile
// has the longer walk in sequence 0 (the causal triangle's last q tiles; a
// ring step past the window, its first), so that the longest walks start
// first.
template <int BK>
__device__ __forceinline__ int dq_tile(const Args& a, int bq, bool causal, bool band) {
  const int nqt = gridDim.y;
  const bool last_first =
      dq_walk<BK>(a, 0, nqt - 1, bq, causal, band).n >= dq_walk<BK>(a, 0, 0, bq, causal, band).n;
  return last_first ? nqt - 1 - blockIdx.y : blockIdx.y;
}

template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
__global__ void __launch_bounds__(DqGeom<D>::THREADS, 1)
    flash_bwd_dq_kernel(const Args a, bf16* __restrict__ dq, int bq) {
  using GM = DqGeom<D>;
  constexpr int ROWS = GM::ROWS, BK = GM::BK, ST = GM::ST, PT = GM::PT, KW = GM::KW, DW = GM::DW;
  constexpr int WC = GM::WC, STAGES = GM::STAGES, THREADS = GM::THREADS;
  constexpr int NK = KW / 8;  // n-tiles of a warp's S / dP
  constexpr int ND = DW / 8;  // n-tiles of a warp's dq
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);                               // (ROWS, ST) Q
  bf16* do_s = q_s + ROWS * ST;                                                // (ROWS, ST) dO
  unsigned char* stages = reinterpret_cast<unsigned char*>(do_s + ROWS * ST);  // K, V (BK, ST) a stage
  bf16* ds_s = reinterpret_cast<bf16*>(stages + STAGES * GM::STAGE);           // (ROWS, PT) dS
  uint64_t* bars = reinterpret_cast<uint64_t*>(ds_s + ROWS * PT);

  const Options o = a.opt;
  const int Sq = a.Sq, Skv = a.Skv, G = a.Hq / a.Hkv;
  const int kvh = blockIdx.x % a.Hkv, b = blockIdx.x / a.Hkv;
  const int qt = dq_tile<BK>(a, bq, CAUSAL, BAND);
  const KvWalk wk = dq_walk<BK>(a, b, qt, bq, CAUSAL, BAND);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WC, wc = warp % WC;  // row group; the warp's keys / D columns in it
  const int r0 = wr * 32;                    // the row group's first block row
  const int len = min(a.lengths[b], Skv);
  const int qoff = a.q_offsets[b];
  const int W = o.window, SK = o.sinks;  // read only with BAND
  const size_t kv_base = ((size_t)b * a.Hkv + kvh) * (size_t)Skv * D;
  const size_t head0 = (size_t)b * a.Hq + (size_t)kvh * G;  // the block's first query head
  const int lo = BAND ? qoff + qt * bq - W + 1 : 0;          // the block's lowest band start

  // Block row r is q row qt * bq + r % bq of head r / bq: live when that head
  // is in the group and the row below Sq (rows past G * bq are idle).
  auto q_row = [&](int r) { return qt * bq + r % bq; };
  auto live = [&](int r) { return r / bq < G && q_row(r) < Sq; };
  auto row_index = [&](int r) { return (head0 + r / bq) * (size_t)Sq + q_row(r); };  // into lse, delta

  // the row group's live rows (warp-uniform): any, all, lowest and highest position
  const bool lane_live = live(r0 + lane);
  const unsigned live_rows = __ballot_sync(~0u, lane_live);
  const bool grp_any = live_rows != 0u, grp_all = live_rows == ~0u;
  const int grp_lo = qoff + __reduce_min_sync(~0u, lane_live ? q_row(r0 + lane) : 1 << 30);
  const int grp_hi = qoff + __reduce_max_sync(~0u, lane_live ? q_row(r0 + lane) : -(1 << 30));

  // the lane's four rows (g, g + 8 of each m16 tile): position, LSE, delta
  bool row_live[2][2];
  int pos[2][2];
  float lse[2][2], dl[2][2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + mt * 16 + g + 8 * hf;
      row_live[mt][hf] = live(r);
      pos[mt][hf] = qoff + q_row(r);
      lse[mt][hf] = row_live[mt][hf] ? a.lse[row_index(r)] : LSE_EMPTY;
      dl[mt][hf] = row_live[mt][hf] ? a.delta[row_index(r)] : 0.f;
    }

  float acc[2][ND][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n) acc[mt][n][0] = acc[mt][n][1] = acc[mt][n][2] = acc[mt][n][3] = 0.f;

  if (wk.n > 0) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], THREADS);
    }
    __syncthreads();
    // the block's Q and dO rows (rows not live zero-filled), covered by the first stage's barrier
#pragma unroll
    for (int c = 0; c < ROWS * D / 8 / THREADS; ++c) {
      const int i = tid + c * THREADS;
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const bool ok = live(row);
      const size_t off = ok ? row_index(row) * D + col : 0;
      cp_async16(q_s + row * ST + col, a.q + off, ok);
      cp_async16(do_s + row * ST + col, a.dout + off, ok);
    }
    // Fill a stage with walk step `it`'s K and V rows (past Skv, and with a
    // window below the block's band unless sinks, zero-filled and unread),
    // then arrive on its barrier.
    auto issue = [&](int it, int stage) {
      const int j0 = wk.tile(it) * BK;
      bf16* ks = reinterpret_cast<bf16*>(stages + stage * GM::STAGE);
      bf16* vs = ks + BK * ST;
#pragma unroll
      for (int c = 0; c < BK * D / 8 / THREADS; ++c) {
        const int i = tid + c * THREADS;
        const int row = i / (D / 8), col = (i % (D / 8)) * 8;
        const int j = j0 + row;
        const bool ok = j < Skv && (!BAND || j < SK || j >= lo);
        const size_t off = ok ? kv_base + (size_t)j * D + col : 0;
        cp_async16(ks + row * ST + col, a.k + off, ok);
        cp_async16(vs + row * ST + col, a.v + off, ok);
      }
      mbar_arrive_cp_async(&bars[stage]);
    };
    for (int s = 0; s < STAGES && s < wk.n; ++s) issue(s, s);

    // the lane's ldmatrix addresses (bytes): Q / dO as A (qa0, da0), dS as A
    // (dsa), and K / V of stage 0 as S's and dP's B (kb0) and K as dq's (kt0)
    constexpr int E = sizeof(bf16);
    const uint32_t qa0 = smem_u32(q_s + (r0 + a_row(lane)) * ST + a_col(lane));
    const uint32_t da0 = qa0 + ROWS * ST * E;
    const uint32_t dsa = smem_u32(ds_s + (r0 + a_row(lane)) * PT + a_col(lane));
    const uint32_t kb0 = smem_u32(stages) + ((wc * KW + b_row(lane)) * ST + b_col(lane)) * E;
    const uint32_t kt0 = smem_u32(stages) + (a_row(lane) * ST + wc * DW + a_col(lane)) * E;
    for (int it = 0; it < wk.n; ++it) {
      const int stage = it % STAGES;
      const uint32_t par = (it / STAGES) & 1;
      const int j0 = wk.tile(it) * BK;
      // Every thread waits for the stage, also where its row group skips the
      // tile, so that no phase is left with copies in flight at a refill.
      mbar_wait(&bars[stage], par);
      // the same for the row group's warps: it has live rows, the tile is not
      // wholly above its diagonal, and not wholly below its band unless sinks
      if (grp_any && (!CAUSAL || j0 <= grp_hi) && (!BAND || j0 + BK - 1 >= grp_lo - W + 1 || j0 < SK)) {
        // S = Q K^T and dP = dO V^T on the warp's KW keys: each K / V
        // fragment serves both m16 tiles
        float s[2][NK][4], dp[2][NK][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < NK; ++n) {
            s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
            dp[mt][n][0] = dp[mt][n][1] = dp[mt][n][2] = dp[mt][n][3] = 0.f;
          }
        const uint32_t kp = kb0 + stage * GM::STAGE;
        const uint32_t vp = kp + BK * ST * E;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t qa[2][4], da[2][4];
          ldmatrix_x4(qa[0], qa0 + kk * 16 * E);
          ldmatrix_x4(qa[1], qa0 + (16 * ST + kk * 16) * E);
          ldmatrix_x4(da[0], da0 + kk * 16 * E);
          ldmatrix_x4(da[1], da0 + (16 * ST + kk * 16) * E);
#pragma unroll
          for (int np = 0; np < KW / 16; ++np) {
            uint32_t kb[4], vb[4];
            ldmatrix_x4(kb, kp + (np * 16 * ST + kk * 16) * E);
            ldmatrix_x4(vb, vp + (np * 16 * ST + kk * 16) * E);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(s[mt][2 * np], qa[mt], kb[0], kb[1]);
              mma_bf16(s[mt][2 * np + 1], qa[mt], kb[2], kb[3]);
              mma_bf16(dp[mt][2 * np], da[mt], vb[0], vb[1]);
              mma_bf16(dp[mt][2 * np + 1], da[mt], vb[2], vb[3]);
            }
          }
        }
        // dS (rows the block's, columns the tile's keys), rounded to bf16 into
        // shared memory for the row group's warps; the mask tests only where
        // the tile crosses a dead row, the length, the diagonal or the band
        const bool need_mask = !grp_all || j0 + BK > len || (CAUSAL && j0 + BK - 1 > grp_lo) ||
                               (BAND && j0 < grp_hi - W + 1);
        auto ds_tile = [&](auto mask) {
          constexpr bool M = decltype(mask)::value;
#pragma unroll
          for (int n = 0; n < NK; ++n)
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int hf = e >> 1;
                const int j = j0 + wc * KW + n * 8 + 2 * t + (e & 1);
                float p;
                p_ds<CAUSAL, SOFTCAP, BAND, M>(s[mt][n][e], dp[mt][n][e], row_live[mt][hf], j, pos[mt][hf],
                                               len, lse[mt][hf], dl[mt][hf], o, p, s[mt][n][e]);
              }
        };
        if (need_mask) ds_tile(std::true_type{});
        else ds_tile(std::false_type{});
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const int c = wc * KW + n * 8 + 2 * t;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = (r0 + mt * 16 + g) * PT + c;
            *reinterpret_cast<uint32_t*>(ds_s + r) = pack_bf16(s[mt][n][0], s[mt][n][1]);
            *reinterpret_cast<uint32_t*>(ds_s + r + 8 * PT) = pack_bf16(s[mt][n][2], s[mt][n][3]);
          }
        }
        named_barrier(1 + wr, 32 * WC);

        // dq += dS K on the warp's DW columns: each K fragment serves both m-tiles
        const uint32_t kq = kt0 + stage * GM::STAGE;
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t sa[2][4], kb[2][4];
          ldmatrix_x4(sa[0], dsa + kk * 16 * E);
          ldmatrix_x4(sa[1], dsa + (16 * PT + kk * 16) * E);
          ldmatrix_x4_trans(kb[0], kq + kk * 16 * ST * E);
#pragma unroll
          for (int np = 0; np < DW / 16; ++np) {
            if (np + 1 < DW / 16) ldmatrix_x4_trans(kb[(np + 1) & 1], kq + (kk * 16 * ST + (np + 1) * 16) * E);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * np], sa[mt], kb[np & 1][0], kb[np & 1][1]);
              mma_bf16(acc[mt][2 * np + 1], sa[mt], kb[np & 1][2], kb[np & 1][3]);
            }
          }
        }
      }
      __syncthreads();  // every reader of this stage and of dS is done: refill
      if (it + STAGES < wk.n) issue(it + STAGES, stage);
    }
    // every stage's last phase has completed before the shared memory is released
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      if (wk.n > s) mbar_wait(&bars[s], ((wk.n - 1 - s) / STAGES) & 1);
  }

  // sm_scale at the store; rows not live are never written, a row with
  // nothing in band gets zeros
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int r = r0 + mt * 16 + g + 8 * hf;
      if (!row_live[mt][hf]) continue;
      bf16* out = dq + row_index(r) * D + wc * DW + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<__nv_bfloat162*>(out + n * 8) =
            __floats2bfloat162_rn(acc[mt][n][2 * hf] * o.sm_scale, acc[mt][n][2 * hf + 1] * o.sm_scale);
    }
}

// dk/dv tiles (see the header): a block owns BKV KV rows in WR row groups of
// 32 (two m16 tiles); the WC warps of a row group split the q columns of
// S^T and dP^T between them, then the D columns of dK and dV. BQ q rows a
// ring stage.
template <int D>
struct KvGeom {
  static constexpr int BKV = D > 128 ? 64 : 128;
  static constexpr int BQ = 64;
  static constexpr int WR = BKV / 32;
  static constexpr int WC = 8 / WR;
  static constexpr int THREADS = 256;
  static constexpr int QW = BQ / WC;  // q columns of a warp's S^T / dP^T
  static constexpr int DW = D / WC;   // columns of a warp's dK / dV
  static constexpr int ST = D + 8;    // padded smem row (elements): conflict-free ldmatrix
  static constexpr int PT = BQ + 8;   // padded row of P^T / dS^T
  static constexpr int STAGES = 2;
  // a stage: Q and dO (BQ, ST) bf16, then the LSE and delta (BQ,) fp32
  static constexpr size_t STAGE = (size_t)2 * BQ * ST * sizeof(bf16) + 2 * BQ * sizeof(float);
  static constexpr size_t SMEM = (size_t)2 * BKV * ST * sizeof(bf16) + STAGES * STAGE +
                                 (size_t)2 * BKV * PT * sizeof(bf16) + STAGES * sizeof(uint64_t);
  static_assert(QW % 16 == 0 && DW % 16 == 0 && STAGE % 16 == 0, "whole ldmatrix tiles");
  static_assert(BKV * D / 8 % THREADS == 0 && BQ * D / 8 % THREADS == 0, "whole copies a thread");
};

// The q walk of KV tile kt of sequence b: the q tiles in band (JAX
// _in_band): none when the tile starts at or past the length; causal, from
// the first tile whose last row reaches the tile's first KV row; with a
// window, up to the last tile whose first row's band reaches the tile's last
// KV row, unless the tile holds sinks. ops/flash_bwd.py's dkdv_walk is its
// twin.
struct Walk {
  int qt0, nq;  // first q tile, number of q tiles
};

__device__ __forceinline__ Walk kv_walk(const Args& a, int b, int kt, int bkv, int bq, bool causal,
                                        bool band) {
  const int j0 = kt * bkv;
  const int len = min(a.lengths[b], a.Skv), qoff = a.q_offsets[b];
  const int i_begin = causal ? max(0, j0 - qoff) / bq * bq : 0;
  int i_end = j0 < len ? a.Sq : 0;
  if (band && j0 >= a.opt.sinks) i_end = min(i_end, max(0, j0 + bkv - 1 + a.opt.window - 1 - qoff + 1));
  return Walk{i_begin / bq, i_end > i_begin ? (i_end - i_begin + bq - 1) / bq : 0};
}

// Splits of a walk of `steps` (head, q tile) steps, `chunk` steps each: 1
// for an empty walk (its block writes the zeros).
__device__ __forceinline__ int walk_splits(int steps, int chunk) {
  return steps ? (steps + chunk - 1) / chunk : 1;
}

// The block's KV tile: tiles in order of blockIdx.y, from the end whose
// first tile has the longer walk in sequence 0 (the causal triangle's first
// KV tiles; a ring step's last), so that the longest walks start first.
__device__ __forceinline__ int kv_tile(const Args& a, int bkv, int bq, bool causal, bool band) {
  const int nkt = gridDim.y;
  const bool up = kv_walk(a, 0, 0, bkv, bq, causal, band).nq >= kv_walk(a, 0, nkt - 1, bkv, bq, causal, band).nq;
  return up ? blockIdx.y : nkt - 1 - blockIdx.y;
}

template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
__global__ void __launch_bounds__(KvGeom<D>::THREADS, 1)
    flash_bwd_dkdv_kernel(const Args a, bf16* __restrict__ dk, bf16* __restrict__ dv,
                          float* __restrict__ ws, int chunk, int splits) {
  using GM = KvGeom<D>;
  constexpr int BKV = GM::BKV, BQ = GM::BQ, ST = GM::ST, PT = GM::PT, QW = GM::QW, DW = GM::DW;
  constexpr int WC = GM::WC, STAGES = GM::STAGES, THREADS = GM::THREADS;
  constexpr int NQ = QW / 8;  // n-tiles of a warp's S^T / dP^T
  constexpr int ND = DW / 8;  // n-tiles of a warp's dK / dV
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);              // (BKV, ST)
  bf16* v_s = k_s + BKV * ST;                                 // (BKV, ST)
  unsigned char* stages = reinterpret_cast<unsigned char*>(v_s + BKV * ST);
  bf16* p_s = reinterpret_cast<bf16*>(stages + STAGES * GM::STAGE);  // (BKV, PT) P^T
  bf16* ds_s = p_s + BKV * PT;                                       // (BKV, PT) dS^T
  uint64_t* bars = reinterpret_cast<uint64_t*>(ds_s + BKV * PT);

  const Options o = a.opt;
  const int Sq = a.Sq, Skv = a.Skv, G = a.Hq / a.Hkv;
  const int split = blockIdx.x % splits, kvh = (blockIdx.x / splits) % a.Hkv;
  const int b = blockIdx.x / (splits * a.Hkv);
  const int kt = kv_tile(a, BKV, BQ, CAUSAL, BAND);
  const Walk wk = kv_walk(a, b, kt, BKV, BQ, CAUSAL, BAND);
  const int steps = G * wk.nq;  // (head, q tile) steps, head-major
  const int nsplit = walk_splits(steps, chunk);
  if (split >= nsplit) return;
  const int t_begin = split * chunk;
  const int n_steps = max(0, min(steps, t_begin + chunk) - t_begin);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp / WC, wc = warp % WC;  // row group; the warp's q / D columns in it
  const int j0 = kt * BKV;
  const int w0 = j0 + wr * 32;  // the row group's first KV row
  const int len = min(a.lengths[b], Skv);
  const int qoff = a.q_offsets[b];
  const int W = o.window, SK = o.sinks;  // read only with BAND
  const size_t kv_base = ((size_t)b * a.Hkv + kvh) * (size_t)Skv * D;

  float dk_acc[2][ND][4], dv_acc[2][ND][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      dk_acc[mt][n][0] = dk_acc[mt][n][1] = dk_acc[mt][n][2] = dk_acc[mt][n][3] = 0.f;
      dv_acc[mt][n][0] = dv_acc[mt][n][1] = dv_acc[mt][n][2] = dv_acc[mt][n][3] = 0.f;
    }

  if (n_steps > 0) {
    if (tid == 0) {
#pragma unroll
      for (int s = 0; s < STAGES; ++s) mbar_init(&bars[s], THREADS);
    }
    __syncthreads();
    // the block's K/V rows (past Skv zero-filled), covered by the first stage's barrier
#pragma unroll
    for (int c = 0; c < BKV * D / 8 / THREADS; ++c) {
      const int i = tid + c * THREADS;
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const bool ok = j0 + row < Skv;
      const size_t off = kv_base + (ok ? (size_t)(j0 + row) * D + col : 0);
      cp_async16(k_s + row * ST + col, a.k + off, ok);
      cp_async16(v_s + row * ST + col, a.v + off, ok);
    }
    // Fill a stage with step `step`'s Q, dO, LSE and delta rows (rows past Sq
    // zero-filled), then arrive on its barrier.
    auto issue = [&](int step, int stage) {
      const int h = step / wk.nq, i0 = (wk.qt0 + step % wk.nq) * BQ;
      const size_t row0 = ((size_t)b * a.Hq + kvh * G + h) * (size_t)Sq + i0;
      bf16* qs = reinterpret_cast<bf16*>(stages + stage * GM::STAGE);
      bf16* dos = qs + BQ * ST;
      float* ls = reinterpret_cast<float*>(dos + BQ * ST);
#pragma unroll
      for (int c = 0; c < BQ * D / 8 / THREADS; ++c) {
        const int i = tid + c * THREADS;
        const int row = i / (D / 8), col = (i % (D / 8)) * 8;
        const bool ok = i0 + row < Sq;
        const size_t off = ok ? (row0 + row) * D + col : 0;
        cp_async16(qs + row * ST + col, a.q + off, ok);
        cp_async16(dos + row * ST + col, a.dout + off, ok);
      }
      if (tid < 2 * BQ) {  // the LSE (threads 0..BQ-1), then delta
        const int r = tid % BQ;
        const bool ok = i0 + r < Sq;
        cp_async4(ls + tid, (tid < BQ ? a.lse : a.delta) + (ok ? row0 + r : 0), ok);
      }
      mbar_arrive_cp_async(&bars[stage]);
    };
    for (int s = 0; s < STAGES && s < n_steps; ++s) issue(t_begin + s, s);

    // the lane's ldmatrix addresses (bytes): K, V, P^T, dS^T, and Q / dO of
    // stage 0 as S^T's B operand (qb0) and as dK's (qv0)
    constexpr int E = sizeof(bf16);
    const uint32_t kp = smem_u32(k_s + (wr * 32 + a_row(lane)) * ST + a_col(lane));
    const uint32_t vp = kp + BKV * ST * E;
    const uint32_t pp = smem_u32(p_s + (wr * 32 + a_row(lane)) * PT + a_col(lane));
    const uint32_t dsp = pp + BKV * PT * E;
    const uint32_t qb0 = smem_u32(stages) + ((wc * QW + b_row(lane)) * ST + b_col(lane)) * E;
    const uint32_t qv0 = smem_u32(stages) + (a_row(lane) * ST + wc * DW + a_col(lane)) * E;
    for (int it = 0; it < n_steps; ++it) {
      const int stage = it % STAGES;
      const uint32_t par = (it / STAGES) & 1;
      const int i0 = (wk.qt0 + (t_begin + it) % wk.nq) * BQ;
      const int i_last = min(i0 + BQ, Sq) - 1;
      // Every thread waits for the stage, also where its row group skips the
      // step: the walk can hold a step that no row group takes (a band or a
      // q offset that ends inside the KV tile), and a phase nobody waited on
      // could still have copies in flight when the stage is refilled.
      mbar_wait(&bars[stage], par);
      // the same for the row group's warps: it has rows below the length,
      // the q tile reaches its first row (causal) and is not past its band
      if (w0 < len && (!CAUSAL || qoff + i_last >= w0) &&
          (!BAND || w0 < SK || qoff + i0 <= w0 + 31 + W - 1)) {
        const float* ls = reinterpret_cast<const float*>(stages + stage * GM::STAGE + 2 * BQ * ST * E);
        const float* dls = ls + BQ;

        // S^T = K Q^T and dP^T = V dO^T: the row group's 32 KV rows (each K /
        // V fragment serves the warp's QW q columns, each Q / dO fragment its
        // two m-tiles), the q fragments a step ahead
        float s[2][NQ][4], dp[2][NQ][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            s[mt][n][0] = s[mt][n][1] = s[mt][n][2] = s[mt][n][3] = 0.f;
            dp[mt][n][0] = dp[mt][n][1] = dp[mt][n][2] = dp[mt][n][3] = 0.f;
          }
        const uint32_t qp = qb0 + stage * GM::STAGE;
        const uint32_t op = qp + BQ * ST * E;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ka[2][4], va[2][4], qb[2][4], db[2][4];
          ldmatrix_x4(ka[0], kp + kk * 16 * E);
          ldmatrix_x4(ka[1], kp + (16 * ST + kk * 16) * E);
          ldmatrix_x4(va[0], vp + kk * 16 * E);
          ldmatrix_x4(va[1], vp + (16 * ST + kk * 16) * E);
          ldmatrix_x4(qb[0], qp + kk * 16 * E);
          ldmatrix_x4(db[0], op + kk * 16 * E);
#pragma unroll
          for (int np = 0; np < QW / 16; ++np) {
            if (np + 1 < QW / 16) {
              ldmatrix_x4(qb[(np + 1) & 1], qp + ((np + 1) * 16 * ST + kk * 16) * E);
              ldmatrix_x4(db[(np + 1) & 1], op + ((np + 1) * 16 * ST + kk * 16) * E);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(s[mt][2 * np], ka[mt], qb[np & 1][0], qb[np & 1][1]);
              mma_bf16(s[mt][2 * np + 1], ka[mt], qb[np & 1][2], qb[np & 1][3]);
              mma_bf16(dp[mt][2 * np], va[mt], db[np & 1][0], db[np & 1][1]);
              mma_bf16(dp[mt][2 * np + 1], va[mt], db[np & 1][2], db[np & 1][3]);
            }
          }
        }
        // P^T and dS^T (rows KV positions, columns q rows), rounded to bf16
        // into shared memory for the row group's warps; the mask tests only
        // where the step crosses Sq, the length, the diagonal or the band of
        // the row group's rows
        const bool need_mask = i0 + BQ > Sq || w0 + 32 > len || (CAUSAL && w0 + 31 > qoff + i0) ||
                               (BAND && w0 <= qoff + i0 + BQ - 1 - W);
        auto p_ds_tile = [&](auto mask) {
          constexpr bool M = decltype(mask)::value;
#pragma unroll
          for (int n = 0; n < NQ; ++n) {
            const int qi = wc * QW + n * 8 + 2 * t;  // the lane's first q column in the tile
            const float lq[2] = {ls[qi], ls[qi + 1]}, dl[2] = {dls[qi], dls[qi + 1]};
#pragma unroll
            for (int mt = 0; mt < 2; ++mt)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int i = i0 + qi + (e & 1);
                const int j = w0 + mt * 16 + g + (e >= 2 ? 8 : 0);
                p_ds<CAUSAL, SOFTCAP, BAND, M>(s[mt][n][e], dp[mt][n][e], i < Sq, j, qoff + i, len,
                                               lq[e & 1], dl[e & 1], o, s[mt][n][e], dp[mt][n][e]);
              }
          }
        };
        if (need_mask) p_ds_tile(std::true_type{});
        else p_ds_tile(std::false_type{});
#pragma unroll
        for (int n = 0; n < NQ; ++n) {
          const int qi = wc * QW + n * 8 + 2 * t;
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            const int r = (wr * 32 + mt * 16 + g) * PT + qi;
            *reinterpret_cast<uint32_t*>(p_s + r) = pack_bf16(s[mt][n][0], s[mt][n][1]);
            *reinterpret_cast<uint32_t*>(p_s + r + 8 * PT) = pack_bf16(s[mt][n][2], s[mt][n][3]);
            *reinterpret_cast<uint32_t*>(ds_s + r) = pack_bf16(dp[mt][n][0], dp[mt][n][1]);
            *reinterpret_cast<uint32_t*>(ds_s + r + 8 * PT) = pack_bf16(dp[mt][n][2], dp[mt][n][3]);
          }
        }
        named_barrier(1 + wr, 32 * WC);

        // dV += P^T dO and dK += dS^T Q on the warp's DW columns: each dO / Q
        // fragment serves both m-tiles
        const uint32_t qv = qv0 + stage * GM::STAGE;
        const uint32_t ob = qv + BQ * ST * E;
#pragma unroll
        for (int kq = 0; kq < BQ / 16; ++kq) {
          uint32_t pa[2][4], sa[2][4], bo[2][4], bq_[2][4];
          ldmatrix_x4(pa[0], pp + kq * 16 * E);
          ldmatrix_x4(pa[1], pp + (16 * PT + kq * 16) * E);
          ldmatrix_x4(sa[0], dsp + kq * 16 * E);
          ldmatrix_x4(sa[1], dsp + (16 * PT + kq * 16) * E);
          ldmatrix_x4_trans(bo[0], ob + kq * 16 * ST * E);
          ldmatrix_x4_trans(bq_[0], qv + kq * 16 * ST * E);
#pragma unroll
          for (int np = 0; np < DW / 16; ++np) {
            if (np + 1 < DW / 16) {
              ldmatrix_x4_trans(bo[(np + 1) & 1], ob + (kq * 16 * ST + (np + 1) * 16) * E);
              ldmatrix_x4_trans(bq_[(np + 1) & 1], qv + (kq * 16 * ST + (np + 1) * 16) * E);
            }
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(dv_acc[mt][2 * np], pa[mt], bo[np & 1][0], bo[np & 1][1]);
              mma_bf16(dv_acc[mt][2 * np + 1], pa[mt], bo[np & 1][2], bo[np & 1][3]);
              mma_bf16(dk_acc[mt][2 * np], sa[mt], bq_[np & 1][0], bq_[np & 1][1]);
              mma_bf16(dk_acc[mt][2 * np + 1], sa[mt], bq_[np & 1][2], bq_[np & 1][3]);
            }
          }
        }
      }
      __syncthreads();  // every reader of this stage and of P^T / dS^T is done: refill
      if (it + STAGES < n_steps) issue(t_begin + it + STAGES, stage);
    }
    // every stage's last phase has completed before the shared memory is released
#pragma unroll
    for (int s = 0; s < STAGES; ++s)
      if (n_steps > s) mbar_wait(&bars[s], ((n_steps - 1 - s) / STAGES) & 1);
  }

  // One split: bf16 dk (scaled) and dv. Several: this split's fp32 sums to
  // the workspace, (splits, 2, B, Hkv, Skv, D), summed by flash_bwd_dkdv_sum.
  const bool direct = nsplit == 1;
  const size_t plane = (size_t)a.B * a.Hkv * Skv * D;
  float* ws_dk = ws + (size_t)split * 2 * plane;
  float* ws_dv = ws_dk + plane;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int j = w0 + mt * 16 + g + hf * 8;
      if (j >= Skv) continue;
      const size_t rowo = kv_base + (size_t)j * D + wc * DW + 2 * t;
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        const float k0 = dk_acc[mt][n][2 * hf], k1 = dk_acc[mt][n][2 * hf + 1];
        const float v0 = dv_acc[mt][n][2 * hf], v1 = dv_acc[mt][n][2 * hf + 1];
        if (direct) {
          *reinterpret_cast<__nv_bfloat162*>(dk + rowo + n * 8) =
              __floats2bfloat162_rn(k0 * o.sm_scale, k1 * o.sm_scale);
          *reinterpret_cast<__nv_bfloat162*>(dv + rowo + n * 8) = __floats2bfloat162_rn(v0, v1);
        } else {
          *reinterpret_cast<float2*>(ws_dk + rowo + n * 8) = make_float2(k0, k1);
          *reinterpret_cast<float2*>(ws_dv + rowo + n * 8) = make_float2(v0, v1);
        }
      }
    }
  }
}

// The split walks' second pass: for each KV row of a tile walked in more
// than one split, dk = sm_scale * (((0 + w[0]) + w[1]) + ...) and dv likewise,
// summed in split order in fp32 and rounded once to bf16; 8 columns a
// thread. Rows of tiles walked in one split were written by their block.
template <int D>
__global__ void __launch_bounds__(256)
    flash_bwd_dkdv_sum(const Args a, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       const float* __restrict__ ws, int chunk) {
  using GM = KvGeom<D>;
  const size_t plane = (size_t)a.B * a.Hkv * a.Skv * D;
  const bool band = a.opt.window < NO_WINDOW;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < plane / 8;
       i += (size_t)gridDim.x * blockDim.x) {
    const size_t e = i * 8;
    const int row = static_cast<int>((e / D) % a.Skv);
    const int b = static_cast<int>(e / ((size_t)a.Hkv * a.Skv * D));
    const Walk wk = kv_walk(a, b, row / GM::BKV, GM::BKV, GM::BQ, a.causal, band);
    const int nsplit = walk_splits((a.Hq / a.Hkv) * wk.nq, chunk);
    if (nsplit == 1) continue;
    float acc[2][8];
#pragma unroll
    for (int w = 0; w < 2; ++w)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[w][c] = 0.f;
    for (int s = 0; s < nsplit; ++s) {
#pragma unroll
      for (int w = 0; w < 2; ++w) {
        const float4* p = reinterpret_cast<const float4*>(ws + ((size_t)s * 2 + w) * plane + e);
        const float4 x = p[0], y = p[1];
        acc[w][0] += x.x, acc[w][1] += x.y, acc[w][2] += x.z, acc[w][3] += x.w;
        acc[w][4] += y.x, acc[w][5] += y.y, acc[w][6] += y.z, acc[w][7] += y.w;
      }
    }
    uint4 pk, pv;
    uint32_t* k32 = reinterpret_cast<uint32_t*>(&pk);
    uint32_t* v32 = reinterpret_cast<uint32_t*>(&pv);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      k32[c] = pack_bf16(acc[0][2 * c] * a.opt.sm_scale, acc[0][2 * c + 1] * a.opt.sm_scale);
      v32[c] = pack_bf16(acc[1][2 * c], acc[1][2 * c + 1]);
    }
    *reinterpret_cast<uint4*>(dk + e) = pk;
    *reinterpret_cast<uint4*>(dv + e) = pv;
  }
}

struct DqLaunch {
  void* dq;
  cudaStream_t stream;
  template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
  cudaError_t run(const Args& a) const {
    using GM = DqGeom<D>;
    const int G = a.Hq / a.Hkv;
    if (G < 1 || G > 8) return cudaErrorInvalidConfiguration;
    const int bq = GM::ROWS / G;  // q rows of each head a block
    auto kernel = flash_bwd_dq_kernel<D, CAUSAL, SOFTCAP, BAND>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(GM::SMEM));
    if (e != cudaSuccess) return e;
    // x: (KV head, sequence); y: q tiles, in dq_tile's order
    dim3 grid(a.Hkv * a.B, (a.Sq + bq - 1) / bq);
    kernel<<<grid, GM::THREADS, GM::SMEM, stream>>>(a, static_cast<bf16*>(dq), bq);
    return cudaGetLastError();
  }
};

struct DkdvLaunch {
  void *dk, *dv, *ws;
  int chunk, splits;
  cudaStream_t stream;
  template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
  cudaError_t run(const Args& a) const {
    using GM = KvGeom<D>;
    if (chunk < 1 || splits < 1 || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
    auto kernel = flash_bwd_dkdv_kernel<D, CAUSAL, SOFTCAP, BAND>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(GM::SMEM));
    if (e != cudaSuccess) return e;
    // x: (split, KV head, sequence); y: KV tiles, in kv_tile's order
    dim3 grid(splits * a.Hkv * a.B, (a.Skv + GM::BKV - 1) / GM::BKV);
    kernel<<<grid, GM::THREADS, GM::SMEM, stream>>>(a, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                     static_cast<float*>(ws), chunk, splits);
    e = cudaGetLastError();
    if (e != cudaSuccess || splits == 1) return e;
    const size_t n8 = (size_t)a.B * a.Hkv * a.Skv * D / 8;
    const int blocks = static_cast<int>((n8 + 255) / 256 < 4096 ? (n8 + 255) / 256 : 4096);
    flash_bwd_dkdv_sum<D><<<blocks, 256, 0, stream>>>(a, static_cast<bf16*>(dk), static_cast<bf16*>(dv),
                                                       static_cast<const float*>(ws), chunk);
    return cudaGetLastError();
  }
};

// The forms of one head_dim: causal or not without the options; BAND,
// SOFTCAP and both for causal only (5 instantiations a kernel and D).
template <int D, class L>
cudaError_t by_flags(const Args& a, const L& l) {
  const bool band = a.opt.window < NO_WINDOW, cap = a.opt.softcap > 0.f;
  if (band || cap) {
    if (!a.causal) return cudaErrorInvalidValue;
    if (band && cap) return l.template run<D, true, true, true>(a);
    if (band) return l.template run<D, true, false, true>(a);
    return l.template run<D, true, true, false>(a);
  }
  return a.causal ? l.template run<D, true, false, false>(a) : l.template run<D, false, false, false>(a);
}

template <class L>
cudaError_t by_dim(int D, const Args& a, const L& l) {
  if (a.opt.window < 1 || a.opt.sinks < 0) return cudaErrorInvalidValue;
  switch (D) {
    case 64:
      return by_flags<64>(a, l);
    case 128:
      return by_flags<128>(a, l);
    case 256:
      return by_flags<256>(a, l);
    default:
      return cudaErrorInvalidValue;
  }
}

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* lengths, const void* q_offsets, int B, int Hq, int Hkv,
               int Sq, int Skv, int causal, float sm_scale, float scale_log2, int window, int sinks,
               float softcap) {
  return Args{static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
              static_cast<const bf16*>(dout), static_cast<const float*>(lse),
              static_cast<const float*>(delta), static_cast<const int*>(lengths),
              static_cast<const int*>(q_offsets), B, Hq, Hkv, Sq, Skv, causal,
              Options{window, sinks, sm_scale, scale_log2, softcap}};
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// q, dout (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), dq (B, Hq, Sq, D): bf16,
// contiguous. lse, delta: (B, Hq, Sq) fp32. lengths, q_offsets: (B,) int32.
// D is 64, 128 or 256; Hq / Hkv <= 8. sm_scale is the score scale,
// scale_log2 the value the forward took (sm_scale * log2 e); window (>= 1,
// 1 << 30 for none), sinks (>= 0), softcap (0 for none) as the forward's,
// causal only.
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* lengths, const void* q_offsets, void* dq, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int causal, float sm_scale,
                 float scale_log2, int window, int sinks, float softcap, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, q_offsets, B, Hq, Hkv, Sq, Skv, causal,
                           sm_scale, scale_log2, window, sinks, softcap);
  return static_cast<int>(by_dim(D, a, DqLaunch{dq, static_cast<cudaStream_t>(stream)}));
}

// The same inputs; dk, dv (B, Hkv, Skv, D) bf16, contiguous. Each KV tile's
// q walk is cut into pieces of `chunk` (head, q tile) steps, one block each,
// for at most `splits` pieces (ops/flash_bwd.py's dkdv_split_plan); with
// splits > 1, ws is an fp32 workspace of (splits, 2, B, Hkv, Skv, D).
int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* lengths, const void* q_offsets, void* dk,
                   void* dv, void* ws, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   int chunk, int splits, float sm_scale, float scale_log2, int window, int sinks,
                   float softcap, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, q_offsets, B, Hq, Hkv, Sq, Skv, causal,
                           sm_scale, scale_log2, window, sinks, softcap);
  return static_cast<int>(
      by_dim(D, a, DkdvLaunch{dk, dv, ws, chunk, splits, static_cast<cudaStream_t>(stream)}));
}

// The dk/dv kernel's tiles at head_dim D: {KV rows a block, q rows a step,
// dynamic shared memory bytes}; 0 for a head_dim it does not take.
int flash_bwd_dkdv_geometry(int D, int* out) {
  switch (D) {
#define SFA_GEOMETRY(DD)                                  \
  case DD:                                                \
    out[0] = KvGeom<DD>::BKV;                             \
    out[1] = KvGeom<DD>::BQ;                              \
    out[2] = static_cast<int>(KvGeom<DD>::SMEM);          \
    return 0;
    SFA_GEOMETRY(64)
    SFA_GEOMETRY(128)
    SFA_GEOMETRY(256)
#undef SFA_GEOMETRY
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dq kernel's tiles at head_dim D and G query heads a KV head: {q rows
// of each head a block, keys a ring stage, dynamic shared memory bytes}; 0
// for a geometry it does not take.
int flash_bwd_dq_geometry(int D, int G, int* out) {
  if (G < 1 || G > 8) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
#define SFA_GEOMETRY(DD)                                  \
  case DD:                                                \
    out[0] = DqGeom<DD>::ROWS / G;                        \
    out[1] = DqGeom<DD>::BK;                              \
    out[2] = static_cast<int>(DqGeom<DD>::SMEM);          \
    return 0;
    SFA_GEOMETRY(64)
    SFA_GEOMETRY(128)
    SFA_GEOMETRY(256)
#undef SFA_GEOMETRY
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
