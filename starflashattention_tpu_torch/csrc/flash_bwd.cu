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
// Design: both kernels use K5's warp layout, mma.sync.m16n8k16 with bf16
// inputs and fp32 accumulators, fragments for the A operand straight from
// registers or shared memory and ldmatrix.trans for the transposed B
// operands, and skip tiles out of band (causal, ragged length, q offset,
// window) before any arithmetic, as the TPU's _in_band does.
// - dq: one block per (q tile, KV head, sequence) holds the G query heads
//   of the group (K5's layout); each warp walks the K/V tiles in band, 16
//   keys at a time, with its dq accumulator in registers, so S, dP and dS
//   never leave registers. The walk is K5's: with BAND the sink tiles below
//   the block's band first, then the band from the tile that holds its
//   first row's band start; rows below the band that are not sinks are
//   zero-filled and never read. At D <= 128 the warp keeps its 16 rows' Q
//   and dO fragments in registers. At D = 256 the accumulator alone takes
//   128 registers a thread and the two fragment sets would take 128 more,
//   past the 255 limit, so (as K5's QSMEM) each warp stages its Q and dO
//   rows in its own slice of shared memory and reads one fragment of each
//   a k-step; the K/V tile is 32 rows (169 KB of shared memory a block).
// - dk/dv: one block per (64-row KV tile, KV head, sequence); each warp owns
//   16 KV rows and their dk, dv accumulators. The block walks the q tiles
//   in band of all G heads, staging Q, dO, lse and delta in shared memory;
//   the group sum falls out of the same walk. With BAND the q walk runs
//   from the tile's first in-band q tile to the last q row whose band
//   reaches the tile's last row (j0 + 63 + window - 1), or to the end when
//   the tile holds sinks. At D = 256 the two fp32 accumulators of 16 x 256
//   would take 256 registers a thread, so D is split between warp pairs:
//   8 warps, two for each 16 KV rows, each owning half of the columns of dk
//   and dv (128 registers, as at D = 128). Both warps of a pair recompute
//   the same S and dP over the full D (12 D operations a pair where the
//   unsplit form does 8 D; no exchange through shared memory). 136 KB of dynamic
//   shared memory a block at D = 256, 70 KB at D = 128.
// Blocks are numbered so that the longest walks start first (the causal
// triangle's last q tiles in dq, its first KV tiles in dk/dv, and with
// sinks the sink tile, which every q row reaches): blocks start in index
// order, and a long block started in the last wave sets the kernel's time.
// With the tile as the fastest grid index, the banded dk/dv with sinks ran
// as slow as the unbanded one at Mistral-7B's shape: the sink tiles of the
// last KV heads started in the last wave.
// Not yet: copies overlapped with compute (cp.async / TMA), wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DQ_MAX_THREADS = 256;      // dq: 8 warps, up to 255 registers a thread
constexpr int KV_WARPS = 4;              // dk/dv: row groups a block, 16 KV rows each
constexpr int BKV = 16 * KV_WARPS;       // dk/dv: KV rows a block owns
constexpr int BQ = 64;                   // dk/dv: q rows per shared-memory tile
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four transposed 8x8 b16 matrices from shared memory; lane l gives the
// address of row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The A fragment (16 rows x 16 columns, row-major) at `p`, row stride `st`:
// lane (g, t) holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t* a, const bf16* p, int st, int g, int t) {
  a[0] = ld32(p + g * st + 2 * t);
  a[1] = ld32(p + (g + 8) * st + 2 * t);
  a[2] = ld32(p + g * st + 2 * t + 8);
  a[3] = ld32(p + (g + 8) * st + 2 * t + 8);
}

// acc (16 x N) += A (16 x 16, a fragment) @ M[0:16, 0:N], M row-major in
// shared memory at `m` with row stride `st` (its rows are the k index).
template <int N>
__device__ __forceinline__ void mma_a_by_rows(float (*acc)[4], const uint32_t* a, const bf16* m, int st,
                                              int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  const bf16* row = m + (rr + (mi & 1) * 8) * st + (mi >> 1) * 8;
#pragma unroll
  for (int np = 0; np < N / 16; ++np) {
    uint32_t bb[4];
    ldmatrix_x4_trans(bb, row + np * 16);
    mma_bf16(acc[2 * np], a, bb[0], bb[1]);
    mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
  }
}

// Stage `rows` rows of D bf16 from `src` (row-major) into shared memory at
// `dst` with row stride ST, by every thread of the block (`nthreads` from
// `tid`). Rows at or past `valid`, and rows in [gap_lo, gap_hi), are
// zero-filled and never read.
template <int D, int ST>
__device__ __forceinline__ void stage_rows(bf16* dst, const bf16* src, int rows, int valid, int tid,
                                           int nthreads, int gap_lo = 0, int gap_hi = 0) {
  for (int i = tid; i < rows * D / 8; i += nthreads) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid && (row < gap_lo || row >= gap_hi))
      x = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col);
    *reinterpret_cast<uint4*>(dst + row * ST + col) = x;
  }
}

// P and dS of one score: `s` is the raw fp32 q.k and `dp` the fp32 dout.v
// of (query at position `pos`, key `col`); `live` is false for a query row
// past Sq. The mask and the scores are the forward's (see the header).
template <bool CAUSAL, bool SOFTCAP, bool BAND>
__device__ __forceinline__ void p_ds(float s, float dp, bool live, int col, int pos, int len, float lse,
                                     float dl, const Options& o, float& p, float& ds) {
  bool valid = live && col < len && (!CAUSAL || col <= pos);
  if constexpr (BAND) valid = valid && (col > pos - o.window || col < o.sinks);
  if constexpr (SOFTCAP) {
    const float t = tanhf(s * o.sm_scale / o.softcap);
    p = valid ? exp2f(__fmul_rn(__fmul_rn(o.softcap, t), LOG2E) - lse) : 0.f;
    ds = p * (dp - dl) * (1.f - t * t);
  } else {
    p = valid ? exp2f(s * o.scale_log2 - lse) : 0.f;
    ds = p * (dp - dl);
  }
}

// dq: K/V rows per shared-memory tile, 32 at D = 256; Q and dO in shared
// memory at D = 256.
template <int D>
struct DqGeom {
  static constexpr bool QSMEM = D > 128;
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int ST = D + 8;  // padded smem row (elements): conflict-free fragment loads
};

template <int D>
size_t dq_smem_bytes(int threads) {
  using GM = DqGeom<D>;
  const size_t kv = 2 * (size_t)GM::BK * GM::ST;
  const size_t qs = GM::QSMEM ? (size_t)(threads / 32) * 32 * GM::ST : 0;  // Q and dO, 16 rows each
  return (kv + qs) * sizeof(bf16);
}

template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
__global__ void __launch_bounds__(DQ_MAX_THREADS)
    flash_bwd_dq_kernel(const Args a, bf16* __restrict__ dq, int bq) {
  using GM = DqGeom<D>;
  constexpr int BK = GM::BK;
  constexpr int ST = GM::ST;
  constexpr int KT = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [BK][ST]
  bf16* v_s = k_s + BK * ST;                      // [BK][ST]

  const Options o = a.opt;
  const int Hq = a.Hq, Sq = a.Sq, Skv = a.Skv;
  const int qt = gridDim.y - 1 - blockIdx.y, kvh = blockIdx.x, b = blockIdx.z;  // the longest walks first
  const int G = Hq / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warps_per_head = bq / 16;
  const int head = kvh * G + warp / warps_per_head;
  const int r0 = qt * bq + (warp % warps_per_head) * 16;  // this warp's first q row
  const int ra = r0 + g, rb = r0 + g + 8;                  // this lane's two rows
  const int len = min(a.lengths[b], Skv);
  const int qoff = a.q_offsets[b];
  const int pa = qoff + ra, pb = qoff + rb;                // their absolute positions
  const int warp_last = qoff + min(r0 + 15, Sq - 1);       // last position of the warp
  const int W = o.window, SK = o.sinks;                    // read only with BAND

  // This warp's Q and dO fragments for the whole walk: in registers, or (D =
  // 256) its 16 rows of each in its own slice of shared memory.
  const size_t row0 = ((size_t)b * Hq + head) * (size_t)Sq;
  const bf16* qh = a.q + row0 * D;
  const bf16* dh = a.dout + row0 * D;
  uint32_t qa[GM::QSMEM ? 1 : KT][4], da[GM::QSMEM ? 1 : KT][4];
  bf16* q_s = v_s + BK * ST + (size_t)warp * 32 * ST;  // [16][ST] Q, then [16][ST] dO; QSMEM only
  bf16* do_s = q_s + 16 * ST;
  if constexpr (GM::QSMEM) {
    const int valid = max(min(16, Sq - r0), 0);
    stage_rows<D, ST>(q_s, qh + (size_t)r0 * D, 16, valid, lane, 32);
    stage_rows<D, ST>(do_s, dh + (size_t)r0 * D, 16, valid, lane, 32);
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ra < Sq ? ld32(qh + (size_t)ra * D + c) : 0u;
      qa[kk][1] = rb < Sq ? ld32(qh + (size_t)rb * D + c) : 0u;
      qa[kk][2] = ra < Sq ? ld32(qh + (size_t)ra * D + c + 8) : 0u;
      qa[kk][3] = rb < Sq ? ld32(qh + (size_t)rb * D + c + 8) : 0u;
      da[kk][0] = ra < Sq ? ld32(dh + (size_t)ra * D + c) : 0u;
      da[kk][1] = rb < Sq ? ld32(dh + (size_t)rb * D + c) : 0u;
      da[kk][2] = ra < Sq ? ld32(dh + (size_t)ra * D + c + 8) : 0u;
      da[kk][3] = rb < Sq ? ld32(dh + (size_t)rb * D + c + 8) : 0u;
    }
  }
  const float lse_a = ra < Sq ? a.lse[row0 + ra] : LSE_EMPTY;
  const float lse_b = rb < Sq ? a.lse[row0 + rb] : LSE_EMPTY;
  const float dl_a = ra < Sq ? a.delta[row0 + ra] : 0.f;
  const float dl_b = rb < Sq ? a.delta[row0 + rb] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const size_t kv_base = ((size_t)b * a.Hkv + kvh) * (size_t)Skv * D;
  const int block_first = qoff + qt * bq;  // first position of the block's rows
  const int block_last_row = min(qt * bq + bq, Sq) - 1;
  const int kv_end = CAUSAL ? min(len, qoff + block_last_row + 1) : len;
  // Window: the block's lowest band start is its first row's; tiles wholly
  // below it are skipped, except the sink tiles, which come first.
  const int lo = BAND ? max(block_first - W + 1, 0) : 0;
  const int band0 = lo / BK * BK;
  const int sink_tiles_end = BAND ? (min(SK, band0) + BK - 1) / BK * BK : 0;
  const int warp_lo = qoff + r0 - W + 1;  // this warp's lowest band start

  for (int j0 = sink_tiles_end ? 0 : band0; j0 < kv_end;
       j0 = j0 + BK < sink_tiles_end ? j0 + BK : max(j0 + BK, band0)) {
    if constexpr (BAND) {  // rows below the band that are not sinks stay unread
      stage_rows<D, ST>(k_s, a.k + kv_base + (size_t)j0 * D, BK, Skv - j0, threadIdx.x, blockDim.x,
                        SK - j0, lo - j0);
      stage_rows<D, ST>(v_s, a.v + kv_base + (size_t)j0 * D, BK, Skv - j0, threadIdx.x, blockDim.x,
                        SK - j0, lo - j0);
    } else {
      stage_rows<D, ST>(k_s, a.k + kv_base + (size_t)j0 * D, BK, Skv - j0, threadIdx.x, blockDim.x);
      stage_rows<D, ST>(v_s, a.v + kv_base + (size_t)j0 * D, BK, Skv - j0, threadIdx.x, blockDim.x);
    }
    __syncthreads();

    // warp-uniform: the warp has rows, the tile is not wholly above its
    // diagonal, and not wholly below its band unless it holds sinks
    if (r0 < Sq && (!CAUSAL || j0 <= warp_last) && (!BAND || j0 + BK - 1 >= warp_lo || j0 < SK)) {
#pragma unroll 1
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys at a time
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
          dp[nn][0] = dp[nn][1] = dp[nn][2] = dp[nn][3] = 0.f;
        }
        if constexpr (GM::QSMEM) {  // one Q and one dO fragment from shared memory a k-step
#pragma unroll
          for (int kq = 0; kq < KT; ++kq) {
            uint32_t af[4], df[4];
            load_a(af, q_s + kq * 16, ST, g, t);
            load_a(df, do_s + kq * 16, ST, g, t);
#pragma unroll
            for (int nn = 0; nn < 2; ++nn) {
              const bf16* krow = k_s + (kk * 16 + nn * 8 + g) * ST + 2 * t + kq * 16;
              const bf16* vrow = v_s + (kk * 16 + nn * 8 + g) * ST + 2 * t + kq * 16;
              mma_bf16(s[nn], af, ld32(krow), ld32(krow + 8));
              mma_bf16(dp[nn], df, ld32(vrow), ld32(vrow + 8));
            }
          }
        } else {
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const bf16* krow = k_s + (kk * 16 + nn * 8 + g) * ST + 2 * t;
            const bf16* vrow = v_s + (kk * 16 + nn * 8 + g) * ST + 2 * t;
#pragma unroll
            for (int kq = 0; kq < KT; ++kq) {
              mma_bf16(s[nn], qa[kq], ld32(krow + kq * 16), ld32(krow + kq * 16 + 8));
              mma_bf16(dp[nn], da[kq], ld32(vrow + kq * 16), ld32(vrow + kq * 16 + 8));
            }
          }
        }
        // dS in place of the scores
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j0 + kk * 16 + nn * 8 + 2 * t + (e & 1);
            const bool hi = e >= 2;
            float p;
            p_ds<CAUSAL, SOFTCAP, BAND>(s[nn][e], dp[nn][e], true, col, hi ? pb : pa, len,
                                        hi ? lse_b : lse_a, hi ? dl_b : dl_a, o, p, s[nn][e]);
          }
        }
        const uint32_t af[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        mma_a_by_rows<D>(acc, af, k_s + kk * 16 * ST, ST, lane);  // dq += dS @ K
      }
    }
    __syncthreads();
  }

  if (r0 >= Sq) return;
  bf16* oh = dq + row0 * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)ra * D + c) =
          __floats2bfloat162_rn(acc[n][0] * o.sm_scale, acc[n][1] * o.sm_scale);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)rb * D + c) =
          __floats2bfloat162_rn(acc[n][2] * o.sm_scale, acc[n][3] * o.sm_scale);
  }
}

// dk/dv: SPLIT warps share each 16 KV rows, each owning DP = D / SPLIT
// columns of dk and dv.
template <int D>
struct KvGeom {
  static constexpr int SPLIT = D > 128 ? 2 : 1;
  static constexpr int THREADS = 32 * KV_WARPS * SPLIT;
  // three blocks an SM at D <= 128 (170 registers a thread): the BAND
  // forms took 202-218 registers unbounded, two blocks an SM, and ran no
  // faster than the unbanded form on 0.76 of its q rows
  static constexpr int MIN_BLOCKS = D > 128 ? 1 : 3;
  static constexpr int DP = D / SPLIT;
  static constexpr int ST = D + 8;
};

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * BKV + 2 * BQ) * (D + 8) * 2 + 2 * BQ * 4;
}

template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
__global__ void __launch_bounds__(KvGeom<D>::THREADS, KvGeom<D>::MIN_BLOCKS)
    flash_bwd_dkdv_kernel(const Args a, bf16* __restrict__ dk, bf16* __restrict__ dv) {
  using GM = KvGeom<D>;
  constexpr int ST = GM::ST;
  constexpr int KT = D / 16;
  constexpr int DP = GM::DP;
  constexpr int NP = DP / 8;  // n-tiles of this warp's columns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);           // (BKV, ST)
  bf16* v_s = k_s + BKV * ST;                              // (BKV, ST)
  bf16* q_s = v_s + BKV * ST;                              // (BQ, ST)
  bf16* do_s = q_s + BQ * ST;                              // (BQ, ST)
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * ST);  // (BQ,)
  float* dl_s = lse_s + BQ;                                // (BQ,)

  const Options o = a.opt;
  const int Sq = a.Sq, Skv = a.Skv;
  const int kt = blockIdx.y, kvh = blockIdx.x, b = blockIdx.z;  // the first KV tiles (the longest walks) first
  const int G = a.Hq / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rg = warp % KV_WARPS, part = warp / KV_WARPS;  // row group; column part (D = 256)
  const int g = lane >> 2, t = lane & 3;
  const int j0 = kt * BKV;
  const int len = min(a.lengths[b], Skv);
  const int qoff = a.q_offsets[b];
  const int w0 = j0 + rg * 16;             // this warp's first KV row
  const int ja = w0 + g, jb = w0 + g + 8;  // this lane's two KV rows
  const int W = o.window, SK = o.sinks;    // read only with BAND

  const size_t kv_base = ((size_t)b * a.Hkv + kvh) * (size_t)Skv * D + (size_t)j0 * D;
  stage_rows<D, ST>(k_s, a.k + kv_base, BKV, Skv - j0, threadIdx.x, blockDim.x);
  stage_rows<D, ST>(v_s, a.v + kv_base, BKV, Skv - j0, threadIdx.x, blockDim.x);

  float dk_acc[NP][4], dv_acc[NP][4];
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  // q rows in band: none past the valid length; causal, from the first row
  // whose position reaches this tile; with a window, up to the last row
  // whose band reaches the tile's last row, unless the tile holds sinks
  const int i_begin = CAUSAL ? max(0, j0 - qoff) / BQ * BQ : 0;
  int i_end = j0 < len ? Sq : 0;
  if (BAND && j0 >= SK) i_end = min(i_end, max(0, j0 + BKV - 1 + W - 1 - qoff + 1));
  for (int h = 0; h < G; ++h) {
    const size_t row0 = ((size_t)b * a.Hq + kvh * G + h) * (size_t)Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      __syncthreads();  // the previous tile's readers are done (first pass: K/V staged)
      stage_rows<D, ST>(q_s, a.q + (row0 + i0) * D, BQ, Sq - i0, threadIdx.x, blockDim.x);
      stage_rows<D, ST>(do_s, a.dout + (row0 + i0) * D, BQ, Sq - i0, threadIdx.x, blockDim.x);
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        lse_s[i] = i0 + i < Sq ? a.lse[row0 + i0 + i] : LSE_EMPTY;
        dl_s[i] = i0 + i < Sq ? a.delta[row0 + i0 + i] : 0.f;
      }
      __syncthreads();

      const int i_last = min(i0 + BQ, Sq) - 1;
      if (w0 >= len || (CAUSAL && qoff + i_last < w0)) continue;  // warp-uniform
      if (BAND && w0 >= SK && qoff + i0 > w0 + 15 + W - 1) continue;  // the tile is past the warp's band
#pragma unroll 1
      for (int c = 0; c < BQ / 16; ++c) {  // 16 q rows at a time
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
          dp[nn][0] = dp[nn][1] = dp[nn][2] = dp[nn][3] = 0.f;
        }
#pragma unroll
        for (int kq = 0; kq < KT; ++kq) {
          uint32_t ka[4], va[4];
          load_a(ka, k_s + rg * 16 * ST + kq * 16, ST, g, t);
          load_a(va, v_s + rg * 16 * ST + kq * 16, ST, g, t);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const bf16* qrow = q_s + (c * 16 + nn * 8 + g) * ST + kq * 16 + 2 * t;
            const bf16* drow = do_s + (c * 16 + nn * 8 + g) * ST + kq * 16 + 2 * t;
            mma_bf16(s[nn], ka, ld32(qrow), ld32(qrow + 8));   // S^T = K Q^T
            mma_bf16(dp[nn], va, ld32(drow), ld32(drow + 8));  // dP^T = V dO^T
          }
        }
        // P^T and dS^T: rows are KV positions, columns q rows
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c * 16 + nn * 8 + 2 * t + (e & 1);
            const int i = i0 + qi;
            p_ds<CAUSAL, SOFTCAP, BAND>(s[nn][e], dp[nn][e], i < Sq, e < 2 ? ja : jb, qoff + i, len,
                                        lse_s[qi], dl_s[qi], o, s[nn][e], dp[nn][e]);
          }
        }
        const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        const uint32_t df[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                                pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
        mma_a_by_rows<DP>(dv_acc, pf, do_s + c * 16 * ST + part * DP, ST, lane);  // dV += P^T dO
        mma_a_by_rows<DP>(dk_acc, df, q_s + c * 16 * ST + part * DP, ST, lane);   // dK += dS^T Q
      }
    }
  }

  const size_t out_base = ((size_t)b * a.Hkv + kvh) * (size_t)Skv * D;
#pragma unroll
  for (int n = 0; n < NP; ++n) {
    const int c = part * DP + n * 8 + 2 * t;
    if (ja < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out_base + (size_t)ja * D + c) =
          __floats2bfloat162_rn(dk_acc[n][0] * o.sm_scale, dk_acc[n][1] * o.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out_base + (size_t)ja * D + c) =
          __floats2bfloat162_rn(dv_acc[n][0], dv_acc[n][1]);
    }
    if (jb < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out_base + (size_t)jb * D + c) =
          __floats2bfloat162_rn(dk_acc[n][2] * o.sm_scale, dk_acc[n][3] * o.sm_scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out_base + (size_t)jb * D + c) =
          __floats2bfloat162_rn(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

struct DqLaunch {
  void* dq;
  cudaStream_t stream;
  template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
  cudaError_t run(const Args& a) const {
    const int G = a.Hq / a.Hkv;
    const int bq = G >= 8 ? 16 : 16 * (8 / G);  // K5's tiling: about 8 warps a block
    const int threads = 32 * G * (bq / 16);
    if (threads > DQ_MAX_THREADS) return cudaErrorInvalidConfiguration;
    auto kernel = flash_bwd_dq_kernel<D, CAUSAL, SOFTCAP, BAND>;
    const size_t smem = dq_smem_bytes<D>(threads);
    if (smem > 48 * 1024) {
      cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
      if (e != cudaSuccess) return e;
    }
    dim3 grid(a.Hkv, (a.Sq + bq - 1) / bq, a.B);
    kernel<<<grid, threads, smem, stream>>>(a, static_cast<bf16*>(dq), bq);
    return cudaGetLastError();
  }
};

struct DkdvLaunch {
  void *dk, *dv;
  cudaStream_t stream;
  template <int D, bool CAUSAL, bool SOFTCAP, bool BAND>
  cudaError_t run(const Args& a) const {
    constexpr int smem = dkdv_smem_bytes<D>();
    auto kernel = flash_bwd_dkdv_kernel<D, CAUSAL, SOFTCAP, BAND>;
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    dim3 grid(a.Hkv, (a.Skv + BKV - 1) / BKV, a.B);
    kernel<<<grid, KvGeom<D>::THREADS, smem, stream>>>(a, static_cast<bf16*>(dk), static_cast<bf16*>(dv));
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

// The same inputs; dk, dv (B, Hkv, Skv, D) bf16, contiguous.
int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* lengths, const void* q_offsets, void* dk,
                   void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   float sm_scale, float scale_log2, int window, int sinks, float softcap,
                   void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, q_offsets, B, Hq, Hkv, Sq, Skv, causal,
                           sm_scale, scale_log2, window, sinks, softcap);
  return static_cast<int>(by_dim(D, a, DkdvLaunch{dk, dv, static_cast<cudaStream_t>(stream)}));
}

}  // extern "C"
