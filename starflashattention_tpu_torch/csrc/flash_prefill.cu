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
// head_dim 256: the output accumulators alone take 128 registers a thread,
// so the Q fragments (64 more) are not kept in registers: each warp stages
// its 16 query rows in its own slice of dynamic shared memory and reads one
// 16-deep fragment per k-step; the K/V tile is 32 rows (not 64), which
// halves the score registers. Shared memory is dynamic for every D (101 KB
// a block at D = 256 with 8 warps).
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
// Bound: at the model's prefill shapes (a few hundred rows per sequence,
// D = 128) the 4 * D operations per (query, key) pair under the causal mask
// bound it at the tensor-core rate; the bytes (q, the valid K/V prefix, the
// output) are small next to them. Design: one block per (q tile, KV head,
// b) holds all G query heads of the group, so each K/V tile staged in
// shared memory serves G heads. Each warp owns 16 query rows of one head
// and runs both products on the tensor cores with mma.sync.m16n8k16 (bf16
// in, fp32 accumulate): Q fragments stay in registers for the whole walk
// (D <= 128), K fragments load straight from shared memory, V fragments through
// ldmatrix.trans, and P goes from the score accumulators to the PV operand
// without touching memory. The online softmax runs in fp32 (quad shuffles
// for the row max; the row sum is reduced once at the end). The block walks
// KV tiles only up to lengths[b] (causal: and the last position of its
// rows); a warp whose rows all precede a tile skips its arithmetic. CAUSAL
// and LSE are template flags, so the serving prefill's instantiation
// carries neither the non-causal branch nor the LSE store. Not yet: copies
// overlapped with compute (cp.async / TMA), wgmma.
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

namespace {

constexpr int MAX_THREADS = 256;  // 8 warps: up to 255 registers a thread
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr float LSE_EMPTY = 3e38f;  // the LSE of a row with no valid position
constexpr float LOG2E = 1.4426950408889634f;
constexpr int NO_WINDOW = 1 << 30;  // the window argument without a window

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
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

// KV rows per shared-memory tile: 64, and 32 at D = 256 (fewer score
// registers beside the 128 of the output accumulators).
template <int D>
struct Geom {
  static constexpr int BK = D > 128 ? 32 : 64;
  static constexpr int ST = D + 8;  // padded smem row (elements): conflict-free fragment loads
  static constexpr bool QSMEM = D > 128;  // Q fragments read from shared memory, not registers
};

template <int D>
size_t smem_bytes(int threads) {
  using GM = Geom<D>;
  const size_t kv = 2 * (size_t)GM::BK * GM::ST;
  const size_t qs = GM::QSMEM ? (size_t)(threads / 32) * 16 * GM::ST : 0;
  return (kv + qs) * sizeof(__nv_bfloat16);
}

struct Options {
  int window;     // row at position p attends cols > p - window; 1 << 30 for none
  int sinks;      // cols < sinks stay attendable (with a window)
  float sm_scale;       // natural units (the softcap's input)
  float scale_log2;     // sm_scale * log2(e)
  float softcap;        // > 0 with SOFTCAP
};

// One tile's scores of a lane's two rows: scale (SOFTCAP: cap * tanh(s *
// sm_scale / cap) in natural units, then base 2), mask (the length, the
// diagonal and, with BAND, the window and sinks) and fold into the row
// maxima. col0 is the lane's first column.
template <int ST_N, bool CAUSAL, bool SOFTCAP, bool BAND>
__device__ __forceinline__ void scale_mask(float (&s)[ST_N][4], int col0, int pa, int pb, int len,
                                           const Options& opt, float& mx_a, float& mx_b) {
#pragma unroll
  for (int n = 0; n < ST_N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = col0 + n * 8 + (e & 1);
      const int pos = e < 2 ? pa : pb;
      bool valid = col < len && (!CAUSAL || col <= pos);
      if constexpr (BAND) valid = valid && (col > pos - opt.window || col < opt.sinks);
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

template <int D, bool CAUSAL, bool LSE, bool SOFTCAP, bool BAND>
__global__ void __launch_bounds__(MAX_THREADS)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                         const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ lse, int Hq, int Hkv, int Sq, int Skv, int bq,
                         const Options opt) {
  using GM = Geom<D>;
  constexpr int BK = GM::BK;
  constexpr int ST = GM::ST;
  constexpr int KT = D / 16;  // k-steps of the QK product
  constexpr int NT = D / 8;   // n-tiles of the PV product
  constexpr int ST_N = BK / 8;  // n-tiles of the QK product
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BK][ST]
  __nv_bfloat16* v_s = k_s + BK * ST;                                 // [BK][ST]

  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warps_per_head = bq / 16;
  const int head = kvh * G + warp / warps_per_head;
  const int r0 = qt * bq + (warp % warps_per_head) * 16;  // this warp's first q row
  const int ra = r0 + g, rb = r0 + g + 8;                  // this lane's two rows
  const int len = min(lengths[b], Skv);
  const int qoff = q_offsets[b];
  const int pa = qoff + ra, pb = qoff + rb;                // their absolute positions
  const int warp_last = qoff + min(r0 + 15, Sq - 1);       // last position of the warp
  const int W = opt.window, SK = opt.sinks;  // read only with BAND

  // The Q fragments of this warp's 16 rows, for the whole walk: in
  // registers, or (D = 256) in this warp's slice of shared memory.
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + head) * (size_t)Sq * D;
  uint32_t qa[GM::QSMEM ? 1 : KT][4];
  __nv_bfloat16* q_s = v_s + BK * ST + (size_t)warp * 16 * ST;  // [16][ST], QSMEM only
  if constexpr (GM::QSMEM) {
    for (int i = lane; i < 16 * D / 8; i += 32) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 x = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + row < Sq) x = *reinterpret_cast<const uint4*>(qh + (size_t)(r0 + row) * D + col);
      *reinterpret_cast<uint4*>(q_s + row * ST + col) = x;
    }
    __syncwarp();
  } else {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      const int c = kk * 16 + 2 * t;
      qa[kk][0] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * D + c) : 0u;
      qa[kk][1] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * D + c) : 0u;
      qa[kk][2] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * D + c + 8) : 0u;
      qa[kk][3] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * D + c + 8) : 0u;
    }
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D;
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
    // Rows below the block's band that are not sinks, and rows past the
    // length, are zero-filled and never read.
    for (int i = threadIdx.x; i < BK * D / 8; i += blockDim.x) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      const int j = j0 + row;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j < len && (!BAND || j >= lo || j < SK)) {
        kv = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)j * D + col);
        vv = *reinterpret_cast<const uint4*>(v + kv_base + (size_t)j * D + col);
      }
      *reinterpret_cast<uint4*>(k_s + row * ST + col) = kv;
      *reinterpret_cast<uint4*>(v_s + row * ST + col) = vv;
    }
    __syncthreads();

    // warp-uniform: the warp has rows, the tile is not wholly above its
    // diagonal, and not wholly below its band unless it holds sinks
    if (r0 < Sq && (!CAUSAL || j0 <= warp_last) && (!BAND || j0 + BK - 1 >= warp_lo || j0 < SK)) {
      float s[ST_N][4];
#pragma unroll
      for (int n = 0; n < ST_N; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if constexpr (GM::QSMEM) {  // one Q fragment from shared memory a k-step
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const __nv_bfloat16* qr = q_s + g * ST + kk * 16 + 2 * t;
          uint32_t af[4];
          af[0] = *reinterpret_cast<const uint32_t*>(qr);
          af[1] = *reinterpret_cast<const uint32_t*>(qr + 8 * ST);
          af[2] = *reinterpret_cast<const uint32_t*>(qr + 8);
          af[3] = *reinterpret_cast<const uint32_t*>(qr + 8 * ST + 8);
#pragma unroll
          for (int n = 0; n < ST_N; ++n) {
            const __nv_bfloat16* krow = k_s + (n * 8 + g) * ST + 2 * t + kk * 16;
            mma_bf16(s[n], af, *reinterpret_cast<const uint32_t*>(krow),
                     *reinterpret_cast<const uint32_t*>(krow + 8));
          }
        }
      } else {
#pragma unroll
        for (int n = 0; n < ST_N; ++n) {
          const __nv_bfloat16* krow = k_s + (n * 8 + g) * ST + 2 * t;
#pragma unroll
          for (int kk = 0; kk < KT; ++kk) {
            const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
            const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
            mma_bf16(s[n], qa[kk], b0, b1);
          }
        }
      }
      // Scale and mask; row maxima over the quad of lanes sharing a row.
      float mx_a = NEG_INF, mx_b = NEG_INF;
      scale_mask<ST_N, CAUSAL, SOFTCAP, BAND>(s, j0 + 2 * t, pa, pb, len, opt, mx_a, mx_b);
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
      l_a = l_a * alpha_a + sum_a;  // this lane's share; reduced over the quad at the end
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha_a;
        o[n][1] *= alpha_a;
        o[n][2] *= alpha_b;
        o[n][3] *= alpha_b;
      }
      // O += P @ V: the score accumulators of two adjacent n-tiles are the
      // A fragment of one 16-deep k-step.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pf[4];
        pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int mi = lane >> 3, rr = lane & 7;
        const __nv_bfloat16* vrow = v_s + (kk * 16 + rr + (mi & 1) * 8) * ST + (mi >> 1) * 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + np * 16);
          mma_bf16(o[2 * np], pf, vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pf, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

  if (r0 >= Sq) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  if (LSE && t == 0) {  // one lane of the quad writes its two rows
    float* lh = lse + ((size_t)b * Hq + head) * (size_t)Sq;
    if (ra < Sq) lh[ra] = l_a > 0.f ? m_a + log2f(l_a) : LSE_EMPTY;
    if (rb < Sq) lh[rb] = l_b > 0.f ? m_b + log2f(l_b) : LSE_EMPTY;
  }
  __nv_bfloat16* oh = out + ((size_t)b * Hq + head) * (size_t)Sq * D;
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
  const int G = Hq / Hkv;
  // 16 rows per warp; about 8 warps per block share each K/V tile.
  const int bq = G >= 8 ? 16 : 16 * (8 / G);
  const int threads = 32 * G * (bq / 16);
  if (threads > MAX_THREADS) return cudaErrorInvalidConfiguration;
  auto kernel = flash_prefill_kernel<D, CAUSAL, LSE, SOFTCAP, BAND>;
  const size_t smem = smem_bytes<D>(threads);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  kernel<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(q_offsets), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), Hq, Hkv, Sq, Skv, bq, opt);
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
