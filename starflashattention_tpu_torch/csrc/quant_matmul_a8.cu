// Int8-activation quantized matmuls for Hopper (sm_90a): W8A8 and W4A8.
//
// Replaces: starflashattention_tpu/ops/quant_matmul.py::_qmm_w8a8_kernel
// (entry quant_matmul_w8a8) and ::_qmm_w4a8_kernel (entry
// quant_matmul_w4a8).
//
// x8: (M, K) int8 activations quantized per row, rs: (M,) fp32 row scales
// (the wrapper computes both); out: (M, N) fp32 or bf16. The weights are
// those of ONE layer (the wrapper offsets the pointers into the stacks):
//  * W8A8 (half == 0): w (K, N) int8, scale (N,) fp32. int32 sums over all
//    of K, then out = f32(acc) * rs[row] * s[col], in that order.
//  * W4A8 (half > 0): w (K/2, N) packed int4 bytes as in quant_matmul.cu
//    (byte r of group g: row g*group + r in the low nibble, biased +8; row
//    g*group + half + r in the high nibble, signed), scale (G, N) fp32,
//    half = group / 2. Each group's exact int32 sum is converted to fp32
//    and multiplied by the group's scale, the groups are summed in fp32,
//    and rs[row] is applied at the store.
// int32 cannot overflow: |acc| <= K * 127 * 128 < 2^31 for K < 132,000.
//
// Bound: at prefill rows (M = 2048) the 2*M*K*N operations at the int8
// tensor-core rate (1,979 TOPS dense), against M*K + K*N bytes. Both run
// the int8 x int8 -> int32 product on mma.sync.m16n8k32.s8 (twice the bf16
// rate per instruction), on one pipeline: 256 threads, a ring of A8_STAGES
// stages in dynamic shared memory filled by 16-byte cp.async (rows past M,
// columns past N and rows past K zero-filled) with one barrier a stage,
// mid-stage (ring_start, ring_refill), A (x8) read by ldmatrix.x4 from
// 128-byte rows XOR-swizzled by the row (a_piece), and the weight rows read
// as 32-bit words a k32 step ahead and transposed 4 x 4 in registers into
// the .col B fragment (b_piece, load_words, transpose4).
//  * W8A8 (qmm_w8a8_tiled): 128 x 256 output tiles, 8 warps of 64 x 64 (2
//    along M, 4 along N): one int32 accumulator, 128 registers a thread, as
//    K4 tiled's fp32 one; a stage is 128 K columns (4 k32 steps: an A row
//    is K11's 128 bytes), so with K % 128 == 64 the last stage runs half.
//  * W4A8 (qmm_w4a8_tiled): 64 x 256 tiles; see its comment.
//
// Requirements checked by the wrapper: K % 64 == 0 (W4A8: half % 32 == 0),
// N % 32 == 0, every pointer 16-byte aligned and contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_tiles.cuh"

namespace {

using namespace qmm;

// D = A(16x32, row) * B(32x8, col) + D: int8 inputs, int32 accumulators.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// mma_s8 with C = 0: a group's first product.
__device__ __forceinline__ void mma_s8_first(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "r"(0));
}

// ---------------------------------------------------------------- shared by W8A8 and W4A8
constexpr int A8_THREADS = 256;
constexpr int A8_STAGES = 4;           // the barrier sits mid-stage, so the ring needs a fourth buffer
constexpr int A8_BN = 256;             // output columns a tile
constexpr int A8_A_ROW = 128;          // bytes: 128 int8 activations a row, 8 swizzled pieces
constexpr int A8_B_ROW = A8_BN;        // bytes: a weight row of the tile (swizzled, no padding)
constexpr int A8_B_PIECES = A8_B_ROW / 16;

// The byte offset of 16-byte piece `piece` of row `row` in an A stage: the
// pieces XOR-swizzled by the row, so that ldmatrix.x4 (8 rows of one piece a
// matrix) reads eight different bank octets. Its b16 layout is the
// m16n8k32 .s8 A fragment (bytes 4t .. 4t + 3 of rows g and g + 8).
__device__ __forceinline__ uint32_t a_piece(int row, int piece) {
  return row * A8_A_ROW + ((piece ^ (row & 7)) << 4);
}

// The same in a B stage: the pieces XOR-swizzled by 2 ((row / 4) % 4), so
// that the four lanes t, which read rows 4t .. 4t + 3, hit four different
// bank octets.
__device__ __forceinline__ uint32_t b_piece(int row, int piece) {
  return row * A8_B_ROW + ((piece ^ (2 * ((row >> 2) & 3))) << 4);
}

// ROWS weight rows from row krow0 of w (N bytes a row) at columns n0 ..
// n0 + 255 into the B stage at b_s (a shared-memory address); rows at or
// past `rows` and columns past N zero-filled.
template <int ROWS>
__device__ __forceinline__ void load_b(uint32_t b_s, const uint8_t* __restrict__ w, int krow0, int rows,
                                       int n0, int N, int tid) {
  const int piece = tid % A8_B_PIECES, row0 = tid / A8_B_PIECES;
#pragma unroll
  for (int i = 0; i < ROWS * A8_B_PIECES / A8_THREADS; ++i) {
    const int row = row0 + A8_THREADS / A8_B_PIECES * i, krow = krow0 + row;
    const int col = n0 + 16 * piece;
    const bool ok = krow < rows && col < N;
    cp_async16(b_s + b_piece(row, piece), ok ? w + (size_t)krow * N + col : w, ok ? 16 : 0);
  }
}

// One k32 step's weight words of 32-column band `band` of the tile: rows
// row0 + 4t + q (r[0]) and row0 + 16 + 4t + q (r[1]), q = 0..3, columns 4g ..
// 4g + 3 of the band (one piece: (row / 4) % 4 is t for all of them).
__device__ __forceinline__ void load_words(uint32_t (&r)[2][4], const unsigned char* b_s, int row0, int band,
                                           int g, int t) {
  const unsigned char* bp =
      b_s + (row0 + 4 * t) * A8_B_ROW + (((2 * band + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    r[0][q] = *reinterpret_cast<const uint32_t*>(bp + q * A8_B_ROW);
    r[1][q] = *reinterpret_cast<const uint32_t*>(bp + (16 + q) * A8_B_ROW);
  }
}

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The 4 x 4 byte block of words r[0..3] (4 rows, 4 columns each)
// transposed: o[i] holds column i of the 4 rows, row q in byte q. From
// load_words' r[0] and r[1], o[i] are the .col B fragment's b0 and b1 of
// n8 tile i at column g (k 4t .. 4t + 3 and 16 + 4t ..): byte i of the
// words at columns 4g feeds tile i, column g, so thread (g, t) holds the 8
// consecutive columns 8t .. 8t + 7 of the band at the store (K4's
// permutation; `k10_b_fragment` in ops/quant_matmul.py spells it out).
__device__ __forceinline__ void transpose4(uint32_t (&o)[4], const uint32_t (&r)[4]) {
  const uint32_t t0 = prmt(r[0], r[1], 0x5140), t1 = prmt(r[2], r[3], 0x5140);
  const uint32_t t2 = prmt(r[0], r[1], 0x7362), t3 = prmt(r[2], r[3], 0x7362);
  o[0] = prmt(t0, t1, 0x5410);
  o[1] = prmt(t0, t1, 0x7632);
  o[2] = prmt(t2, t3, 0x5410);
  o[3] = prmt(t2, t3, 0x7632);
}

// The ring's start: stages 0 .. A8_STAGES - 2 in flight (load_stage(stage,
// buffer)), one commit group each, and stage 0 landed for every thread.
template <class Load>
__device__ __forceinline__ void ring_start(int nstages, const Load& load_stage) {
#pragma unroll
  for (int s = 0; s < A8_STAGES - 1; ++s) {
    if (s < nstages) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<A8_STAGES - 2>();
  __syncthreads();
}

// The ring's one barrier a stage, mid-stage s: stage s + 1 has landed, and
// every warp is past stage s - 1, whose buffer takes stage s + A8_STAGES - 1.
template <class Load>
__device__ __forceinline__ void ring_refill(int s, int nstages, const Load& load_stage) {
  cp_async_wait<A8_STAGES - 3>();
  __syncthreads();
  if (s + A8_STAGES - 1 < nstages) load_stage(s + A8_STAGES - 1, (s + A8_STAGES - 1) % A8_STAGES);
  cp_async_commit();
}

// ---------------------------------------------------------------- W8A8
// 128 x 256 output tiles, 8 warps of 64 x 64 (2 along M, 4 along N), a warp
// two 32-column halves (K4 tiled's tile). K runs in stages of 128 columns:
// A 128 rows x 128 bytes, B 128 weight rows x 256 bytes. Each k32 step:
// the weight words of both halves (read the step before) transposed into
// 8 B fragments, the next step's words read, then per m16 tile one
// ldmatrix.x4 for A and 8 products. The int8 weights need no widening.
// What bounds it on the H100: the operations (0.73 TOP through the four 7B
// layer shapes at 2048 rows: 0.367 ms at 1,979 TOPS); a tile moves 384
// bytes from L2 into shared memory a k32 step for 32,768 products (PERF.md).
constexpr int W8_WARPS_M = 2, W8_WARPS_N = 4;
constexpr int W8_MT = 4;                        // m16 tiles a warp: warp tiles of 64 x 64
constexpr int W8_BM = W8_WARPS_M * W8_MT * 16;  // 128
constexpr int W8_SK = 128;                      // K columns a stage
constexpr int W8_STEPS = W8_SK / 32;            // k32 steps a stage
constexpr int W8_BAND_M = 16;                   // row tiles a raster band: 2048 rows
constexpr int W8_A_BYTES = W8_BM * A8_A_ROW;
constexpr int W8_B_BYTES = W8_SK * A8_B_ROW;
constexpr int W8_STAGE_BYTES = W8_A_BYTES + W8_B_BYTES;
constexpr int W8_SMEM = A8_STAGES * W8_STAGE_BYTES;  // 196,608 bytes
static_assert(W8_WARPS_M * W8_WARPS_N * 32 == A8_THREADS && W8_WARPS_N * 64 == A8_BN, "8 warps of 64 x 64");

template <typename OutT>
__global__ void __launch_bounds__(A8_THREADS, 1)
    qmm_w8a8_tiled(const int8_t* __restrict__ x8, const float* __restrict__ rs,
                   const uint8_t* __restrict__ w, const float* __restrict__ scale,
                   OutT* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / W8_WARPS_N, wn = warp % W8_WARPS_N;  // rows wm * 64 .., columns wn * 64 ..
  const int2 origin = raster<W8_BM, A8_BN, W8_BAND_M>(M, N);
  const int m0 = origin.x, n0 = origin.y;
  const int nk32 = K / 32, nstages = (K + W8_SK - 1) / W8_SK;
  const uint32_t smem0 = smem_addr(smem);

  // This thread's copies. A: piece tid % 8 (columns 16 piece ..) of rows
  // tid / 8 + (threads / 8) i; B: load_b.
  auto load_stage = [&](int s, int buf) {
    const uint32_t a_s = smem0 + buf * W8_STAGE_BYTES;
    const int piece = tid & 7, k = s * W8_SK + 16 * piece;
#pragma unroll
    for (int i = 0; i < W8_BM * 8 / A8_THREADS; ++i) {
      const int row = (tid >> 3) + A8_THREADS / 8 * i;
      const bool ok = k < K && m0 + row < M;
      cp_async16(a_s + a_piece(row, piece), ok ? x8 + (size_t)(m0 + row) * K + k : x8, ok ? 16 : 0);
    }
    load_b<W8_SK>(a_s + W8_A_BYTES, w, s * W8_SK, K, n0, N, tid);
  };
  // k32 step j's words of the warp's two 32-column halves
  auto step_words = [&](uint32_t (&wd)[2][2][4], int buf, int j) {
    const unsigned char* b_s = smem + buf * W8_STAGE_BYTES + W8_A_BYTES;
    load_words(wd[0], b_s, 32 * j, 2 * wn, g, t);
    load_words(wd[1], b_s, 32 * j, 2 * wn + 1, g, t);
  };

  int acc[W8_MT][8][4];  // int32 sums over all of K
#pragma unroll
  for (int mt = 0; mt < W8_MT; ++mt)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][i][e] = 0;

  ring_start(nstages, load_stage);
  uint32_t wd[2][2][4];
  step_words(wd, 0, 0);
  for (int s = 0; s < nstages; ++s) {
    const int buf = s % A8_STAGES;
    const uint32_t a_s = smem0 + buf * W8_STAGE_BYTES;
#pragma unroll
    for (int j = 0; j < W8_STEPS; ++j) {
      if (j == W8_STEPS / 2) ring_refill(s, nstages, load_stage);
      if (s * W8_STEPS + j >= nk32) break;  // uniform across the block: K % 128 == 64
      uint32_t bf[2][4][2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t o0[4], o1[4];
        transpose4(o0, wd[h][0]);  // k 4t .. 4t + 3 of the step: the b0 registers
        transpose4(o1, wd[h][1]);  // k 16 + 4t ..: the b1 registers
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          bf[h][i][0] = o0[i];
          bf[h][i][1] = o1[i];
        }
      }
      // the next step's words, a step ahead of the products: step j + 1 of
      // this stage, or step 0 of the next (it landed before this stage's
      // mid-stage barrier; past the last step they go unused)
      if (j + 1 < W8_STEPS) {
        step_words(wd, buf, j + 1);
      } else {
        step_words(wd, (s + 1) % A8_STAGES, 0);
      }
#pragma unroll
      for (int mt = 0; mt < W8_MT; ++mt) {
        uint32_t af[4];
        ldmatrix_x4(af, a_s + a_piece(wm * 64 + mt * 16 + (lane & 15), 2 * j + (lane >> 4)));
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_s8(acc[mt][4 * h + i], af, bf[h][i]);
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, t) holds columns c = n0 + wn * 64 + 32h + 8t .. + 8 of each
  // half h: acc[..][4h + i][0 / 2] at c + i, acc[..][4h + i][1 / 3] at c + 4
  // + i, rows g and g + 8 of each m16 tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = n0 + wn * 64 + 32 * h + 8 * t;
    if (c >= N) continue;
    float sc[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) sc[i] = __ldg(scale + c + i);
#pragma unroll
    for (int mt = 0; mt < W8_MT; ++mt)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int r = m0 + wm * 64 + mt * 16 + g + 8 * rr;
        if (r < M) {
          const float rsr = rs[r];
          float v[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = static_cast<float>(acc[mt][4 * h + i][2 * rr]) * rsr * sc[i];
            v[4 + i] = static_cast<float>(acc[mt][4 * h + i][2 * rr + 1]) * rsr * sc[4 + i];
          }
          store8(out + (size_t)r * N + c, v);
        }
      }
  }
}

// ---------------------------------------------------------------- W4A8
// 64 x 256 output tiles, 8 warps of 64 x 32 side by side along N: the int32
// group sum and the fp32 total are 128 registers a thread, as K6's two fp32
// accumulators are, so the tile is K6's. K runs in stages of 64 packed rows,
// each 2 chunks of 32 packed rows; a chunk is two k32 mma steps, its low
// nibbles against 32 activation columns and its high nibbles against the
// 32 half a group on. A chunk never straddles a group (half % 32 == 0); at
// g128 a stage is one group (the G128 form: the group starts with a zero-C
// mma and is flushed at the stage's end, with no branch). The ring and the
// layouts are W8A8's (see the top of the file):
//  * A (x8): piece j * 4 + h * 2 + q of a row holds chunk j's 16 columns q
//    of its low (h = 0) or high (h = 1) half.
//  * B (packed bytes): each thread reads the words of packed rows 4t .. 4t
//    + 3 (and 16 + 4t ..) of its warp's band (load_words) a chunk ahead of
//    their products and transposes them (transpose4); `k11_b_fragment` in
//    ops/quant_matmul.py spells out the map. The nibbles widen to int8 in
//    registers, 4 at a time: nib_lo16 gives 16 (n_lo - 8) and nib_hi16 16
//    n_hi, both exact in int8, so each group's int32 sum is 16 times the
//    true one, exactly; the fp32 sums over groups are then exactly 16 times
//    the unscaled ones (a power of two commutes with rounding), and rs[row]
//    / 16 at the store gives the same bits.
//  * S (scales) holds each chunk's group row for the tile's columns (at
//    g128 only chunk 0's: the stage is one group).
// What bounds it on the H100: the operations (0.73 TOP through the four 7B
// layer shapes at 2048 rows: 0.367 ms at 1,979 TOPS). It moves about 2.4
// TB/s from L2 into shared memory at those shapes, and at the int8 rate
// that traffic, not the mma, sets its time (PERF.md): a larger tile needs
// registers the two accumulators hold, so wgmma is the next step (ROADMAP).
constexpr int A4_MT = 4;                  // m16 tiles a warp: warp tiles of 64 x 32
constexpr int A4_WARPS_M = 1, A4_WARPS_N = 8;
constexpr int A4_BM = A4_WARPS_M * A4_MT * 16;
constexpr int A4_SP = 64;                 // packed rows a stage
constexpr int A4_CHUNKS = A4_SP / 32;     // chunks a stage
constexpr int A4_BAND_M = 32;             // row tiles a raster band: 2048 rows
constexpr int A4_A_BYTES = A4_BM * A8_A_ROW;
constexpr int A4_B_BYTES = A4_SP * A8_B_ROW;
constexpr int A4_S_BYTES = A4_CHUNKS * A8_BN * 4;
constexpr int A4_STAGE_BYTES = A4_A_BYTES + A4_B_BYTES + A4_S_BYTES;
constexpr int A4_SMEM = A8_STAGES * A4_STAGE_BYTES;  // 106,496 bytes
static_assert(A4_WARPS_M * A4_WARPS_N * 32 == A8_THREADS && A4_WARPS_N * 32 == A8_BN, "8 warps of 64 x 32");

// 4 packed bytes -> 4 int8: 16 (low nibble - 8) (the low nibble is stored
// biased +8: (n << 4) ^ 0x80 is 16 n - 128 mod 256) and 16 (high nibble)
// (signed already: the byte's high four bits with the low four cleared).
__device__ __forceinline__ uint32_t nib_lo16(uint32_t w) { return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u; }
__device__ __forceinline__ uint32_t nib_hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

template <typename OutT, bool G128>
__global__ void __launch_bounds__(A8_THREADS, 1)
    qmm_w4a8_tiled(const int8_t* __restrict__ x8, const float* __restrict__ rs,
                   const uint8_t* __restrict__ w, const float* __restrict__ scale,
                   OutT* __restrict__ out, int M, int K, int N, int half) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / A4_WARPS_N, wn = warp % A4_WARPS_N;  // rows wm * 64 .., columns wn * 32 ..
  const int2 origin = raster<A4_BM, A8_BN, A4_BAND_M>(M, N);
  const int m0 = origin.x, n0 = origin.y;
  const int kp = K / 2, nchunks = kp / 32;
  const int nstages = (nchunks + A4_CHUNKS - 1) / A4_CHUNKS;

  // This thread's copies. A: piece tid % 8 of rows tid / 8 + (threads / 8)
  // i; B: load_b; S: 4 columns (tid % (A8_BN / 4)) of chunk tid / (A8_BN /
  // 4).
  const int a_pc = tid & 7, a_row0 = tid >> 3;
  const int a_chunk = a_pc >> 2, a_high = (a_pc >> 1) & 1, a_q = a_pc & 1;
  const uint32_t smem0 = smem_addr(smem);

  auto load_stage = [&](int s, int buf) {
    const uint32_t a_s = smem0 + buf * A4_STAGE_BYTES;
    const uint32_t b_s = a_s + A4_A_BYTES, s_s = b_s + A4_B_BYTES;
    {
      const int c = s * A4_CHUNKS + a_chunk;
      int col = 0;
      if (c < nchunks) {
        const int grp = 32 * c / half;
        col = grp * 2 * half + a_high * half + (32 * c - grp * half) + 16 * a_q;
      }
#pragma unroll
      for (int i = 0; i < A4_BM * 8 / A8_THREADS; ++i) {
        const int row = a_row0 + A8_THREADS / 8 * i;
        const bool ok = c < nchunks && m0 + row < M;
        cp_async16(a_s + a_piece(row, a_pc), ok ? x8 + (size_t)(m0 + row) * K + col : x8, ok ? 16 : 0);
      }
    }
    load_b<A4_SP>(b_s, w, s * A4_SP, kp, n0, N, tid);
    for (int i = tid; i < (G128 ? 1 : A4_CHUNKS) * A8_BN / 4; i += A8_THREADS) {  // G128: one group a stage
      const int j = i / (A8_BN / 4), col = i % (A8_BN / 4) * 4;
      const int c = s * A4_CHUNKS + j;
      const bool ok = c < nchunks && n0 + col < N;
      cp_async16(s_s + (j * A8_BN + col) * 4,
                 ok ? scale + (size_t)(32 * c / half) * N + n0 + col : scale, ok ? 16 : 0);
    }
  };

  int gacc[A4_MT][4][4];
  float acc[A4_MT][4][4];
#pragma unroll
  for (int mt = 0; mt < A4_MT; ++mt)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        gacc[mt][i][e] = 0;
        acc[mt][i][e] = 0.f;
      }

  ring_start(nstages, load_stage);
  // a chunk's packed words: rows 4t + q (r[0]) and 16 + 4t + q (r[1]) of the warp's band
  auto chunk_words = [&](uint32_t (&r)[2][4], int buf, int j) {
    load_words(r, smem + buf * A4_STAGE_BYTES + A4_A_BYTES, 32 * j, wn, g, t);
  };
  uint32_t words[2][4];
  chunk_words(words, 0, 0);
  for (int s = 0; s < nstages; ++s) {
    const int buf = s % A8_STAGES;
    const uint32_t a_s = smem0 + buf * A4_STAGE_BYTES;
    const float* s_s = reinterpret_cast<const float*>(smem + buf * A4_STAGE_BYTES + A4_A_BYTES + A4_B_BYTES);
    float sc[8];  // the scales of the thread's 8 columns for the group that ends next
    auto load_scales = [&](int j) {
      const float* sp = s_s + j * A8_BN + wn * 32 + 8 * t;
      const float4 s_lo = *reinterpret_cast<const float4*>(sp);
      const float4 s_hi = *reinterpret_cast<const float4*>(sp + 4);
      sc[0] = s_lo.x, sc[1] = s_lo.y, sc[2] = s_lo.z, sc[3] = s_lo.w;
      sc[4] = s_hi.x, sc[5] = s_hi.y, sc[6] = s_hi.z, sc[7] = s_hi.w;
    };
    if (G128) load_scales(0);  // early, off the flush's path
#pragma unroll
    for (int j = 0; j < A4_CHUNKS; ++j) {
      // mid-stage, away from the group flush at the stage's end
      if (j == A4_CHUNKS / 2) ring_refill(s, nstages, load_stage);
      const int c = s * A4_CHUNKS + j;
      if (!G128 && c >= nchunks) break;  // uniform across the block
      uint32_t o0[4], o1[4];
      transpose4(o0, words[0]);  // k 4t .. 4t + 3 of the chunk: the b0 registers
      transpose4(o1, words[1]);  // k 16 + 4t ..: the b1 registers
      // the next chunk's words, a chunk ahead of the products: chunk j + 1 of
      // this stage, or chunk 0 of the next (it landed before this stage's
      // mid-stage barrier; past the last chunk they go unused)
      if (j + 1 < A4_CHUNKS) {
        chunk_words(words, buf, j + 1);
      } else {
        chunk_words(words, (s + 1) % A8_STAGES, 0);
      }
      uint32_t blo[4][2], bhi[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        blo[i][0] = nib_lo16(o0[i]);
        blo[i][1] = nib_lo16(o1[i]);
        bhi[i][0] = nib_hi16(o0[i]);
        bhi[i][1] = nib_hi16(o1[i]);
      }
#pragma unroll
      for (int mt = 0; mt < A4_MT; ++mt) {
        const int row = wm * 64 + mt * 16 + (lane & 15);
        uint32_t alo[4], ahi[4];
        ldmatrix_x4(alo, a_s + a_piece(row, j * 4 + (lane >> 4)));
        ldmatrix_x4(ahi, a_s + a_piece(row, j * 4 + 2 + (lane >> 4)));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (G128 && j == 0) {  // the group's first products: gacc starts from 0
            mma_s8_first(gacc[mt][i], alo, blo[i]);
          } else {
            mma_s8(gacc[mt][i], alo, blo[i]);
          }
          mma_s8(gacc[mt][i], ahi, bhi[i]);
        }
      }
      if (G128 ? j == A4_CHUNKS - 1 : 32 * (c + 1) % half == 0) {  // the chunk ends its group
        if (!G128) load_scales(j);
#pragma unroll
        for (int mt = 0; mt < A4_MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][i][0] += static_cast<float>(gacc[mt][i][0]) * sc[i];
            acc[mt][i][1] += static_cast<float>(gacc[mt][i][1]) * sc[4 + i];
            acc[mt][i][2] += static_cast<float>(gacc[mt][i][2]) * sc[i];
            acc[mt][i][3] += static_cast<float>(gacc[mt][i][3]) * sc[4 + i];
            if (!G128) {
#pragma unroll
              for (int e = 0; e < 4; ++e) gacc[mt][i][e] = 0;
            }
          }
      }
    }
  }
  cp_async_wait<0>();

  // thread (g, t) holds columns n0 + wn * 32 + 8t .. + 8: acc[..][i][0 / 2] at
  // + i, acc[..][i][1 / 3] at + 4 + i, rows g and g + 8 of each m16 tile
  const int c = n0 + wn * 32 + 8 * t;
  if (c >= N) return;
#pragma unroll
  for (int mt = 0; mt < A4_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 64 + mt * 16 + g + 8 * h;
      if (r < M) {
        const float rsr = rs[r] * 0.0625f;  // the nibbles entered the products times 16
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = acc[mt][i][2 * h] * rsr;
          v[4 + i] = acc[mt][i][2 * h + 1] * rsr;
        }
        store8(out + (size_t)r * N + c, v);
      }
    }
}

template <typename OutT>
cudaError_t launch_w8a8(const void* x8, const void* rs, const void* w, const void* scale, void* out,
                        int M, int K, int N, cudaStream_t stream) {
  auto kernel = qmm_w8a8_tiled<OutT>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W8_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + W8_BM - 1) / W8_BM) * ((N + A8_BN - 1) / A8_BN);
  kernel<<<tiles, A8_THREADS, W8_SMEM, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(rs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale), static_cast<OutT*>(out),
      M, K, N);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_w4a8(const void* x8, const void* rs, const void* w, const void* scale, void* out,
                        int M, int K, int N, int half, cudaStream_t stream) {
  auto kernel = half == A4_SP ? qmm_w4a8_tiled<OutT, true> : qmm_w4a8_tiled<OutT, false>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, A4_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + A4_BM - 1) / A4_BM) * ((N + A8_BN - 1) / A8_BN);
  kernel<<<tiles, A8_THREADS, A4_SMEM, stream>>>(
      static_cast<const int8_t*>(x8), static_cast<const float*>(rs),
      static_cast<const uint8_t*>(w), static_cast<const float*>(scale), static_cast<OutT*>(out),
      M, K, N, half);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// x8 (M, K) int8; rs (M,) fp32; w and scale of one layer: half == 0 for
// W8A8 (w (K, N) int8, scale (N,)), else W4A8 with half = group / 2 (w
// (K/2, N) packed int4, scale (K / group, N)); out (M, N) fp32, or bf16
// when out_bf16.
int quant_matmul_a8(const void* x8, const void* rs, const void* w, const void* scale, void* out,
                    int M, int K, int N, int half, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (half > 0) {
    e = out_bf16 ? launch_w4a8<__nv_bfloat16>(x8, rs, w, scale, out, M, K, N, half, s)
                 : launch_w4a8<float>(x8, rs, w, scale, out, M, K, N, half, s);
  } else {
    e = out_bf16 ? launch_w8a8<__nv_bfloat16>(x8, rs, w, scale, out, M, K, N, s)
                 : launch_w8a8<float>(x8, rs, w, scale, out, M, K, N, s);
  }
  return static_cast<int>(e);
}

// The W8A8 kernel's tiles: {rows, columns, K columns a stage, dynamic
// shared memory bytes}.
int quant_matmul_w8a8_geometry(int* out) {
  out[0] = W8_BM;
  out[1] = A8_BN;
  out[2] = W8_SK;
  out[3] = W8_SMEM;
  return 0;
}

}  // extern "C"
