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
// rate per instruction).
//  * W8A8 (qmm_w8a8_tiled): 64 x 64 output tiles, K in steps of 64 through
//    shared memory, 4 warps of 32 x 32 each, B fragments gathered byte by
//    byte from the row-major weight tile. No software pipelining yet.
//  * W4A8 (qmm_w4a8_tiled): qmm_int4_tiled's pipeline (quant_matmul.cu) on
//    the int8 tensor cores; see its comment.
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

// ---------------------------------------------------------------- W8A8
constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;                 // int8 columns of A per stage
constexpr int A_STRIDE = BK + 16;      // bytes per A row in shared memory
constexpr int B_STRIDE = BN + 16;      // bytes per B row

__device__ __forceinline__ uint32_t byte_of(int v) { return static_cast<uint32_t>(v) & 0xffu; }

// Four int8 values (k0..k0+3 of column col) packed low byte first.
__device__ __forceinline__ uint32_t gather4(uint8_t (*Bs)[B_STRIDE], int k0, int col) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) r |= byte_of(static_cast<int8_t>(Bs[k0 + i][col])) << (8 * i);
  return r;
}

// One k32 step of the warp's 32 x 32 sub-tile: A columns and B rows kk..kk+31.
__device__ __forceinline__ void warp_k32(int (*acc)[4][4], uint8_t (*As)[A_STRIDE],
                                         uint8_t (*Bs)[B_STRIDE], int kk, int wm, int wn, int g,
                                         int t) {
  uint32_t af[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = wm * 32 + mt * 16 + g;
    af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 4 * t]);
    af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 4 * t]);
    af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 16 + 4 * t]);
    af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 16 + 4 * t]);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int col = wn * 32 + j * 8 + g;
    uint32_t bf[2];
    bf[0] = gather4(Bs, kk + 4 * t, col);
    bf[1] = gather4(Bs, kk + 16 + 4 * t, col);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][j], af[mt], bf);
  }
}

template <typename OutT>
__global__ void __launch_bounds__(128)
    qmm_w8a8_tiled(const int8_t* __restrict__ x8, const float* __restrict__ rs,
                   const uint8_t* __restrict__ w, const float* __restrict__ scale,
                   OutT* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) uint8_t As[BM][A_STRIDE];
  __shared__ __align__(16) uint8_t Bs[BK][B_STRIDE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int iacc[2][4][4];  // int32 sums over all of K
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) iacc[mt][j][e] = 0;

  for (int st = 0; st < K / BK; ++st) {
    for (int i = tid; i < BM * 4; i += 128) {  // A: 64 rows x 64 int8 columns
      const int r = i >> 2, part = i & 3;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x8 + (size_t)(m0 + r) * K + st * BK + part * 16);
      *reinterpret_cast<uint4*>(&As[r][part * 16]) = v;
    }
    for (int i = tid; i < BK * (BN / 16); i += 128) {
      const int r = i >> 2, cc = (i & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + cc < N) v = __ldg(reinterpret_cast<const uint4*>(w + ((size_t)st * BK + r) * N + n0 + cc));
      *reinterpret_cast<uint4*>(&Bs[r][cc]) = v;
    }
    __syncthreads();
    warp_k32(iacc, As, Bs, 0, wm, wn, g, t);
    warp_k32(iacc, As, Bs, 32, wm, wn, g, t);
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r0 = m0 + wm * 32 + mt * 16 + g;
      const int c = n0 + wn * 32 + j * 8 + 2 * t;
      if (c >= N) continue;
#pragma unroll
      for (int half_row = 0; half_row < 2; ++half_row) {
        const int r = r0 + 8 * half_row;
        if (r >= M) continue;
        const float rsr = rs[r];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = static_cast<float>(iacc[mt][j][2 * half_row + e]) * rsr * scale[c + e];
          store_out(out + (size_t)r * N + c + e, v);
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
// mma and is flushed at the stage's end, with no branch). A ring of
// A4_STAGES stages in dynamic shared memory, filled by 16-byte cp.async
// (rows past M, columns past N and chunks past K zero-filled), one barrier
// a stage, mid-stage, as in qmm_int4_tiled.
//  * A (x8) is stored 128 bytes a row, its 16-byte pieces XOR-swizzled by
//    the row and read with ldmatrix.x4: the b16 layout of ldmatrix is the
//    m16n8k32 .s8 A fragment (bytes 4t .. 4t + 3 of rows g and g + 8).
//    Piece j * 4 + h * 2 + q of a row holds chunk j's 16 columns q of its low
//    (h = 0) or high (h = 1) half.
//  * B (packed bytes) is stored 256 bytes a row with its 16-byte pieces
//    XOR-swizzled by 2 ((row / 4) % 4), so that the four lanes t, which
//    read rows 4t .. 4t + 3, hit four different bank octets. The .col B
//    fragment needs 4 consecutive k of one column in a register, and a
//    32-bit word holds 4 columns of one packed row: each thread reads the
//    words of packed rows 4t .. 4t + 3 (and 16 + 4t ..) at columns wn * 32
//    + 4g, transposes each 4 x 4 byte block with 8 prmt (transpose4), and
//    byte i of the words feeds n8 tile i, column g, so thread (g, t) holds
//    the 8 consecutive columns wn * 32 + 8t .. + 7 at the store (K6's
//    permutation; `k11_b_fragment` in ops/quant_matmul.py spells it out).
//    The words are read a chunk ahead of their products. The nibbles
//    widen to int8 in registers, 4 at a time: nib_lo16 gives 16
//    (n_lo - 8) and nib_hi16 16 n_hi, both exact in int8, so each group's
//    int32 sum is 16 times the true one, exactly; the fp32 sums over groups
//    are then exactly 16 times the unscaled ones (a power of two commutes
//    with rounding), and rs[row] / 16 at the store gives the same bits.
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
constexpr int A4_BN = A4_WARPS_N * 32;
constexpr int A4_SP = 64;                 // packed rows a stage
constexpr int A4_CHUNKS = A4_SP / 32;     // chunks a stage
constexpr int A4_STAGES = 4;              // the barrier sits mid-stage, so the ring needs a fourth buffer
constexpr int A4_THREADS = A4_WARPS_M * A4_WARPS_N * 32;
constexpr int A4_B_PIECES = A4_BN / 16;   // 16-byte pieces of a packed row
constexpr int A4_BAND_M = 32;             // row tiles a raster band: 2048 rows
constexpr int A4_A_ROW = 2 * A4_SP;       // bytes: 128 int8 activations a row
constexpr int A4_B_ROW = A4_BN;           // bytes: 256 packed bytes (swizzled, no padding)
constexpr int A4_A_BYTES = A4_BM * A4_A_ROW;
constexpr int A4_B_BYTES = A4_SP * A4_B_ROW;
constexpr int A4_S_BYTES = A4_CHUNKS * A4_BN * 4;
constexpr int A4_STAGE_BYTES = A4_A_BYTES + A4_B_BYTES + A4_S_BYTES;
constexpr int A4_SMEM = A4_STAGES * A4_STAGE_BYTES;  // 106,496 bytes

__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t sel) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "r"(sel));
  return r;
}

// The 4 x 4 byte block of words r[0..3] (4 packed rows, 4 columns each)
// transposed: o[i] holds column i of the 4 rows, row q in byte q.
__device__ __forceinline__ void transpose4(uint32_t (&o)[4], const uint32_t (&r)[4]) {
  const uint32_t t0 = prmt(r[0], r[1], 0x5140), t1 = prmt(r[2], r[3], 0x5140);
  const uint32_t t2 = prmt(r[0], r[1], 0x7362), t3 = prmt(r[2], r[3], 0x7362);
  o[0] = prmt(t0, t1, 0x5410);
  o[1] = prmt(t0, t1, 0x7632);
  o[2] = prmt(t2, t3, 0x5410);
  o[3] = prmt(t2, t3, 0x7632);
}

// 4 packed bytes -> 4 int8: 16 (low nibble - 8) (the low nibble is stored
// biased +8: (n << 4) ^ 0x80 is 16 n - 128 mod 256) and 16 (high nibble)
// (signed already: the byte's high four bits with the low four cleared).
__device__ __forceinline__ uint32_t nib_lo16(uint32_t w) { return ((w << 4) & 0xF0F0F0F0u) ^ 0x80808080u; }
__device__ __forceinline__ uint32_t nib_hi16(uint32_t w) { return w & 0xF0F0F0F0u; }

template <typename OutT, bool G128>
__global__ void __launch_bounds__(A4_THREADS, 1)
    qmm_w4a8_tiled(const int8_t* __restrict__ x8, const float* __restrict__ rs,
                   const uint8_t* __restrict__ w, const float* __restrict__ scale,
                   OutT* __restrict__ out, int M, int K, int N, int half) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / A4_WARPS_N, wn = warp % A4_WARPS_N;  // rows wm * 64 .., columns wn * 32 ..
  const int2 origin = raster<A4_BM, A4_BN, A4_BAND_M>(M, N);
  const int m0 = origin.x, n0 = origin.y;
  const int kp = K / 2, nchunks = kp / 32;
  const int nstages = (nchunks + A4_CHUNKS - 1) / A4_CHUNKS;

  // This thread's copies. A: piece tid % 8 of rows tid / 8 + (threads / 8)
  // i; B: piece tid % A4_B_PIECES of packed rows tid / A4_B_PIECES +
  // (threads / A4_B_PIECES) i; S: 4 columns (tid % (A4_BN / 4)) of chunk
  // tid / (A4_BN / 4).
  const int a_piece = tid & 7, a_row0 = tid >> 3;
  const int a_chunk = a_piece >> 2, a_high = (a_piece >> 1) & 1, a_q = a_piece & 1;
  const int b_piece = tid % A4_B_PIECES, b_row0 = tid / A4_B_PIECES;
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
      for (int i = 0; i < A4_BM * 8 / A4_THREADS; ++i) {
        const int row = a_row0 + A4_THREADS / 8 * i;
        const bool ok = c < nchunks && m0 + row < M;
        cp_async16(a_s + row * A4_A_ROW + ((a_piece ^ (row & 7)) << 4),
                   ok ? x8 + (size_t)(m0 + row) * K + col : x8, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < A4_SP * A4_B_PIECES / A4_THREADS; ++i) {
      const int row = b_row0 + A4_THREADS / A4_B_PIECES * i, prow = s * A4_SP + row;
      const int col = n0 + 16 * b_piece;
      const bool ok = prow < kp && col < N;
      cp_async16(b_s + row * A4_B_ROW + ((b_piece ^ (2 * ((row >> 2) & 3))) << 4),
                 ok ? w + (size_t)prow * N + col : w, ok ? 16 : 0);
    }
    for (int i = tid; i < (G128 ? 1 : A4_CHUNKS) * A4_BN / 4; i += A4_THREADS) {  // G128: one group a stage
      const int j = i / (A4_BN / 4), col = i % (A4_BN / 4) * 4;
      const int c = s * A4_CHUNKS + j;
      const bool ok = c < nchunks && n0 + col < N;
      cp_async16(s_s + (j * A4_BN + col) * 4,
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

#pragma unroll
  for (int s = 0; s < A4_STAGES - 1; ++s) {
    if (s < nstages) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<A4_STAGES - 2>();
  __syncthreads();  // stage 0 has landed
  // the piece of a B row that holds this thread's 4 columns (the same
  // swizzle for all its rows: (row / 4) % 4 is t for rows 4t .. and 16 + 4t ..)
  const int b_off = (((wn * 2 + (g >> 2)) ^ (2 * t)) << 4) + 4 * (g & 3);
  // a chunk's packed words: rows 4t + q (r[0]) and 16 + 4t + q (r[1])
  auto load_words = [&](uint32_t (&r)[2][4], int buf, int j) {
    const unsigned char* bp = smem + buf * A4_STAGE_BYTES + A4_A_BYTES + (32 * j + 4 * t) * A4_B_ROW + b_off;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      r[0][q] = *reinterpret_cast<const uint32_t*>(bp + q * A4_B_ROW);
      r[1][q] = *reinterpret_cast<const uint32_t*>(bp + (16 + q) * A4_B_ROW);
    }
  };
  uint32_t words[2][4];
  load_words(words, 0, 0);
  for (int s = 0; s < nstages; ++s) {
    const int buf = s % A4_STAGES;
    const uint32_t a_s = smem0 + buf * A4_STAGE_BYTES;
    const float* s_s = reinterpret_cast<const float*>(smem + buf * A4_STAGE_BYTES + A4_A_BYTES + A4_B_BYTES);
    float sc[8];  // the scales of the thread's 8 columns for the group that ends next
    auto load_scales = [&](int j) {
      const float* sp = s_s + j * A4_BN + wn * 32 + 8 * t;
      const float4 s_lo = *reinterpret_cast<const float4*>(sp);
      const float4 s_hi = *reinterpret_cast<const float4*>(sp + 4);
      sc[0] = s_lo.x, sc[1] = s_lo.y, sc[2] = s_lo.z, sc[3] = s_lo.w;
      sc[4] = s_hi.x, sc[5] = s_hi.y, sc[6] = s_hi.z, sc[7] = s_hi.w;
    };
    if (G128) load_scales(0);  // early, off the flush's path
#pragma unroll
    for (int j = 0; j < A4_CHUNKS; ++j) {
      if (j == A4_CHUNKS / 2) {
        // mid-stage, away from the group flush at the stage's end: stage
        // s + 1 has landed, and every warp is past stage s - 1, whose
        // buffer takes stage s + A4_STAGES - 1
        cp_async_wait<A4_STAGES - 3>();
        __syncthreads();
        if (s + A4_STAGES - 1 < nstages) load_stage(s + A4_STAGES - 1, (s + A4_STAGES - 1) % A4_STAGES);
        cp_async_commit();
      }
      const int c = s * A4_CHUNKS + j;
      if (!G128 && c >= nchunks) break;  // uniform across the block
      uint32_t o0[4], o1[4];
      transpose4(o0, words[0]);  // k 4t .. 4t + 3 of the chunk: the b0 registers
      transpose4(o1, words[1]);  // k 16 + 4t ..: the b1 registers
      // the next chunk's words, a chunk ahead of the products: chunk j + 1 of
      // this stage, or chunk 0 of the next (it landed before this stage's
      // mid-stage barrier; past the last chunk they go unused)
      if (j + 1 < A4_CHUNKS) {
        load_words(words, buf, j + 1);
      } else {
        load_words(words, (s + 1) % A4_STAGES, 0);
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
        const uint32_t a_row = a_s + row * A4_A_ROW;
        uint32_t alo[4], ahi[4];
        ldmatrix_x4(alo, a_row + (((j * 4 + (lane >> 4)) ^ (row & 7)) << 4));
        ldmatrix_x4(ahi, a_row + (((j * 4 + 2 + (lane >> 4)) ^ (row & 7)) << 4));
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
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  qmm_w8a8_tiled<OutT><<<grid, 128, 0, stream>>>(
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
  const int tiles = ((M + A4_BM - 1) / A4_BM) * ((N + A4_BN - 1) / A4_BN);
  kernel<<<tiles, A4_THREADS, A4_SMEM, stream>>>(
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

}  // extern "C"
