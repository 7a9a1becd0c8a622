// The split-K matmul of up to 64 x rows as device functions: quant_matmul.cu's
// qmm_split_k (K4 / K6 at decode rows) is built from them, and fused_mlp.cu
// (K13) runs them for each of its two phases.
//
// M <= 64 rows (decode steps, verify spans, MoE experts). The weight stream
// bounds these calls, so the design is about bytes in flight: enough blocks
// and enough stages. A block computes one band of SK_BN = 128 output
// columns over one K range ("split") of `split` rows; the wrapper picks the
// splits (ops/quant_matmul.small_m_grid) from the shapes and the SM count:
// as many as fit one wave of three blocks an SM.
//  * The weights sit in the mma's A slot and x in its B slot: an
//    m16n8k16 product has its 16 rows over output columns and its 8 columns
//    over x rows, so M <= 8 runs one n8 tile rather than a mostly empty m16
//    one. Each of the 8 warps owns 16 columns of the band over the whole
//    split, so no sum crosses warps. Lane (g, t) reads 32-bit words (4
//    columns) at rows 2t, 2t + 1, 2t + 8, 2t + 9 of column quad g / 2,
//    shifted right by 8 (g & 1) bits: bytes 0 and 2 are the fragment's rows
//    g and g + 8, i.e. columns 4 (g / 2) + (g & 1) and that + 2
//    (`small_m_fragment` in ops/quant_matmul.py spells it out). Two lanes
//    read each word. The bytes become bf16 pairs by qmm_tiles.cuh's
//    s8x2_bf16 / e4m3x2_bf16 / nib2_bf16, as in the tiled forms.
//  * The weight tiles (SK_BK rows, int4 packed rows, x 128 columns) stream
//    through a ring of SK_STAGES stages in dynamic shared memory, filled by
//    16-byte cp.async with one barrier a stage: three stages (24 KB of
//    weights a block) are in flight while one is multiplied. x's rows (zeros
//    past M) ride in the same stages, the columns the stage's rows meet, and
//    are read by ldmatrix from an XOR-swizzled layout; x is not staged
//    whole, since a split's x at 64 rows can pass 300 KB. int4 brings, with
//    each stage, the scale row of every group that ends in it.
//  * int8 / fp8: fp32 sums over the split, the column scale applied once to
//    the full sum. int4: each group's fp32 partial (its low- and high-nibble
//    k16 steps) times its scale, added when the group ends; splits hold
//    whole groups.
//  * More than one split: each block writes its fp32 partial to a workspace
//    in its threads' register order (16-byte stores), and the last block of
//    a band to arrive (an arrival counter bumped after __threadfence, reset
//    to 0 by that block) sums the partials in split order, SK_MERGE loads in
//    flight at a time, so every run gives the same bits. The band goes out
//    through shared memory in 16-byte stores.
// What bounds it on the H100: the weight loads, at under half the byte
// bound (PERF.md). In trial builds a copy of the kernel that only loaded
// took nearly all of its time, and deeper rings (6, 8 stages), 128-row
// stages, 256-column bands, more blocks an SM, an L2 prefetch ahead of the
// ring, one bulk copy (cp.async.bulk on an mbarrier) a weight row and one
// 2D tensor copy a stage each ran slower or within a few percent.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_tiles.cuh"

namespace qmm {

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// byte I of words a and b (two k of one column) -> one bf16x2, by format
template <typename WT, int I>
__device__ __forceinline__ uint32_t bytes2_bf16(uint32_t a, uint32_t b) {
  if constexpr (std::is_same<WT, int8_t>::value) {
    return s8x2_bf16<I>(a, b);
  } else {
    return e4m3x2_bf16<I>(a, b);
  }
}

constexpr int SK_WARPS = 8;
constexpr int SK_THREADS = SK_WARPS * 32;
constexpr int SK_BN = SK_WARPS * 16;    // output columns a band
constexpr int SK_BK = 64;               // weight rows (int4: packed rows) a stage
constexpr int SK_STAGES = 4;
constexpr int SK_W_ROW = SK_BN + 16;    // bytes: 128 weight bytes + padding (conflict-free words)
constexpr int SK_W_BYTES = SK_BK * SK_W_ROW;
constexpr int SK_OUT_ROW = SK_BN + 4;   // floats: a row of the epilogue's tile
constexpr int SK_MERGE = 8;             // partials the last block loads at a time

struct Int4 {};  // the weight tag of the int4 form

template <typename WT, int NT>
struct SplitK {
  static constexpr bool INT4 = std::is_same<WT, Int4>::value;
  static constexpr int ROWS = 8 * NT;             // x rows (M <= ROWS): NT n8 tiles
  static constexpr int X_PIECES = INT4 ? SK_BK / 4 : SK_BK / 8;  // 16-byte pieces of an x row a stage
  static constexpr int X_ROW = X_PIECES * 16;
  static constexpr int X_BYTES = ROWS * X_ROW;
  static constexpr int S_BYTES = INT4 ? (SK_BK / 16) * SK_BN * 4 : 0;
  static constexpr int STAGE = SK_W_BYTES + X_BYTES + S_BYTES;
  static constexpr int SMEM = SK_STAGES * STAGE;
  static_assert(X_PIECES % 8 == 0, "x's swizzle permutes 8 pieces of a row");
  static_assert(ROWS * SK_OUT_ROW * 4 <= SMEM, "the epilogue tile reuses the ring");
};

// The split's products: acc (lane's NT n8 tiles, in small_m_fragment's
// order) = x rows [0, M) times the weight rows [r0, r1) (int4: packed rows)
// of the band's SK_BN columns from n0, through the ring in `smem`; fp32
// sums over the split, int4 groups times their scales. PAIRED: the band's
// columns are 64 from n0 and 64 from pair_off + n0 (a gate band beside its
// up band). before_x (not null): the weights of the ring's
// first stages are copied first, then before_x() runs (the fused MLP waits
// there for x to be written), then their x rows. Ends with the ring free
// (every copy landed, a block barrier).
template <typename WT, int NT, bool PAIRED = false, typename Hook = std::nullptr_t>
__device__ __forceinline__ void split_k_products(float (&acc)[NT][4], unsigned char* smem,
                                                 const __nv_bfloat16* __restrict__ x,
                                                 const uint8_t* __restrict__ w, const float* __restrict__ scale,
                                                 int M, int K, int N, int half, int n0, int pair_off, int r0,
                                                 int r1, Hook before_x = nullptr) {
  using G = SplitK<WT, NT>;
  static_assert(!(PAIRED && G::INT4), "the paired band is 8-bit only");
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3, e = g & 1;
  const int nstages = (r1 - r0 + SK_BK - 1) / SK_BK;
  const uint32_t smem0 = smem_addr(smem);

  // a stage's weights (and int4's scales) and its x rows (parts: ALL); the
  // weights only (WEIGHTS) or the rows only (ROWS) in before_x's prologue
  using ALL = std::integral_constant<int, 3>;
  using WEIGHTS = std::integral_constant<int, 1>;
  using ROWS = std::integral_constant<int, 2>;
  auto load_stage = [&](int s, int buf, auto parts) {
    constexpr bool weights = decltype(parts)::value & 1, rows = decltype(parts)::value & 2;
    const uint32_t w_s = smem0 + buf * G::STAGE, x_s = w_s + SK_W_BYTES, s_s = x_s + G::X_BYTES;
    const int row0 = r0 + s * SK_BK;
#pragma unroll
    for (int i = 0; i < (weights ? SK_BK * (SK_BN / 16) / SK_THREADS : 0); ++i) {
      const int idx = tid + i * SK_THREADS, row = idx / (SK_BN / 16), piece = idx % (SK_BN / 16);
      // paired: pieces 0-3 the band's 64 columns from n0, 4-7 those from pair_off + n0
      const int col = PAIRED && piece >= SK_BN / 32 ? pair_off + n0 + 16 * (piece - SK_BN / 32) : n0 + 16 * piece;
      const bool ok = row0 + row < r1 && col < N;
      cp_async16(w_s + row * SK_W_ROW + 16 * piece, ok ? w + (size_t)(row0 + row) * N + col : w,
                 ok ? 16 : 0);
    }
    for (int idx = tid; idx < (rows ? G::ROWS * G::X_PIECES : 0); idx += SK_THREADS) {
      const int row = idx / G::X_PIECES, piece = idx % G::X_PIECES;
      int col;
      bool ok;
      if constexpr (G::INT4) {
        // piece 4c + 2h + q: chunk c's 8 activation columns q of its low (h
        // 0) or its high (h 1) nibble half
        const int p = row0 + 16 * (piece >> 2);  // the chunk's first packed row
        const int grp = p / half;
        col = grp * 2 * half + ((piece >> 1) & 1) * half + (p - grp * half) + 8 * (piece & 1);
        ok = p < r1;
      } else {
        col = row0 + 8 * piece;
        ok = col < r1;
      }
      ok = ok && row < M;
      cp_async16(x_s + row * G::X_ROW + ((piece ^ (row & 7)) << 4), ok ? x + (size_t)row * K + col : x,
                 ok ? 16 : 0);
    }
    if constexpr (G::INT4) {
      // the scale row of each group that ends in the stage, in the slot of
      // the chunk that ends it
      if (tid < (weights ? (SK_BK / 16) * (SK_BN / 4) : 0)) {
        const int c = tid / (SK_BN / 4), q = tid % (SK_BN / 4);
        const int p = row0 + 16 * c;
        if (p < r1 && (p + 16) % half == 0 && n0 + 4 * q < N)
          cp_async16(s_s + (c * SK_BN + 4 * q) * 4, scale + (size_t)((p + 16) / half - 1) * N + n0 + 4 * q,
                     16);
      }
    }
  };

  // the B fragments of every n8 tile (x rows 8 jn .. + 7) at x pieces p0
  // and p0 + 1 (16 columns) of a stage, by ldmatrix
  auto load_b = [&](uint32_t (&b)[NT][2], uint32_t x_s, int p0) {
    if constexpr (NT == 1) {
      const int row = lane & 7, piece = p0 + ((lane >> 3) & 1);
      ldmatrix_x2(b[0], x_s + row * G::X_ROW + ((piece ^ row) << 4));
    } else {
#pragma unroll
      for (int q = 0; q < NT / 2; ++q) {
        const int row = 16 * q + (lane & 7) + 8 * (lane >> 4), piece = p0 + ((lane >> 3) & 1);
        uint32_t r[4];
        ldmatrix_x4(r, x_s + row * G::X_ROW + ((piece ^ (row & 7)) << 4));
        b[2 * q][0] = r[0], b[2 * q][1] = r[1], b[2 * q + 1][0] = r[2], b[2 * q + 1][1] = r[3];
      }
    }
  };

  float gacc[NT][4];
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[jn][i] = gacc[jn][i] = 0.f;

  if constexpr (std::is_same<Hook, std::nullptr_t>::value) {
#pragma unroll
    for (int s = 0; s < SK_STAGES - 1; ++s) {
      if (s < nstages) load_stage(s, s, ALL{});
      cp_async_commit();
    }
  } else {
#pragma unroll
    for (int s = 0; s < SK_STAGES - 1; ++s)
      if (s < nstages) load_stage(s, s, WEIGHTS{});
    before_x();
#pragma unroll
    for (int s = 0; s < SK_STAGES - 1; ++s) {
      if (s < nstages) load_stage(s, s, ROWS{});
      cp_async_commit();
    }
  }
  const int word = warp * 16 + 4 * (g >> 1);  // the byte offset of the lane's word in a weight row
  for (int s = 0; s < nstages; ++s) {
    // stage s has landed, and every warp is past stage s - 1, whose buffer
    // takes stage s + SK_STAGES - 1
    cp_async_wait<SK_STAGES - 2>();
    __syncthreads();
    if (s + SK_STAGES - 1 < nstages) load_stage(s + SK_STAGES - 1, (s + SK_STAGES - 1) % SK_STAGES, ALL{});
    cp_async_commit();
    const int buf = s % SK_STAGES;
    const unsigned char* w_s = smem + buf * G::STAGE;
    const uint32_t x_s = smem0 + buf * G::STAGE + SK_W_BYTES;
    const float* s_s = reinterpret_cast<const float*>(w_s + SK_W_BYTES + G::X_BYTES);
    const int row0 = r0 + s * SK_BK;
    const int steps = min(SK_BK, r1 - row0) / 16;  // k16 steps (int4: chunks) in the stage
#pragma unroll
    for (int j = 0; j < SK_BK / 16; ++j) {
      if (j >= steps) break;  // uniform across the block
      const unsigned char* bp = w_s + (16 * j + 2 * t) * SK_W_ROW + word;
      const int sh = 8 * e;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(bp) >> sh;
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(bp + SK_W_ROW) >> sh;
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(bp + 8 * SK_W_ROW) >> sh;
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(bp + 9 * SK_W_ROW) >> sh;
      if constexpr (G::INT4) {
        uint32_t lo[4][2], hi[4][2];
        unpack_tile<0>(lo, hi, w0, w1, w8, w9);
        unpack_tile<2>(lo, hi, w0, w1, w8, w9);
        const uint32_t alo[4] = {lo[0][0], lo[2][0], lo[0][1], lo[2][1]};
        const uint32_t ahi[4] = {hi[0][0], hi[2][0], hi[0][1], hi[2][1]};
        uint32_t blo[NT][2], bhi[NT][2];
        load_b(blo, x_s, 4 * j);
        load_b(bhi, x_s, 4 * j + 2);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) {
          mma_bf16(gacc[jn], alo, blo[jn]);
          mma_bf16(gacc[jn], ahi, bhi[jn]);
        }
        if ((row0 + 16 * j + 16) % half == 0) {  // the chunk ends its group: flush it times its scale
          const float* sc = s_s + j * SK_BN + word + e;
          const float s0 = sc[0], s1 = sc[2];
#pragma unroll
          for (int jn = 0; jn < NT; ++jn) {
            acc[jn][0] += gacc[jn][0] * s0;
            acc[jn][1] += gacc[jn][1] * s0;
            acc[jn][2] += gacc[jn][2] * s1;
            acc[jn][3] += gacc[jn][3] * s1;
#pragma unroll
            for (int i = 0; i < 4; ++i) gacc[jn][i] = 0.f;
          }
        }
      } else {
        const uint32_t a[4] = {bytes2_bf16<WT, 0>(w0, w1), bytes2_bf16<WT, 2>(w0, w1),
                               bytes2_bf16<WT, 0>(w8, w9), bytes2_bf16<WT, 2>(w8, w9)};
        uint32_t b[NT][2];
        load_b(b, x_s, 2 * j);
#pragma unroll
        for (int jn = 0; jn < NT; ++jn) mma_bf16(acc[jn], a, b[jn]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the caller's epilogue tile may reuse it
}

// More than one split: write the split's partial (16 bytes a thread per n8
// tile) to slot `slot` of the workspace and arrive on the slot's counter.
// The last block of the slot to arrive (which resets the counter to 0)
// gets every split's partial summed in split order in acc and returns
// true; the others return false. `last` is a __shared__ int of the block.
template <int NT>
__device__ __forceinline__ bool split_k_merge(float (&acc)[NT][4], float* __restrict__ part,
                                              int* __restrict__ arrivals, int slot, int splits, int sp,
                                              int& last) {
  const int tid = threadIdx.x;
  float4* mine = reinterpret_cast<float4*>(part) + (size_t)(slot * splits + sp) * NT * SK_THREADS;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn)
    __stcg(mine + jn * SK_THREADS + tid, make_float4(acc[jn][0], acc[jn][1], acc[jn][2], acc[jn][3]));
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = arrivals + slot;
    last = atomicAdd(counter, 1) == splits - 1;
    if (last) *counter = 0;  // every split of the band has arrived: ready for the next call
  }
  __syncthreads();
  if (!last) return false;
  __threadfence();
  // SK_MERGE splits' loads in flight at a time, added in split order
  const float4* parts = reinterpret_cast<const float4*>(part) + (size_t)slot * splits * NT * SK_THREADS + tid;
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    float4 v = __ldcg(parts + jn * SK_THREADS);
    for (int q0 = 1; q0 < splits; q0 += SK_MERGE) {
      float4 u[SK_MERGE];
#pragma unroll
      for (int i = 0; i < SK_MERGE; ++i)
        if (q0 + i < splits) u[i] = __ldcg(parts + ((q0 + i) * NT + jn) * SK_THREADS);
#pragma unroll
      for (int i = 0; i < SK_MERGE; ++i)
        if (q0 + i < splits) v.x += u[i].x, v.y += u[i].y, v.z += u[i].z, v.w += u[i].w;
    }
    acc[jn][0] = v.x, acc[jn][1] = v.y, acc[jn][2] = v.z, acc[jn][3] = v.w;
  }
  return true;
}

// acc into the band's (8 NT, SK_OUT_ROW) fp32 tile in shared memory (the
// caller's block barrier follows).
template <int NT>
__device__ __forceinline__ void split_k_tile(const float (&acc)[NT][4], float* tile) {
  // accumulator (jn, i): x row 8 jn + 2t + (i & 1), column word + e + 2 (i >> 1)
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int col = (threadIdx.x >> 5) * 16 + 4 * (g >> 1) + (g & 1);
#pragma unroll
  for (int jn = 0; jn < NT; ++jn) {
    float* r = tile + (8 * jn + 2 * t) * SK_OUT_ROW + col;
    r[0] = acc[jn][0];
    r[SK_OUT_ROW] = acc[jn][1];
    r[2] = acc[jn][2];
    r[SK_OUT_ROW + 2] = acc[jn][3];
  }
}

// The band's tile out: rows < M, 8 columns a thread at a time, times the
// column scale (int8 / fp8), into out (row stride N).
template <typename WT, typename OutT>
__device__ __forceinline__ void split_k_store(const float* tile, const float* __restrict__ scale,
                                              OutT* __restrict__ out, int M, int N, int n0) {
  for (int idx = threadIdx.x; idx < M * (SK_BN / 8); idx += SK_THREADS) {
    const int r = idx / (SK_BN / 8), c = idx % (SK_BN / 8) * 8;
    if (n0 + c >= N) continue;
    const float4* src = reinterpret_cast<const float4*>(tile + r * SK_OUT_ROW + c);
    const float4 v0 = src[0], v1 = src[1];
    float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
    if constexpr (!std::is_same<WT, Int4>::value) {
      const float4 s0 = __ldg(reinterpret_cast<const float4*>(scale + n0 + c));
      const float4 s1 = __ldg(reinterpret_cast<const float4*>(scale + n0 + c + 4));
      v[0] *= s0.x, v[1] *= s0.y, v[2] *= s0.z, v[3] *= s0.w;
      v[4] *= s1.x, v[5] *= s1.y, v[6] *= s1.z, v[7] *= s1.w;
    }
    store8(out + (size_t)r * N + n0 + c, v);
  }
}

}  // namespace qmm
