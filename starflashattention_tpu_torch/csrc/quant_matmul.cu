// Weight-only quantized matmuls for Hopper (sm_90a): out = x @ dequant(w).
//
// Replaces: starflashattention_tpu/ops/quant_matmul.py::_qmm_kernel (entry
// quant_matmul: int8 / fp8 weights, per-output-channel scales) and
// ::_qmm_int4_kernel (entry quant_matmul_int4: nibble-packed int4 weights,
// grouped scales).
//
// x: (M, K) bf16 activations; w: the weights of ONE layer (the wrapper
// offsets the pointer into the (L, ...) stack); out: (M, N) fp32 or bf16.
// Accumulation is fp32 on tensor-core mma.sync.m16n8k16 (bf16 in).
//  * int8 / fp8: w (K, N) 8-bit, scale (N,) fp32, applied in the epilogue.
//  * int4: w (K/2, N) int8 bytes, scale (G, N) fp32 with G = K / group. Byte
//    r of group g holds row g*group + r in its low nibble (stored biased +8)
//    and row g*group + group/2 + r in its high nibble (signed), so one
//    packed 16-row chunk feeds two k16 steps: the low nibbles against the
//    activation columns g*group + r and the high nibbles against
//    g*group + group/2 + r. Each group's fp32 partial product is multiplied
//    by the group's scale before it is added to the accumulator, as the TPU
//    kernel does (rounding nibble * scale to bf16 would be another function).
//
// Bound: at decode rows (M = 16) the weight stream against 3.35 TB/s: 8-bit
// K * N bytes (177 MB per 7B layer plus 131 MB for the lm_head); int4 half
// of that plus 4 * G * N bytes of scales. The 2*M*K*N operations are ~1/60
// of that time. At prefill rows (M in the thousands) the operations bound
// it. The weights are never dequantized into a bf16 copy in device memory
// (that copy is what the kernel exists to avoid): each 8-bit weight or
// nibble is converted to bf16 in registers right before it feeds an mma
// (both nibbles are small integers, exact in bf16). The weights are read
// from shared memory as 32-bit words and converted a bf16 pair at a time
// (qmm_tiles.cuh), in every form.
//
// Two forms each, picked by M:
//  * split K (M <= 64, int8 / fp8 and int4): bands of 128 output columns x
//    K ranges, one wave of three blocks an SM, the weights in the mma's A slot
//    streamed through a 4-stage cp.async ring with x's rows beside them, the
//    splits' fp32 partials summed in split order by the band's last block
//    (see qmm_split_k).
//  * tiled (M > 64), int8 / fp8: 128 x 256 output tiles, 8 warps of 64 x
//    64, a 4-buffer cp.async ring of 64 rows a stage, A fragments by
//    ldmatrix from a swizzled layout (see qmm_8bit_tiled).
//  * tiled (M > 64), int4: 64 x 256 output tiles, 8 warps, a 4-buffer
//    cp.async ring of 64 packed rows a stage (one g128 group), A fragments
//    by ldmatrix from a swizzled layout, the nibbles unpacked by the
//    magic-number conversion (see qmm_int4_tiled). Bound at prefill rows by
//    the operations: 2048 rows through 7B's five shapes are 1.26 TFLOP,
//    1.28 ms at 989 TFLOP/s.
//
// Requirements checked by the wrapper: K % 32 == 0, N % 32 == 0 (int4:
// group / 2 % 16 == 0), x, w, scale and out contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "qmm_split_k.cuh"

namespace {

using namespace qmm;

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// ---------------------------------------------------------------- small M: split K
// M <= 64 rows (decode steps, verify spans, MoE experts): the design is in
// qmm_split_k.cuh. A block computes one band of SK_BN = 128 output columns
// over one K range ("split") of `split` rows; the wrapper picks the splits
// (ops/quant_matmul.small_m_grid) from the shapes and the SM count.
template <typename WT, int NT, typename OutT>
__device__ __forceinline__ void split_k_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                                               const float* __restrict__ scale, OutT* __restrict__ out,
                                               float* __restrict__ part, int* __restrict__ arrivals, int M, int K,
                                               int N, int half, int split) {
  using G = SplitK<WT, NT>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int band = blockIdx.x, sp = blockIdx.y, splits = gridDim.y;
  const int n0 = band * SK_BN;
  // the block's weight rows [r0, r1): K rows, or packed rows (int4)
  const int per = G::INT4 ? split / 2 : split;
  const int r0 = sp * per, r1 = min(r0 + per, G::INT4 ? K / 2 : K);
  float acc[NT][4];
  split_k_products<WT, NT>(acc, smem, x, w, scale, M, K, N, half, n0, 0, r0, r1);
  if (splits > 1 && !split_k_merge<NT>(acc, part, arrivals, band, splits, sp, last)) return;
  float* tile = reinterpret_cast<float*>(smem);
  split_k_tile<NT>(acc, tile);
  __syncthreads();
  split_k_store<WT>(tile, scale, out, M, N, n0);
}

template <typename WT, int NT, typename OutT>
__global__ void __launch_bounds__(SK_THREADS)
    qmm_split_k(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, OutT* __restrict__ out, float* __restrict__ part,
                int* __restrict__ arrivals, int M, int K, int N, int half, int split) {
  split_k_kernel<WT, NT, OutT>(x, w, scale, out, part, arrivals, M, K, N, half, split);
}

// The int4 form at one n8 tile, three blocks an SM (the bound caps its
// registers at 80: left free, the compiler gives it 98 and two blocks, which
// ran the DeepSeek experts' 4-row calls 11% slower).
template <typename OutT>
__global__ void __launch_bounds__(SK_THREADS, 3)
    qmm_split_k_int4_m8(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                        const float* __restrict__ scale, OutT* __restrict__ out, float* __restrict__ part,
                        int* __restrict__ arrivals, int M, int K, int N, int half, int split) {
  split_k_kernel<Int4, 1, OutT>(x, w, scale, out, part, arrivals, M, K, N, half, split);
}

template <typename WT, int NT, typename OutT>
cudaError_t run_split_k(dim3 grid, const void* x, const void* w, const void* scale, void* out,
                        void* part, void* arrivals, int M, int K, int N, int half, int split,
                        cudaStream_t stream) {
  auto kernel = [] {
    if constexpr (std::is_same<WT, Int4>::value && NT == 1) return qmm_split_k_int4_m8<OutT>;
    else return qmm_split_k<WT, NT, OutT>;
  }();
  constexpr int smem = SplitK<WT, NT>::SMEM;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  kernel<<<grid, SK_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
      static_cast<OutT*>(out), static_cast<float*>(part), static_cast<int*>(arrivals), M, K, N, half, split);
  return cudaGetLastError();
}

// The split-K launch: bands of SK_BN columns x ceil(K / split) splits; a
// split is a multiple of 16 rows (int4: of the group, 2 half), the last
// one may be shorter. part / arrivals: the workspace (more than one split).
template <typename WT, typename OutT>
cudaError_t launch_split_k(const void* x, const void* w, const void* scale, void* out, void* part,
                           void* arrivals, int M, int K, int N, int half, int split, cudaStream_t stream) {
  const int unit = std::is_same<WT, Int4>::value ? 2 * half : 16;
  if (split <= 0 || split % unit) return cudaErrorInvalidValue;
  const dim3 grid((N + SK_BN - 1) / SK_BN, (K + split - 1) / split);
  if (grid.y > 1 && (part == nullptr || arrivals == nullptr)) return cudaErrorInvalidValue;
  auto run = M <= 8    ? run_split_k<WT, 1, OutT>
              : M <= 16 ? run_split_k<WT, 2, OutT>
              : M <= 32 ? run_split_k<WT, 4, OutT>
                        : run_split_k<WT, 8, OutT>;
  return run(grid, x, w, scale, out, part, arrivals, M, K, N, half, split, stream);
}

// ---------------------------------------------------------------- int4 tiled
// 64 x 256 output tiles, 8 warps of 64 x 32 side by side along N. K runs in
// stages of 64 packed rows, each 4 chunks of 16 packed rows; a chunk is 16
// low-nibble rows against 16 activation columns and 16 high-nibble rows
// against the 16 columns half a group on. A stage's chunks cover 128
// activation columns, so at g128 one stage is one scale group (the G128
// form: its group start and flush sit at fixed chunks, with no branch). A
// ring of I4_STAGES stages in dynamic shared memory, filled by 16-byte
// cp.async (rows past M, columns past N and chunks past K zero-filled),
// keeps two to three stages in flight while one is multiplied. One barrier
// a stage, in its middle: at the stage's end the group flush then runs into
// the next stage's products with no barrier between them. Each group's
// products go to an fp32 group accumulator (its first mma starts from 0),
// which is multiplied by the group's scale and added to the accumulator
// when the group ends.
//  * A (x) is stored 256 bytes a row, its 16-byte pieces XOR-swizzled by
//    the row (piece ^ (row & 7)), and read with ldmatrix.x4 without bank
//    conflicts. Piece j * 4 + h * 2 + q of a row holds chunk j's 8 columns
//    q of its low (h = 0) or high (h = 1) half.
//  * B (packed bytes) keeps its global layout, 272 bytes a row (16 of
//    padding: the lanes' rows 2t land in four different bank octets). Each
//    thread reads 32-bit words: 4 output columns of one packed row. The mma
//    B fragment needs k pairs (2t, 2t + 1) of one column, so the columns
//    are permuted: byte i of the word at columns wn * 32 + 4g feeds n8 tile
//    i, column g; thread (g, t) then holds output columns wn * 32 + 8t + i
//    and wn * 32 + 8t + 4 + i, i.e. 8 consecutive columns, stored with
//    16-byte stores. The nibbles become bf16 in registers (nib2_bf16:
//    prmt, lop3, one bf16x2 FMA) - no per-byte shared reads, no float
//    conversions.
//  * S (scales) holds each chunk's group row for the tile's columns (at
//    g128 only chunk 0's: the stage is one group).
// What bounds it on the H100: the group accumulator (64 more fp32
// registers a thread, 205 in all) caps the tile at 64 x 256 with one block
// an SM, so the tiles' traffic from L2 is large; copies of the kernel with
// the global reads, the group flush or the unpack taken out each ran
// faster, the first by most, and the deeper rings and other rasters did
// not. The rest is mma.sync's rate. wgmma is the next step (ROADMAP).
// The grid is rastered in bands of I4_BAND_M row tiles (qmm::raster).
constexpr int I4_MT = 4;                 // m16 tiles a warp: warp tiles of 64 x 32
constexpr int I4_WARPS = 8;              // side by side along N
constexpr int I4_BM = I4_MT * 16;
constexpr int I4_BN = I4_WARPS * 32;
constexpr int I4_SP = 64;                // packed rows a stage
constexpr int I4_CHUNKS = I4_SP / 16;    // chunks a stage
constexpr int I4_STAGES = 4;  // the barrier sits mid-stage, so the ring needs a fourth buffer
constexpr int I4_THREADS = I4_WARPS * 32;
constexpr int I4_B_PIECES = I4_BN / 16;  // 16-byte pieces of a packed row
constexpr int I4_BAND_M = 32;            // row tiles a raster band
constexpr int I4_A_ROW = 2 * I4_SP * 2;  // bytes: 128 bf16 activations a row
constexpr int I4_B_ROW = I4_BN + 16;     // bytes: 256 packed bytes + padding
constexpr int I4_A_BYTES = I4_BM * I4_A_ROW;
constexpr int I4_B_BYTES = I4_SP * I4_B_ROW;
constexpr int I4_S_BYTES = I4_CHUNKS * I4_BN * 4;
constexpr int I4_STAGE_BYTES = I4_A_BYTES + I4_B_BYTES + I4_S_BYTES;
constexpr int I4_SMEM = I4_STAGES * I4_STAGE_BYTES;  // 151,552 bytes

// D = A(16x16, row) * B(16x8, col): mma_bf16 with C = 0, a group's first product.
__device__ __forceinline__ void mma_bf16_first(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

template <typename OutT, bool G128>
__global__ void __launch_bounds__(I4_THREADS, 1)
    qmm_int4_tiled(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N,
                   int half) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wn = warp;  // the warp's columns: wn * 32 ..

  const int2 origin = raster<I4_BM, I4_BN, I4_BAND_M>(M, N);
  const int m0 = origin.x, n0 = origin.y;

  const int kp = K / 2, nchunks = kp / 16;
  const int nstages = (nchunks + I4_CHUNKS - 1) / I4_CHUNKS;

  // This thread's copies. A: piece tid % 16 of rows tid / 16 + (threads /
  // 16) i; B: piece tid % I4_B_PIECES of packed rows tid / I4_B_PIECES +
  // (threads / I4_B_PIECES) i; S: 4 columns (tid % (I4_BN / 4)) of chunk
  // tid / (I4_BN / 4).
  const int a_piece = tid & 15, a_row0 = tid >> 4;
  const int a_chunk = a_piece >> 2, a_high = (a_piece >> 1) & 1, a_q = a_piece & 1;
  const uint32_t smem0 = smem_addr(smem);

  auto load_stage = [&](int s, int buf) {
    const uint32_t a_s = smem0 + buf * I4_STAGE_BYTES;
    const uint32_t b_s = a_s + I4_A_BYTES, s_s = b_s + I4_B_BYTES;
    {
      const int c = s * I4_CHUNKS + a_chunk;
      int col = 0;
      if (c < nchunks) {
        const int grp = 16 * c / half;
        col = grp * 2 * half + a_high * half + (16 * c - grp * half) + 8 * a_q;
      }
#pragma unroll
      for (int i = 0; i < I4_BM * 16 / I4_THREADS; ++i) {
        const int row = a_row0 + I4_THREADS / 16 * i;
        const bool ok = c < nchunks && m0 + row < M;
        cp_async16(a_s + row * I4_A_ROW + ((a_piece ^ (row & 7)) << 4),
                   ok ? x + (size_t)(m0 + row) * K + col : x, ok ? 16 : 0);
      }
    }
#pragma unroll
    for (int i = 0; i < I4_SP * I4_B_PIECES / I4_THREADS; ++i) {
      const int row = tid / I4_B_PIECES + I4_THREADS / I4_B_PIECES * i, col = tid % I4_B_PIECES * 16;
      const int prow = s * I4_SP + row;
      const bool ok = prow < kp && n0 + col < N;
      cp_async16(b_s + row * I4_B_ROW + col, ok ? w + (size_t)prow * N + n0 + col : w, ok ? 16 : 0);
    }
    for (int i = tid; i < (G128 ? 1 : I4_CHUNKS) * I4_BN / 4; i += I4_THREADS) {  // G128: one group a stage
      const int j = i / (I4_BN / 4), col = i % (I4_BN / 4) * 4;
      const int c = s * I4_CHUNKS + j;
      const bool ok = c < nchunks && n0 + col < N;
      cp_async16(s_s + (j * I4_BN + col) * 4,
                 ok ? scale + (size_t)(16 * c / half) * N + n0 + col : scale, ok ? 16 : 0);
    }
  };

  float acc[I4_MT][4][4], gacc[I4_MT][4][4];
  zero_acc(acc);
  zero_acc(gacc);

#pragma unroll
  for (int s = 0; s < I4_STAGES - 1; ++s) {
    if (s < nstages) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<I4_STAGES - 2>();
  __syncthreads();  // stage 0 has landed
  for (int s = 0; s < nstages; ++s) {
    const int buf = s % I4_STAGES;
    const uint32_t a_s = smem0 + buf * I4_STAGE_BYTES;
    const unsigned char* b_s = smem + buf * I4_STAGE_BYTES + I4_A_BYTES;
    const float* s_s = reinterpret_cast<const float*>(b_s + I4_B_BYTES);
    float sc0[4], sc1[4];  // the scales of the thread's 8 columns for the group that ends next
    auto load_scales = [&](int j) {
      const float* sp = s_s + j * I4_BN + wn * 32 + 8 * t;
      const float4 s_lo = *reinterpret_cast<const float4*>(sp);
      const float4 s_hi = *reinterpret_cast<const float4*>(sp + 4);
      sc0[0] = s_lo.x, sc0[1] = s_lo.y, sc0[2] = s_lo.z, sc0[3] = s_lo.w;
      sc1[0] = s_hi.x, sc1[1] = s_hi.y, sc1[2] = s_hi.z, sc1[3] = s_hi.w;
    };
    if (G128) load_scales(0);  // early, off the flush's path
#pragma unroll
    for (int j = 0; j < I4_CHUNKS; ++j) {
      if (j == I4_CHUNKS / 2) {
        // mid-stage, away from the group flush at the stage's end: stage
        // s + 1 has landed, and every warp is past stage s - 1, whose
        // buffer takes stage s + I4_STAGES - 1
        cp_async_wait<I4_STAGES - 3>();
        __syncthreads();
        if (s + I4_STAGES - 1 < nstages) load_stage(s + I4_STAGES - 1, (s + I4_STAGES - 1) % I4_STAGES);
        cp_async_commit();
      }
      const int c = s * I4_CHUNKS + j;
      if (!G128 && c >= nchunks) break;  // uniform across the block
      const unsigned char* bp = b_s + (16 * j + 2 * t) * I4_B_ROW + wn * 32 + 4 * g;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(bp);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(bp + I4_B_ROW);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(bp + 8 * I4_B_ROW);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(bp + 9 * I4_B_ROW);
      uint32_t blo[4][2], bhi[4][2];
      unpack_tile<0>(blo, bhi, w0, w1, w8, w9);
      unpack_tile<1>(blo, bhi, w0, w1, w8, w9);
      unpack_tile<2>(blo, bhi, w0, w1, w8, w9);
      unpack_tile<3>(blo, bhi, w0, w1, w8, w9);
#pragma unroll
      for (int mt = 0; mt < I4_MT; ++mt) {
        const int row = mt * 16 + (lane & 15);
        const uint32_t a_row = a_s + row * I4_A_ROW;
        uint32_t alo[4], ahi[4];
        ldmatrix_x4(alo, a_row + (((j * 4 + (lane >> 4)) ^ (row & 7)) << 4));
        ldmatrix_x4(ahi, a_row + (((j * 4 + 2 + (lane >> 4)) ^ (row & 7)) << 4));
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (G128 && j == 0) {  // the group's first products: gacc starts from 0
            mma_bf16_first(gacc[mt][i], alo, blo[i]);
          } else {
            mma_bf16(gacc[mt][i], alo, blo[i]);
          }
          mma_bf16(gacc[mt][i], ahi, bhi[i]);
        }
      }
      if (G128 ? j == I4_CHUNKS - 1 : 16 * (c + 1) % half == 0) {  // the chunk ends its group
        if (!G128) load_scales(j);
#pragma unroll
        for (int mt = 0; mt < I4_MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            acc[mt][i][0] += gacc[mt][i][0] * sc0[i];
            acc[mt][i][1] += gacc[mt][i][1] * sc1[i];
            acc[mt][i][2] += gacc[mt][i][2] * sc0[i];
            acc[mt][i][3] += gacc[mt][i][3] * sc1[i];
            if (!G128) {
#pragma unroll
              for (int e = 0; e < 4; ++e) gacc[mt][i][e] = 0.f;
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
  for (int mt = 0; mt < I4_MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + mt * 16 + g + 8 * h;
      if (r < M) {
        float v[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          v[i] = acc[mt][i][2 * h];
          v[4 + i] = acc[mt][i][2 * h + 1];
        }
        store8(out + (size_t)r * N + c, v);
      }
    }
}

template <typename OutT>
cudaError_t launch_int4(const void* x, const void* w, const void* scale, void* out, void* part,
                        void* arrivals, int M, int K, int N, int half, int split, cudaStream_t stream) {
  if (M <= 64)
    return launch_split_k<Int4, OutT>(x, w, scale, out, part, arrivals, M, K, N, half, split, stream);
  auto kernel = half == I4_SP ? qmm_int4_tiled<OutT, true> : qmm_int4_tiled<OutT, false>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, I4_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + I4_BM - 1) / I4_BM) * ((N + I4_BN - 1) / I4_BN);
  kernel<<<tiles, I4_THREADS, I4_SMEM, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const uint8_t*>(w),
                                                 static_cast<const float*>(scale), static_cast<OutT*>(out),
                                                 M, K, N, half);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- tiled (int8 / fp8)
// 128 x 256 output tiles, 8 warps of 64 x 64 (2 along M, 4 along N). K runs
// in stages of 64 rows (4 k16 steps) through a ring of W8_STAGES buffers in
// dynamic shared memory, filled by 16-byte cp.async (rows past M, columns
// past N and rows past K zero-filled), with one barrier a stage, mid-stage
// (so the ring needs a fourth buffer), as in qmm_int4_tiled. One scale a
// column: there is no group accumulator, so the tile is twice K6's.
//  * A (x, bf16) is stored 128 bytes a row, its 16-byte pieces XOR-swizzled
//    by the row, and read with ldmatrix.x4 without bank conflicts.
//  * B (the 8-bit weights) keeps its global layout, 272 bytes a row (the
//    lanes' rows 2t land in four different bank octets). Each thread reads
//    32-bit words at rows 2t, 2t + 1, 2t + 8 and 2t + 9 of a k16 step, 4
//    output columns each; byte i of the words at columns c0 + 4g feeds n8
//    tile i, column g, so thread (g, t) holds the 8 consecutive columns c0 +
//    8t .. + 7 at the store (K6's permutation; `k4_b_fragment` in
//    ops/quant_matmul.py spells it out). The bytes become bf16 in registers,
//    exactly and with no conversion instruction: s8x2_bf16 (int8) and
//    e4m3x2_bf16 (float8_e4m3fn), 4 instructions a bf16 pair. Each k16
//    step's A fragments and weight words are loaded one step ahead of its
//    products, and the words converted right after the previous step's
//    products are issued, so the shared-memory latency and the conversion
//    run beside the mma.
// What bounds it on the H100: the 2*M*K*N operations (1.26 TFLOP through
// 7B's five shapes at 2048 rows: 1.28 ms at 989 TFLOP/s). Its tiles move
// about 2.8 TB/s from L2 into shared memory at those shapes, as the other
// tiled matmuls do (PERF.md); the tile cannot grow on mma.sync, whose
// accumulators fill the registers. wgmma is the next step (ROADMAP).
constexpr int W8_WARPS_M = 2, W8_WARPS_N = 4;
constexpr int W8_MT = 4;                        // m16 tiles a warp: warp tiles of 64 x 64
constexpr int W8_BM = W8_WARPS_M * W8_MT * 16;  // 128
constexpr int W8_BN = W8_WARPS_N * 64;          // 256
constexpr int W8_BK = 64;                       // rows a stage
constexpr int W8_STAGES = 4;
constexpr int W8_THREADS = W8_WARPS_M * W8_WARPS_N * 32;
constexpr int W8_B_PIECES = W8_BN / 16;         // 16-byte pieces of a weight row
constexpr int W8_BAND_M = 16;                   // row tiles a raster band: 2048 rows
constexpr int W8_A_ROW = W8_BK * 2;             // bytes: 64 bf16 activations a row
constexpr int W8_B_ROW = W8_BN + 16;            // bytes: 256 weight bytes + padding
constexpr int W8_A_BYTES = W8_BM * W8_A_ROW;
constexpr int W8_B_BYTES = W8_BK * W8_B_ROW;
constexpr int W8_STAGE_BYTES = W8_A_BYTES + W8_B_BYTES;
constexpr int W8_SMEM = W8_STAGES * W8_STAGE_BYTES;  // 135,168 bytes

// The B fragments of n8 tile I from words w[0..3] (rows 2t, 2t + 1, 2t + 8,
// 2t + 9 of the thread's 4 columns).
template <typename WT, int I>
__device__ __forceinline__ void bytes_tile(uint32_t (&bf)[4][2], const uint32_t (&w)[4]) {
  bf[I][0] = bytes2_bf16<WT, I>(w[0], w[1]);
  bf[I][1] = bytes2_bf16<WT, I>(w[2], w[3]);
}

template <typename WT, typename OutT>
__global__ void __launch_bounds__(W8_THREADS, 1)
    qmm_8bit_tiled(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp / W8_WARPS_N, wn = warp % W8_WARPS_N;
  const int2 origin = raster<W8_BM, W8_BN, W8_BAND_M>(M, N);
  const int m0 = origin.x, n0 = origin.y;
  const int nstages = (K + W8_BK - 1) / W8_BK;
  const uint32_t smem0 = smem_addr(smem);

  // This thread's copies. A: piece tid % 8 of rows tid / 8 + (threads / 8)
  // i; B: piece tid % W8_B_PIECES of rows tid / W8_B_PIECES + (threads /
  // W8_B_PIECES) i.
  const int a_piece = tid & 7, a_row0 = tid >> 3;
  const int b_piece = tid % W8_B_PIECES, b_row0 = tid / W8_B_PIECES;
  auto load_stage = [&](int s, int buf) {
    const uint32_t a_s = smem0 + buf * W8_STAGE_BYTES, b_s = a_s + W8_A_BYTES;
    const int k = s * W8_BK + 8 * a_piece;
#pragma unroll
    for (int i = 0; i < W8_BM * 8 / W8_THREADS; ++i) {
      const int row = a_row0 + W8_THREADS / 8 * i;
      const bool ok = k < K && m0 + row < M;
      cp_async16(a_s + row * W8_A_ROW + ((a_piece ^ (row & 7)) << 4),
                 ok ? x + (size_t)(m0 + row) * K + k : x, ok ? 16 : 0);
    }
#pragma unroll
    for (int i = 0; i < W8_BK * W8_B_PIECES / W8_THREADS; ++i) {
      const int row = b_row0 + W8_THREADS / W8_B_PIECES * i, krow = s * W8_BK + row;
      const int col = n0 + 16 * b_piece;
      const bool ok = krow < K && col < N;
      cp_async16(b_s + row * W8_B_ROW + 16 * b_piece, ok ? w + (size_t)krow * N + col : w,
                 ok ? 16 : 0);
    }
  };

  // One k16 step's fragments: A by ldmatrix, the weight words of each
  // 32-column half h at rows 2t, 2t + 1, 2t + 8, 2t + 9.
  auto load_frags = [&](uint32_t (&af)[W8_MT][4], uint32_t (&wd)[2][4], int buf, int j) {
    const uint32_t a_s = smem0 + buf * W8_STAGE_BYTES;
#pragma unroll
    for (int mt = 0; mt < W8_MT; ++mt) {
      const int row = wm * 64 + mt * 16 + (lane & 15);
      ldmatrix_x4(af[mt], a_s + row * W8_A_ROW + (((2 * j + (lane >> 4)) ^ (row & 7)) << 4));
    }
    const unsigned char* b_s = smem + buf * W8_STAGE_BYTES + W8_A_BYTES;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned char* bp = b_s + (16 * j + 2 * t) * W8_B_ROW + wn * 64 + h * 32 + 4 * g;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        wd[h][q] = *reinterpret_cast<const uint32_t*>(bp + ((q & 1) + 8 * (q >> 1)) * W8_B_ROW);
    }
  };

  float acc[W8_MT][8][4];
#pragma unroll
  for (int mt = 0; mt < W8_MT; ++mt)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

#pragma unroll
  for (int s = 0; s < W8_STAGES - 1; ++s) {
    if (s < nstages) load_stage(s, s);
    cp_async_commit();
  }
  cp_async_wait<W8_STAGES - 2>();
  __syncthreads();  // stage 0 has landed
  // a step's B registers from its words, both halves
  uint32_t bf[2][4][2];
  auto convert = [&](const uint32_t (&wd)[2][4]) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      bytes_tile<WT, 0>(bf[h], wd[h]);
      bytes_tile<WT, 1>(bf[h], wd[h]);
      bytes_tile<WT, 2>(bf[h], wd[h]);
      bytes_tile<WT, 3>(bf[h], wd[h]);
    }
  };
  uint32_t af[W8_MT][4];
  {
    uint32_t wd[2][4];
    load_frags(af, wd, 0, 0);
    convert(wd);
  }
  for (int s = 0; s < nstages; ++s) {
    const int buf = s % W8_STAGES;
#pragma unroll
    for (int j = 0; j < W8_BK / 16; ++j) {
      if (j == W8_BK / 32) {
        // mid-stage: stage s + 1 has landed, and every warp is past stage
        // s - 1, whose buffer takes stage s + W8_STAGES - 1
        cp_async_wait<W8_STAGES - 3>();
        __syncthreads();
        if (s + W8_STAGES - 1 < nstages) load_stage(s + W8_STAGES - 1, (s + W8_STAGES - 1) % W8_STAGES);
        cp_async_commit();
      }
      // the next step's fragments, one step ahead of the products: step j +
      // 1 of this stage, or step 0 of the next (it landed before this
      // stage's mid-stage barrier; past the last stage they go unused); its
      // words are converted after this step's products are issued
      uint32_t af_n[W8_MT][4], wd_n[2][4];
      if (j + 1 < W8_BK / 16) {
        load_frags(af_n, wd_n, buf, j + 1);
      } else {
        load_frags(af_n, wd_n, (s + 1) % W8_STAGES, 0);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h)  // the warp's two 32-column halves
#pragma unroll
        for (int mt = 0; mt < W8_MT; ++mt)
#pragma unroll
          for (int i = 0; i < 4; ++i) mma_bf16(acc[mt][4 * h + i], af[mt], bf[h][i]);
      convert(wd_n);
#pragma unroll
      for (int mt = 0; mt < W8_MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) af[mt][e] = af_n[mt][e];
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
          float v[8];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            v[i] = acc[mt][4 * h + i][2 * rr] * sc[i];
            v[4 + i] = acc[mt][4 * h + i][2 * rr + 1] * sc[4 + i];
          }
          store8(out + (size_t)r * N + c, v);
        }
      }
  }
}

template <typename WT, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, void* part, void* arrivals,
                   int M, int K, int N, int split, cudaStream_t stream) {
  if (M <= 64) return launch_split_k<WT, OutT>(x, w, scale, out, part, arrivals, M, K, N, 0, split, stream);
  auto kernel = qmm_8bit_tiled<WT, OutT>;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, W8_SMEM);
  if (e != cudaSuccess) return e;
  const int tiles = ((M + W8_BM - 1) / W8_BM) * ((N + W8_BN - 1) / W8_BN);
  kernel<<<tiles, W8_THREADS, W8_SMEM, stream>>>(static_cast<const __nv_bfloat16*>(x),
                                                 static_cast<const uint8_t*>(w),
                                                 static_cast<const float*>(scale), static_cast<OutT*>(out),
                                                 M, K, N);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// x (M, K) bf16; w (K, N) 8-bit, one layer; scale (N,) fp32; out (M, N).
// M <= 64: the split-K form over splits of `split` rows (a multiple of 16),
// with part (fp32, ceil(N / 128) * splits * 128 * the rows rounded up to 8,
// 16, 32 or 64) and arrivals (ceil(N / 128) int32 zeros, left at zero) when
// there is more than one split; M > 64: the tiled form (part, arrivals and
// split unused). w_fp8: 0 = int8, 1 = float8_e4m3fn. out_bf16: 0 = fp32
// out, 1 = bf16 out.
int quant_matmul(const void* x, const void* w, const void* scale, void* out, void* part, void* arrivals,
                 int M, int K, int N, int split, int w_fp8, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w_fp8) {
    e = out_bf16 ? launch<__nv_fp8_e4m3, __nv_bfloat16>(x, w, scale, out, part, arrivals, M, K, N, split, s)
                 : launch<__nv_fp8_e4m3, float>(x, w, scale, out, part, arrivals, M, K, N, split, s);
  } else {
    e = out_bf16 ? launch<int8_t, __nv_bfloat16>(x, w, scale, out, part, arrivals, M, K, N, split, s)
                 : launch<int8_t, float>(x, w, scale, out, part, arrivals, M, K, N, split, s);
  }
  return static_cast<int>(e);
}

// x (M, K) bf16; w (K/2, N) packed int4 bytes, one layer; scale (K / (2 *
// half), N) fp32 group scales; half = group / 2 (a multiple of 16); out
// (M, N). part, arrivals, split (a multiple of the group) and out_bf16 as
// above.
int quant_matmul_int4(const void* x, const void* w, const void* scale, void* out, void* part,
                      void* arrivals, int M, int K, int N, int half, int split, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = out_bf16
                      ? launch_int4<__nv_bfloat16>(x, w, scale, out, part, arrivals, M, K, N, half, split, s)
                      : launch_int4<float>(x, w, scale, out, part, arrivals, M, K, N, half, split, s);
  return static_cast<int>(e);
}

// The dynamic shared memory of the split-K form with nt n8 tiles (1, 2, 4
// or 8) on int4 (int4 = 1) or 8-bit weights; 0 for another nt.
int quant_matmul_split_k_smem(int int4, int nt) {
  switch (nt) {
    case 1: return int4 ? SplitK<Int4, 1>::SMEM : SplitK<int8_t, 1>::SMEM;
    case 2: return int4 ? SplitK<Int4, 2>::SMEM : SplitK<int8_t, 2>::SMEM;
    case 4: return int4 ? SplitK<Int4, 4>::SMEM : SplitK<int8_t, 4>::SMEM;
    case 8: return int4 ? SplitK<Int4, 8>::SMEM : SplitK<int8_t, 8>::SMEM;
    default: return 0;
  }
}

}  // extern "C"
