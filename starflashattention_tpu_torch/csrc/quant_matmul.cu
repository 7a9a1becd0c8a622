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
// (both nibbles are small integers, exact in bf16).
//
// Two variants each, picked by M:
//  * small-M (M <= 64): one block per 32 output columns, 8 warps that
//    split K between them (each warp loads 16 rows x 32 columns of weight
//    bytes per step, 16 bytes per thread, coalesced), then a deterministic
//    cross-warp sum in shared memory. The x rows (<= 64) are read straight
//    from L1/L2 as mma A fragments. int4 splits K by whole groups.
//  * tiled (M > 64): 64 x 64 output tiles, K in steps of 32 (int4: one
//    packed 16-row chunk, i.e. 32 rows) through shared memory, 4 warps of
//    32 x 32 each. No software pipelining yet.
//
// Requirements checked by the wrapper: K % 32 == 0, N % 32 == 0 (int4:
// group / 2 % 16 == 0), x, w, scale and out contiguous and 16-byte aligned.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename WT>
__device__ __forceinline__ float w2f(uint8_t b);

template <>
__device__ __forceinline__ float w2f<int8_t>(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}

template <>
__device__ __forceinline__ float w2f<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

// The two signed nibbles of a packed int4 byte, as floats (exact).
__device__ __forceinline__ float lo_nib(uint8_t b) { return static_cast<float>((b & 15) - 8); }
__device__ __forceinline__ float hi_nib(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b) >> 4);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

template <int MT>
__device__ __forceinline__ void zero_acc(float (&acc)[MT][4][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
}

// int4: acc += gacc * the group's scale (scale row srow) for the output
// columns cbase + j * 8 + 2t and the next one.
template <int MT>
__device__ __forceinline__ void add_group(float (&acc)[MT][4][4], const float (&gacc)[MT][4][4],
                                          const float* __restrict__ srow, int cbase, int t, int N) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = cbase + j * 8 + 2 * t;
    if (c < N) {
      const float s0 = srow[c], s1 = srow[c + 1];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        acc[mt][j][0] += gacc[mt][j][0] * s0;
        acc[mt][j][1] += gacc[mt][j][1] * s1;
        acc[mt][j][2] += gacc[mt][j][2] * s0;
        acc[mt][j][3] += gacc[mt][j][3] * s1;
      }
    }
  }
}

// ---------------------------------------------------------------- small M
constexpr int SM_WARPS = 8;
constexpr int SM_BN = 32;
constexpr int SM_UNROLL = 4;

// The small-M epilogue: a deterministic cross-warp sum of the warps'
// accumulators in shared memory (warps add in a fixed order), then rows < M
// of the block's SM_BN columns stored, times scale[col] unless scale is null.
template <int MT, typename OutT>
__device__ __forceinline__ void reduce_store(const float (&acc)[MT][4][4], float (*red)[SM_BN],
                                             OutT* __restrict__ out, int M, int N, int n0,
                                             const float* __restrict__ scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int wi = 0; wi < SM_WARPS; ++wi) {
    if (warp == wi) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r0 = mt * 16 + g, c = j * 8 + 2 * t;
          if (wi == 0) {
            red[r0][c] = acc[mt][j][0];
            red[r0][c + 1] = acc[mt][j][1];
            red[r0 + 8][c] = acc[mt][j][2];
            red[r0 + 8][c + 1] = acc[mt][j][3];
          } else {
            red[r0][c] += acc[mt][j][0];
            red[r0][c + 1] += acc[mt][j][1];
            red[r0 + 8][c] += acc[mt][j][2];
            red[r0 + 8][c + 1] += acc[mt][j][3];
          }
        }
    }
    __syncthreads();
  }
  for (int idx = threadIdx.x; idx < MT * 16 * SM_BN; idx += blockDim.x) {
    const int r = idx / SM_BN, c = idx % SM_BN;
    if (r < M) store_out(out + (size_t)r * N + n0 + c, scale ? red[r][c] * scale[n0 + c] : red[r][c]);
  }
}

template <typename WT, int MT, typename OutT>
__global__ void __launch_bounds__(SM_WARPS * 32)
    qmm_small_m(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) uint8_t wt[SM_WARPS][SM_UNROLL][16][SM_BN];
  __shared__ float red[MT * 16][SM_BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * SM_BN;
  const int kchunks = K / 16;
  const int k2 = K / 2;
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);

  float acc[MT][4][4];
  zero_acc(acc);

  for (int kc0 = warp * SM_UNROLL; kc0 < kchunks; kc0 += SM_WARPS * SM_UNROLL) {
    // Each lane loads row (lane / 2) of the 16-row chunk, 16 columns.
    uint4 wv[SM_UNROLL];
#pragma unroll
    for (int u = 0; u < SM_UNROLL; ++u) {
      const int kc = kc0 + u;
      if (kc < kchunks) {
        const uint8_t* src = w + (size_t)(kc * 16 + (lane >> 1)) * N + n0 + (lane & 1) * 16;
        wv[u] = __ldg(reinterpret_cast<const uint4*>(src));
      } else {
        wv[u] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int u = 0; u < SM_UNROLL; ++u)
      *reinterpret_cast<uint4*>(&wt[warp][u][lane >> 1][(lane & 1) * 16]) = wv[u];
    __syncwarp();
#pragma unroll
    for (int u = 0; u < SM_UNROLL; ++u) {
      const int kc = kc0 + u;
      if (kc < kchunks) {  // uniform across the warp
        uint32_t bf[4][2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = j * 8 + g;
          bf[j][0] = pack_bf16(w2f<WT>(wt[warp][u][2 * t][col]), w2f<WT>(wt[warp][u][2 * t + 1][col]));
          bf[j][1] = pack_bf16(w2f<WT>(wt[warp][u][2 * t + 8][col]), w2f<WT>(wt[warp][u][2 * t + 9][col]));
        }
        const int kb2 = kc * 8;  // k offset in bf16 pairs
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r0 = mt * 16 + g, r1 = r0 + 8;
          uint32_t af[4];
          af[0] = r0 < M ? x32[(size_t)r0 * k2 + kb2 + t] : 0u;
          af[1] = r1 < M ? x32[(size_t)r1 * k2 + kb2 + t] : 0u;
          af[2] = r0 < M ? x32[(size_t)r0 * k2 + kb2 + t + 4] : 0u;
          af[3] = r1 < M ? x32[(size_t)r1 * k2 + kb2 + t + 4] : 0u;
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], af, bf[j]);
        }
      }
    }
    __syncwarp();
  }

  reduce_store<MT>(acc, red, out, M, N, n0, scale);
}

// ---------------------------------------------------------------- tiled
constexpr int LG_BM = 64;
constexpr int LG_BN = 64;
constexpr int LG_BK = 32;
constexpr int AS_STRIDE = LG_BK + 8;   // bf16 elements per A row (80 bytes)
constexpr int BS_STRIDE = LG_BN + 16;  // bytes per B row

// The tiled epilogue: one warp's 32 x 32 sub-tile at (r_base, c_base),
// rows < M and columns < N, times scale[col] unless scale is null.
template <typename OutT>
__device__ __forceinline__ void store_tile(const float (&acc)[2][4][4], OutT* __restrict__ out, int M,
                                           int N, int r_base, int c_base, const float* __restrict__ scale) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r0 = r_base + mt * 16 + g;
      const int c = c_base + j * 8 + 2 * t;
      if (c < N) {
        const float s0 = scale ? scale[c] : 1.f, s1 = scale ? scale[c + 1] : 1.f;
        if (r0 < M) {
          store_out(out + (size_t)r0 * N + c, acc[mt][j][0] * s0);
          store_out(out + (size_t)r0 * N + c + 1, acc[mt][j][1] * s1);
        }
        if (r0 + 8 < M) {
          store_out(out + (size_t)(r0 + 8) * N + c, acc[mt][j][2] * s0);
          store_out(out + (size_t)(r0 + 8) * N + c + 1, acc[mt][j][3] * s1);
        }
      }
    }
}

template <typename WT, typename OutT>
__global__ void __launch_bounds__(128)
    qmm_tiled(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N) {
  __shared__ __align__(16) __nv_bfloat16 As[LG_BM][AS_STRIDE];
  __shared__ __align__(16) uint8_t Bs[LG_BK][BS_STRIDE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * LG_BM, n0 = blockIdx.y * LG_BN;

  float acc[2][4][4];
  zero_acc(acc);

  for (int k0 = 0; k0 < K; k0 += LG_BK) {
    for (int i = tid; i < LG_BM * (LG_BK / 8); i += 128) {
      const int r = i >> 2, c = (i & 3) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + k0 + c);
      *reinterpret_cast<uint4*>(&As[r][c]) = v;
    }
    for (int i = tid; i < LG_BK * (LG_BN / 16); i += 128) {
      const int r = i >> 2, c = (i & 3) * 16;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (n0 + c < N) v = __ldg(reinterpret_cast<const uint4*>(w + (size_t)(k0 + r) * N + n0 + c));
      *reinterpret_cast<uint4*>(&Bs[r][c]) = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < LG_BK; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm * 32 + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t + 8]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = wn * 32 + j * 8 + g;
        uint32_t bf[2];
        bf[0] = pack_bf16(w2f<WT>(Bs[kk + 2 * t][col]), w2f<WT>(Bs[kk + 2 * t + 1][col]));
        bf[1] = pack_bf16(w2f<WT>(Bs[kk + 2 * t + 8][col]), w2f<WT>(Bs[kk + 2 * t + 9][col]));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][j], af[mt], bf);
      }
    }
    __syncthreads();
  }

  store_tile(acc, out, M, N, m0 + wm * 32, n0 + wn * 32, scale);
}

template <typename WT, typename OutT>
cudaError_t launch(const void* x, const void* w, const void* scale, void* out, int M, int K,
                   int N, cudaStream_t stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  if (M <= 16) {
    qmm_small_m<WT, 1, OutT><<<N / SM_BN, SM_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, K, N);
  } else if (M <= 32) {
    qmm_small_m<WT, 2, OutT><<<N / SM_BN, SM_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, K, N);
  } else if (M <= 64) {
    qmm_small_m<WT, 4, OutT><<<N / SM_BN, SM_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, K, N);
  } else {
    dim3 grid((M + LG_BM - 1) / LG_BM, (N + LG_BN - 1) / LG_BN);
    qmm_tiled<WT, OutT><<<grid, 128, 0, stream>>>(xp, wp, sp, op, M, K, N);
  }
  return cudaGetLastError();
}

// ---------------------------------------------------------------- int4
constexpr int I4_UNROLL = 4;  // packed 16-row chunks a warp loads per step

template <int MT, typename OutT>
__global__ void __launch_bounds__(SM_WARPS * 32)
    qmm_int4_small_m(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                     const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N,
                     int half) {
  __shared__ __align__(16) uint8_t wt[SM_WARPS][I4_UNROLL][16][SM_BN];
  __shared__ float red[MT * 16][SM_BN];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * SM_BN;
  const int groups = K / (2 * half);
  const int nch = half / 16;  // packed 16-row chunks per group
  const int k2 = K / 2;
  const uint32_t* x32 = reinterpret_cast<const uint32_t*>(x);

  float acc[MT][4][4];
  zero_acc(acc);

  for (int grp = warp; grp < groups; grp += SM_WARPS) {
    float gacc[MT][4][4];
    zero_acc(gacc);
    const uint8_t* wg = w + (size_t)grp * half * N;
    const int xlo = grp * 2 * half;  // first activation column of the group
    for (int c0 = 0; c0 < nch; c0 += I4_UNROLL) {
      uint4 wv[I4_UNROLL];
#pragma unroll
      for (int u = 0; u < I4_UNROLL; ++u) {
        const int c = c0 + u;
        if (c < nch) {
          const uint8_t* src = wg + (size_t)(c * 16 + (lane >> 1)) * N + n0 + (lane & 1) * 16;
          wv[u] = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          wv[u] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
#pragma unroll
      for (int u = 0; u < I4_UNROLL; ++u)
        *reinterpret_cast<uint4*>(&wt[warp][u][lane >> 1][(lane & 1) * 16]) = wv[u];
      __syncwarp();
#pragma unroll
      for (int u = 0; u < I4_UNROLL; ++u) {
        const int c = c0 + u;
        if (c < nch) {  // uniform across the warp
          uint32_t blo[4][2], bhi[4][2];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = j * 8 + g;
            const uint8_t b0 = wt[warp][u][2 * t][col], b1 = wt[warp][u][2 * t + 1][col];
            const uint8_t b2 = wt[warp][u][2 * t + 8][col], b3 = wt[warp][u][2 * t + 9][col];
            blo[j][0] = pack_bf16(lo_nib(b0), lo_nib(b1));
            blo[j][1] = pack_bf16(lo_nib(b2), lo_nib(b3));
            bhi[j][0] = pack_bf16(hi_nib(b0), hi_nib(b1));
            bhi[j][1] = pack_bf16(hi_nib(b2), hi_nib(b3));
          }
          const int kb_lo = (xlo + c * 16) / 2, kb_hi = (xlo + half + c * 16) / 2;  // bf16 pairs
#pragma unroll
          for (int mt = 0; mt < MT; ++mt) {
            const int r0 = mt * 16 + g, r1 = r0 + 8;
            uint32_t alo[4], ahi[4];
            alo[0] = r0 < M ? x32[(size_t)r0 * k2 + kb_lo + t] : 0u;
            alo[1] = r1 < M ? x32[(size_t)r1 * k2 + kb_lo + t] : 0u;
            alo[2] = r0 < M ? x32[(size_t)r0 * k2 + kb_lo + t + 4] : 0u;
            alo[3] = r1 < M ? x32[(size_t)r1 * k2 + kb_lo + t + 4] : 0u;
            ahi[0] = r0 < M ? x32[(size_t)r0 * k2 + kb_hi + t] : 0u;
            ahi[1] = r1 < M ? x32[(size_t)r1 * k2 + kb_hi + t] : 0u;
            ahi[2] = r0 < M ? x32[(size_t)r0 * k2 + kb_hi + t + 4] : 0u;
            ahi[3] = r1 < M ? x32[(size_t)r1 * k2 + kb_hi + t + 4] : 0u;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma_bf16(gacc[mt][j], alo, blo[j]);
              mma_bf16(gacc[mt][j], ahi, bhi[j]);
            }
          }
        }
      }
      __syncwarp();
    }
    add_group(acc, gacc, scale + (size_t)grp * N, n0, t, N);  // the group's partial times its scale
  }

  reduce_store<MT>(acc, red, out, M, N, n0, static_cast<const float*>(nullptr));
}

template <typename OutT>
__global__ void __launch_bounds__(128)
    qmm_int4_tiled(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                   const float* __restrict__ scale, OutT* __restrict__ out, int M, int K, int N,
                   int half) {
  // A columns 0..15: the chunk's low-half activations; 16..31: its high half
  __shared__ __align__(16) __nv_bfloat16 As[LG_BM][AS_STRIDE];
  __shared__ __align__(16) uint8_t Bs[16][BS_STRIDE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * LG_BM, n0 = blockIdx.y * LG_BN;
  const int groups = K / (2 * half), nch = half / 16;

  float acc[2][4][4];
  zero_acc(acc);

  for (int grp = 0; grp < groups; ++grp) {
    float gacc[2][4][4];
    zero_acc(gacc);
    for (int c = 0; c < nch; ++c) {
      const int klo = grp * 2 * half + c * 16, khi = klo + half;
      for (int i = tid; i < LG_BM * 4; i += 128) {
        const int r = i >> 2, part = i & 3;
        const int col = (part < 2 ? klo : khi) + (part & 1) * 8;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x + (size_t)(m0 + r) * K + col);
        *reinterpret_cast<uint4*>(&As[r][part * 8]) = v;
      }
      for (int i = tid; i < 16 * (LG_BN / 16); i += 128) {
        const int r = i >> 2, cc = (i & 3) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + cc < N)
          v = __ldg(reinterpret_cast<const uint4*>(
              w + (size_t)(grp * half + c * 16 + r) * N + n0 + cc));
        *reinterpret_cast<uint4*>(&Bs[r][cc]) = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < 32; kk += 16) {  // 0: low nibbles, 16: high nibbles
        uint32_t af[2][4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const int r = wm * 32 + mt * 16 + g;
          af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t]);
          af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t]);
          af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + 2 * t + 8]);
          af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + 2 * t + 8]);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = wn * 32 + j * 8 + g;
          const uint8_t b0 = Bs[2 * t][col], b1 = Bs[2 * t + 1][col];
          const uint8_t b2 = Bs[2 * t + 8][col], b3 = Bs[2 * t + 9][col];
          uint32_t bf[2];
          if (kk == 0) {
            bf[0] = pack_bf16(lo_nib(b0), lo_nib(b1));
            bf[1] = pack_bf16(lo_nib(b2), lo_nib(b3));
          } else {
            bf[0] = pack_bf16(hi_nib(b0), hi_nib(b1));
            bf[1] = pack_bf16(hi_nib(b2), hi_nib(b3));
          }
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(gacc[mt][j], af[mt], bf);
        }
      }
      __syncthreads();
    }
    add_group(acc, gacc, scale + (size_t)grp * N, n0 + wn * 32, t, N);
  }

  store_tile(acc, out, M, N, m0 + wm * 32, n0 + wn * 32, static_cast<const float*>(nullptr));
}

template <typename OutT>
cudaError_t launch_int4(const void* x, const void* w, const void* scale, void* out, int M,
                        int K, int N, int half, cudaStream_t stream) {
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* sp = static_cast<const float*>(scale);
  auto* op = static_cast<OutT*>(out);
  if (M <= 16) {
    qmm_int4_small_m<1, OutT><<<N / SM_BN, SM_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, K, N, half);
  } else if (M <= 32) {
    qmm_int4_small_m<2, OutT><<<N / SM_BN, SM_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, K, N, half);
  } else if (M <= 64) {
    qmm_int4_small_m<4, OutT><<<N / SM_BN, SM_WARPS * 32, 0, stream>>>(xp, wp, sp, op, M, K, N, half);
  } else {
    dim3 grid((M + LG_BM - 1) / LG_BM, (N + LG_BN - 1) / LG_BN);
    qmm_int4_tiled<OutT><<<grid, 128, 0, stream>>>(xp, wp, sp, op, M, K, N, half);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// x (M, K) bf16; w (K, N) 8-bit, one layer; scale (N,) fp32; out (M, N).
// w_fp8: 0 = int8, 1 = float8_e4m3fn. out_bf16: 0 = fp32 out, 1 = bf16 out.
int quant_matmul(const void* x, const void* w, const void* scale, void* out, int M, int K,
                 int N, int w_fp8, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (w_fp8) {
    e = out_bf16 ? launch<__nv_fp8_e4m3, __nv_bfloat16>(x, w, scale, out, M, K, N, s)
                 : launch<__nv_fp8_e4m3, float>(x, w, scale, out, M, K, N, s);
  } else {
    e = out_bf16 ? launch<int8_t, __nv_bfloat16>(x, w, scale, out, M, K, N, s)
                 : launch<int8_t, float>(x, w, scale, out, M, K, N, s);
  }
  return static_cast<int>(e);
}

// x (M, K) bf16; w (K/2, N) packed int4 bytes, one layer; scale (K / (2 *
// half), N) fp32 group scales; half = group / 2 (a multiple of 16); out
// (M, N). out_bf16 as above.
int quant_matmul_int4(const void* x, const void* w, const void* scale, void* out, int M, int K,
                      int N, int half, int out_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = out_bf16 ? launch_int4<__nv_bfloat16>(x, w, scale, out, M, K, N, half, s)
                           : launch_int4<float>(x, w, scale, out, M, K, N, half, s);
  return static_cast<int>(e);
}

}  // extern "C"
