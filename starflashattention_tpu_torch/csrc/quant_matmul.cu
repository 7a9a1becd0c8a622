// Weight-only quantized matmul for Hopper (sm_90a): out = x @ (w * scale).
//
// Replaces: starflashattention_tpu/ops/quant_matmul.py::_qmm_kernel
// (entry quant_matmul).
//
// x: (M, K) bf16 activations; w: (K, N) int8 or fp8-e4m3 weights of ONE
// layer (the wrapper offsets the pointer into the (L, K, N) stack); scale:
// (N,) fp32 per-output-channel; out: (M, N) fp32 or bf16. Accumulation is
// fp32; the scale is applied in the epilogue.
//
// Bound: at decode rows (M = 16) the weight stream — K * N bytes, 177 MB per
// 7B layer plus 131 MB for the lm_head — against 3.35 TB/s; the 2*M*K*N
// operations are ~1/60 of that time. At prefill rows (M in the thousands)
// the operations bound it. The weights are never dequantized into a bf16
// copy in device memory (that copy is what the kernel exists to avoid):
// each 8-bit weight is converted to bf16 in registers right before it
// feeds a tensor-core mma.sync.m16n8k16 (bf16 in, fp32 accumulate).
//
// Two variants, picked by M:
//  * qmm_small_m (M <= 64): one block per 32 output columns, 8 warps that
//    split K between them (each warp loads 16 rows x 32 columns of weight
//    per step, 16 bytes per thread, coalesced), then a deterministic
//    cross-warp sum in shared memory. The x rows (<= 64) are read straight
//    from L1/L2 as mma A fragments.
//  * qmm_tiled (M > 64): 64 x 64 output tiles, K in steps of 32 through
//    shared memory, 4 warps of 32 x 32 each. No software pipelining yet.
//
// Requirements checked by the wrapper: K % 32 == 0, N % 32 == 0, x, w,
// scale and out contiguous and 16-byte aligned.

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

// ---------------------------------------------------------------- small M
constexpr int SM_WARPS = 8;
constexpr int SM_BN = 32;
constexpr int SM_UNROLL = 4;

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
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

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

  // Deterministic cross-warp reduction: warps add in a fixed order.
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
    if (r < M) store_out(out + (size_t)r * N + n0 + c, red[r][c] * scale[n0 + c]);
  }
}

// ---------------------------------------------------------------- tiled
constexpr int LG_BM = 64;
constexpr int LG_BN = 64;
constexpr int LG_BK = 32;
constexpr int AS_STRIDE = LG_BK + 8;   // bf16 elements per A row (80 bytes)
constexpr int BS_STRIDE = LG_BN + 16;  // bytes per B row

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
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;

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

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r0 = m0 + wm * 32 + mt * 16 + g;
      const int c = n0 + wn * 32 + j * 8 + 2 * t;
      if (c < N) {
        const float s0 = scale[c], s1 = scale[c + 1];
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

}  // extern "C"
