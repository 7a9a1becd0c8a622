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
//    half = group / 2. Each nibble is unpacked to int8; each group's int32
//    sum is converted to fp32 and multiplied by the group's scale, the
//    groups are summed in fp32, and rs[row] is applied at the store.
// int32 cannot overflow: |acc| <= K * 127 * 127 < 2^31 for K < 133,000.
//
// Bound: at prefill rows (M = 2048) the 2*M*K*N operations at the int8
// tensor-core rate (1,979 TOPS dense), against M*K + K*N bytes. Design: the
// int8 x int8 -> int32 product runs on mma.sync.m16n8k32.s8 (twice the bf16
// rate per instruction); 64 x 64 output tiles, K in steps of 64 (W4A8: 32
// packed rows, the low and the high half of a 64-row slice of one group)
// through shared memory, 4 warps of 32 x 32 each. B fragments are gathered
// byte by byte from the row-major weight tile. No software pipelining,
// wgmma or TMA yet.
//
// Requirements checked by the wrapper: K % 64 == 0 (W4A8: half % 32 == 0),
// N % 32 == 0, every pointer 16-byte aligned and contiguous.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;                 // int8 columns of A per stage
constexpr int A_STRIDE = BK + 16;      // bytes per A row in shared memory
constexpr int B_STRIDE = BN + 16;      // bytes per B row

// D = A(16x32, row) * B(32x8, col) + D: int8 inputs, int32 accumulators.
__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t byte_of(int v) { return static_cast<uint32_t>(v) & 0xffu; }

// Four int8 values (k0..k0+3 of column col) packed low byte first. MODE 0:
// the bytes as they are; 1: their low nibbles; 2: their high nibbles.
template <int MODE>
__device__ __forceinline__ uint32_t gather4(uint8_t (*Bs)[B_STRIDE], int k0, int col) {
  uint32_t r = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint8_t b = Bs[k0 + i][col];
    int v;
    if (MODE == 0) v = static_cast<int8_t>(b);
    else if (MODE == 1) v = (b & 15) - 8;
    else v = static_cast<int8_t>(b) >> 4;
    r |= byte_of(v) << (8 * i);
  }
  return r;
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// One k32 step of the warp's 32 x 32 sub-tile: A columns kk..kk+31 of the
// stage, B rows given by MODE (see gather4) starting at row kb.
template <int MODE>
__device__ __forceinline__ void warp_k32(int (*acc)[4][4], uint8_t (*As)[A_STRIDE],
                                         uint8_t (*Bs)[B_STRIDE], int kk, int kb, int wm,
                                         int wn, int g, int t) {
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
    bf[0] = gather4<MODE>(Bs, kb + 4 * t, col);
    bf[1] = gather4<MODE>(Bs, kb + 16 + 4 * t, col);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) mma_s8(acc[mt][j], af[mt], bf);
  }
}

template <bool INT4, typename OutT>
__global__ void __launch_bounds__(128)
    qmm_a8_tiled(const int8_t* __restrict__ x8, const float* __restrict__ rs,
                 const uint8_t* __restrict__ w, const float* __restrict__ scale,
                 OutT* __restrict__ out, int M, int K, int N, int half) {
  __shared__ __align__(16) uint8_t As[BM][A_STRIDE];
  __shared__ __align__(16) uint8_t Bs[BK][B_STRIDE];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;

  int iacc[2][4][4];   // int32 sums: over all of K (W8A8) or one group (W4A8)
  float facc[2][4][4];  // W4A8: the scaled group sums
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        iacc[mt][j][e] = 0;
        facc[mt][j][e] = 0.f;
      }

  // W8A8: one "group" spanning K, in stages of 64 rows. W4A8: G groups of
  // half / 32 stages, each stage 32 packed rows = 64 contraction rows.
  const int groups = INT4 ? K / (2 * half) : 1;
  const int stages = INT4 ? half / 32 : K / BK;
  for (int grp = 0; grp < groups; ++grp) {
    for (int st = 0; st < stages; ++st) {
      // A: 64 rows x 64 int8 columns. W4A8: columns 0..31 are the low-half
      // activations of this stage, 32..63 the high-half ones.
      for (int i = tid; i < BM * 4; i += 128) {
        const int r = i >> 2, part = i & 3;
        int col;
        if (INT4) {
          col = grp * 2 * half + st * 32 + (part >= 2 ? half : 0) + (part & 1) * 16;
        } else {
          col = st * BK + part * 16;
        }
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (m0 + r < M) v = *reinterpret_cast<const uint4*>(x8 + (size_t)(m0 + r) * K + col);
        *reinterpret_cast<uint4*>(&As[r][part * 16]) = v;
      }
      const int brows = INT4 ? 32 : BK;
      const size_t brow0 = INT4 ? (size_t)grp * half + st * 32 : (size_t)st * BK;
      for (int i = tid; i < brows * (BN / 16); i += 128) {
        const int r = i >> 2, cc = (i & 3) * 16;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (n0 + cc < N) v = __ldg(reinterpret_cast<const uint4*>(w + (brow0 + r) * N + n0 + cc));
        *reinterpret_cast<uint4*>(&Bs[r][cc]) = v;
      }
      __syncthreads();
      if (INT4) {
        warp_k32<1>(iacc, As, Bs, 0, 0, wm, wn, g, t);   // low nibbles, rows 0..31
        warp_k32<2>(iacc, As, Bs, 32, 0, wm, wn, g, t);  // high nibbles, same bytes
      } else {
        warp_k32<0>(iacc, As, Bs, 0, 0, wm, wn, g, t);
        warp_k32<0>(iacc, As, Bs, 32, 32, wm, wn, g, t);
      }
      __syncthreads();
    }
    if (INT4) {  // the group's int32 sum -> fp32, times the group scale
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = n0 + wn * 32 + j * 8 + 2 * t;
        if (c < N) {
          const float s0 = scale[(size_t)grp * N + c], s1 = scale[(size_t)grp * N + c + 1];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
            facc[mt][j][0] += static_cast<float>(iacc[mt][j][0]) * s0;
            facc[mt][j][1] += static_cast<float>(iacc[mt][j][1]) * s1;
            facc[mt][j][2] += static_cast<float>(iacc[mt][j][2]) * s0;
            facc[mt][j][3] += static_cast<float>(iacc[mt][j][3]) * s1;
          }
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) iacc[mt][j][e] = 0;
      }
    }
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
          const int idx = 2 * half_row + e;
          float v;
          if (INT4) {
            v = facc[mt][j][idx] * rsr;
          } else {
            v = static_cast<float>(iacc[mt][j][idx]) * rsr * scale[c + e];
          }
          store_out(out + (size_t)r * N + c + e, v);
        }
      }
    }
}

template <bool INT4, typename OutT>
cudaError_t launch(const void* x8, const void* rs, const void* w, const void* scale, void* out,
                   int M, int K, int N, int half, cudaStream_t stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  qmm_a8_tiled<INT4, OutT><<<grid, 128, 0, stream>>>(
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
    e = out_bf16 ? launch<true, __nv_bfloat16>(x8, rs, w, scale, out, M, K, N, half, s)
                 : launch<true, float>(x8, rs, w, scale, out, M, K, N, half, s);
  } else {
    e = out_bf16 ? launch<false, __nv_bfloat16>(x8, rs, w, scale, out, M, K, N, 0, s)
                 : launch<false, float>(x8, rs, w, scale, out, M, K, N, 0, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
