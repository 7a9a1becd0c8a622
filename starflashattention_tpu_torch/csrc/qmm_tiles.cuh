// Pieces shared by the tiled matmuls of quant_matmul.cu and quant_matmul_a8.cu:
// 16-byte cp.async into shared memory, ldmatrix, bf16 packing and the
// 8-column stores of a thread's permuted output columns.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qmm {

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; src_bytes 0 writes zeros and
// reads nothing (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// Eight consecutive output columns of one row, as two (fp32) or one (bf16)
// 16-byte stores.
__device__ __forceinline__ void store8(float* p, const float (&v)[8]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}
__device__ __forceinline__ void store8(__nv_bfloat16* p, const float (&v)[8]) {
  *reinterpret_cast<uint4*>(p) =
      make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]), pack_bf16(v[4], v[5]),
                 pack_bf16(v[6], v[7]));
}

// The tiles of a grid rastered in bands of BAND_M row tiles, row tiles
// fastest within a band: the blocks in flight share each weight tile and
// the activations in L2, and every weight byte is read from device memory
// about once. Returns the block's first row and column.
template <int BM, int BN, int BAND_M>
__device__ __forceinline__ int2 raster(int M, int N) {
  const int tiles_m = (M + BM - 1) / BM, tiles_n = (N + BN - 1) / BN;
  const int band = blockIdx.x / (BAND_M * tiles_n);
  const int band_m = min(tiles_m - band * BAND_M, BAND_M);
  const int in_band = blockIdx.x - band * BAND_M * tiles_n;
  return make_int2((band * BAND_M + in_band % band_m) * BM, (in_band / band_m) * BN);
}

}  // namespace qmm
