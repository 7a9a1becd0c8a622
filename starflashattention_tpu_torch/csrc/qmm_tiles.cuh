// Pieces shared by the matmuls of quant_matmul.cu and quant_matmul_a8.cu:
// 16-byte cp.async into shared memory, ldmatrix, bf16 packing, the 8-column
// stores of a thread's permuted output columns, and the register
// conversions of int8, float8_e4m3fn and packed int4 weight words to bf16
// pairs (the tiled and the split-K forms read the weights as 32-bit words).

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

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// int8: byte I of words a and b -> one bf16x2 (a's value in the low half),
// exact. prmt puts byte I of each word in the low byte of its 16-bit half;
// lop3 makes L = 0x4300 | (byte & 0x7F), bf16 128 + the 7 low bits, and C =
// 0x4300 | (byte & 0x80), bf16 128 or (sign bit set) 256; one bf16x2 FMA
// gives L - C, the int8 value: an integer in [-128, 127], exact in bf16.
template <int I>
__device__ __forceinline__ uint32_t s8x2_bf16(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12);
  uint32_t x, l, c, r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(x) : "r"(a), "r"(b), "n"(sel));
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(l) : "r"(x), "n"(0x007F007Fu), "n"(0x43004300u));
  asm("lop3.b32 %0, %1, %2, %3, 0xea;\n" : "=r"(c) : "r"(x), "n"(0x00800080u), "n"(0x43004300u));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(r) : "r"(c), "r"(0xBF80BF80u), "r"(l));
  return r;
}

// float8_e4m3fn: byte I of words a and b -> one bf16x2. prmt gives each
// byte a 16-bit half, the byte low and its sign replicated high; shifted
// left by 4 and masked with 0x87F0, a half holds the sign in bit 15 and the
// byte's 4 exponent and 3 mantissa bits in bits 7-10 and 4-6: the bf16 of
// the e4m3 value times 2^-120 (a bf16 subnormal for an e4m3 subnormal).
// One bf16x2 multiply by 2^120 (0x7B80) restores it, exact for every
// finite value.
template <int I>
__device__ __forceinline__ uint32_t e4m3x2_bf16(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = I | ((I | 8) << 4) | ((4 + I) << 8) | ((12 + I) << 12);
  uint32_t x, r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(x) : "r"(a), "r"(b), "n"(sel));
  const uint32_t y = (x << 4) & 0x87F087F0u;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(r) : "r"(y), "r"(0x7B807B80u));
  return r;
}

// Byte I of word a and byte I of word b -> one bf16x2 (a's value in the low
// half), of their low nibbles (HIGH false: stored biased +8) or of their
// high nibbles already shifted into bits 0-3 (HIGH true: signed, so bit 3
// is flipped to give the same +8 bias). prmt gathers the two bytes; lop3
// computes (x & 0x000f000f) ^ magic, which puts the biased nibble n into
// the mantissa of bf16 128.0 (0x4300 | n = 128 + n, exact); one bf16x2 FMA
// subtracts 136. Exact for every value in [-8, 7].
template <int I, bool HIGH>
__device__ __forceinline__ uint32_t nib2_bf16(uint32_t a, uint32_t b) {
  constexpr uint32_t sel = I | (I << 4) | ((4 + I) << 8) | ((4 + I) << 12);
  constexpr uint32_t magic = HIGH ? 0x43084308u : 0x43004300u;
  uint32_t x, y, z;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(x) : "r"(a), "r"(b), "n"(sel));
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n" : "=r"(y) : "r"(x), "n"(0x000f000fu), "n"(magic));
  asm("fma.rn.bf16x2 %0, %1, %2, %3;\n" : "=r"(z) : "r"(y), "r"(0x3f803f80u), "r"(0xc308c308u));
  return z;
}

// The int4 fragments of byte I of one chunk's words: w0, w1, w8, w9 hold
// packed rows 2t, 2t + 1, 2t + 8, 2t + 9; lo/hi[I] are the bf16 pairs
// (rows 2t, 2t + 1) and (rows 2t + 8, 2t + 9) of the low and the high
// nibbles.
template <int I>
__device__ __forceinline__ void unpack_tile(uint32_t (&lo)[4][2], uint32_t (&hi)[4][2],
                                            uint32_t w0, uint32_t w1, uint32_t w8, uint32_t w9) {
  lo[I][0] = nib2_bf16<I, false>(w0, w1);
  lo[I][1] = nib2_bf16<I, false>(w8, w9);
  hi[I][0] = nib2_bf16<I, true>(w0 >> 4, w1 >> 4);
  hi[I][1] = nib2_bf16<I, true>(w8 >> 4, w9 >> 4);
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
