// What the attention kernels share (flash_prefill.cu, flash_bwd.cu): the
// bf16 mma.sync tile, ldmatrix, cp.async with zero-fill, and the mbarriers
// that track a cp.async ring.
//
// A ring stage is filled by every thread of the block with cp.async, and
// each thread then arrives on the stage's mbarrier with
// cp.async.mbarrier.arrive.noinc: the barrier's phase completes once every
// thread's copies issued so far have landed, so a consumer waits on the
// barrier alone (no block barrier, and no wait on copies issued later).
// A stage is refilled only after a block barrier that follows its last
// reader, which is the ring's one block barrier a stage.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace attn {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

// Four 8x8 b16 matrices from shared memory at a shared-memory address
// (smem_u32); lane l gives the address of row (l % 8) of matrix (l / 8),
// and gets (row l / 4, columns 2 (l % 4), +1) of each.
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// The same, each matrix transposed.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  ldmatrix_x4_trans(r, smem_u32(p));
}

// Lane offsets (row, column) into a row-major 16 x 16 bf16 tile for
// ldmatrix_x4. a_*: matrices rows 0-7 / 8-15 at columns 0-7, then at 8-15:
// an A fragment (non-transposed), or with .trans the B fragments of two
// 8-column n-tiles of a matrix stored k-major (V in O = P V: registers 0, 1
// for columns 0-7, 2, 3 for columns 8-15). b_*: matrices rows 0-7 at
// columns 0-7 and 8-15, then rows 8-15: the B fragments of two n-tiles of
// a matrix stored n-major (K in S = Q K^T), non-transposed.
__device__ __forceinline__ int a_row(int lane) { return (lane & 7) + ((lane >> 3) & 1) * 8; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + (lane >> 4) * 8; }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

// 16 bytes global -> shared, or 16 zero bytes when !fill (src-size 0: the
// source is not read).
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, or 0 when !fill.
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool fill) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(fill ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// The barrier's current phase completes for this thread once its
// cp.async copies issued so far have landed (one of `count` arrivals).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// A barrier of `threads` threads (whole warps) under hardware barrier `id`
// (1-15; 0 is __syncthreads').
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

}  // namespace attn
