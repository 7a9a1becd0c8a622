// In-place KV-cache row append for Hopper (sm_90a).
//
// Replaces: starflashattention_tpu/ops/cache_append.py::_append_kernel_kv
// (entry append_rows_kv); the one-table form _append_kernel_one
// (append_rows) is the same kernel with the V table left out.
//
// Computes table[layer, b, h, pos[b], :] = new[b, h, :] for the K and the V
// table, in place.
//
// Bound: 2 * B * Hkv * D elements read and written (64 KiB at B=16, Hkv=8,
// D=128, bf16) — far too little to load the memory system, so the kernel is
// bound by launch latency. Design: one block per (b, kv head) copies its
// row(s) with 16-byte vector accesses when the row width allows it, and
// bytes otherwise, so every cache dtype (bf16, fp32, int8, fp8) takes the
// same code. The TPU kernel's 16/32-row read-modify-write window and its
// head_dim % 128 check exist only for the TPU's tiled DMAs and are not
// carried over. The layer is a pointer offset into the (L, B, Hkv, S, D)
// table. Positions outside [0, S) are skipped (the caller clamps them).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void append_rows_kernel(char* __restrict__ k_table, char* __restrict__ v_table,
                                   const char* __restrict__ k_new,
                                   const char* __restrict__ v_new,
                                   const int* __restrict__ pos, long long layer, int B,
                                   int Hkv, int S, int row_bytes, int vec16) {
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  const long long row = ((layer * B + b) * (long long)Hkv + (bh % Hkv)) * S + p;
  char* dst_k = k_table + row * row_bytes;
  const char* src_k = k_new + (long long)bh * row_bytes;
  char* dst_v = v_table ? v_table + row * row_bytes : nullptr;
  const char* src_v = v_new ? v_new + (long long)bh * row_bytes : nullptr;
  if (vec16) {
    const int n = row_bytes / 16;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      reinterpret_cast<uint4*>(dst_k)[i] = reinterpret_cast<const uint4*>(src_k)[i];
      if (dst_v) reinterpret_cast<uint4*>(dst_v)[i] = reinterpret_cast<const uint4*>(src_v)[i];
    }
  } else {
    for (int i = threadIdx.x; i < row_bytes; i += blockDim.x) {
      dst_k[i] = src_k[i];
      if (dst_v) dst_v[i] = src_v[i];
    }
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// k_table/v_table: (L, B, Hkv, S, D) contiguous; k_new/v_new: (B, Hkv, D)
// contiguous, same dtype; pos: (B,) int32 on the device. v_table and v_new
// may be null (one-table append). vec16 = 1 only if row_bytes and every
// pointer are multiples of 16 bytes.
int append_rows(void* k_table, void* v_table, const void* k_new, const void* v_new,
                const void* pos, int layer, int B, int Hkv, int S, int row_bytes,
                int vec16, void* stream) {
  const int units = vec16 ? row_bytes / 16 : row_bytes;
  int threads = units < 128 ? ((units + 31) / 32) * 32 : 128;
  if (threads < 32) threads = 32;
  append_rows_kernel<<<B * Hkv, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_table), static_cast<char*>(v_table),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      static_cast<const int*>(pos), layer, B, Hkv, S, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
