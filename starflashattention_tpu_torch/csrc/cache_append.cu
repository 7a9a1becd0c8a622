// In-place KV-cache row append for Hopper (sm_90a).
//
// Replaces: starflashattention_tpu/ops/cache_append.py::_append_kernel_kv
// (entry append_rows_kv); the one-table form _append_kernel_one
// (append_rows) is the same kernel with the V table left out; and
// ::_append_kernel_paged (entry append_rows_paged_kv), the same kernel with
// the row address read through a page table; and ::_append_block_kernel_kv
// (entry append_block_kv, speculative decoding's verify step), the T-row
// form below (append_block_kernel).
//
// Computes table[layer, b, h, pos[b], :] = new[b, h, :] for the K and the V
// table, in place; in paged mode pool[layer, h, page_table[b, pos[b] / ps],
// pos[b] % ps, :] = new[b, h, :] for the K and the V page pools; in block
// mode table[layer, b, h, pos[b] + j, :] = new[b, h, j, :] for j < n_valid[b].
// The block mode moves T times the bytes of the one-row mode (2 tables *
// B * Hkv * T * D elements, 160 KiB at T = 5, B = 8, bf16) and is as
// launch-bound. The model's decode and verify steps launch none of these:
// flash_decode_split.cu writes their rows in the attention's own launch;
// these stay as the ports of JAX's public append entries.
//
// Bound: 2 * B * Hkv * D elements read and written (64 KiB at B=16, Hkv=8,
// D=128, bf16) — far too little to load the memory system, so the kernel is
// bound by launch latency. Design: one block per (b, kv head) copies its
// row(s) with 16-byte vector accesses when the row width allows it, and
// bytes otherwise, so every cache dtype (bf16, fp32, int8, fp8) takes the
// same code. The TPU kernels' 16/32-row read-modify-write window
// (_window_for, _rmw_body) and their head_dim % 128 check exist only for the
// TPU's tiled DMAs and are not carried over. The layer is a pointer offset
// into the (L, B, Hkv, S, D) table or the (L, Hkv, P, ps, D) pool; in paged
// mode the block reads its physical page from the (B, pages_per_seq) table.
// Positions outside [0, S) (paged: [0, pages_per_seq * ps)) are skipped (the
// caller clamps them). A table entry of 0 (the null page of an inactive
// slot) is written like any other page.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// page_table null: contiguous (L, B, Hkv, S, D) tables. Otherwise paged
// (L, Hkv, num_pages, page_size, D) pools, S = pages_per_seq * page_size.
__global__ void append_rows_kernel(char* __restrict__ k_table, char* __restrict__ v_table,
                                   const char* __restrict__ k_new,
                                   const char* __restrict__ v_new,
                                   const int* __restrict__ pos,
                                   const int* __restrict__ page_table, long long layer, int B,
                                   int Hkv, int S, int num_pages, int page_size,
                                   int pages_per_seq, int row_bytes, int vec16) {
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv, h = bh % Hkv;
  const int p = pos[b];
  if (p < 0 || p >= S) return;
  long long row;
  if (page_table) {
    const long long page = page_table[(long long)b * pages_per_seq + p / page_size];
    row = ((layer * Hkv + h) * num_pages + page) * page_size + p % page_size;
  } else {
    row = ((layer * B + b) * (long long)Hkv + h) * S + p;
  }
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

// Block mode (replaces ::_append_block_kernel_kv, entry append_block_kv):
// table[layer, b, h, pos[b] + j, :] = new[b, h, j, :] for j < n_valid[b],
// for the K and the V table. The rows of one (b, h) are contiguous on both
// sides, so one block per (b, kv head) copies one span of n * row_bytes
// bytes (16-byte vectors when vec16, else bytes). Rows at pos + j outside
// [0, S) are skipped. The TPU kernel's 2-window read-modify-write slab, its
// pre-shift of the new rows into a zero block and its T <= window limit
// exist for VMEM tiling only and are not carried over.
__global__ void append_block_kernel(char* __restrict__ k_table, char* __restrict__ v_table,
                                    const char* __restrict__ k_new,
                                    const char* __restrict__ v_new,
                                    const int* __restrict__ pos,
                                    const int* __restrict__ n_valid, long long layer, int B,
                                    int Hkv, int S, int T, int row_bytes, int vec16) {
  const int bh = blockIdx.x;  // b * Hkv + h
  const int b = bh / Hkv;
  const int p = pos[b];
  const int lo = max(0, -p);                          // first row inside the table
  const int hi = min(min(n_valid[b], T), S - p);      // one past the last
  if (hi <= lo) return;
  const long long dst_row = ((layer * B + b) * (long long)Hkv + bh % Hkv) * S + p + lo;
  const long long src_row = (long long)bh * T + lo;
  const long long n_bytes = (long long)(hi - lo) * row_bytes;
  char* dk = k_table + dst_row * row_bytes;
  char* dv = v_table + dst_row * row_bytes;
  const char* sk = k_new + src_row * row_bytes;
  const char* sv = v_new + src_row * row_bytes;
  if (vec16) {
    const long long n = n_bytes / 16;
    for (long long i = threadIdx.x; i < n; i += blockDim.x) {
      reinterpret_cast<uint4*>(dk)[i] = reinterpret_cast<const uint4*>(sk)[i];
      reinterpret_cast<uint4*>(dv)[i] = reinterpret_cast<const uint4*>(sv)[i];
    }
  } else {
    for (long long i = threadIdx.x; i < n_bytes; i += blockDim.x) {
      dk[i] = sk[i];
      dv[i] = sv[i];
    }
  }
}

int threads_for(int row_bytes, int vec16) {
  const int units = vec16 ? row_bytes / 16 : row_bytes;
  const int threads = units < 128 ? ((units + 31) / 32) * 32 : 128;
  return threads < 32 ? 32 : threads;
}

__global__ void empty_kernel() {}

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
  append_rows_kernel<<<B * Hkv, threads_for(row_bytes, vec16), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_table), static_cast<char*>(v_table),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      static_cast<const int*>(pos), nullptr, layer, B, Hkv, S, 0, 0, 0, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

// k_pool/v_pool: (L, Hkv, num_pages, page_size, D) contiguous; k_new/v_new:
// (B, Hkv, D) contiguous, same dtype; pos: (B,) int32 logical positions;
// page_table: (B, pages_per_seq) int32 physical page ids, all on the device.
int append_rows_paged(void* k_pool, void* v_pool, const void* k_new, const void* v_new,
                      const void* pos, const void* page_table, int layer, int B, int Hkv,
                      int num_pages, int page_size, int pages_per_seq, int row_bytes,
                      int vec16, void* stream) {
  append_rows_kernel<<<B * Hkv, threads_for(row_bytes, vec16), 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      static_cast<const int*>(pos), static_cast<const int*>(page_table), layer, B, Hkv,
      pages_per_seq * page_size, num_pages, page_size, pages_per_seq, row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

// k_table/v_table: (L, B, Hkv, S, D) contiguous; k_new/v_new: (B, Hkv, T, D)
// contiguous, same dtype; pos, n_valid: (B,) int32 on the device. Writes
// rows pos[b] + j for j < n_valid[b] (and inside [0, S)) of layer `layer`.
int append_block(void* k_table, void* v_table, const void* k_new, const void* v_new,
                 const void* pos, const void* n_valid, int layer, int B, int Hkv, int S, int T,
                 int row_bytes, int vec16, void* stream) {
  append_block_kernel<<<B * Hkv, threads_for(T * row_bytes, vec16), 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_table), static_cast<char*>(v_table),
      static_cast<const char*>(k_new), static_cast<const char*>(v_new),
      static_cast<const int*>(pos), static_cast<const int*>(n_valid), layer, B, Hkv, S, T,
      row_bytes, vec16);
  return static_cast<int>(cudaGetLastError());
}

// One block of 32 threads that does nothing: the launch floor the appends
// above sit on (chip_smoke.py's phase 2 times it with the kernels' timer).
int launch_floor(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
