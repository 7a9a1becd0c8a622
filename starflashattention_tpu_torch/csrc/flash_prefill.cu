// Causal prefill attention (FlashAttention-2 forward) for Hopper (sm_90a).
//
// Replaces: starflashattention_tpu/ops/flash_prefill.py::_prefill_kernel
// (entry flash_prefill) in the form the model's prefill uses: causal, with
// per-sequence lengths and q_offsets, no window, sinks, softcap or LSE.
//
// q: (B, Hq, Sq, D) bf16; k, v: (B, Hkv, Skv, D) bf16 (in the model, one
// layer of the cache table, passed as a pointer into it); lengths and
// q_offsets: (B,) int32. Query row i of sequence b sits at absolute
// position q_offsets[b] + i and attends KV positions j <= q_offsets[b] + i
// with j < lengths[b]. Query head h reads KV head h / G. A row with no
// valid position gives 0; rows past Sq are never written.
//
// Bound: at the model's prefill shapes (a few hundred rows per sequence,
// D = 128) the 4 * D operations per (query, key) pair under the causal mask
// bound it at the tensor-core rate; the bytes (q, the valid K/V prefix, the
// output) are small next to them. Design: one block per (q tile, KV head,
// b) holds all G query heads of the group, so each K/V tile staged in
// shared memory serves G heads. Each warp owns 16 query rows of one head
// and runs both products on the tensor cores with mma.sync.m16n8k16 (bf16
// in, fp32 accumulate): Q fragments stay in registers for the whole walk,
// K fragments load straight from shared memory, V fragments through
// ldmatrix.trans, and P goes from the score accumulators to the PV operand
// without touching memory. The online softmax runs in fp32 (quad shuffles
// for the row max; the row sum is reduced once at the end). The block walks
// KV tiles only up to min(lengths[b], last position of its rows); a warp
// whose rows all precede a tile skips its arithmetic. Not yet: copies
// overlapped with compute (cp.async / TMA), wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;  // KV rows per shared-memory tile
constexpr int MAX_THREADS = 256;  // 8 warps: up to 255 registers a thread
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

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

// Four transposed 8x8 b16 matrices from shared memory; lane l gives the
// address of row (l % 8) of matrix (l / 8).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

template <int D>
__global__ void __launch_bounds__(MAX_THREADS)
    flash_prefill_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, const int* __restrict__ lengths,
                         const int* __restrict__ q_offsets, __nv_bfloat16* __restrict__ out,
                         int Hq, int Hkv, int Sq, int Skv, int bq, float scale) {
  constexpr int ST = D + 8;  // padded smem row (elements): conflict-free fragment loads
  constexpr int KT = D / 16;  // k-steps of the QK product
  constexpr int NT = D / 8;   // n-tiles of the PV product
  constexpr int ST_N = BK / 8;  // n-tiles of the QK product
  __shared__ __align__(16) __nv_bfloat16 k_s[BK * ST];
  __shared__ __align__(16) __nv_bfloat16 v_s[BK * ST];

  const int qt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int warps_per_head = bq / 16;
  const int head = kvh * G + warp / warps_per_head;
  const int r0 = qt * bq + (warp % warps_per_head) * 16;  // this warp's first q row
  const int ra = r0 + g, rb = r0 + g + 8;                  // this lane's two rows
  const int len = min(lengths[b], Skv);
  const int qoff = q_offsets[b];
  const int pa = qoff + ra, pb = qoff + rb;                // their absolute positions
  const int warp_last = qoff + min(r0 + 15, Sq - 1);       // last position of the warp

  // The Q fragments of this warp's 16 rows, for the whole walk.
  const __nv_bfloat16* qh = q + ((size_t)b * Hq + head) * (size_t)Sq * D;
  uint32_t qa[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * D + c) : 0u;
    qa[kk][1] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * D + c) : 0u;
    qa[kk][2] = ra < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)ra * D + c + 8) : 0u;
    qa[kk][3] = rb < Sq ? *reinterpret_cast<const uint32_t*>(qh + (size_t)rb * D + c + 8) : 0u;
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D;
  const int block_last_row = min(qt * bq + bq, Sq) - 1;
  const int kv_end = min(len, qoff + block_last_row + 1);

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    for (int i = threadIdx.x; i < BK * D / 8; i += blockDim.x) {
      const int row = i / (D / 8), col = (i % (D / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (j0 + row < Skv) {
        kv = *reinterpret_cast<const uint4*>(k + kv_base + (size_t)(j0 + row) * D + col);
        vv = *reinterpret_cast<const uint4*>(v + kv_base + (size_t)(j0 + row) * D + col);
      }
      *reinterpret_cast<uint4*>(k_s + row * ST + col) = kv;
      *reinterpret_cast<uint4*>(v_s + row * ST + col) = vv;
    }
    __syncthreads();

    if (r0 < Sq && j0 <= warp_last) {  // warp-uniform
      float s[ST_N][4];
#pragma unroll
      for (int n = 0; n < ST_N; ++n) {
        s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
        const __nv_bfloat16* krow = k_s + (n * 8 + g) * ST + 2 * t;
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
          mma_bf16(s[n], qa[kk], b0, b1);
        }
      }
      // Scale and mask; row maxima over the quad of lanes sharing a row.
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int n = 0; n < ST_N; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = j0 + n * 8 + 2 * t + (e & 1);
          const int pos = e < 2 ? pa : pb;
          const bool valid = col < len && col <= pos;
          s[n][e] = valid ? s[n][e] * scale : NEG_INF;
        }
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float alpha_a = expf(m_a - mn_a), alpha_b = expf(m_b - mn_b);
      m_a = mn_a;
      m_b = mn_b;
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int n = 0; n < ST_N; ++n) {
        s[n][0] = s[n][0] == NEG_INF ? 0.f : expf(s[n][0] - mn_a);
        s[n][1] = s[n][1] == NEG_INF ? 0.f : expf(s[n][1] - mn_a);
        s[n][2] = s[n][2] == NEG_INF ? 0.f : expf(s[n][2] - mn_b);
        s[n][3] = s[n][3] == NEG_INF ? 0.f : expf(s[n][3] - mn_b);
        sum_a += s[n][0] + s[n][1];
        sum_b += s[n][2] + s[n][3];
      }
      l_a = l_a * alpha_a + sum_a;  // this lane's share; reduced over the quad at the end
      l_b = l_b * alpha_b + sum_b;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[n][0] *= alpha_a;
        o[n][1] *= alpha_a;
        o[n][2] *= alpha_b;
        o[n][3] *= alpha_b;
      }
      // O += P @ V: the score accumulators of two adjacent n-tiles are the
      // A fragment of one 16-deep k-step.
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t pf[4];
        pf[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
        pf[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
        pf[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pf[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        const int mi = lane >> 3, rr = lane & 7;
        const __nv_bfloat16* vrow = v_s + (kk * 16 + rr + (mi & 1) * 8) * ST + (mi >> 1) * 8;
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t vb[4];
          ldmatrix_x4_trans(vb, vrow + np * 16);
          mma_bf16(o[2 * np], pf, vb[0], vb[1]);
          mma_bf16(o[2 * np + 1], pf, vb[2], vb[3]);
        }
      }
    }
    __syncthreads();
  }

  if (r0 >= Sq) return;
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / (l_a == 0.f ? 1.f : l_a);
  const float inv_b = 1.f / (l_b == 0.f ? 1.f : l_b);
  __nv_bfloat16* oh = out + ((size_t)b * Hq + head) * (size_t)Sq * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)ra * D + c) =
          __floats2bfloat162_rn(o[n][0] * inv_a, o[n][1] * inv_a);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)rb * D + c) =
          __floats2bfloat162_rn(o[n][2] * inv_b, o[n][3] * inv_b);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths,
                   const void* q_offsets, void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                   float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  // 16 rows per warp; about 8 warps per block share each K/V tile.
  const int bq = G >= 8 ? 16 : 16 * (8 / G);
  const int threads = 32 * G * (bq / 16);
  if (threads > MAX_THREADS) return cudaErrorInvalidConfiguration;
  dim3 grid((Sq + bq - 1) / bq, Hkv, B);
  flash_prefill_kernel<D><<<grid, threads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(lengths),
      static_cast<const int*>(q_offsets), static_cast<__nv_bfloat16*>(out), Hq, Hkv, Sq, Skv,
      bq, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), out (B, Hq, Sq, D): bf16,
// contiguous. lengths, q_offsets: (B,) int32. D is 64 or 128; Hq / Hkv <= 8.
int flash_prefill(const void* q, const void* k, const void* v, const void* lengths,
                  const void* q_offsets, void* out, int B, int Hq, int Hkv, int Sq, int Skv,
                  int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (D) {
    case 64:
      e = launch<64>(q, k, v, lengths, q_offsets, out, B, Hq, Hkv, Sq, Skv, scale, s);
      break;
    case 128:
      e = launch<128>(q, k, v, lengths, q_offsets, out, B, Hq, Hkv, Sq, Skv, scale, s);
      break;
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
