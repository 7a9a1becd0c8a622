// Decode attention over a multi-layer contiguous KV cache, for Hopper (sm_90a).
//
// Replaces: starflashattention_tpu/ops/flash_decode.py::_decode_kernel_fused
// (single split, entry flash_decode with num_splits = 1) and ::_decode_kernel
// (split-KV partials, entry flash_decode_with_stats). One kernel, two output
// modes:
//  * fused (num_splits == 1): the normalized output in q's dtype, with the
//    l == 0 -> 1 guard;
//  * partials: unnormalized o (B, Hq, N, D) fp32 and the natural-log
//    running max m and sum l (B, Hq, N) fp32, merged afterwards by
//    lse_combine_splits. A split that holds no valid position writes
//    m = NEG_INF, l = 0, o = 0.
//
// q: (B, Hq, D); k/v: the (B, Hkv, S, D) table of one layer (the wrapper
// offsets the pointer into the (L, B, Hkv, S, D) table, so no per-layer copy
// exists); lengths: (B,) int32. Query head h reads KV head h / G.
//
// Bound: the K/V bytes read — lengths[b] * Hkv * D * 2 tables * 2 bytes per
// sequence in bf16, 33.5 MB per layer at B = 16, Hkv = 8, D = 128 and a mean
// length of 512, i.e. ~10 us at 3.35 TB/s; the 4 * len * Hq * D operations
// are far below the tensor-core rate. Design against that bound: one block
// per (split, kv head, b) holds all G = Hq / Hkv query rows of the group, so
// every K/V tile is read from device memory once per group, not G times;
// each block walks only the 32-row tiles below ITS OWN lengths[b] (the TPU
// kernel batches sequences per grid cell and walks to the batch group's
// maximum — a VMEM choice that does not carry over). K/V tiles are staged
// in shared memory with 16-byte loads; scores, the online softmax (fp32,
// warp reductions) and P @ V run on the CUDA cores. Masked positions get
// p = 0 exactly, so a row of length 0 gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BK = 32;  // KV rows per tile (= warp size: one score per lane)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Padded row stride (elements) of the K tile in shared memory: one extra
// 32-bit word per row, so lanes reading the same column of different rows
// hit different banks.
template <typename T, int D>
struct Tile {
  static constexpr int KS = D + 4 / sizeof(T);
  static constexpr int VEC = 16 / sizeof(T);
};

template <typename T, int D>
size_t smem_bytes(int G) {
  return sizeof(T) * (size_t)BK * (Tile<T, D>::KS + D) +
         sizeof(float) * ((size_t)2 * G * D + (size_t)G * BK + 3 * (size_t)G);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_layer,
                        const T* __restrict__ v_layer, const int* __restrict__ lengths,
                        T* __restrict__ out, float* __restrict__ o_part,
                        float* __restrict__ m_part, float* __restrict__ l_part, int Hq, int Hkv,
                        int S, int num_splits, int split_len, float scale, int fused) {
  using TL = Tile<T, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int NWARPS = THREADS / 32;

  T* k_s = reinterpret_cast<T*>(smem_raw);       // [BK][KS]
  T* v_s = k_s + BK * TL::KS;                    // [BK][D]
  float* q_s = reinterpret_cast<float*>(v_s + BK * D);  // [G][D]
  float* acc = q_s + G * D;                      // [G][D]
  float* s_s = acc + G * D;                      // [G][BK]
  float* m_s = s_s + G * BK;                     // [G]
  float* l_s = m_s + G;                          // [G]
  float* a_s = l_s + G;                          // [G] rescale factor of this tile

  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G;  // first q head of the group
  for (int i = tid; i < G * D; i += THREADS) {
    q_s[i] = to_f(q[head0 * D + i]);
    acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += THREADS) {
    m_s[g] = NEG_INF;
    l_s[g] = 0.f;
  }
  __syncthreads();

  const int len = min(lengths[b], S);
  const int start = split * split_len;
  const int end = min(start + split_len, len);
  const T* kb = k_layer + ((size_t)b * Hkv + kvh) * (size_t)S * D;
  const T* vb = v_layer + ((size_t)b * Hkv + kvh) * (size_t)S * D;

  for (int j0 = start; j0 < end; j0 += BK) {
    const int nrows = min(BK, end - j0);
    // Stage the K and V tiles (rows past nrows are zero-filled so that
    // p = 0 never meets uninitialized memory).
    const uint4* ksrc = reinterpret_cast<const uint4*>(kb + (size_t)j0 * D);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vb + (size_t)j0 * D);
    for (int i = tid; i < BK * D / TL::VEC; i += THREADS) {
      const int row = (i * TL::VEC) / D, col = (i * TL::VEC) % D;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (row < nrows) {
        kv = ksrc[i];
        vv = vsrc[i];
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * TL::KS + col);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      reinterpret_cast<uint4*>(v_s)[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < G * BK; i += THREADS) {
      const int g = i / BK, j = i % BK;
      float s = NEG_INF;
      if (j < nrows) {
        const float* qg = q_s + g * D;
        const T* kj = k_s + j * TL::KS;
        float a = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) a += qg[d] * to_f(kj[d]);
        s = a * scale;
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NWARPS) {
      const float s = s_s[g * BK + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = lane < nrows ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      s_s[g * BK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();

    for (int i = tid; i < G * D; i += THREADS) {
      const int g = i / D, d = i % D;
      const float* pg = s_s + g * BK;
      float a = acc[i] * a_s[g];
      for (int j = 0; j < nrows; ++j) a += pg[j] * to_f(v_s[j * D + d]);
      acc[i] = a;
    }
    __syncthreads();
  }

  if (fused) {
    for (int i = tid; i < G * D; i += THREADS) {
      const float l = l_s[i / D];
      from_f(out + head0 * D + i, acc[i] / (l == 0.f ? 1.f : l));
    }
  } else {
    for (int i = tid; i < G * D; i += THREADS) {
      const size_t h = head0 + i / D;
      o_part[(h * num_splits + split) * D + i % D] = acc[i];
    }
    for (int g = tid; g < G; g += THREADS) {
      const size_t h = head0 + g;
      m_part[h * num_splits + split] = m_s[g];
      l_part[h * num_splits + split] = l_s[g];
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* lengths, void* out,
                   void* o_part, void* m_part, void* l_part, int B, int Hq, int Hkv, int S,
                   int num_splits, int split_len, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t smem = smem_bytes<T, D>(G);
  auto kernel = flash_decode_kernel<T, D>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(num_splits, Hkv, B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(lengths), static_cast<T*>(out), static_cast<float*>(o_part),
      static_cast<float*>(m_part), static_cast<float*>(l_part), Hq, Hkv, S, num_splits,
      split_len, scale, out != nullptr ? 1 : 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(int D, const void* q, const void* k, const void* v, const void* lengths,
                     void* out, void* o_part, void* m_part, void* l_part, int B, int Hq,
                     int Hkv, int S, int num_splits, int split_len, float scale,
                     cudaStream_t stream) {
  switch (D) {
    case 64:
      return launch<T, 64>(q, k, v, lengths, out, o_part, m_part, l_part, B, Hq, Hkv, S,
                           num_splits, split_len, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, lengths, out, o_part, m_part, l_part, B, Hq, Hkv, S,
                            num_splits, split_len, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// q (B, Hq, D); k, v: one layer's (B, Hkv, S, D); lengths (B,) int32.
// Fused mode: out (B, Hq, D) non-null, partial pointers null, num_splits 1.
// Partials mode: out null; o_part (B, Hq, N, D), m_part/l_part (B, Hq, N).
// dtype: 0 = fp32, 1 = bf16 (q and the cache share it). D is 64 or 128.
int flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 void* o_part, void* m_part, void* l_part, int B, int Hq, int Hkv, int S, int D,
                 int num_splits, int split_len, float scale, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 1
                      ? launch_d<__nv_bfloat16>(D, q, k, v, lengths, out, o_part, m_part, l_part,
                                                B, Hq, Hkv, S, num_splits, split_len, scale, s)
                      : launch_d<float>(D, q, k, v, lengths, out, o_part, m_part, l_part, B, Hq,
                                        Hkv, S, num_splits, split_len, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
