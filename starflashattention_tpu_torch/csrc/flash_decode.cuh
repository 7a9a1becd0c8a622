// Decode attention over MLA's latent row (head_dim 640), on a multi-layer
// contiguous KV cache or a paged KV pool, for Hopper (sm_90a): the kernel,
// included by flash_decode.cu.
//
// Replaces, at D 640: starflashattention_tpu/ops/flash_decode.py::
// _decode_kernel_fused (single split, entry flash_decode with num_splits =
// 1) and starflashattention_tpu/ops/paged_decode.py::_paged_decode_kernel
// (entry paged_flash_decode). Head_dims 64, 128 and 256 have their own
// kernel, flash_decode_split.cu, which splits the KV walk across blocks.
// One kernel, templated on where a KV row lives, with two output modes:
//  * fused (num_splits == 1): the normalized output in q's dtype, with the
//    l == 0 -> 1 guard;
//  * partials: unnormalized o (B, Hq, N, D) fp32 and the natural-log
//    running max m and sum l (B, Hq, N) fp32, merged afterwards by
//    lse_combine_splits. A split that holds no valid position writes
//    m = NEG_INF, l = 0, o = 0. The wrappers do not reach it yet (ROADMAP
//    Queue 2a: K2 at D 640).
//
// MLA's latent row (bf16 q and bf16 K/V, no window, sinks, softcap or
// verify span): DeepSeek-V2 caches one 640-lane row a token (kv_lora_rank
// 512 + rope 64, padded) that all 16 query heads attend, so a block holds
// G = 16 rows of 640 fp32 accumulators. Shared memory at BK 32: the K tile
// 32 x 642 and the V tile 32 x 640 in bf16, q and acc 2 x 16 x 640 fp32,
// about 166 KB (opt-in, under 227 KB). With one latent head the grid is only
// (1, 1, B) blocks, so a block runs 512 threads to spread a tile's 16 x 32
// scores and 16 x 640 outputs; the split-KV partials would add blocks
// (ROADMAP Queue 2, K2 at D 640). This design's time was found to move
// with the size of its parameter block (DecodeArgs): on the H100, 12 more
// bytes with the same code made its fused and paged decodes at D 128 23%
// and 8% slower. Without the other head_dims' verify span and quantized
// output the block is 112 bytes.
//
// q: (B, Hq, D); k/v: the (B, Hkv, S, D) table of one layer (the wrapper
// offsets the pointer into the (L, B, Hkv, S, D) table, so no per-layer copy
// exists); lengths: (B,) int32. Query head h reads KV head h / G.
//
// Paged (PAGED = true, fused mode only): k/v point at one layer's
// (Hkv, num_pages, page_size, D) slice of the (L, Hkv, P, ps, D) pools, and
// KV row j of sequence b lives at row j % ps of page page_table[b, j / ps]
// ((B, pages_per_seq) int32). At the start of each tile, the first 32
// threads resolve the tile's rows through the table into shared memory, so
// any page size works (a tile may span pages) and the null page 0 of an
// unmapped entry is never read below lengths[b]. As the JAX wrapper does, the
// paged mode folds sm_scale into q and rounds the scaled q to q's dtype
// before the dot products. The TPU kernel's DMA double buffer (_PageCopies),
// its pages_per_compute_block grid and its prefetch-chain rule are TPU
// scheduling and are not carried over.
//
// Bound: the K/V bytes read — lengths[b] * D * 2 tables * 2 bytes per
// sequence; the 4 * len * Hq * D operations are far below the tensor-core
// rate. One block per (split, kv head, b) holds all G = Hq / Hkv query rows
// of the group, so every K/V tile is read from device memory once per group,
// not G times; each block walks only the 32-row tiles below ITS OWN
// lengths[b]. K/V tiles are staged in shared memory with 16-byte loads;
// scores, the online softmax (fp32, warp reductions) and P @ V run on the
// CUDA cores. Masked positions get p = 0 exactly, so a row of length 0
// gives 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;   // the latent row's block (see above)
constexpr int LATENT_D = 640;  // MLA's latent row
constexpr int BK = 32;  // KV rows per tile (= warp size: one score per lane)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;

__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T's precision (the tag pointer picks the overload)
__device__ __forceinline__ float round_to(float v, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(v));
}

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

template <typename KV, int D>
size_t smem_bytes(int R) {
  return sizeof(KV) * (size_t)BK * (Tile<KV, D>::KS + D) +
         sizeof(float) * ((size_t)2 * R * D + (size_t)R * BK + 3 * (size_t)R);
}

template <typename T, typename KV>
struct DecodeArgs {
  const T* q;
  const KV* k;  // one layer: (B, Hkv, S, D) table, or (Hkv, P, ps, D) pool slice
  const KV* v;
  const int* lengths;
  const int* page_table;  // paged only: (B, pages_per_seq)
  T* out;                 // fused mode, in q's dtype
  float* o_part;          // partials mode
  float* m_part;
  float* l_part;
  int Hq, Hkv, S;  // S: table rows, or pages_per_seq * page_size
  int num_splits, split_len;
  int pages_per_seq, page_size, num_pages;
  float scale;
  int fold_scale;  // 1: q * scale rounded to T before the dots (paged)
};

template <typename T, typename KV, int D, bool PAGED>
__global__ void __launch_bounds__(THREADS) flash_decode_kernel(const DecodeArgs<T, KV> a) {
  constexpr int NT = THREADS;
  using TL = Tile<KV, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long row_off[BK];  // paged: element offset of each tile row
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int R = G;  // query rows
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  constexpr int NWARPS = NT / 32;

  KV* k_s = reinterpret_cast<KV*>(smem_raw);     // [BK][KS]
  KV* v_s = k_s + BK * TL::KS;                   // [BK][D]
  float* q_s = reinterpret_cast<float*>(v_s + BK * D);  // [R][D]
  float* acc = q_s + R * D;                      // [R][D]
  float* s_s = acc + R * D;                      // [R][BK]
  float* m_s = s_s + R * BK;                     // [R]
  float* l_s = m_s + R;                          // [R]
  float* a_s = l_s + R;                          // [R] rescale factor of this tile

  // first query row of the group: q head (b, kvh * G)
  const size_t row0 = (size_t)b * a.Hq + (size_t)kvh * G;
  for (int i = tid; i < R * D; i += NT) {
    const float x = to_f(a.q[row0 * D + i]);
    q_s[i] = a.fold_scale ? round_to(x * a.scale, a.q) : x;
    acc[i] = 0.f;
  }
  const float s_scale = a.fold_scale ? 1.f : a.scale;
  for (int r = tid; r < R; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  __syncthreads();

  const int len = min(a.lengths[b], a.S);
  const int start = split * a.split_len;
  const int end = min(start + a.split_len, len);
  const KV* kb = a.k;
  const KV* vb = a.v;
  if constexpr (!PAGED) {
    kb += ((size_t)b * a.Hkv + kvh) * (size_t)a.S * D;
    vb += ((size_t)b * a.Hkv + kvh) * (size_t)a.S * D;
  }

  for (int j0 = start; j0 < end; j0 += BK) {
    const int nrows = min(BK, end - j0);
    if constexpr (PAGED) {
      if (tid < BK) {
        long long off = 0;
        if (tid < nrows) {
          const int j = j0 + tid;
          const long long page = a.page_table[(size_t)b * a.pages_per_seq + j / a.page_size];
          off = (((long long)kvh * a.num_pages + page) * a.page_size + j % a.page_size) * D;
        }
        row_off[tid] = off;
      }
      __syncthreads();
    }
    // Stage the K and V tiles (rows past nrows are zero-filled: p = 0 never
    // meets uninitialized memory).
    const uint4* ksrc = reinterpret_cast<const uint4*>(kb + (size_t)j0 * D);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vb + (size_t)j0 * D);
    for (int i = tid; i < BK * D / TL::VEC; i += NT) {
      const int row = (i * TL::VEC) / D, col = (i * TL::VEC) % D;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (row < nrows) {
        if constexpr (PAGED) {
          kv = *reinterpret_cast<const uint4*>(kb + row_off[row] + col);
          vv = *reinterpret_cast<const uint4*>(vb + row_off[row] + col);
        } else {
          kv = ksrc[i];
          vv = vsrc[i];
        }
      }
      uint32_t* kd = reinterpret_cast<uint32_t*>(k_s + row * TL::KS + col);
      kd[0] = kv.x;
      kd[1] = kv.y;
      kd[2] = kv.z;
      kd[3] = kv.w;
      reinterpret_cast<uint4*>(v_s)[i] = vv;
    }
    __syncthreads();

    for (int i = tid; i < R * BK; i += NT) {
      const int g = i / BK, j = i % BK;
      float s = NEG_INF;
      if (j < nrows) {
        const float* qg = q_s + g * D;
        const KV* kj = k_s + j * TL::KS;
        float acc_s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc_s += qg[d] * to_f(kj[d]);
        s = acc_s * s_scale;
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < R; g += NWARPS) {
      const bool ok = lane < nrows;
      const float s = s_s[g * BK + lane];
      const float m_old = m_s[g];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float p = ok ? expf(s - m_new) : 0.f;
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

    for (int i = tid; i < R * D; i += NT) {
      const int g = i / D, d = i % D;
      const float* pg = s_s + g * BK;
      float o = acc[i] * a_s[g];
      for (int j = 0; j < nrows; ++j) o += pg[j] * to_f(v_s[j * D + d]);
      acc[i] = o;
    }
    __syncthreads();
  }

  if (a.out != nullptr) {
    for (int i = tid; i < R * D; i += NT) {
      const float l = l_s[i / D];
      from_f(a.out + row0 * D + i, acc[i] / (l == 0.f ? 1.f : l));
    }
  } else {  // partials
    for (int i = tid; i < G * D; i += NT) {
      const size_t h = row0 + i / D;
      a.o_part[(h * a.num_splits + split) * D + i % D] = acc[i];
    }
    for (int g = tid; g < G; g += NT) {
      const size_t h = row0 + g;
      a.m_part[h * a.num_splits + split] = m_s[g];
      a.l_part[h * a.num_splits + split] = l_s[g];
    }
  }
}

template <bool PAGED>
cudaError_t launch(const DecodeArgs<__nv_bfloat16, __nv_bfloat16>& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<__nv_bfloat16, LATENT_D>(a.Hq / a.Hkv);
  auto kernel = flash_decode_kernel<__nv_bfloat16, __nv_bfloat16, LATENT_D, PAGED>;
  if (smem + BK * sizeof(long long) > 48 * 1024) {  // dynamic + the static row_off
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(a.num_splits, a.Hkv, B);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// bf16 q (B, Hq, 640); k, v: one layer's (B, Hkv, S, 640) bf16 table;
// lengths (B,) int32. Fused mode: out (B, Hq, 640) bf16 non-null, partial
// pointers null, num_splits 1. Partials mode: out null; o_part
// (B, Hq, N, 640), m_part/l_part (B, Hq, N). ``scale`` multiplies the scores.
int flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 void* o_part, void* m_part, void* l_part, int B, int Hq, int Hkv, int S,
                 int num_splits, int split_len, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv || num_splits < 1 || split_len < 1) return cudaErrorInvalidValue;
  if (out != nullptr && num_splits != 1) return cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
  const DecodeArgs<BF, BF> a{static_cast<const BF*>(q), static_cast<const BF*>(k), static_cast<const BF*>(v),
                             static_cast<const int*>(lengths), nullptr, static_cast<BF*>(out),
                             static_cast<float*>(o_part), static_cast<float*>(m_part),
                             static_cast<float*>(l_part), Hq, Hkv, S, num_splits, split_len, 0, 1, 0,
                             scale, 0};
  return static_cast<int>(launch<false>(a, B, static_cast<cudaStream_t>(stream)));
}

// bf16 q (B, Hq, 640); k, v: one layer's (Hkv, num_pages, page_size, 640)
// slice of the bf16 pools; page_table (B, pages_per_seq) int32; lengths (B,)
// int32; out (B, Hq, 640) bf16, normalized; rows of length 0 give 0. q *
// scale is rounded to bf16 in the kernel.
int paged_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                       const void* page_table, void* out, int B, int Hq, int Hkv, int num_pages,
                       int page_size, int pages_per_seq, float scale, void* stream) {
  if (Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  using BF = __nv_bfloat16;
  const int S = pages_per_seq * page_size;
  const DecodeArgs<BF, BF> a{static_cast<const BF*>(q), static_cast<const BF*>(k), static_cast<const BF*>(v),
                             static_cast<const int*>(lengths), static_cast<const int*>(page_table),
                             static_cast<BF*>(out), nullptr, nullptr, nullptr, Hq, Hkv, S, 1, S,
                             pages_per_seq, page_size, num_pages, scale, 1};
  return static_cast<int>(launch<true>(a, B, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
