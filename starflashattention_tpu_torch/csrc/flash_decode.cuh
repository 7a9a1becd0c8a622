// Decode attention over a multi-layer contiguous KV cache or a paged KV pool,
// for Hopper (sm_90a): the kernel, included by flash_decode.cu and
// flash_decode_variants.cu.
//
// Replaces: starflashattention_tpu/ops/flash_decode.py::_decode_kernel_fused
// (single split, entry flash_decode with num_splits = 1, and its verify mode
// qspan > 1, entry flash_verify) and ::_decode_kernel (split-KV partials,
// entry flash_decode_with_stats); and
// starflashattention_tpu/ops/paged_decode.py::_paged_decode_kernel (entry
// paged_flash_decode). One kernel, templated on where a KV row lives, with two
// output modes:
//  * fused (num_splits == 1): the normalized output in q's dtype, with the
//    l == 0 -> 1 guard;
//  * partials: unnormalized o (B, Hq, N, D) fp32 and the natural-log
//    running max m and sum l (B, Hq, N) fp32, merged afterwards by
//    lse_combine_splits. A split that holds no valid position writes
//    m = NEG_INF, l = 0, o = 0.
//
// Two builds of this header: flash_decode.cu (SFA_DECODE_VARIANTS 0) and
// flash_decode_variants.cu (1), each a library with the same C entry
// points; the wrappers take the second for a call with a window, sinks or a
// softcap. The first is the kernel as it was before the variants: its code
// and its 128-byte parameter block are unchanged, so models without them
// pay nothing for them. On the H100 at the serving shapes, a parameter
// block 12 bytes larger with the same code made the fused and paged
// decodes 23% and 8% slower, and one build with the variants' tests in a
// 128-byte block made the fused decode 24%, the split partials 8% and the
// paged decode 3% slower. The second build keeps the block at 128 bytes
// too (see DecodeArgs).
//
// Options (JAX _attend_block / _decode_kernel_fused, paged_decode.py
// :117-202): a softcap (cap > 0: s = cap * tanh(s / cap) on the scaled
// natural-unit score, before the mask); a sliding window W (row of length
// len attends [len - W, len)); and `sinks` (rows j < sinks stay attendable
// with a window). The walk is two segments: the sink tiles the band does
// not reach (tile starts below the band's first tile), then the band from
// the tile that holds max(len - W, 0), so no tile is attended twice. Rows
// below the band that are not sinks are never read: the staging loop
// zero-fills them, so a reclaimed page (table entry 0, the null page) or
// any row below the band is never loaded. The band test is a select after
// each row's dot product and one more term of the softmax's validity.
// Window and sinks are runtime ints (W = 1 << 30 without a window) and the
// softcap a runtime float, tested once per score outside the D-long dot
// product, so neither adds an instantiation. D is 64 or 128 (D 256 has a kernel of its
// own, flash_decode_d256.cu, which splits the KV walk across blocks).
//
// MLA's latent row (D = 640, the plain build only, bf16 q and bf16 K/V,
// decode and paged, no verify): DeepSeek-V2 caches one 640-lane row a token
// (kv_lora_rank 512 + rope 64, padded) that all 16 query heads attend, so a
// block holds G = 16 rows of 640 fp32 accumulators. Shared memory at BK 32:
// the K tile 32 x 642 and the V tile 32 x 640 in bf16, q and acc 2 x 16 x
// 640 fp32, about 166 KB (opt-in, under 227 KB). With one latent head the
// grid is only (1, 1, B) blocks, so this form runs 512 threads a block (128
// otherwise) to spread a tile's 16 x 32 scores and 16 x 640 outputs; the
// split-KV partials would add blocks (ROADMAP Queue 2, K2 at D 640).
//
// q: (B, Hq, D); k/v: the (B, Hkv, S, D) table of one layer (the wrapper
// offsets the pointer into the (L, B, Hkv, S, D) table, so no per-layer copy
// exists); lengths: (B,) int32. Query head h reads KV head h / G.
//
// Verify (qspan = T > 1, fused contiguous mode only; speculative decoding):
// q and out are (B, Hq, T, D), and query token j of sequence b attends KV
// positions < lengths[b] + j (the staircase mask). The block of (kv head,
// b) stages all G * T query rows, row r = g * T + j (head kvh * G + g,
// token j), and walks the tiles below lengths[b] + T - 1; each row masks by
// its own length (staged in shared memory once). It is an instantiation
// of the decode kernel (VERIFY = true) with the decode's tile, score,
// softmax and P @ V loops, so a tile a row sees none of leaves its (m, l,
// acc) bit-unchanged (alpha = 1, p = 0), and row j equals a decode at
// lengths + j bit for bit; the decode instantiations keep their own code.
// A verify block runs 512 threads (a decode block 128) for its T-fold work
// a tile: with B * Hkv blocks (64 at 7B shapes and 8 slots) the card is
// not full, so the block's own width sets the step's time. Shared memory
// grows with G * T (about 95 KB at G = 4, T = 17).
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
// Quantized KV: the K/V tables or pools may hold int8 or fp8-e4m3 values
// (a KV element type apart from q's T). Tiles are staged with the same
// 16-byte loads and each value is converted to float where it is read
// (exact, as the TPU kernel's upcast to q's dtype is). The dequant scales do
// not enter the kernel: as the JAX wrappers do, ops/flash_decode.py and
// ops/paged_decode.py fold sm_scale * k_scale[h] into q (the kernel then
// scales the scores by 1) and multiply v_scale[h] into the output or the
// partials. The paged mode can write its output in fp32 for that.
//
// Bound: the K/V bytes read — lengths[b] * Hkv * D * 2 tables * 2 bytes per
// sequence in bf16 (1 byte in int8 / fp8), 33.5 MB per layer at B = 16,
// Hkv = 8, D = 128 and a mean length of 512, i.e. ~10 us at 3.35 TB/s; the 4 * len * Hq * D operations
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
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef SFA_DECODE_VARIANTS
#error "include this header from flash_decode.cu or flash_decode_variants.cu"
#endif

namespace {

constexpr bool VARIANTS = SFA_DECODE_VARIANTS;

constexpr int THREADS = 128;         // decode block
constexpr int VERIFY_THREADS = 512;  // verify block: G * T rows, T times the work a tile
constexpr int LATENT_D = 640;        // MLA's latent row (see above)

// threads a block: the verify block's and the latent row's are 512 wide
template <int D, bool VERIFY>
__host__ __device__ constexpr int block_threads() {
  return VERIFY || D == LATENT_D ? VERIFY_THREADS : THREADS;
}

// Whether a q / KV type pair has the latent-row form: bf16 both, plain build.
template <typename T, typename KV>
constexpr bool has_latent_form() {
  return !VARIANTS && std::is_same_v<T, __nv_bfloat16> && std::is_same_v<KV, __nv_bfloat16>;
}
constexpr int BK = 32;  // KV rows per tile (= warp size: one score per lane)
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int NO_WINDOW = 1 << 30;  // the window argument without a window

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return static_cast<float>(v); }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return static_cast<float>(v); }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void from_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }
// v rounded to T's precision (the tag pointer picks the overload)
__device__ __forceinline__ float round_to(float v, const float*) { return v; }
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

// The variant arguments: the fields of the variants build, their "none"
// values in the plain build (whose argument struct has no such fields).
template <typename A>
__device__ __forceinline__ int window_of(const A& a) {
  if constexpr (VARIANTS) return a.window;
  else return NO_WINDOW;
}
template <typename A>
__device__ __forceinline__ int sinks_of(const A& a) {
  if constexpr (VARIANTS) return a.sinks;
  else return 0;
}
template <typename A>
__device__ __forceinline__ float softcap_of(const A& a) {
  if constexpr (VARIANTS) return a.softcap;
  else return 0.f;
}
// The next tile of the walk: the next one, or (VARIANTS) from the last sink
// tile to the band's first.
template <bool VARIANT>
__device__ __forceinline__ int next_tile(int j0, int sink_tiles_end, int band0) {
  if constexpr (VARIANT) return j0 + BK < sink_tiles_end ? j0 + BK : max(j0 + BK, band0);
  return j0 + BK;
}

// Padded row stride (elements) of the K tile in shared memory: one extra
// 32-bit word per row, so lanes reading the same column of different rows
// hit different banks.
template <typename T, int D>
struct Tile {
  static constexpr int KS = D + 4 / sizeof(T);
  static constexpr int VEC = 16 / sizeof(T);
};

// R: query rows a block holds (G, or G * T in verify mode)
template <typename KV, int D>
size_t smem_bytes(int R) {
  return sizeof(KV) * (size_t)BK * (Tile<KV, D>::KS + D) +
         sizeof(float) * ((size_t)2 * R * D + (size_t)R * BK + 3 * (size_t)R) + sizeof(int) * R;
}

template <typename T, typename KV>
struct DecodeArgs {
  const T* q;
  const KV* k;  // one layer: (B, Hkv, S, D) table, or (Hkv, P, ps, D) pool slice
  const KV* v;
  const int* lengths;
  const int* page_table;  // paged only: (B, pages_per_seq)
  T* out;                 // fused mode, in q's dtype
  float* out_f32;         // fused mode, in fp32 (instead of out)
  float* o_part;          // partials mode
  float* m_part;
  float* l_part;
  int Hq, Hkv, S;  // S: table rows, or pages_per_seq * page_size
#if !SFA_DECODE_VARIANTS
  int num_splits, split_len;
#endif
  int qspan;  // T query tokens per sequence (verify), else 1
  int pages_per_seq, page_size, num_pages;
  float scale;
#if !SFA_DECODE_VARIANTS
  int fold_scale;  // 1: q * scale rounded to T before the dots (paged)
#else
  // The struct is the kernel's parameter block, and it stays at the 128
  // bytes it had before the variants: 12 more bytes made the fused and
  // paged decodes 23% and 8% slower at the serving shapes with the kernel
  // code unchanged. So the variants build, which runs one split and folds
  // the scale exactly when paged, trades num_splits, split_len and
  // fold_scale for its three fields (the *_of accessors below).
  int window;      // W: a row of length len attends [len - W, len); 1 << 30 for none
  int sinks;       // rows j < sinks stay attendable (with a window)
  float softcap;   // > 0: cap * tanh(s / cap) on the scaled score
#endif
};
static_assert(sizeof(DecodeArgs<float, float>) == 128, "the kernel's parameter block");

template <typename A>
__host__ __device__ __forceinline__ int num_splits_of(const A& a) {
  if constexpr (VARIANTS) return 1;
  else return a.num_splits;
}
template <typename A>
__device__ __forceinline__ int split_len_of(const A& a) {
  if constexpr (VARIANTS) return a.S;
  else return a.split_len;
}
template <bool PAGED, typename A>
__device__ __forceinline__ int fold_scale_of(const A& a) {
  if constexpr (VARIANTS) return PAGED;
  else return a.fold_scale;
}

// VERIFY: the qspan > 1 instantiation. The decode instantiations
// (VERIFY = false) compile with one query token a head and the tile's own
// row count, so the verify mode costs the decode nothing.
template <typename T, typename KV, int D, bool PAGED, bool VERIFY>
__global__ void __launch_bounds__(block_threads<D, VERIFY>())
    flash_decode_kernel(const DecodeArgs<T, KV> a) {
  constexpr int NT = block_threads<D, VERIFY>();
  using TL = Tile<KV, D>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ long long row_off[BK];  // paged: element offset of each tile row
  const int split = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv;
  const int span = VERIFY ? a.qspan : 1;  // T query tokens a sequence
  const int R = G * span;    // query rows: r = g * T + j
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
  int* len_s = reinterpret_cast<int*>(a_s + R);  // [R] valid KV rows of each query row

  // first query row of the group: q head (b, kvh * G), token 0
  const size_t row0 = ((size_t)b * a.Hq + (size_t)kvh * G) * span;
  for (int i = tid; i < R * D; i += NT) {
    const float x = to_f(a.q[row0 * D + i]);
    q_s[i] = fold_scale_of<PAGED>(a) ? round_to(x * a.scale, a.q) : x;
    acc[i] = 0.f;
  }
  const float s_scale = fold_scale_of<PAGED>(a) ? 1.f : a.scale;
  const int len0 = a.lengths[b];  // valid KV of query token 0
  for (int r = tid; r < R; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    if (VERIFY) len_s[r] = min(len0 + r % span, a.S);  // token j = r % T: len0 + j rows
  }
  __syncthreads();

  const int len = min(len0 + span - 1, a.S);
  const int start = split * split_len_of(a);
  const int end = min(start + split_len_of(a), len);
  const KV* kb = a.k;
  const KV* vb = a.v;
  if constexpr (!PAGED) {
    kb += ((size_t)b * a.Hkv + kvh) * (size_t)a.S * D;
    vb += ((size_t)b * a.Hkv + kvh) * (size_t)a.S * D;
  }
  // VARIANTS: the band walk. Token 0 (length len0) has the lowest band
  // start; the sink tiles below the band's first tile come first, then the
  // band itself (next_tile jumps from the last sink tile to band0).
  int lo = 0, band0 = start, sink_tiles_end = 0;
  if constexpr (VARIANTS) {
    lo = max(len0 - window_of(a), 0);
    band0 = max(start, lo / BK * BK);
    sink_tiles_end = (min(sinks_of(a), band0) + BK - 1) / BK * BK;
  }

  for (int j0 = VARIANTS && sink_tiles_end ? 0 : band0; j0 < end;
       j0 = next_tile<VARIANTS>(j0, sink_tiles_end, band0)) {
    const int nrows = min(BK, end - j0);
    const int r_lo = lo - j0, r_sk = sinks_of(a) - j0;  // VARIANTS: rows to read, >= r_lo or < r_sk
    if constexpr (PAGED) {
      if (tid < BK) {
        long long off = 0;
        if (tid < nrows && (!VARIANTS || tid >= r_lo || tid < r_sk)) {
          const int j = j0 + tid;
          const long long page = a.page_table[(size_t)b * a.pages_per_seq + j / a.page_size];
          off = (((long long)kvh * a.num_pages + page) * a.page_size + j % a.page_size) * D;
        }
        row_off[tid] = off;
      }
      __syncthreads();
    }
    // Stage the K and V tiles (rows past nrows, and with VARIANTS rows
    // below the band that are not sinks, are zero-filled: p = 0 never meets
    // uninitialized memory, and nothing below the band is read).
    const uint4* ksrc = reinterpret_cast<const uint4*>(kb + (size_t)j0 * D);
    const uint4* vsrc = reinterpret_cast<const uint4*>(vb + (size_t)j0 * D);
    for (int i = tid; i < BK * D / TL::VEC; i += NT) {
      const int row = (i * TL::VEC) / D, col = (i * TL::VEC) % D;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (row < nrows && (!VARIANTS || row >= r_lo || row < r_sk)) {
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
      // the row's own valid count in this tile (<= 0: the tile is all past it)
      const int nr = VERIFY ? min(nrows, len_s[g] - j0) : nrows;
      float s = NEG_INF;
      if (j < nr) {
        const float* qg = q_s + g * D;
        const KV* kj = k_s + j * TL::KS;
        float acc_s = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) acc_s += qg[d] * to_f(kj[d]);
        s = acc_s * s_scale;
        if constexpr (VARIANTS) {
          if (softcap_of(a) > 0.f) s = softcap_of(a) * tanhf(s / softcap_of(a));
          // a row below the band (zero-filled when staged) scores nothing
          const int lo_r = (VERIFY ? len_s[g] : len) - window_of(a);
          if (j0 + j < lo_r && j0 + j >= sinks_of(a)) s = NEG_INF;
        }
      }
      s_s[i] = s;
    }
    __syncthreads();

    for (int g = warp; g < R; g += NWARPS) {
      const int nr = VERIFY ? min(nrows, len_s[g] - j0) : nrows;
      bool ok = lane < nr;
      if constexpr (VARIANTS) {
        const int len_r = VERIFY ? len_s[g] : len;
        ok = ok && (j0 + lane >= len_r - window_of(a) || j0 + lane < sinks_of(a));
      }
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

  if (a.out != nullptr || a.out_f32 != nullptr) {
    for (int i = tid; i < R * D; i += NT) {
      const float l = l_s[i / D];
      const float o = acc[i] / (l == 0.f ? 1.f : l);
      if (a.out_f32 != nullptr) {
        a.out_f32[row0 * D + i] = o;
      } else {
        from_f(a.out + row0 * D + i, o);
      }
    }
  } else {  // partials: qspan 1, so row0 is the group's first q head
    for (int i = tid; i < G * D; i += NT) {
      const size_t h = row0 + i / D;
      a.o_part[(h * num_splits_of(a) + split) * D + i % D] = acc[i];
    }
    for (int g = tid; g < G; g += NT) {
      const size_t h = row0 + g;
      a.m_part[h * num_splits_of(a) + split] = m_s[g];
      a.l_part[h * num_splits_of(a) + split] = l_s[g];
    }
  }
}

template <typename T, typename KV, int D, bool PAGED, bool VERIFY>
cudaError_t launch(const DecodeArgs<T, KV>& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<KV, D>(a.Hq / a.Hkv * a.qspan);
  auto kernel = flash_decode_kernel<T, KV, D, PAGED, VERIFY>;
  if (smem + BK * sizeof(long long) > 48 * 1024) {  // dynamic + the static row_off
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(num_splits_of(a), a.Hkv, B);
  kernel<<<grid, block_threads<D, VERIFY>(), smem, stream>>>(a);
  return cudaGetLastError();
}

// The untyped arguments of one call, as the C entry points receive them.
struct RawArgs {
  const void *q, *k, *v, *lengths, *page_table;
  void *out, *out_f32, *o_part, *m_part, *l_part;
  int B, Hq, Hkv, S, D, num_splits, split_len, qspan, pages_per_seq, page_size, num_pages;
  float scale;
  int fold_scale;
  int window, sinks;
  float softcap;
};

template <typename T, typename KV, bool PAGED>
cudaError_t run(const RawArgs& r, cudaStream_t stream) {
  const DecodeArgs<T, KV> a{static_cast<const T*>(r.q), static_cast<const KV*>(r.k),
                            static_cast<const KV*>(r.v), static_cast<const int*>(r.lengths),
                            static_cast<const int*>(r.page_table), static_cast<T*>(r.out),
                            static_cast<float*>(r.out_f32), static_cast<float*>(r.o_part),
                            static_cast<float*>(r.m_part), static_cast<float*>(r.l_part),
                            r.Hq, r.Hkv, r.S,
#if !SFA_DECODE_VARIANTS
                            r.num_splits, r.split_len,
#endif
                            r.qspan, r.pages_per_seq, r.page_size, r.num_pages, r.scale,
#if !SFA_DECODE_VARIANTS
                            r.fold_scale
#else
                            r.window, r.sinks, r.softcap
#endif
                            };
  if constexpr (!PAGED) {
    if (r.qspan > 1) {
      switch (r.D) {
        case 64:
          return launch<T, KV, 64, false, true>(a, r.B, stream);
        case 128:
          return launch<T, KV, 128, false, true>(a, r.B, stream);
        default:
          return cudaErrorInvalidValue;
      }
    }
  }
  switch (r.D) {
    case 64:
      return launch<T, KV, 64, PAGED, false>(a, r.B, stream);
    case 128:
      return launch<T, KV, 128, PAGED, false>(a, r.B, stream);
    case LATENT_D:
      if constexpr (has_latent_form<T, KV>()) return launch<T, KV, LATENT_D, PAGED, false>(a, r.B, stream);
      return cudaErrorInvalidValue;
    default:
      return cudaErrorInvalidValue;
  }
}

// dtype: 0 = fp32 q, 1 = bf16 q; kv_dtype: 0 = q's dtype, 1 = int8, 2 = fp8-e4m3.
template <bool PAGED>
cudaError_t dispatch(int dtype, int kv_dtype, const RawArgs& r, cudaStream_t s) {
  if (dtype == 1) {
    switch (kv_dtype) {
      case 0: return run<__nv_bfloat16, __nv_bfloat16, PAGED>(r, s);
      case 1: return run<__nv_bfloat16, int8_t, PAGED>(r, s);
      case 2: return run<__nv_bfloat16, __nv_fp8_e4m3, PAGED>(r, s);
      default: return cudaErrorInvalidValue;
    }
  }
  switch (kv_dtype) {
    case 0: return run<float, float, PAGED>(r, s);
    case 1: return run<float, int8_t, PAGED>(r, s);
    case 2: return run<float, __nv_fp8_e4m3, PAGED>(r, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// q (B, Hq, D), or (B, Hq, qspan, D) in verify mode; k, v: one layer's
// (B, Hkv, S, D); lengths (B,) int32 (valid KV of query token 0).
// Fused mode: out (q's shape) in q's dtype non-null, partial pointers null,
// num_splits 1. Partials mode (qspan 1): out null; o_part (B, Hq, N, D),
// m_part/l_part (B, Hq, N). dtype: 0 = fp32, 1 = bf16 (q's dtype); kv_dtype:
// 0 = q's dtype, 1 = int8, 2 = fp8-e4m3. D is 64 or 128, or 640 for
// bf16 q and K/V in the plain build, not in verify mode. ``scale``
// multiplies the scores (the quantized path passes 1 with q prescaled).
// window (>= 1; 1 << 30 for none), sinks (>= 0), softcap (0 for none).
int flash_decode(const void* q, const void* k, const void* v, const void* lengths, void* out,
                 void* o_part, void* m_part, void* l_part, int B, int Hq, int Hkv, int S, int D,
                 int num_splits, int split_len, int qspan, float scale, int dtype, int kv_dtype,
                 int window, int sinks, float softcap, void* stream) {
  if (qspan < 1 || (qspan > 1 && (out == nullptr || num_splits != 1))) return cudaErrorInvalidValue;
  if (window < 1 || sinks < 0) return cudaErrorInvalidValue;
  if (!VARIANTS && (window != NO_WINDOW || sinks || softcap > 0.f)) return cudaErrorInvalidValue;
  if (VARIANTS && (num_splits != 1 || split_len != S)) return cudaErrorInvalidValue;
  const RawArgs r{q, k, v, lengths, nullptr, out, nullptr, o_part, m_part, l_part, B, Hq, Hkv,
                  S, D, num_splits, split_len, qspan, 0, 1, 0, scale, 0, window, sinks, softcap};
  return static_cast<int>(dispatch<false>(dtype, kv_dtype, r, static_cast<cudaStream_t>(stream)));
}

// q (B, Hq, D); k, v: one layer's (Hkv, num_pages, page_size, D) slice of
// the pools; page_table (B, pages_per_seq) int32; lengths (B,) int32;
// out (B, Hq, D), normalized, in q's dtype, or in fp32 when out_f32; rows
// of length 0 give 0. dtype, kv_dtype, window, sinks, softcap as above. q *
// scale is rounded to q's dtype in the kernel. Table entries below the band
// (reclaimed pages) are never read.
int paged_flash_decode(const void* q, const void* k, const void* v, const void* lengths,
                       const void* page_table, void* out, int B, int Hq, int Hkv, int num_pages,
                       int page_size, int pages_per_seq, int D, float scale, int dtype,
                       int kv_dtype, int out_f32, int window, int sinks, float softcap,
                       void* stream) {
  if (window < 1 || sinks < 0) return cudaErrorInvalidValue;
  if (!VARIANTS && (window != NO_WINDOW || sinks || softcap > 0.f)) return cudaErrorInvalidValue;
  const int S = pages_per_seq * page_size;
  const RawArgs r{q, k, v, lengths, page_table, out_f32 ? nullptr : out, out_f32 ? out : nullptr,
                  nullptr, nullptr, nullptr, B, Hq, Hkv, S, D, 1, S, 1, pages_per_seq, page_size,
                  num_pages, scale, 1, window, sinks, softcap};
  return static_cast<int>(dispatch<true>(dtype, kv_dtype, r, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
