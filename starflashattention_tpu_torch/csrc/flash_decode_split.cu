// Decode attention at head_dim 64, 128, 256 and 640 for Hopper (sm_90a):
// the contiguous decode and its verify span (K1), the split-KV partials (K2)
// and the paged decode (K7), on bf16, int8 or fp8-e4m3 KV, with the window,
// sinks and softcap, and the quantized KV's scales folded in. D 640 is MLA's
// latent row (DeepSeek-V2: one 640-lane KV head that all query heads of the
// group attend), built for bf16 q on bf16 KV in the plain form only.
//
// Replaces: starflashattention_tpu/ops/flash_decode.py::_decode_kernel_fused
// (entries flash_decode with num_splits = 1 and flash_verify),
// ::_decode_kernel (entry flash_decode_with_stats) and
// starflashattention_tpu/ops/paged_decode.py::_paged_decode_kernel (entry
// paged_flash_decode).
//
// Bound: the K/V bytes the walk reads, 2 tables x D x 2 bytes a row and KV
// head in bf16 (D bytes in int8 / fp8); the 4 * D operations a (query row,
// key row) pair are far below the tensor cores' rate. One block per
// (sequence, KV head) is 64-128 blocks on 132 SMs at the serving shapes (B 8
// or 16 on Hkv 8), and only B at MLA's one latent head, each walking its
// whole length alone. So the walk is split
// (flash-decoding): block (chunk i, kv head, b) walks only the tiles of rows
// [i C, (i + 1) C) that the single-pass walk visits - the sink tiles below
// the band's first tile, then the band from the tile holding
// max(len - W, 0) - and writes fp32 (o, m, l) for its R = G * T query rows.
// The wrapper picks C (a multiple of the 32-row tile) from the table's S,
// B * Hkv and D alone, never from the lengths, so that B * Hkv * ceil(S / C)
// is about as many blocks as the card holds at once (8 an SM up to D 256,
// 1 at D 640). A chunk the walk misses writes the empty partial
// (m = NEG_INF, l = 0, o = 0). The last block of a (b, kv head) to arrive
// (an arrival counter bumped after __threadfence, reset by that block, so
// no memset launch) merges the chunks in chunk order with the natural-log
// rescale, applies the l == 0 -> 1 guard and rounds once: one launch a call.
// It computes each row's chunk weights exp(m_c - max m) and its sum l once,
// then reads the chunks' o 16 bytes a thread with 8 chunks in flight; every
// element is the same chain of the same products in chunk order.
// Because C is fixed in absolute positions and an empty chunk or a tile a
// row does not see adds exact zeros, verify token j is bit for bit the
// decode at lengths + j, and the paged and contiguous forms share the
// chunk grid.
//
// Inside a block (D threads, D / 32 warps): K and V tiles of 32 rows
// double-buffered in dynamic shared memory by 16-byte cp.async (rows below
// the band that are not sinks, and rows past the chunk, are zero-filled and
// never read, so a reclaimed page or a row below the band is never loaded; a
// paged row is resolved through the page table by the thread that copies
// it). Scores are split over D: warp w takes dimensions 32w .. 32w + 31 and
// writes its partial dot product of every (query row, key row). For bf16 q
// the warp runs them on the tensor cores (mma.sync m16n8k16 on 16-row
// blocks of q staged in bf16, K's bf16, int8 or fp8 values converted
// exactly; the products are exact and the sums fp32); for fp32 q on the
// CUDA cores, lane l taking key row l. K rows are padded by 16 bytes, so
// neither reads with bank conflicts; every thread works at G = 1 or 2, with
// no shuffles. The online softmax takes one warp a query row (a lane a key)
// and sums the D / 32 partials in a fixed pairwise order as it reads them.
// P @ V: for bf16 q on bf16 V on the tensor cores too (P as two bf16 parts
// that hold it to about 16 bits, V by ldmatrix.trans from rows padded like
// K's); otherwise one output column a thread, each V element converted once
// for all R rows, four rows at a time in independent FMA chains. Scores,
// softmax and accumulators are fp32.
//
// Why D threads at D 64 / 128 (128 at 7B-GQA's D 128, G 4; the verify block
// holds G * T = 20 rows): the work a tile is R x 32 x D products, a few
// hundred mma.sync a block, so the tile's wait on device memory, not the
// block's width, sets the time; what fills the card is the number of blocks,
// and the chunk grid supplies them (B 16 x Hkv 8 x 8 chunks at S 1024: 1,024
// blocks). A block of D threads keeps one split of the work at every D -
// a warp a 32-dimension slice of the scores and of P @ V, a thread an output
// column on the CUDA cores - and its shared memory (46 KB at D 128 in bf16,
// 35 KB of it the two K/V stages) lets 4 blocks share an SM (7 on 1-byte
// KV), each with one tile in flight while it computes on the other. A wider block would add
// warps with no slice of their own. At G 4 the m16n8k16 score tile wastes 12
// of its 16 rows (and 11 of 32 at verify's 20); the kernel is bound by
// bytes, and the tensor cores finish a tile's scores in a few dozen cycles,
// so packing two KV heads' groups into one m-tile would save nothing the
// clock can see.
//
// MLA's latent row (D 640: 640 threads, 20 warps, at most 16 rows, which
// fill one m16 tile at DeepSeek-V2-Lite's G 16): the template's layout would
// take 311,808 bytes of shared memory, over the 232,448 a block may have.
// Here q is staged straight to bf16 (the paged form's sm_scale fold is
// computed in fp32 and rounded once, as at every D), so there is no fp32
// copy of q, and the P @ V accumulators stay in registers across the tiles,
// rescaled by each tile's alpha and written out once, so there is no fp32
// accumulator array: 229,888 bytes at 16 rows (the 165,888-byte K/V ring,
// q in bf16, the partial scores), one block an SM. The bound of 640
// threads leaves at most 96 registers a thread (65,536 / 640, rounded down
// to 8), as __launch_bounds__(640, 1) would; the lane's 4 x 4 accumulators
// fit beside the score fragments with no spill. The bound states a
// minimum of blocks only for bf16 q at D 256 (min_blocks()): two, which
// its shared memory allows, so ptxas may take up to 128 registers; without
// it those forms took 64-80 and the paged VARIANTS form spilled 24 bytes.
// Stated for every D, a minimum let ptxas take 81-131 registers at D
// 64-128, which would cut the blocks an SM holds there.
//
// Partials mode (out null): the blocks write the caller's (o, m, l) at the
// caller's split geometry (C = split_len, N = num_splits) and do not merge.
//
// Quantized KV (int8 / fp8-e4m3 tables or pools, with (Hkv,) k_scales and
// v_scales): values are converted to float where read (exact: they are
// bf16 values). As the JAX wrappers do (flash_decode.py:400-409,
// paged_decode.py:341-346), sm_scale * k_scale[h] is folded into q in fp32
// and rounded to q's dtype where q is staged (the scores are then scaled by
// 1), and v_scale[h] is applied after the merge with JAX's roundings: the
// contiguous forms (decode, verify) round the normalized output to q's
// dtype, multiply by v_scale and round again (flash_decode.py:662-666); the
// paged form multiplies the fp32 output by v_scale and rounds once
// (paged_decode.py:404-406); the partials carry v_scale in their fp32 o.
// The paged form folds sm_scale into q and rounds it to q's dtype on any KV,
// as the JAX wrapper does.
//
// VARIANTS: the window, sinks and softcap are runtime arguments of the
// VARIANTS form; the plain form (no window, no sinks, no softcap) compiles
// them away. Both read the same parameter block.
//
// The folded append (replaces starflashattention_tpu/ops/cache_append.py::
// _append_kernel_kv, entry append_rows_kv, and ::_append_kernel_paged, entry
// append_rows_paged_kv, on the decode paths, and ::_append_block_kernel_kv,
// entry append_block_kv, on the verify path; the reference's
// flash_decoder_kernel writes the new K/V in its own launch too): with
// k_new / v_new (B, Hkv, T, D) in the cache's dtype (T = qspan, so the
// decode's (B, Hkv, D)), wpos (B,) and nvalid (B,) or null, the launch first
// writes rows j < nv of each sequence's new K and V at p = wp + j, wp =
// min(wpos[b], S - T) (paged: S = pages_per_seq * page_size, through the
// page table; at T = 1 that is S - 1), then attends as without it. nv is
// min(nvalid[b], T), 0 for an inactive verify row; a null nvalid writes
// all T rows (the decode's one row, written whether the row is active or
// not, as JAX's decode step does). Rows outside [0, S) are skipped. On its
// own that write moves 64 KiB at B 16, Hkv 8, D 128 in bf16 (160 KiB at
// verify's B 8, T 5) and costs a launch; here it costs a few 16-byte
// stores. In each (b, kv head) every block whose chunk [cs, cs + chunk)
// holds rows of [wp, wp + nv) owns those rows, and only those: the merging
// grid's ceil(S / C) chunks and the partials mode's split geometry both
// cover [0, S), so every row has exactly one owner, and a span that
// straddles a chunk edge has two. An owner writes its rows with 16-byte
// stores, a strided loop over the block, once its first tile's copies are
// in flight (their wait hides the stores' loads), before its walk and
// whether or not the walk is empty, and the stage() of a tile that holds
// rows of the span takes each of them from k_new / v_new (row p from the
// new rows' p - wp; a span can touch two 32-row tiles; every other tile is
// staged by a loop without that test). No block reads a row another block
// of the launch writes (a walk reads only rows of its own chunk; inactive
// paged rows write into the null page 0, which no active row reads), so
// nothing orders the blocks, and the stores are never read back through
// cp.async. The output and the tables are bit for bit those of the
// standalone append followed by the decode or the verify.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int BK = 32;  // KV rows a tile
constexpr int RG = 4;   // query rows a pass of the CUDA-core P @ V loop
constexpr int STAGES = 2;
constexpr float NEG_INF = -0.7f * 3.4028234663852886e38f;
constexpr int NO_WINDOW = 1 << 30;  // the window argument without a window
constexpr int LATENT_D = 640;       // MLA's latent row
constexpr int LATENT_ROWS = 16;     // the most query rows a D 640 block holds: one m16 tile
constexpr int MERGE_AHEAD = 8;      // chunks of o in flight a thread in the merge

// D threads a block: a warp a 32-dimension slice of the scores and of
// P @ V, a thread an output column (see above)
template <int D>
__host__ __device__ constexpr int block_threads() {
  return D;
}

struct Args {
  const void* q;  // (B, Hq, T, D) in q's dtype
  const void* k;  // one layer: (B, Hkv, S, D) table, or (Hkv, num_pages, page_size, D) pool slice
  const void* v;
  const int* lengths;     // (B,): valid KV of query token 0
  const int* page_table;  // paged: (B, pages_per_seq)
  void* out;              // merged output (q's shape) in q's dtype; null: partials
  float* o_part;          // (B, Hq, T, n_chunks, D): the workspace, or the caller's partials
  float* m_part;          // (B, Hq, T, n_chunks)
  float* l_part;
  int* arrivals;          // (B, Hkv) counters, 0 between calls (merging mode)
  const float* k_scales;  // (Hkv,) of an int8 / fp8 cache, else null
  const float* v_scales;
  const void* k_new;   // the folded append: (B, Hkv, qspan, D) rows in the cache's dtype, or null
  const void* v_new;
  const int* wpos;     // (B,) first write positions, clamped to S - qspan here
  const int* nvalid;   // (B,) rows to write (at most qspan), or null: all qspan
  int Hq, Hkv, S, qspan, chunk, n_chunks;
  int pages_per_seq, page_size, num_pages;
  float scale;
  int window, sinks;
  float softcap;
};

// The variant arguments of the VARIANTS form, their "none" values in the
// plain form.
template <bool VARIANTS>
__device__ __forceinline__ int window_of(const Args& a) {
  if constexpr (VARIANTS) return a.window;
  else return NO_WINDOW;
}
template <bool VARIANTS>
__device__ __forceinline__ int sinks_of(const Args& a) {
  if constexpr (VARIANTS) return a.sinks;
  else return 0;
}
template <bool VARIANTS>
__device__ __forceinline__ float softcap_of(const Args& a) {
  if constexpr (VARIANTS) return a.softcap;
  else return 0.f;
}

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

// 8 consecutive KV elements from shared memory, as floats (fp32 q's score loop)
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0], b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}
template <typename B8>
__device__ __forceinline__ void load8_bytes(const B8* p, float (&f)[8]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const B8* h = reinterpret_cast<const B8*>(&u);
#pragma unroll
  for (int e = 0; e < 8; ++e) f[e] = to_f(h[e]);
}
__device__ __forceinline__ void load8(const int8_t* p, float (&f)[8]) { load8_bytes(p, f); }
__device__ __forceinline__ void load8(const __nv_fp8_e4m3* p, float (&f)[8]) { load8_bytes(p, f); }

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
// p[0] + p[stride] + ... + p[(N - 1) stride], summed pairwise: the same
// order for every row
template <int N>
__device__ __forceinline__ float tree_sum(const float* p, int stride) {
  if constexpr (N == 1) return p[0];
  else return tree_sum<N / 2>(p, stride) + tree_sum<N - N / 2>(p + N / 2 * stride, stride);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }

// A K row in shared memory takes 16 bytes more than its data, so that the
// 32 lanes of a warp, one key row each, read a column without bank
// conflicts (the row stride is 4 banks past a multiple of 32 at every D).
template <typename KV, int D>
__host__ __device__ constexpr int k_row_bytes() {
  return D * static_cast<int>(sizeof(KV)) + 16;
}
template <typename KV, int D>
__host__ __device__ constexpr int stage_bytes() {
  return 2 * BK * k_row_bytes<KV, D>();  // V rows are padded alike, for ldmatrix.trans
}

// bf16 q: the scores run on the tensor cores (mma.sync, bf16 products are
// exact, fp32 sums), q staged once more in bf16, in 16-row blocks padded by
// 16 bytes a row so that ldmatrix reads it without bank conflicts.
template <typename T>
__host__ __device__ constexpr bool mma_scores() {
  return std::is_same_v<T, __nv_bfloat16>;
}
// bf16 q on bf16 V: P @ V on the tensor cores too, P (fp32) entering as two
// bf16 parts, hi = bf16(p) and lo = bf16(p - hi), which hold p to about 16
// bits (far below the output's bf16 rounding); V by ldmatrix.trans.
template <typename T, typename KV>
__host__ __device__ constexpr bool mma_pv() {
  return std::is_same_v<T, __nv_bfloat16> && std::is_same_v<KV, __nv_bfloat16>;
}
template <int D>
__host__ __device__ constexpr int qb_row() {
  return D + 8;  // bf16 elements a row of the staged q
}
// The fewest blocks an SM that the kernel's __launch_bounds__ states (0:
// none): two for bf16 q at D 256 (see above)
template <typename T, int D>
__host__ __device__ constexpr int min_blocks() {
  return D == 256 && mma_scores<T>() ? 2 : 0;
}
// MLA's latent row (built for bf16 q on bf16 KV, at most LATENT_ROWS rows):
// q staged straight to bf16 and the P @ V accumulators in registers, so
// neither q nor the accumulators have an fp32 array in shared memory
template <int D>
__host__ __device__ constexpr bool register_acc() {
  return D == LATENT_D;
}

// R: query rows a block holds (G, or G * T to verify)
template <typename T, typename KV, int D>
size_t smem_bytes(int R) {
  constexpr int NWARPS = block_threads<D>() / 32;
  const size_t q_bf16 = mma_scores<T>() ? (size_t)(R + 15) / 16 * 16 * qb_row<D>() * 2 : 0;
  const size_t q_acc = register_acc<D>() ? 0 : (size_t)2 * R * D;  // q_s and acc, fp32
  return (size_t)STAGES * stage_bytes<KV, D>() + q_bf16 +
         sizeof(float) * (q_acc + (size_t)(NWARPS + 1) * R * BK + 4 * (size_t)R);
}

// D = A(16x16, row) * B(16x8, col) + D, bf16 inputs, fp32 accumulators.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
// Two fp32 values as bf16x2 parts: hi = bf16(p), lo = bf16(p - hi).
__device__ __forceinline__ void split_bf16(float2 p, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p.x, p.y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(p.x - hf.x, p.y - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
// Two consecutive KV elements as a bf16x2 (exact: int8 and fp8-e4m3 values are bf16 values).
__device__ __forceinline__ uint32_t pair_bf16(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
template <typename B8>
__device__ __forceinline__ uint32_t pair_bf16(const B8* p) {
  __nv_bfloat162 v = __floats2bfloat162_rn(to_f(p[0]), to_f(p[1]));
  return *reinterpret_cast<uint32_t*>(&v);
}

template <typename T, typename KV, int D, bool PAGED, bool VARIANTS>
__global__ void __launch_bounds__(block_threads<D>(), min_blocks<T, D>()) decode_split_kernel(const Args a) {
  constexpr int THREADS = block_threads<D>(), NWARPS = THREADS / 32;
  static_assert(THREADS == D && D == 32 * NWARPS && BK == 32, "a column a thread, 32 dimensions a warp, a key a lane");
  static_assert(!register_acc<D>() || mma_pv<T, KV>(), "the latent row's accumulators are mma fragments");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  constexpr int KROW = k_row_bytes<KV, D>(), KT = BK * KROW, SB = stage_bytes<KV, D>(), QB_ROW = qb_row<D>();
  constexpr int PIECES_ROW = D * sizeof(KV) / 16;  // 16-byte pieces a KV row
  const int chunk = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = a.Hq / a.Hkv, span = a.qspan, R = G * span;  // row r = g * T + j
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* q = static_cast<const T*>(a.q);
  const KV* kbase = static_cast<const KV*>(a.k);
  const KV* vbase = static_cast<const KV*>(a.v);
  const int window = window_of<VARIANTS>(a), sinks = sinks_of<VARIANTS>(a);
  const float softcap = softcap_of<VARIANTS>(a);

  const int RP = (R + 15) / 16 * 16;  // R in 16-row blocks
  __nv_bfloat16* q_bf = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * SB);  // [RP][QB_ROW] (bf16 q)
  constexpr int QD = register_acc<D>() ? 0 : D;  // the fp32 arrays' row: none at D 640
  float* q_s = reinterpret_cast<float*>(smem + STAGES * SB + (mma_scores<T>() ? RP * QB_ROW * 2 : 0));  // [R][QD]
  float* acc = q_s + R * QD;                                  // [R][QD]
  float* part = acc + R * QD;                                 // [NWARPS][R][BK] partial scores
  float* s_s = part + NWARPS * R * BK;                        // [R][BK] P
  float* m_s = s_s + R * BK;
  float* l_s = m_s + R;
  float* al_s = l_s + R;                                      // this tile's rescale factor
  int* len_s = reinterpret_cast<int*>(al_s + R);              // [R] each row's valid rows
  const uint32_t kv_s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));

  const size_t row0 = ((size_t)b * a.Hq + (size_t)kvh * G) * span;  // q row of (head kvh * G, token 0)
  const int len0 = a.lengths[b];                                     // valid KV of token 0
  const int len = min(len0 + span - 1, a.S);                         // the last token's
  const int cs = chunk * a.chunk, ce = min(cs + a.chunk, len);       // this chunk's rows
  // The band walk: token 0 has the lowest band start lo; the sink tiles below
  // the band's first tile come first, then the band (skip() jumps the gap).
  const int lo = VARIANTS ? max(len0 - window, 0) : 0;
  const int band0 = lo / BK * BK;
  const int sink_end = (min(sinks, band0) + BK - 1) / BK * BK;
  auto skip = [&](int j0) { return j0 >= sink_end && j0 < band0 ? band0 : j0; };
  // element offset of KV row p of this (b, kv head) in the layer
  auto row_offset = [&](int p) -> size_t {
    if constexpr (PAGED) {
      const long long page = a.page_table[(size_t)b * a.pages_per_seq + p / a.page_size];
      return (((size_t)kvh * a.num_pages + page) * a.page_size + p % a.page_size) * D;
    } else {
      return (((size_t)b * a.Hkv + kvh) * a.S + p) * D;
    }
  };

  // The folded append: rows [w0, w1) of this (b, kv head) are new rows,
  // row p at new_row + (p - wp) rows of k_new / v_new; the blocks whose
  // chunks hold them write them to the table (below, once their first tile
  // is in flight)
  int wp = 0, w0 = 0, w1 = 0;
  if (a.wpos != nullptr) {
    wp = min(a.wpos[b], a.S - span);
    const int nv = a.nvalid != nullptr ? min(max(a.nvalid[b], 0), span) : span;
    w0 = max(wp, 0);
    w1 = min(wp + nv, a.S);
  }
  const size_t new_row = ((size_t)b * a.Hkv + kvh) * span;
  auto new_byte = [&](int p) { return (new_row + (p - wp)) * D * sizeof(KV); };

  // Stage the tile at j0 into buffer buf: rows past the chunk, and rows below
  // the band that are not sinks, are zero-filled and not read. A tile that
  // holds rows of [w0, w1) takes them from the new rows; every other tile
  // runs the loop without that test (holds_new false).
  auto stage_tile = [&](int j0, int buf, auto holds_new) {
    const uint32_t kd = kv_s + buf * SB, vd = kd + KT;
    for (int i = tid; i < BK * PIECES_ROW; i += THREADS) {
      const int row = i / PIECES_ROW, piece = i % PIECES_ROW;
      const int p = j0 + row;
      const bool ok = p < ce && (!VARIANTS || p >= lo || p < sinks);
      const char* ks = reinterpret_cast<const char*>(kbase);
      const char* vs = reinterpret_cast<const char*>(vbase);
      size_t byte = piece * 16;
      if (decltype(holds_new)::value && p >= w0 && p < w1) {
        ks = static_cast<const char*>(a.k_new);
        vs = static_cast<const char*>(a.v_new);
        byte += new_byte(p);
      } else if (ok) {
        byte += row_offset(p) * sizeof(KV);
      }
      cp_async16(kd + row * KROW + piece * 16, ks + byte, ok ? 16 : 0);
      cp_async16(vd + row * KROW + piece * 16, vs + byte, ok ? 16 : 0);
    }
  };
  auto stage = [&](int j0, int buf) {
    if (w0 < j0 + BK && w1 > j0) stage_tile(j0, buf, std::true_type{});
    else stage_tile(j0, buf, std::false_type{});
  };

  // q is scaled by sm_scale (times k_scale[h] on quantized KV) and rounded
  // to its dtype where it is staged, on the paged form and on quantized KV;
  // otherwise the scores are scaled by sm_scale
  const bool fold = PAGED || a.k_scales != nullptr;
  const float q_scale = a.k_scales != nullptr ? a.scale * a.k_scales[kvh] : a.scale;
  const float s_scale = fold ? 1.f : a.scale;
  int j0 = skip(cs);
  if (j0 < ce) {
    stage(j0, 0);
    cp_async_commit();
    if constexpr (register_acc<D>()) {
      for (int i = tid; i < RP * D; i += THREADS) {  // rows past R are zeros; one rounding to bf16
        const float x = i < R * D ? to_f(q[row0 * D + i]) : 0.f;
        q_bf[i / D * QB_ROW + i % D] = __float2bfloat16(fold ? x * q_scale : x);
      }
    } else {
      for (int i = tid; i < R * D; i += THREADS) {
        const float x = to_f(q[row0 * D + i]);
        q_s[i] = fold ? round_to(x * q_scale, q) : x;
      }
      if constexpr (mma_scores<T>()) {
        for (int i = tid; i < RP * D; i += THREADS)  // rows past R are zeros
          q_bf[i / D * QB_ROW + i % D] = __float2bfloat16(i < R * D ? q_s[i] : 0.f);
      }
    }
  }
  // the owner writes its rows of the span with 16-byte stores, whether or
  // not its walk is empty (a decode's inactive row still writes at its
  // stale position); no block of the launch reads those rows of the table
  {
    const int r0 = max(w0, cs), r1 = min(w1, cs + a.chunk);
    for (int i = tid; i < (r1 - r0) * PIECES_ROW; i += THREADS) {
      const int p = r0 + i / PIECES_ROW;
      const size_t piece = (size_t)(i % PIECES_ROW) * 16;
      const size_t dst = row_offset(p) * sizeof(KV) + piece, src = new_byte(p) + piece;
      *reinterpret_cast<uint4*>(static_cast<char*>(const_cast<void*>(a.k)) + dst) =
          *reinterpret_cast<const uint4*>(static_cast<const char*>(a.k_new) + src);
      *reinterpret_cast<uint4*>(static_cast<char*>(const_cast<void*>(a.v)) + dst) =
          *reinterpret_cast<const uint4*>(static_cast<const char*>(a.v_new) + src);
    }
  }
  for (int i = tid; i < R * QD; i += THREADS) acc[i] = 0.f;
  // D 640: lane (g, t) of warp w holds rows g, g + 8 and dimensions
  // 32w + 8i + 2t, + 1 of the P @ V accumulators (racc[i][2h + e]: row
  // g + 8h, dimension 32w + 8i + 2t + e), in registers across the tiles
  float racc[4][4] = {};
  for (int r = tid; r < R; r += THREADS) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
    // token j = r % T sees len0 + j rows; unclamped, so that its band starts
    // at len0 + j - window (ce <= S stops the rows past the table)
    len_s[r] = len0 + r % span;
  }

  int buf = 0;
  while (j0 < ce) {
    cp_async_wait_all();
    __syncthreads();  // tile j0 has landed; every thread is done with the other buffer
    const int jn = skip(j0 + BK);
    if (jn < ce) {
      stage(jn, buf ^ 1);
      cp_async_commit();
    }

    // scores, split over D: warp w takes dimensions 32w .. 32w + 31 and
    // writes its partial dot product of every (query row, key row)
    if constexpr (mma_scores<T>()) {
      // on the tensor cores: 16 query rows x 32 keys a block of rows, two
      // k16 steps; lane (g, t) holds rows g, g + 8 and keys 8i + 2t, + 1
      const int g = lane >> 2, t = lane & 3;
      const uint32_t q_addr = static_cast<uint32_t>(__cvta_generic_to_shared(q_bf));
      for (int rb = 0; rb < R; rb += 16) {
        float c[4][4] = {};
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k0 = 32 * warp + 16 * ks;
          uint32_t af[4];
          ldmatrix_x4(af, q_addr + ((rb + (lane & 15)) * QB_ROW + k0 + 8 * (lane >> 4)) * 2);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const KV* kr = reinterpret_cast<const KV*>(smem + buf * SB + (8 * i + g) * KROW) + k0 + 2 * t;
            const uint32_t bf[2] = {pair_bf16(kr), pair_bf16(kr + 8)};
            mma_bf16(c[i], af, bf);
          }
        }
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = rb + g + 8 * h;
          if (r < R) {
#pragma unroll
            for (int i = 0; i < 4; ++i)
              *reinterpret_cast<float2*>(part + (warp * R + r) * BK + 8 * i + 2 * t) =
                  make_float2(c[i][2 * h], c[i][2 * h + 1]);
          }
        }
      }
    } else {
      // on the CUDA cores (fp32 q): lane l takes key row l
      const KV* kr = reinterpret_cast<const KV*>(smem + buf * SB + lane * KROW) + 32 * warp;
      float kf[4][8];
#pragma unroll
      for (int c = 0; c < 4; ++c) load8(kr + 8 * c, kf[c]);
      for (int r = 0; r < R; ++r) {
        const float4* qr = reinterpret_cast<const float4*>(q_s + r * D + 32 * warp);
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float4 qv = qr[c];
          d0 = fmaf(qv.x, kf[c / 2][4 * (c % 2)], d0);
          d1 = fmaf(qv.y, kf[c / 2][4 * (c % 2) + 1], d1);
          d2 = fmaf(qv.z, kf[c / 2][4 * (c % 2) + 2], d2);
          d3 = fmaf(qv.w, kf[c / 2][4 * (c % 2) + 3], d3);
        }
        part[(warp * R + r) * BK + lane] = (d0 + d1) + (d2 + d3);
      }
    }
    __syncthreads();

    // online softmax: a warp a row, a lane a key; the score is the warps'
    // partials summed in a fixed order, the same for every row
    for (int r = warp; r < R; r += NWARPS) {
      const float dot = tree_sum<NWARPS>(part + r * BK + lane, R * BK);
      // the row's own valid rows: its length, the chunk's end, its band
      const int len_r = len_s[r];
      const int p = j0 + lane;
      const bool ok = p < min(ce, len_r) && (!VARIANTS || p >= len_r - window || p < sinks);
      float s = dot * s_scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = ok ? s : NEG_INF;
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, warp_max(s));
      const float pr_ = ok ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(pr_);
      s_s[r * BK + lane] = pr_;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
        al_s[r] = alpha;
      }
    }
    __syncthreads();

    if constexpr (mma_pv<T, KV>()) {
      // P @ V on the tensor cores: warp w takes dimensions 32w .. 32w + 31
      // of 16 query rows at a time, two k16 steps of keys; lane (g, t)
      // holds rows g, g + 8 and dimensions 32w + 8i + 2t, + 1
      const int g = lane >> 2, t = lane & 3;
      const uint32_t v_addr = kv_s + buf * SB + KT;
      auto pv_rows = [&](float (&c)[4][4], int rb) {  // c += P[rb .. rb + 15] @ V (this warp's dimensions)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const int k0 = 16 * ks;
          uint32_t ahi[4], alo[4];  // (g, k0 + 2t), (g + 8, k0 + 2t), (g, k0 + 2t + 8), (g + 8, ...)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = rb + g + 8 * (e & 1), k = k0 + 2 * t + 8 * (e >> 1);
            const float2 pv = r < R ? *reinterpret_cast<const float2*>(s_s + r * BK + k) : make_float2(0.f, 0.f);
            split_bf16(pv, ahi[e], alo[e]);
          }
#pragma unroll
          for (int np = 0; np < 2; ++np) {  // n8 tiles 2np, 2np + 1: dimensions 32w + 16np ..
            const int mtx = lane >> 3;
            const int key = k0 + (mtx & 1) * 8 + (lane & 7), dim = 32 * warp + 16 * np + (mtx >> 1) * 8;
            uint32_t bv[4];
            ldmatrix_x4_trans(bv, v_addr + key * KROW + dim * 2);
            const uint32_t b0[2] = {bv[0], bv[1]}, b1[2] = {bv[2], bv[3]};
            mma_bf16(c[2 * np], ahi, b0);
            mma_bf16(c[2 * np], alo, b0);
            mma_bf16(c[2 * np + 1], ahi, b1);
            mma_bf16(c[2 * np + 1], alo, b1);
          }
        }
      };
      if constexpr (register_acc<D>()) {  // one m16 tile: rescale the registers, add this tile
        const float al0 = g < R ? al_s[g] : 0.f, al1 = g + 8 < R ? al_s[g + 8] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          racc[i][0] *= al0;
          racc[i][1] *= al0;
          racc[i][2] *= al1;
          racc[i][3] *= al1;
        }
        pv_rows(racc, 0);
      } else {
        for (int rb = 0; rb < R; rb += 16) {
          float c[4][4] = {};
          pv_rows(c, rb);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = rb + g + 8 * h;
            if (r < R) {
              const float al = al_s[r];
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                float2* ap = reinterpret_cast<float2*>(acc + r * D + 32 * warp + 8 * i + 2 * t);
                const float2 o = *ap;
                *ap = make_float2(o.x * al + c[i][2 * h], o.y * al + c[i][2 * h + 1]);
              }
            }
          }
        }
      }
    } else {
      // P @ V on the CUDA cores: thread d, its V column converted once for
      // every row; RG rows at a time, each summed in four interleaved chains
      // (keys j % 4), the same order for every row
      const KV* vs = reinterpret_cast<const KV*>(smem + buf * SB + KT);
      float vf[BK];
#pragma unroll
      for (int jj = 0; jj < BK; ++jj) vf[jj] = to_f(vs[jj * (KROW / static_cast<int>(sizeof(KV))) + tid]);
      for (int r0 = 0; r0 < R; r0 += RG) {
        float o[RG][4];
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const float4* pr = reinterpret_cast<const float4*>(s_s + min(r0 + rr, R - 1) * BK);
#pragma unroll
          for (int e = 0; e < 4; ++e) o[rr][e] = 0.f;
#pragma unroll
          for (int jj = 0; jj < BK / 4; ++jj) {
            const float4 p = pr[jj];
            o[rr][0] = fmaf(p.x, vf[4 * jj], o[rr][0]);
            o[rr][1] = fmaf(p.y, vf[4 * jj + 1], o[rr][1]);
            o[rr][2] = fmaf(p.z, vf[4 * jj + 2], o[rr][2]);
            o[rr][3] = fmaf(p.w, vf[4 * jj + 3], o[rr][3]);
          }
        }
#pragma unroll
        for (int rr = 0; rr < RG; ++rr) {
          const int r = r0 + rr;
          if (r < R) acc[r * D + tid] = acc[r * D + tid] * al_s[r] + ((o[rr][0] + o[rr][1]) + (o[rr][2] + o[rr][3]));
        }
      }
    }
    j0 = jn;
    buf ^= 1;
  }
  __syncthreads();

  // this chunk's partials, at (row0 + r) * n_chunks + chunk; the caller's
  // partials of quantized V carry v_scale (linear: it commutes with the merge)
  const int n = a.n_chunks;
  const float o_scale = a.out == nullptr && a.v_scales != nullptr ? a.v_scales[kvh] : 1.f;
  if constexpr (register_acc<D>()) {
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
      if (r < R) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float2*>(a.o_part + ((row0 + r) * n + chunk) * D + 32 * warp + 8 * i + 2 * t) =
              make_float2(racc[i][2 * h] * o_scale, racc[i][2 * h + 1] * o_scale);
      }
    }
  } else {
    for (int i = tid; i < R * D; i += THREADS)
      a.o_part[((row0 + i / D) * n + chunk) * D + i % D] = acc[i] * o_scale;
  }
  for (int r = tid; r < R; r += THREADS) {
    a.m_part[(row0 + r) * n + chunk] = m_s[r];
    a.l_part[(row0 + r) * n + chunk] = l_s[r];
  }
  if (a.out == nullptr) return;  // partials mode

  // merging mode: the last block of (b, kv head) to arrive merges the chunks
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int* counter = a.arrivals + (size_t)b * a.Hkv + kvh;
    is_last = atomicAdd(counter, 1) == n - 1;
    if (is_last) *counter = 0;  // every block of this (b, kv head) has arrived: ready for the next call
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // each row's chunk weights exp(m_c - max m), written over its m (the
  // workspace), and the divisor: its sum l (1 where l == 0), in chunk order,
  // a warp a row, every lane running the same chain
  for (int r = warp; r < R; r += NWARPS) {
    float* mh = a.m_part + (row0 + r) * n;
    const float* lh = a.l_part + (row0 + r) * n;
    float mg = NEG_INF;
    for (int c = lane; c < n; c += 32) mg = fmaxf(mg, __ldcg(mh + c));
    mg = warp_max(mg);
    float lg = 0.f;
    for (int c0 = 0; c0 < n; c0 += 32) {
      const int c = c0 + lane;
      const float alpha = c < n ? expf(__ldcg(mh + c) - mg) : 0.f;
      const float l = c < n ? __ldcg(lh + c) : 0.f;
      if (c < n) mh[c] = alpha;
      for (int j = 0; j < min(32, n - c0); ++j)
        lg += __shfl_sync(0xffffffffu, alpha, j) * __shfl_sync(0xffffffffu, l, j);
    }
    if (lane == 0) l_s[r] = lg == 0.f ? 1.f : lg;
  }
  __syncthreads();
  // o = sum over chunks of weight * o_c in chunk order, 4 columns a thread,
  // MERGE_AHEAD chunks' 16-byte loads in flight
  const float v_scale = a.v_scales != nullptr ? a.v_scales[kvh] : 1.f;
  constexpr int D4 = D / 4;
  for (int i = tid; i < R * D4; i += THREADS) {
    const int r = i / D4, c4 = i % D4;
    const size_t h = row0 + r;
    const float* wh = a.m_part + h * n;
    const float4* oh = reinterpret_cast<const float4*>(a.o_part + h * n * D) + c4;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int c0 = 0; c0 < n; c0 += MERGE_AHEAD) {
      float w[MERGE_AHEAD];
      float4 x[MERGE_AHEAD];
#pragma unroll
      for (int u = 0; u < MERGE_AHEAD; ++u) {
        const bool ok = c0 + u < n;
        w[u] = ok ? __ldcg(wh + c0 + u) : 0.f;
        x[u] = ok ? __ldcg(oh + (size_t)(c0 + u) * D4) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < MERGE_AHEAD; ++u) {
        if (c0 + u < n) {
          o.x += w[u] * x[u].x;
          o.y += w[u] * x[u].y;
          o.z += w[u] * x[u].z;
          o.w += w[u] * x[u].w;
        }
      }
    }
    const float div = l_s[r];
    const float res[4] = {o.x / div, o.y / div, o.z / div, o.w / div};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float y = res[e];
      if (a.v_scales != nullptr)  // JAX's roundings: paged once, contiguous twice (q's dtype, then times v_scale)
        y = PAGED ? y * v_scale : round_to(y, q) * v_scale;
      from_f(static_cast<T*>(a.out) + h * D + 4 * c4 + e, y);
    }
  }
}

template <typename T, typename KV, int D, bool PAGED, bool VARIANTS>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  const size_t smem = smem_bytes<T, KV, D>(a.Hq / a.Hkv * a.qspan);
  auto kernel = decode_split_kernel<T, KV, D, PAGED, VARIANTS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kernel<<<dim3(a.n_chunks, a.Hkv, B), block_threads<D>(), smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, typename KV, int D>
cudaError_t run_d(const Args& a, int B, int paged, int variants, cudaStream_t s) {
  if (variants) return paged ? launch<T, KV, D, true, true>(a, B, s) : launch<T, KV, D, false, true>(a, B, s);
  return paged ? launch<T, KV, D, true, false>(a, B, s) : launch<T, KV, D, false, false>(a, B, s);
}

template <typename T, typename KV>
cudaError_t run(const Args& a, int B, int D, int paged, int variants, cudaStream_t s) {
  switch (D) {
    case 64: return run_d<T, KV, 64>(a, B, paged, variants, s);
    case 128: return run_d<T, KV, 128>(a, B, paged, variants, s);
    case 256: return run_d<T, KV, 256>(a, B, paged, variants, s);
    case LATENT_D:  // bf16 q on bf16 KV, the plain form, one m16 tile of rows
      if constexpr (mma_pv<T, KV>()) {
        if (!variants && a.Hq / a.Hkv * a.qspan <= LATENT_ROWS)
          return paged ? launch<T, KV, LATENT_D, true, false>(a, B, s) : launch<T, KV, LATENT_D, false, false>(a, B, s);
      }
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// q (B, Hq, qspan, D), D 64, 128, 256 or 640 (bf16 q and KV, plain form,
// G * qspan <= 16); k, v: one layer's (B, Hkv, S, D)
// table (paged 0) or (Hkv, num_pages, page_size, D) pool slice (paged 1,
// with page_table (B, pages_per_seq) and S = pages_per_seq * page_size);
// lengths (B,). Merging mode: out non-null (q's shape and dtype), o/m/l_part
// a workspace of (B, Hq, qspan, n_chunks[, D]) fp32 and arrivals (B, Hkv)
// int32 zeros (left at zero). Partials mode: out null, arrivals null,
// o/m/l_part the caller's (B, Hq, n_chunks[, D]), chunk = split_len.
// dtype: 0 = fp32 q, 1 = bf16 q; kv_dtype: 0 = q's dtype, 1 = int8, 2 =
// fp8-e4m3, which take k_scales and v_scales (Hkv,) fp32 (null otherwise).
// variants 0: the plain form (window 1 << 30, sinks 0, softcap 0 required);
// 1: window (1 << 30 for none), sinks, softcap (0 for none) at run time.
// k_new, v_new (B, Hkv, qspan, D) in the cache's dtype, 16-byte aligned,
// wpos (B,) int32 and nvalid (B,) int32 or null (all qspan rows): the folded
// append (k_new, v_new, wpos null for none, and nvalid then null too).
int flash_decode_split(const void* q, const void* k, const void* v, const void* lengths,
                       const void* page_table, void* out, void* o_part, void* m_part, void* l_part,
                       void* arrivals, const void* k_scales, const void* v_scales,
                       const void* k_new, const void* v_new, const void* wpos, const void* nvalid,
                       int B, int Hq,
                       int Hkv, int S, int D, int qspan, int chunk, int n_chunks, int pages_per_seq,
                       int page_size, int num_pages, float scale, int dtype, int kv_dtype, int paged,
                       int variants, int window, int sinks, float softcap, void* stream) {
  if (qspan < 1 || chunk < 1 || n_chunks < 1 || window < 1 || sinks < 0 || Hkv < 1 || Hq % Hkv)
    return cudaErrorInvalidValue;
  if ((out == nullptr) != (arrivals == nullptr) || (paged && qspan > 1)) return cudaErrorInvalidValue;
  if ((kv_dtype != 0) != (k_scales != nullptr) || (k_scales == nullptr) != (v_scales == nullptr))
    return cudaErrorInvalidValue;
  if (!variants && (window != NO_WINDOW || sinks || softcap > 0.f)) return cudaErrorInvalidValue;
  if ((k_new == nullptr) != (wpos == nullptr) || (v_new == nullptr) != (wpos == nullptr) ||
      (nvalid != nullptr && wpos == nullptr))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, static_cast<const int*>(lengths), static_cast<const int*>(page_table), out,
               static_cast<float*>(o_part), static_cast<float*>(m_part), static_cast<float*>(l_part),
               static_cast<int*>(arrivals), static_cast<const float*>(k_scales),
               static_cast<const float*>(v_scales), k_new, v_new, static_cast<const int*>(wpos),
               static_cast<const int*>(nvalid), Hq, Hkv, S, qspan, chunk, n_chunks,
               pages_per_seq, page_size, num_pages, scale, window, sinks, softcap};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1) {
    switch (kv_dtype) {
      case 0: e = run<__nv_bfloat16, __nv_bfloat16>(a, B, D, paged, variants, s); break;
      case 1: e = run<__nv_bfloat16, int8_t>(a, B, D, paged, variants, s); break;
      case 2: e = run<__nv_bfloat16, __nv_fp8_e4m3>(a, B, D, paged, variants, s); break;
      default: e = cudaErrorInvalidValue;
    }
  } else {
    switch (kv_dtype) {
      case 0: e = run<float, float>(a, B, D, paged, variants, s); break;
      case 1: e = run<float, int8_t>(a, B, D, paged, variants, s); break;
      case 2: e = run<float, __nv_fp8_e4m3>(a, B, D, paged, variants, s); break;
      default: e = cudaErrorInvalidValue;
    }
  }
  return static_cast<int>(e);
}

// The dynamic shared memory (bytes) of a block of `rows` query rows at
// head_dim d, bf16 q on bf16 KV (-1 for a head_dim without a kernel).
int flash_decode_split_smem_bytes(int d, int rows) {
  using BF = __nv_bfloat16;
  switch (d) {
    case 64: return static_cast<int>(smem_bytes<BF, BF, 64>(rows));
    case 128: return static_cast<int>(smem_bytes<BF, BF, 128>(rows));
    case 256: return static_cast<int>(smem_bytes<BF, BF, 256>(rows));
    case LATENT_D: return static_cast<int>(smem_bytes<BF, BF, LATENT_D>(rows));
    default: return -1;
  }
}

}  // extern "C"
