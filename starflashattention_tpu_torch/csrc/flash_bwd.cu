// FlashAttention-2 backward for Hopper (sm_90a): two kernels, dq and dk/dv.
//
// Replaces: starflashattention_tpu/ops/flash_bwd.py::_dq_kernel and
// ::_dkdv_kernel (entry flash_prefill_bwd, behind flash_attention's
// custom_vjp), causal or not, with per-sequence lengths and q_offsets; no
// window, sinks or softcap.
//
// q, dout: (B, Hq, Sq, D) bf16; k, v: (B, Hkv, Skv, D) bf16; lse: (B, Hq,
// Sq) fp32, the base-2 LSE flash_prefill.cu wrote in the forward (3e38 for
// a row with no valid position); delta: (B, Hq, Sq) fp32, rowsum(dout * o),
// computed by the wrapper; lengths and q_offsets: (B,) int32, with the
// forward's meaning. Both kernels recompute, tile by tile, in fp32
//   s2 = scale_log2 * q.k      (scale_log2 = sm_scale * log2 e, as K5)
//   p  = 2^(s2 - lse)          (0 where the forward's mask is false)
//   dp = dout . v,  ds = p * (dp - delta)
// and accumulate, with P and dS rounded to bf16 before their products as
// the TPU kernels round them:
//   dq = sm_scale * ds @ k,  dk = sm_scale * ds^T @ q,  dv = p^T @ dout.
// dk and dv sum over the G query heads of each KV head. Every gradient
// element is written once by one thread, in a fixed order, with no atomics:
// two runs give the same bytes. Rows past Sq (dq) or Skv (dk, dv) are
// never written; rows with nothing in band get 0.
//
// Bound: 10 * D operations per (query, key) pair in band (the two
// recomputed products and the three gradient products: 5 matmuls of 2 * D
// each) at the tensor-core rate; the bytes are a few times the forward's.
// Design: both kernels use K5's warp layout, mma.sync.m16n8k16 with bf16
// inputs and fp32 accumulators, fragments for the A operand straight from
// registers or shared memory and ldmatrix.trans for the transposed B
// operands, and skip tiles out of band (causal, ragged length, q offset)
// before any arithmetic, as the TPU's _in_band does.
// - dq: one block per (q tile, KV head, sequence) holds the G query heads
//   of the group (K5's layout); each warp keeps its 16 rows' Q and dO
//   fragments and its dq accumulator in registers and walks the K/V tiles
//   in band, 16 keys at a time, so S, dP and dS never leave registers.
// - dk/dv: one block per (64-row KV tile, KV head, sequence); each warp owns
//   16 KV rows and their dk, dv accumulators. The block walks the q tiles
//   in band of all G heads, staging Q, dO, lse and delta in shared memory;
//   the group sum falls out of the same walk (dynamic shared memory: 70 KB
//   at D = 128).
// Not yet: copies overlapped with compute (cp.async / TMA), wgmma, a
// balanced order for the causal triangle (the first KV tiles hold the most
// q rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64;                   // dq: KV rows per shared-memory tile
constexpr int DQ_MAX_THREADS = 256;      // dq: 8 warps, up to 255 registers a thread
constexpr int KV_WARPS = 4;              // dk/dv: warps a block, 16 KV rows each
constexpr int BKV = 16 * KV_WARPS;       // dk/dv: KV rows a block owns
constexpr int BQ = 64;                   // dk/dv: q rows per shared-memory tile
constexpr float LSE_EMPTY = 3e38f;       // the LSE of a row with no valid position

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
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

// The A fragment (16 rows x 16 columns, row-major) at `p`, row stride `st`:
// lane (g, t) holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9.
__device__ __forceinline__ void load_a(uint32_t* a, const __nv_bfloat16* p, int st, int g, int t) {
  a[0] = ld32(p + g * st + 2 * t);
  a[1] = ld32(p + (g + 8) * st + 2 * t);
  a[2] = ld32(p + g * st + 2 * t + 8);
  a[3] = ld32(p + (g + 8) * st + 2 * t + 8);
}

// acc (16 x D) += A (16 x 16, a fragment) @ M[0:16, 0:D], M row-major in
// shared memory at `m` with row stride `st` (its rows are the k index).
template <int D>
__device__ __forceinline__ void mma_a_by_rows(float (*acc)[4], const uint32_t* a,
                                              const __nv_bfloat16* m, int st, int lane) {
  const int mi = lane >> 3, rr = lane & 7;
  const __nv_bfloat16* row = m + (rr + (mi & 1) * 8) * st + (mi >> 1) * 8;
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {
    uint32_t bb[4];
    ldmatrix_x4_trans(bb, row + np * 16);
    mma_bf16(acc[2 * np], a, bb[0], bb[1]);
    mma_bf16(acc[2 * np + 1], a, bb[2], bb[3]);
  }
}

// Stage `rows` rows of D bf16 from `src` (row-major, rows past `valid`
// zero) into shared memory at `dst` with row stride ST.
template <int D, int ST>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int rows,
                                           int valid) {
  for (int i = threadIdx.x; i < rows * D / 8; i += blockDim.x) {
    const int row = i / (D / 8), col = (i % (D / 8)) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (row < valid) x = *reinterpret_cast<const uint4*>(src + (size_t)row * D + col);
    *reinterpret_cast<uint4*>(dst + row * ST + col) = x;
  }
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(DQ_MAX_THREADS)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ lengths, const int* __restrict__ q_offsets,
                        __nv_bfloat16* __restrict__ dq, int Hq, int Hkv, int Sq, int Skv, int bq,
                        float scale, float scale_log2) {
  constexpr int ST = D + 8;  // padded smem row (elements): conflict-free fragment loads
  constexpr int KT = D / 16;
  constexpr int NT = D / 8;
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

  // This warp's Q and dO fragments, lse and delta, for the whole walk.
  const size_t row0 = ((size_t)b * Hq + head) * (size_t)Sq;
  const __nv_bfloat16* qh = q + row0 * D;
  const __nv_bfloat16* dh = dout + row0 * D;
  uint32_t qa[KT][4], da[KT][4];
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = ra < Sq ? ld32(qh + (size_t)ra * D + c) : 0u;
    qa[kk][1] = rb < Sq ? ld32(qh + (size_t)rb * D + c) : 0u;
    qa[kk][2] = ra < Sq ? ld32(qh + (size_t)ra * D + c + 8) : 0u;
    qa[kk][3] = rb < Sq ? ld32(qh + (size_t)rb * D + c + 8) : 0u;
    da[kk][0] = ra < Sq ? ld32(dh + (size_t)ra * D + c) : 0u;
    da[kk][1] = rb < Sq ? ld32(dh + (size_t)rb * D + c) : 0u;
    da[kk][2] = ra < Sq ? ld32(dh + (size_t)ra * D + c + 8) : 0u;
    da[kk][3] = rb < Sq ? ld32(dh + (size_t)rb * D + c + 8) : 0u;
  }
  const float lse_a = ra < Sq ? lse[row0 + ra] : LSE_EMPTY;
  const float lse_b = rb < Sq ? lse[row0 + rb] : LSE_EMPTY;
  const float dl_a = ra < Sq ? delta[row0 + ra] : 0.f;
  const float dl_b = rb < Sq ? delta[row0 + rb] : 0.f;

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D;
  const int block_last_row = min(qt * bq + bq, Sq) - 1;
  const int kv_end = CAUSAL ? min(len, qoff + block_last_row + 1) : len;

  for (int j0 = 0; j0 < kv_end; j0 += BK) {
    stage_rows<D, ST>(k_s, k + kv_base + (size_t)j0 * D, BK, Skv - j0);
    stage_rows<D, ST>(v_s, v + kv_base + (size_t)j0 * D, BK, Skv - j0);
    __syncthreads();

    if (r0 < Sq && (!CAUSAL || j0 <= warp_last)) {  // warp-uniform
#pragma unroll 1
      for (int kk = 0; kk < BK / 16; ++kk) {  // 16 keys at a time
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
          dp[nn][0] = dp[nn][1] = dp[nn][2] = dp[nn][3] = 0.f;
          const __nv_bfloat16* krow = k_s + (kk * 16 + nn * 8 + g) * ST + 2 * t;
          const __nv_bfloat16* vrow = v_s + (kk * 16 + nn * 8 + g) * ST + 2 * t;
#pragma unroll
          for (int kq = 0; kq < KT; ++kq) {
            mma_bf16(s[nn], qa[kq], ld32(krow + kq * 16), ld32(krow + kq * 16 + 8));
            mma_bf16(dp[nn], da[kq], ld32(vrow + kq * 16), ld32(vrow + kq * 16 + 8));
          }
        }
        // dS = P * (dP - delta), in place of the scores
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = j0 + kk * 16 + nn * 8 + 2 * t + (e & 1);
            const bool lo = e < 2;
            const bool valid = col < len && (!CAUSAL || col <= (lo ? pa : pb));
            const float p = valid ? exp2f(s[nn][e] * scale_log2 - (lo ? lse_a : lse_b)) : 0.f;
            s[nn][e] = p * (dp[nn][e] - (lo ? dl_a : dl_b));
          }
        }
        const uint32_t af[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        mma_a_by_rows<D>(acc, af, k_s + kk * 16 * ST, ST, lane);  // dq += dS @ K
      }
    }
    __syncthreads();
  }

  if (r0 >= Sq) return;
  __nv_bfloat16* oh = dq + row0 * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ra < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)ra * D + c) =
          __floats2bfloat162_rn(acc[n][0] * scale, acc[n][1] * scale);
    if (rb < Sq)
      *reinterpret_cast<__nv_bfloat162*>(oh + (size_t)rb * D + c) =
          __floats2bfloat162_rn(acc[n][2] * scale, acc[n][3] * scale);
  }
}

template <int D>
constexpr int dkdv_smem_bytes() {
  return (2 * BKV + 2 * BQ) * (D + 8) * 2 + 2 * BQ * 4;
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(32 * KV_WARPS)
    flash_bwd_dkdv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse, const float* __restrict__ delta,
                          const int* __restrict__ lengths, const int* __restrict__ q_offsets,
                          __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq,
                          int Hkv, int Sq, int Skv, float scale, float scale_log2) {
  constexpr int ST = D + 8;
  constexpr int KT = D / 16;
  constexpr int NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // (BKV, ST)
  __nv_bfloat16* v_s = k_s + BKV * ST;                                 // (BKV, ST)
  __nv_bfloat16* q_s = v_s + BKV * ST;                                 // (BQ, ST)
  __nv_bfloat16* do_s = q_s + BQ * ST;                                 // (BQ, ST)
  float* lse_s = reinterpret_cast<float*>(do_s + BQ * ST);             // (BQ,)
  float* dl_s = lse_s + BQ;                                            // (BQ,)

  const int kt = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = kt * BKV;
  const int len = min(lengths[b], Skv);
  const int qoff = q_offsets[b];
  const int w0 = j0 + warp * 16;          // this warp's first KV row
  const int ja = w0 + g, jb = w0 + g + 8;  // this lane's two KV rows

  const size_t kv_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D + (size_t)j0 * D;
  stage_rows<D, ST>(k_s, k + kv_base, BKV, Skv - j0);
  stage_rows<D, ST>(v_s, v + kv_base, BKV, Skv - j0);

  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    dk_acc[n][0] = dk_acc[n][1] = dk_acc[n][2] = dk_acc[n][3] = 0.f;
    dv_acc[n][0] = dv_acc[n][1] = dv_acc[n][2] = dv_acc[n][3] = 0.f;
  }

  // q rows in band: none past the valid length; causal, from the first row
  // whose position reaches this tile
  const int i_begin = CAUSAL ? max(0, j0 - qoff) / BQ * BQ : 0;
  const int i_end = j0 < len ? Sq : 0;
  for (int h = 0; h < G; ++h) {
    const size_t row0 = ((size_t)b * Hq + kvh * G + h) * (size_t)Sq;
    for (int i0 = i_begin; i0 < i_end; i0 += BQ) {
      __syncthreads();  // the previous tile's readers are done (first pass: K/V staged)
      stage_rows<D, ST>(q_s, q + (row0 + i0) * D, BQ, Sq - i0);
      stage_rows<D, ST>(do_s, dout + (row0 + i0) * D, BQ, Sq - i0);
      for (int i = threadIdx.x; i < BQ; i += blockDim.x) {
        lse_s[i] = i0 + i < Sq ? lse[row0 + i0 + i] : LSE_EMPTY;
        dl_s[i] = i0 + i < Sq ? delta[row0 + i0 + i] : 0.f;
      }
      __syncthreads();

      const int i_last = min(i0 + BQ, Sq) - 1;
      if (w0 >= len || (CAUSAL && qoff + i_last < w0)) continue;  // warp-uniform
#pragma unroll 1
      for (int c = 0; c < BQ / 16; ++c) {  // 16 q rows at a time
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          s[nn][0] = s[nn][1] = s[nn][2] = s[nn][3] = 0.f;
          dp[nn][0] = dp[nn][1] = dp[nn][2] = dp[nn][3] = 0.f;
        }
#pragma unroll
        for (int kq = 0; kq < KT; ++kq) {
          uint32_t ka[4], va[4];
          load_a(ka, k_s + warp * 16 * ST + kq * 16, ST, g, t);
          load_a(va, v_s + warp * 16 * ST + kq * 16, ST, g, t);
#pragma unroll
          for (int nn = 0; nn < 2; ++nn) {
            const __nv_bfloat16* qrow = q_s + (c * 16 + nn * 8 + g) * ST + kq * 16 + 2 * t;
            const __nv_bfloat16* drow = do_s + (c * 16 + nn * 8 + g) * ST + kq * 16 + 2 * t;
            mma_bf16(s[nn], ka, ld32(qrow), ld32(qrow + 8));   // S^T = K Q^T
            mma_bf16(dp[nn], va, ld32(drow), ld32(drow + 8));  // dP^T = V dO^T
          }
        }
        // P^T and dS^T: rows are KV positions, columns q rows
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = c * 16 + nn * 8 + 2 * t + (e & 1);
            const int i = i0 + qi;
            const int j = e < 2 ? ja : jb;
            const bool valid = i < Sq && j < len && (!CAUSAL || j <= qoff + i);
            const float p = valid ? exp2f(s[nn][e] * scale_log2 - lse_s[qi]) : 0.f;
            s[nn][e] = p;
            dp[nn][e] = p * (dp[nn][e] - dl_s[qi]);
          }
        }
        const uint32_t pf[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                                pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
        const uint32_t df[4] = {pack_bf16(dp[0][0], dp[0][1]), pack_bf16(dp[0][2], dp[0][3]),
                                pack_bf16(dp[1][0], dp[1][1]), pack_bf16(dp[1][2], dp[1][3])};
        mma_a_by_rows<D>(dv_acc, pf, do_s + c * 16 * ST, ST, lane);  // dV += P^T dO
        mma_a_by_rows<D>(dk_acc, df, q_s + c * 16 * ST, ST, lane);   // dK += dS^T Q
      }
    }
  }

  const size_t out_base = ((size_t)b * Hkv + kvh) * (size_t)Skv * D;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int c = n * 8 + 2 * t;
    if (ja < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out_base + (size_t)ja * D + c) =
          __floats2bfloat162_rn(dk_acc[n][0] * scale, dk_acc[n][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out_base + (size_t)ja * D + c) =
          __floats2bfloat162_rn(dv_acc[n][0], dv_acc[n][1]);
    }
    if (jb < Skv) {
      *reinterpret_cast<__nv_bfloat162*>(dk + out_base + (size_t)jb * D + c) =
          __floats2bfloat162_rn(dk_acc[n][2] * scale, dk_acc[n][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + out_base + (size_t)jb * D + c) =
          __floats2bfloat162_rn(dv_acc[n][2], dv_acc[n][3]);
    }
  }
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;
  const int *lengths, *q_offsets;
  int B, Hq, Hkv, Sq, Skv;
  float scale, scale_log2;
};

Args make_args(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, const void* lengths, const void* q_offsets, int B, int Hq, int Hkv,
               int Sq, int Skv, float scale, float scale_log2) {
  return Args{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
              static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
              static_cast<const float*>(lse), static_cast<const float*>(delta),
              static_cast<const int*>(lengths), static_cast<const int*>(q_offsets),
              B, Hq, Hkv, Sq, Skv, scale, scale_log2};
}

template <int D, bool CAUSAL>
cudaError_t launch_dq(const Args& a, void* dq, cudaStream_t stream) {
  const int G = a.Hq / a.Hkv;
  const int bq = G >= 8 ? 16 : 16 * (8 / G);  // K5's tiling: about 8 warps a block
  const int threads = 32 * G * (bq / 16);
  if (threads > DQ_MAX_THREADS) return cudaErrorInvalidConfiguration;
  dim3 grid((a.Sq + bq - 1) / bq, a.Hkv, a.B);
  flash_bwd_dq_kernel<D, CAUSAL><<<grid, threads, 0, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.lengths, a.q_offsets,
      static_cast<__nv_bfloat16*>(dq), a.Hq, a.Hkv, a.Sq, a.Skv, bq, a.scale, a.scale_log2);
  return cudaGetLastError();
}

template <int D, bool CAUSAL>
cudaError_t launch_dkdv(const Args& a, void* dk, void* dv, cudaStream_t stream) {
  constexpr int smem = dkdv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<D, CAUSAL>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  dim3 grid((a.Skv + BKV - 1) / BKV, a.Hkv, a.B);
  flash_bwd_dkdv_kernel<D, CAUSAL><<<grid, 32 * KV_WARPS, smem, stream>>>(
      a.q, a.k, a.v, a.dout, a.lse, a.delta, a.lengths, a.q_offsets,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.Hq, a.Hkv, a.Sq, a.Skv,
      a.scale, a.scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// q, dout (B, Hq, Sq, D), k/v (B, Hkv, Skv, D), dq (B, Hq, Sq, D): bf16,
// contiguous. lse, delta: (B, Hq, Sq) fp32. lengths, q_offsets: (B,) int32.
// D is 64 or 128; Hq / Hkv <= 8. scale is sm_scale, scale_log2 the value
// the forward took (sm_scale * log2 e).
int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                 const void* delta, const void* lengths, const void* q_offsets, void* dq, int B,
                 int Hq, int Hkv, int Sq, int Skv, int D, int causal, float scale,
                 float scale_log2, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, q_offsets, B, Hq, Hkv, Sq, Skv,
                           scale, scale_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 64)
    e = causal ? launch_dq<64, true>(a, dq, s) : launch_dq<64, false>(a, dq, s);
  else if (D == 128)
    e = causal ? launch_dq<128, true>(a, dq, s) : launch_dq<128, false>(a, dq, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// The same inputs; dk, dv (B, Hkv, Skv, D) bf16, contiguous.
int flash_bwd_dkdv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                   const void* delta, const void* lengths, const void* q_offsets, void* dk,
                   void* dv, int B, int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                   float scale, float scale_log2, void* stream) {
  const Args a = make_args(q, k, v, dout, lse, delta, lengths, q_offsets, B, Hq, Hkv, Sq, Skv,
                           scale, scale_log2);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 64)
    e = causal ? launch_dkdv<64, true>(a, dk, dv, s) : launch_dkdv<64, false>(a, dk, dv, s);
  else if (D == 128)
    e = causal ? launch_dkdv<128, true>(a, dk, dv, s) : launch_dkdv<128, false>(a, dk, dv, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

}  // extern "C"
