// Fused quantized SwiGLU MLP for Hopper (sm_90a), one launch per call:
//   gu  = (x @ dq(w1)) * s1          (B, 2I) fp32, w1 = [gate (I) | up (I)]
//   act = silu(gate) * up            rounded to x's dtype
//   out = (act @ dq(w2)) * s2        (B, H) fp32
//
// Replaces: starflashattention_tpu/ops/fused_mlp.py::_fused_mlp_kernel
// (entry fused_mlp). The TPU kernel runs one sequential grid whose steps
// first stream w1 into a VMEM accumulator, then stream w2 against the
// resident activation. On Hopper the blocks run in parallel: the launch is
// cooperative and the grid sized from cudaOccupancyMaxActiveBlocksPerMultiprocessor
// times the SM count, so every block is resident, and each loops over the
// work items of phase 1, then of phase 2.
//
// Bound: at decode rows the weight stream, 3 * H * I bytes (135.3 MB at
// 7B's H 4096, I 11008: about 40 us at 3.35 TB/s); the 6 * B * H * I
// operations are far below that at B <= 64.
//
// bf16 x (fused_mlp_split_k, the serving dtype): each phase is K4's split-K
// matmul (qmm_split_k.cuh, the same device functions as quant_matmul.cu's
// qmm_split_k): x rows in tiles of up to 64 (8 * NT), bands of 128 weight
// columns times K splits from ops/quant_matmul.small_m_grid, the 8-bit
// weights in the mma's A slot through a 4-stage cp.async ring, the splits'
// fp32 partials summed in split order by each band's last block on the
// split-K workspace (each phase on slots of its own), three blocks an SM.
//  * phase 1: a band is 64 gate columns c.. and the 64 up columns I + c..
//    (split_k_products' PAIRED bands), K = H; the band's last block applies
//    s1 and silu(gate) * up, writes act (B, I) in bf16 and sets the band's
//    flag in device memory to the call's epoch;
//  * phase 2: bands of 128 output columns, K = I split over blocks; an item
//    copies its first weight stages, waits for the flags of the phase-1
//    bands its K range reads (no grid-wide barrier: it starts as soon as
//    those are written), then reads act through L2 (cp.async.cg: written
//    in this launch); s2 at the store.
// An item is a function of its own (not inlined), so its loops take the 80
// registers of one qmm_split_k whatever the kernel keeps across items.
// What bounds it on the H100: as K4, the weight loads at under half the
// byte bound; the handoff between the phases costs about what the kernel
// boundary costs the two K4 calls (PERF.md).
//
// fp32 x (fused_mlp_kernel, the CUDA-core form): act stays fp32, so the
// products run on the CUDA cores in fp32 (an fp32 x has no bf16 mma), and
// the phases are split by a grid-wide barrier: every block arrives on a
// counter in global memory (the sense-reversing counter of
// cooperative_groups' grid sync: block 0 adds 2^31 - (grid - 1), the others
// 1, so the top bit flips once all have arrived and the low bits return to
// 0 — the counter needs no reset between calls). A
// work item of phase 1 is a tile of 32 gate columns and the 32 matching up
// columns for one tile of rows; phase 2 a tile of 32 output columns for one
// tile of rows, reducing over all of I. Each block stages a chunk of 64
// weight rows in shared memory with one 16-byte load a thread, and the
// activations of the row tile beside it in fp32, read back 16 bytes at a
// time; each thread keeps the loads of the next 4 chunks (1 for 32-row
// tiles) in flight in registers while the block multiplies the current
// one. Row tiles of 8, 16 or 32 rows, by B.
//
// Arithmetic, as the TPU kernel's: the weights are upcast to x's dtype
// (int8 and fp8 e4m3 are exact in bf16 and fp32) and every product is summed
// in fp32; bf16 x times an 8-bit weight is exact in fp32, so for bf16 x only
// the order of the fp32 sums differs from the plain version.
//
// Requirements checked by the wrapper: H % 64 == 0, I % 64 == 0, every
// pointer 16-byte aligned, the tensors contiguous.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "qmm_split_k.cuh"

namespace {

// ---------------------------------------------------------------- fp32 x: the CUDA-core form
constexpr int THREADS = 256;
constexpr int KC = 64;    // weight rows a chunk
constexpr int TC1 = 32;   // phase 1: gate columns a tile (and as many up columns)
constexpr int TC2 = 32;   // phase 2: output columns a tile
constexpr int KS1 = THREADS / (2 * TC1);  // phase 1 k-slices: 4, each 16 rows of a chunk
constexpr int KS2 = THREADS / TC2;        // phase 2 k-slices: 8, each 8 rows of a chunk

template <typename WT>
__device__ __forceinline__ float w2f(uint8_t b);

template <>
__device__ __forceinline__ float w2f<int8_t>(uint8_t b) {
  return static_cast<float>(static_cast<int8_t>(b));
}

template <>
__device__ __forceinline__ float w2f<__nv_fp8_e4m3>(uint8_t b) {
  __nv_fp8_e4m3 v;
  v.__x = b;
  return static_cast<float>(v);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ void from_f(float* p, float v) { *p = v; }

// act written in this launch: read through L2, never a stale L1 line
__device__ __forceinline__ float load_act(const float* p) { return __ldcg(p); }

__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int inc = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(bar, inc);
    while (((old ^ *reinterpret_cast<volatile unsigned int*>(bar)) & 0x80000000u) == 0) {
    }
    __threadfence();
  }
  __syncthreads();
}

template <int RB>
struct Smem {
  uint8_t w[KC * 2 * TC1];  // one chunk of weights: 4096 bytes (phase 2 uses half)
  float x[RB][KC];          // the row tile's activations of the chunk
  float red[KS2][RB][TC2];  // the k-slices' partial sums (phase 1 uses [KS1][RB][2 * TC1])
};

// A chunk's loads, held in registers until the block stores them to shared
// memory: one 16-byte weight segment (the loaders' threads) and XPT of the
// row tile's activations.
template <int XPT>
struct ChunkRegs {
  uint4 w;
  float x[XPT];
};

template <typename XT, typename WT, int RB>
__global__ void __launch_bounds__(THREADS)
    fused_mlp_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w1,
                     const float* __restrict__ s1, const uint8_t* __restrict__ w2,
                     const float* __restrict__ s2, XT* act, float* __restrict__ out,
                     unsigned int* bar, int B, int H, int I) {
  static_assert(KS1 * RB * 2 * TC1 <= KS2 * RB * TC2, "phase 1 partials fit the reduction buffer");
  constexpr int XPT = RB * KC / THREADS;  // activations a thread stages a chunk
  // chunks in flight a thread (the loads' latency, not their bytes, is the limit); one for 32-row tiles,
  // whose two-deep form took 243 registers a thread and was slower at B 64 (1.48 against 1.25 ms)
  constexpr int PF = RB <= 16 ? 4 : 1;
  __shared__ __align__(16) Smem<RB> sm;
  const int tid = threadIdx.x;
  const int n_rt = (B + RB - 1) / RB;
  const int two_i = 2 * I;
  ChunkRegs<XPT> regs[PF];

  // ---------------- phase 1: act = silu(x @ w1_gate * s1) * (x @ w1_up * s1)
  {
    const int col = tid % (2 * TC1);  // 0-31 gate, 32-63 up
    const int ks = tid / (2 * TC1);
    // the 16-byte load of a thread: chunk row tid / 4, segment tid % 4
    const int lrow = tid / 4, lseg = tid % 4;
    float (*red)[RB][2 * TC1] = reinterpret_cast<float (*)[RB][2 * TC1]>(&sm.red[0][0][0]);
    const int n_items = n_rt * (I / TC1);
    const int n_chunks = H / KC;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int c0 = (item % (I / TC1)) * TC1;
      const int r0 = (item / (I / TC1)) * RB;
      // segments 0, 1: gate columns c0 + 0-15, 16-31; 2, 3: up columns I + c0 + ...
      const int gcol = (lseg < 2 ? c0 : I + c0) + (lseg & 1) * 16;
      const uint8_t* wsrc = w1 + (size_t)lrow * two_i + gcol;
      auto load = [&](int kc, ChunkRegs<XPT>& R) {
        R.w = __ldg(reinterpret_cast<const uint4*>(wsrc + (size_t)kc * KC * two_i));
#pragma unroll
        for (int j = 0; j < XPT; ++j) {
          const int idx = tid + j * THREADS, r = idx / KC, k = idx % KC;
          R.x[j] = r0 + r < B ? to_f(x[(size_t)(r0 + r) * H + kc * KC + k]) : 0.f;
        }
      };
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll
      for (int u = 0; u < PF; ++u)
        if (u < n_chunks) load(u, regs[u]);
      for (int kc0 = 0; kc0 < n_chunks; kc0 += PF) {
#pragma unroll
        for (int u = 0; u < PF; ++u) {
          const int kc = kc0 + u;
          if (kc >= n_chunks) break;  // the same for the whole block
          __syncthreads();
          *reinterpret_cast<uint4*>(&sm.w[lrow * 2 * TC1 + lseg * 16]) = regs[u].w;
#pragma unroll
          for (int j = 0; j < XPT; ++j) {
            const int idx = tid + j * THREADS;
            sm.x[idx / KC][idx % KC] = regs[u].x[j];
          }
          __syncthreads();
          if (kc + PF < n_chunks) load(kc + PF, regs[u]);
          float wv[16];
#pragma unroll
          for (int i = 0; i < 16; ++i) wv[i] = w2f<WT>(sm.w[(ks * 16 + i) * 2 * TC1 + col]);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float a = acc[r];
            const float4* xr = reinterpret_cast<const float4*>(&sm.x[r][ks * 16]);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float4 xv = xr[q];
              a = fmaf(xv.x, wv[4 * q], a);
              a = fmaf(xv.y, wv[4 * q + 1], a);
              a = fmaf(xv.z, wv[4 * q + 2], a);
              a = fmaf(xv.w, wv[4 * q + 3], a);
            }
            acc[r] = a;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) red[ks][r][col] = acc[r];
      __syncthreads();
      for (int idx = tid; idx < RB * TC1; idx += THREADS) {
        const int r = idx / TC1, c = idx % TC1;
        if (r0 + r >= B) continue;
        float g = 0.f, u = 0.f;
#pragma unroll
        for (int s = 0; s < KS1; ++s) {
          g += red[s][r][c];
          u += red[s][r][TC1 + c];
        }
        g *= s1[c0 + c];
        u *= s1[I + c0 + c];
        const float silu = g / (1.f + expf(-g));
        from_f(act + (size_t)(r0 + r) * I + c0 + c, silu * u);
      }
    }
  }

  grid_barrier(bar);

  // ---------------- phase 2: out = (act @ w2) * s2
  {
    const int col = tid % TC2;
    const int ks = tid / TC2;
    // 64 rows x 32 columns = 2048 bytes: the first 128 threads load 16 bytes each
    const int lrow = tid / 2, lseg = tid % 2;
    const bool loader = tid < KC * 2;
    const int n_items = n_rt * (H / TC2);
    const int n_chunks = I / KC;
    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int c0 = (item % (H / TC2)) * TC2;
      const int r0 = (item / (H / TC2)) * RB;
      const uint8_t* wsrc = w2 + (size_t)lrow * H + c0 + lseg * 16;
      auto load = [&](int kc, ChunkRegs<XPT>& R) {
        if (loader) R.w = __ldg(reinterpret_cast<const uint4*>(wsrc + (size_t)kc * KC * H));
#pragma unroll
        for (int j = 0; j < XPT; ++j) {
          const int idx = tid + j * THREADS, r = idx / KC, k = idx % KC;
          R.x[j] = r0 + r < B ? load_act(act + (size_t)(r0 + r) * I + kc * KC + k) : 0.f;
        }
      };
      float acc[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc[r] = 0.f;
#pragma unroll
      for (int u = 0; u < PF; ++u)
        if (u < n_chunks) load(u, regs[u]);
      for (int kc0 = 0; kc0 < n_chunks; kc0 += PF) {
#pragma unroll
        for (int u = 0; u < PF; ++u) {
          const int kc = kc0 + u;
          if (kc >= n_chunks) break;  // the same for the whole block
          __syncthreads();
          if (loader) *reinterpret_cast<uint4*>(&sm.w[lrow * TC2 + lseg * 16]) = regs[u].w;
#pragma unroll
          for (int j = 0; j < XPT; ++j) {
            const int idx = tid + j * THREADS;
            sm.x[idx / KC][idx % KC] = regs[u].x[j];
          }
          __syncthreads();
          if (kc + PF < n_chunks) load(kc + PF, regs[u]);
          float wv[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) wv[i] = w2f<WT>(sm.w[(ks * 8 + i) * TC2 + col]);
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            float a = acc[r];
            const float4* xr = reinterpret_cast<const float4*>(&sm.x[r][ks * 8]);
#pragma unroll
            for (int q = 0; q < 2; ++q) {
              const float4 xv = xr[q];
              a = fmaf(xv.x, wv[4 * q], a);
              a = fmaf(xv.y, wv[4 * q + 1], a);
              a = fmaf(xv.z, wv[4 * q + 2], a);
              a = fmaf(xv.w, wv[4 * q + 3], a);
            }
            acc[r] = a;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < RB; ++r) sm.red[ks][r][col] = acc[r];
      __syncthreads();
      for (int idx = tid; idx < RB * TC2; idx += THREADS) {
        const int r = idx / TC2, c = idx % TC2;
        if (r0 + r >= B) continue;
        float o = 0.f;
#pragma unroll
        for (int s = 0; s < KS2; ++s) o += sm.red[s][r][c];
        out[(size_t)(r0 + r) * H + c0 + c] = o * s2[c0 + c];
      }
    }
  }
}

// ---------------------------------------------------------------- bf16 x: the split-K form
constexpr int PAIR = qmm::SK_BN / 2;  // gate columns (and as many up columns) of a phase-1 band

// A flag in device memory, written and read at device scope.
__device__ __forceinline__ void store_release(int* p, int v) {
  asm volatile("st.release.gpu.global.b32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.b32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// One item of a phase (a row tile, band and split): phase 1 multiplies x
// by w1 (K = H) in bands of PAIR gate and PAIR up columns, and the band's
// last block writes act and sets the band's flag; phase 2 multiplies act by
// w2 (K = I) in bands of SK_BN output columns, once the phase-1 bands its K
// range reads are flagged. part / arrivals: the phase's own slots of the
// split-K workspace. Not inlined: the item's loops take the registers of
// one qmm_split_k, and the kernel's state across items stays outside them.
template <typename WT, int NT, int phase>  // phase 1 or 2
__device__ __noinline__ void mlp_item(int item, unsigned char* smem, int& last,
                                  const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                                  const float* __restrict__ s1, const float* __restrict__ s2, __nv_bfloat16* act,
                                  float* __restrict__ out, float* __restrict__ part, int* __restrict__ arrivals,
                                  int* ready, int epoch, int B, int H, int I, int split) {
  using namespace qmm;
  constexpr int ROWS = 8 * NT;  // x rows a row tile
  float* tile = reinterpret_cast<float*>(smem);  // the band's epilogue tile (it reuses the ring)
  const int K = phase == 2 ? I : H, N = phase == 2 ? H : 2 * I;
  const int bands = phase == 2 ? (H + SK_BN - 1) / SK_BN : I / PAIR, splits = (K + split - 1) / split;
  const int sp = item % splits, band = item / splits % bands, rt = item / (splits * bands);
  const int m = min(ROWS, B - rt * ROWS), n0 = band * (phase == 2 ? SK_BN : PAIR);
  // phase 2: the phase-1 bands of this split's act columns are written (the
  // ring's first weight stages are already on their way)
  auto bands_written = [&] {
    const int b0 = sp * split / PAIR, nb = (min(sp * split + split, K) - 1) / PAIR - b0 + 1;
    if (threadIdx.x < nb) {
      const int* flag = ready + rt * (I / PAIR) + b0 + threadIdx.x;
      while (load_acquire(flag) != epoch) __nanosleep(64);
    }
    __syncthreads();
  };
  __syncthreads();  // the previous item's epilogue has read the tile
  float acc[NT][4];
  if constexpr (phase == 2)
    split_k_products<WT, NT>(acc, smem, x + (size_t)rt * ROWS * K, w, nullptr, m, K, N, 0, n0, 0, sp * split,
                             min(sp * split + split, K), bands_written);
  else
    split_k_products<WT, NT, true>(acc, smem, x + (size_t)rt * ROWS * K, w, nullptr, m, K, N, 0, n0, I,
                                   sp * split, min(sp * split + split, K));
  if (splits > 1 && !split_k_merge<NT>(acc, part, arrivals, rt * bands + band, splits, sp, last)) return;
  split_k_tile<NT>(acc, tile);
  __syncthreads();
  if constexpr (phase == 2) {
    split_k_store<WT>(tile, s2, out + (size_t)rt * ROWS * H, m, H, n0);
    return;
  }
  // act: rows < m, 8 columns a thread at a time, gate at tile columns c, up at PAIR + c
  for (int idx = threadIdx.x; idx < m * (PAIR / 8); idx += SK_THREADS) {
    const int r = idx / (PAIR / 8), c = idx % (PAIR / 8) * 8;
    float v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float gate = tile[r * SK_OUT_ROW + c + i] * __ldg(s1 + n0 + c + i);
      const float up = tile[r * SK_OUT_ROW + PAIR + c + i] * __ldg(s1 + I + n0 + c + i);
      v[i] = gate / (1.f + expf(-gate)) * up;
    }
    store8(act + (size_t)(rt * ROWS + r) * I + n0 + c, v);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    store_release(ready + rt * bands + band, epoch);
  }
}

// Three blocks an SM, as qmm_split_k runs (the bound caps the registers at
// 80 a thread). The handoff between the phases is a flag a phase-1 band
// (its last block sets ready[band] to this call's `epoch` once the band's
// act is written), and a phase-2 item waits only for the bands its K range
// reads, so phase 2 starts while phase 1's last bands finish; the grid is
// co-resident, so every flag a block waits for is set by a block that
// waits for none in phase 1.
template <typename WT, int NT>
__global__ void __launch_bounds__(qmm::SK_THREADS, 3)
    fused_mlp_split_k(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w1,
                      const float* __restrict__ s1, const uint8_t* __restrict__ w2,
                      const float* __restrict__ s2, __nv_bfloat16* act, float* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ arrivals, int* ready, int epoch, int B, int H,
                      int I, int split1, int split2) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last;
  const int n_rt = (B + 8 * NT - 1) / (8 * NT);
  // the split-K workspace: phase 1's slots (a row tile and band each), then
  // phase 2's, so that phase 2's arrivals and partials never meet phase 1's
  const int slots1 = n_rt * (I / PAIR), splits1 = (H + split1 - 1) / split1;
  float* part2 = part + (size_t)slots1 * splits1 * 8 * NT * qmm::SK_BN;
  for (int item = blockIdx.x; item < slots1 * splits1; item += gridDim.x)
    mlp_item<WT, NT, 1>(item, smem, last, x, w1, s1, s2, act, out, part, arrivals, ready, epoch, B, H, I, split1);
  const int items2 = n_rt * ((H + qmm::SK_BN - 1) / qmm::SK_BN) * ((I + split2 - 1) / split2);
  for (int item = blockIdx.x; item < items2; item += gridDim.x)
    mlp_item<WT, NT, 2>(item, smem, last, act, w2, s1, s2, act, out, part2, arrivals + slots1, ready, epoch, B, H,
                        I, split2);
}

// One cooperative launch of the split-K form: every block resident, each
// looping over a phase's (row tile, band, split) items.
template <typename WT, int NT>
cudaError_t launch_split_k(const void* x, const void* w1, const void* s1, const void* w2, const void* s2,
                           void* act, void* out, void* part, void* arrivals, void* ready, int epoch, int B, int H,
                           int I, int split1, int split2, cudaStream_t stream) {
  auto kernel = fused_mlp_split_k<WT, NT>;
  constexpr int smem = qmm::SplitK<WT, NT>::SMEM;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, qmm::SK_THREADS, smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  if (split1 <= 0 || split1 % 16 || split2 <= 0 || split2 % 16) return cudaErrorInvalidValue;
  const int n_rt = (B + 8 * NT - 1) / (8 * NT);
  const int items1 = n_rt * (I / PAIR) * ((H + split1 - 1) / split1);
  const int items2 = n_rt * ((H + qmm::SK_BN - 1) / qmm::SK_BN) * ((I + split2 - 1) / split2);
  const int work = items1 > items2 ? items1 : items2;
  const int grid = work < per_sm * sms ? work : per_sm * sms;
  const __nv_bfloat16* xp = static_cast<const __nv_bfloat16*>(x);
  const uint8_t* w1p = static_cast<const uint8_t*>(w1);
  const float* s1p = static_cast<const float*>(s1);
  const uint8_t* w2p = static_cast<const uint8_t*>(w2);
  const float* s2p = static_cast<const float*>(s2);
  __nv_bfloat16* actp = static_cast<__nv_bfloat16*>(act);
  float* outp = static_cast<float*>(out);
  float* partp = static_cast<float*>(part);
  int* arrp = static_cast<int*>(arrivals);
  int* readyp = static_cast<int*>(ready);
  void* args[] = {&xp,   &w1p, &s1p, &w2p, &s2p, &actp, &outp,   &partp,
                  &arrp, &readyp, &epoch, &B, &H, &I, &split1, &split2};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(qmm::SK_THREADS), args,
                                  smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename WT>
cudaError_t launch_split_k_rows(const void* x, const void* w1, const void* s1, const void* w2, const void* s2,
                                void* act, void* out, void* part, void* arrivals, void* ready, int epoch, int B,
                                int H, int I, int split1, int split2, cudaStream_t stream) {
  auto run = B <= 8    ? launch_split_k<WT, 1>
             : B <= 16 ? launch_split_k<WT, 2>
             : B <= 32 ? launch_split_k<WT, 4>
                       : launch_split_k<WT, 8>;
  return run(x, w1, s1, w2, s2, act, out, part, arrivals, ready, epoch, B, H, I, split1, split2, stream);
}

template <typename XT, typename WT, int RB>
cudaError_t launch(const void* x, const void* w1, const void* s1, const void* w2, const void* s2,
                   void* act, void* out, void* bar, int B, int H, int I, cudaStream_t stream) {
  auto kernel = fused_mlp_kernel<XT, WT, RB>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int n_rt = (B + RB - 1) / RB;
  const int work = n_rt * (I / TC1 > H / TC2 ? I / TC1 : H / TC2);
  const int grid = work < per_sm * sms ? work : per_sm * sms;
  const XT* xp = static_cast<const XT*>(x);
  const uint8_t* w1p = static_cast<const uint8_t*>(w1);
  const float* s1p = static_cast<const float*>(s1);
  const uint8_t* w2p = static_cast<const uint8_t*>(w2);
  const float* s2p = static_cast<const float*>(s2);
  XT* actp = static_cast<XT*>(act);
  float* outp = static_cast<float*>(out);
  unsigned int* barp = static_cast<unsigned int*>(bar);
  void* args[] = {&xp, &w1p, &s1p, &w2p, &s2p, &actp, &outp, &barp, &B, &H, &I};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel), dim3(grid), dim3(THREADS), args,
                                  0, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename XT, typename WT>
cudaError_t launch_rows(const void* x, const void* w1, const void* s1, const void* w2, const void* s2,
                        void* act, void* out, void* bar, int B, int H, int I, cudaStream_t stream) {
  if (B <= 8) return launch<XT, WT, 8>(x, w1, s1, w2, s2, act, out, bar, B, H, I, stream);
  if (B <= 16) return launch<XT, WT, 16>(x, w1, s1, w2, s2, act, out, bar, B, H, I, stream);
  return launch<XT, WT, 32>(x, w1, s1, w2, s2, act, out, bar, B, H, I, stream);
}

}  // namespace

extern "C" {

const char* error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }

// x (B, H) bf16 (x_bf16 = 1) or fp32; w1 (H, 2I), w2 (I, H) int8 (w_fp8 = 0)
// or float8_e4m3fn, one layer each; s1 (2I,), s2 (H,) fp32; act (B, I) in
// x's dtype (scratch); out (B, H) fp32. fp32 x: bar, one uint32 of the
// device's barrier counter (zero-initialized once, never reset). bf16 x:
// part / arrivals, the split-K workspace (fp32 partials; int32 counters at
// zero, left at zero); ready, a flag a (row tile, phase-1 band), and epoch,
// a value no earlier call on these flags passed; split1 / split2, the K
// rows of a split in each phase (multiples of 16; ops/fused_mlp.py:
// split_plan).
int fused_mlp(const void* x, const void* w1, const void* s1, const void* w2, const void* s2, void* act,
              void* out, void* bar, void* part, void* arrivals, void* ready, int epoch, int B, int H, int I,
              int split1, int split2, int x_bf16, int w_fp8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (x_bf16) {
    e = w_fp8 ? launch_split_k_rows<__nv_fp8_e4m3>(x, w1, s1, w2, s2, act, out, part, arrivals, ready, epoch, B,
                                                   H, I, split1, split2, s)
              : launch_split_k_rows<int8_t>(x, w1, s1, w2, s2, act, out, part, arrivals, ready, epoch, B, H, I,
                                            split1, split2, s);
  } else {
    e = w_fp8 ? launch_rows<float, __nv_fp8_e4m3>(x, w1, s1, w2, s2, act, out, bar, B, H, I, s)
              : launch_rows<float, int8_t>(x, w1, s1, w2, s2, act, out, bar, B, H, I, s);
  }
  return static_cast<int>(e);
}

}  // extern "C"
