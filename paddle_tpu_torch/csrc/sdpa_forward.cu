// Flash attention forward (B6) for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_sdpa_fwd_kernel`
// (entry `pallas_sdpa_forward`). In the port it also takes the shapes that
// the JAX package's `flash_attention` hands to jax's library flash kernel
// on a TPU (`_shapes_ok_for_lib`): cross-attention (Sq != Skv), non-causal
// self-attention longer than the shortseq kernel takes, and head dims 192
// and 256. Plain PyTorch version and wrapper:
// paddle_tpu_torch/ops/flash_attention.py (`sdpa_forward_plain`,
// `sdpa_forward`).
//
// What it computes, per (batch*head) row block of q [BH, Sq, D] against
// k, v [BH, Skv, D]: O = softmax(q k^T * scale) v, the TPU kernel's
// arithmetic: q, k and v enter the products as fp32; when causal, keys
// after the query get -1e30; the softmax is online (a running max m, a
// running sum l and an fp32 accumulator, rescaled by exp(m_prev - m_new)
// at every key tile); the probabilities enter PV unrounded, in fp32 (where
// the causal kernel B1 rounds them to v's dtype); O = acc / max(l, 1e-30)
// is cast once to the input dtype. There is no LSE output.
//
// Differences from the TPU kernel: the TPU grid (BH, q block, k block)
// carries acc, m and l in VMEM scratch along its sequential k axis. Here
// one CTA owns one (bh, q tile) and an in-CTA loop walks 64-key tiles, m,
// l and the accumulator in registers. Any Sq and Skv: the ragged edges are
// zero-filled and keys past Skv get probability 0 (the TPU kernel needs S
// % block == 0); q rows past Sq are not stored. Causal runs only at Sq ==
// Skv; key tiles wholly above the diagonal are never loaded, as the TPU
// kernel's `run` skips them. No atomics: every output element is written
// once by one thread, so the result is the same bits from run to run.
//
// Bound on this card: operations. 4 * BH * Sq * Skv * D FLOP (QK and PV),
// about half of that when causal, over 989 TFLOP/s bf16: at the
// Transformer-base encoder's B8 H8 S1024 D64 that is 34.4 GFLOP, about
// 35 us.
//
// Two designs, by dtype:
// - bfloat16 (`sdpa_fwd_mma_kernel`): the tensor cores through `mma.sync`
//   (attention_mma.cuh), FlashAttention-2's shape. One CTA per (bh,
//   128-row q tile), 8 warps of 16 q rows; 64-key K and V tiles through a
//   two-stage `cp.async` ring into swizzled shared memory. QK on the
//   tensor cores is the fp32 product of the contract: a product of two
//   bf16 values is exact in fp32, and fp32 accumulation differs from it
//   only in the order of the sums. P is not rounded: it enters PV as hi =
//   bf16(p) and lo = bf16(p - hi), acc += hi V + lo V, two products on the
//   same V fragments (hi + lo carries p to about 2^-16 relative, far below
//   the bf16 output's rounding), so PV costs twice its FLOP: 1.5x the
//   counted total. Q stays in registers as A fragments up to D 128; at D
//   192 and 256, where the accumulator alone takes 96 and 128 registers a
//   lane, each key tile reads Q's fragments again from shared memory.
//   The tile copies run as rolled loops, which hold fewer registers for
//   their addresses (with unrolled copies the kernel spills at D 256).
//   Shared memory: 48 KB at D 64, 144 KB at D 192, 128 KB at D 256. When
//   causal, a warp skips a tile wholly above its rows, only tiles that
//   cross its diagonal are masked, and the heaviest q tiles are launched
//   first. Not yet `wgmma` or TMA.
// - float32 (`sdpa_fwd_fma_kernel`, the first design): plain fp32 FMA from
//   fp32 shared-memory tiles with rows padded to D + 1 floats, one CTA per
//   (bh, 64-row q tile), 214,016 bytes at D = 256. It serves the f32
//   parity runs, which hold the card to the CPU at 1e-5, a bar a TF32
//   tensor-core product (about 1e-3) cannot meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// ---------------------------------------------------------------------------
// float32: the first design, scalar FMA
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kTPR = 4;          // threads per q row
constexpr int kThreads = kBQ * kTPR;

// the first design's loads and stores, instantiated for float only
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles with rows padded to D + 1 floats (no bank conflicts on
  // a column walk), plus the fp32 probability tile padded to kBK + 1.
  return (3 * kBQ * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

// grid (ceil(Sq / kBQ), BH), block kThreads. Thread (r, part) owns q row
// r of the tile; for QK it scores keys c = j * kTPR + part, for PV it
// accumulates output columns d = j * kTPR + part.
template <typename T, int D, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(kThreads) sdpa_fwd_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
    float scale, float* __restrict__ lse) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * DP;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  const int gq = q0 + r;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int g = q0 + rr;
    sQ[rr * DP + d] =
        g < Sq ? to_f(q[qbase + static_cast<size_t>(g) * D + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[D / kTPR];
#pragma unroll
  for (int j = 0; j < D / kTPR; ++j) acc[j] = 0.f;

  // causal (Sq == Skv): keys past the tile's last row are all masked
  const int kend = CAUSAL ? min(q0 + kBQ, Skv) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, d = i % D;
      const int g = k0 + rr;
      const bool in = g < Skv;
      const size_t at = kbase + static_cast<size_t>(g) * D + d;
      sK[rr * DP + d] = in ? to_f(k[at]) : 0.f;
      sV[rr * DP + d] = in ? to_f(v[at]) : 0.f;
    }
    __syncthreads();

    // s = q k^T * scale; -1e30 above the diagonal, as the TPU kernel
    // masks; keys past Skv take no part (the TPU kernel has none)
    float sc[kBK / kTPR];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kBK / kTPR; ++j) {
      const int c = j * kTPR + part;
      const int gk = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += sQ[r * DP + d] * sK[c * DP + d];
      dot *= scale;
      if (CAUSAL && gk > gq) dot = kNegInf;
      sc[j] = dot;
      if (gk < Skv) tmax = fmaxf(tmax, dot);
    }
#pragma unroll
    for (int off = 1; off < kTPR; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / kTPR; ++j) {
      const int c = j * kTPR + part;
      const float p = k0 + c < Skv ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      sP[r * PP + c] = p;  // fp32: B6 does not round P before PV
    }
#pragma unroll
    for (int off = 1; off < kTPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own warp

    const int cend = min(kBK, Skv - k0);
#pragma unroll
    for (int j = 0; j < D / kTPR; ++j) acc[j] *= alpha;
    for (int c = 0; c < cend; ++c) {
      const float p = sP[r * PP + c];
#pragma unroll
      for (int j = 0; j < D / kTPR; ++j)
        acc[j] += p * sV[c * DP + j * kTPR + part];
    }
  }

  if (gq < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    const size_t at = qbase + static_cast<size_t>(gq) * D;
#pragma unroll
    for (int j = 0; j < D / kTPR; ++j)
      o[at + j * kTPR + part] = from_f<T>(acc[j] / denom);
    if (LSE && part == 0)
      lse[static_cast<size_t>(bh) * Sq + gq] = m + logf(l);
  }
}

template <typename T, int D, bool CAUSAL, bool LSE>
int launch_fma(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int Sq, int Skv, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_fwd_fma_kernel<T, D, CAUSAL, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, bh);
  sdpa_fwd_fma_kernel<T, D, CAUSAL, LSE><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, scale, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// head dims 320 to 512, both dtypes: the wide design, scalar FMA
// ---------------------------------------------------------------------------
// The mma design keeps a row's fp32 accumulator in registers (D / 2 a lane
// at 16 rows a warp): 160 to 256 registers above D 256, past the register
// file. Here one CTA owns 32 q rows, 8 threads a row, so a thread holds
// D / 8 accumulators (64 at D 512); 32-key tiles of K and V and the q tile
// sit in shared memory as fp32 rows padded to D + 1 floats, 201,216 bytes
// at D 512, so one CTA an SM (`__launch_bounds__(256, 1)`: without the 1,
// ptxas aimed at more and spilled). The arithmetic is the first design's:
// fp32 products of the inputs, the online softmax, P unrounded into PV.
constexpr int kWideBQ = 32;      // q rows per CTA
constexpr int kWideBK = 32;      // keys per tile
constexpr int kWideTPR = 8;      // threads per q row
constexpr int kWideThreads = kWideBQ * kWideTPR;

template <int D>
constexpr size_t wide_smem_bytes() {
  return (3 * kWideBQ * (D + 1) + kWideBQ * (kWideBK + 1)) * sizeof(float);
}

__device__ __forceinline__ float wide_f(float x) { return x; }
__device__ __forceinline__ float wide_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T wide_t(float x);
template <>
__device__ __forceinline__ float wide_t<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 wide_t<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// grid (ceil(Sq / kWideBQ), BH), block kWideThreads. Thread (r, part) owns
// q row r; for QK it scores keys c = j * kWideTPR + part, for PV it
// accumulates output columns d = j * kWideTPR + part.
template <typename T, int D, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(kWideThreads, 1) sdpa_fwd_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
    float scale, float* __restrict__ lse) {
  constexpr int DP = D + 1;
  constexpr int PP = kWideBK + 1;
  constexpr int NJ = D / kWideTPR;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kWideBQ * DP;
  float* sV = sK + kWideBK * DP;
  float* sP = sV + kWideBK * DP;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kWideBQ;
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const int tid = threadIdx.x;
  const int r = tid / kWideTPR;
  const int part = tid % kWideTPR;
  const int gq = q0 + r;

  for (int i = tid; i < kWideBQ * D; i += kWideThreads) {
    const int rr = i / D, d = i % D;
    const int g = q0 + rr;
    sQ[rr * DP + d] =
        g < Sq ? wide_f(q[qbase + static_cast<size_t>(g) * D + d]) : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  const int kend = CAUSAL ? min(q0 + kWideBQ, Skv) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kWideBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kWideBK * D; i += kWideThreads) {
      const int rr = i / D, d = i % D;
      const int g = k0 + rr;
      const bool in = g < Skv;
      const size_t at = kbase + static_cast<size_t>(g) * D + d;
      sK[rr * DP + d] = in ? wide_f(k[at]) : 0.f;
      sV[rr * DP + d] = in ? wide_f(v[at]) : 0.f;
    }
    __syncthreads();

    float sc[kWideBK / kWideTPR];
    float tmax = kNegInf;
#pragma unroll
    for (int j = 0; j < kWideBK / kWideTPR; ++j) {
      const int c = j * kWideTPR + part;
      const int gk = k0 + c;
      float dot = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) dot += sQ[r * DP + d] * sK[c * DP + d];
      dot *= scale;
      if (CAUSAL && gk > gq) dot = kNegInf;
      sc[j] = dot;
      if (gk < Skv) tmax = fmaxf(tmax, dot);
    }
#pragma unroll
    for (int off = 1; off < kWideTPR; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kWideBK / kWideTPR; ++j) {
      const int c = j * kWideTPR + part;
      const float p = k0 + c < Skv ? expf(sc[j] - m_new) : 0.f;
      psum += p;
      sP[r * PP + c] = p;
    }
#pragma unroll
    for (int off = 1; off < kWideTPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float alpha = expf(m - m_new);
    l = alpha * l + psum;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own warp

    const int cend = min(kWideBK, Skv - k0);
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[j] *= alpha;
    for (int c = 0; c < cend; ++c) {
      const float p = sP[r * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        acc[j] += p * sV[c * DP + j * kWideTPR + part];
    }
  }

  if (gq < Sq) {
    const float denom = fmaxf(l, 1e-30f);
    const size_t at = qbase + static_cast<size_t>(gq) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      o[at + j * kWideTPR + part] = wide_t<T>(acc[j] / denom);
    if (LSE && part == 0)
      lse[static_cast<size_t>(bh) * Sq + gq] = m + logf(l);
  }
}

template <typename T, int D, bool CAUSAL, bool LSE>
int launch_wide(const void* q, const void* k, const void* v, void* o,
                float* lse, int bh, int Sq, int Skv, float scale,
                cudaStream_t stream) {
  constexpr size_t bytes = wide_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_fwd_wide_kernel<T, D, CAUSAL, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kWideBQ - 1) / kWideBQ, bh);
  sdpa_fwd_wide_kernel<T, D, CAUSAL, LSE>
      <<<grid, kWideThreads, bytes, stream>>>(
          static_cast<const T*>(q), static_cast<const T*>(k),
          static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, scale, lse);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaBQ = 128;      // q rows per CTA, 16 per warp
constexpr int kMmaThreads = 256;

// keys per tile: 64, and 32 at D 256, where a 64-key score tile (32
// registers a lane) beside the 128-register accumulator spilled
template <int D>
__host__ __device__ constexpr int mma_bk() { return D > 192 ? 32 : 64; }

template <int D>
constexpr size_t mma_smem_bytes() {
  // the Q tile and two stages of the K and V tiles, bf16
  return (kMmaBQ + 4 * mma_bk<D>()) * D * sizeof(__nv_bfloat16);
}

// grid (BH, ceil(Sq / kMmaBQ)), block kMmaThreads. Warp w owns q rows
// q0 + 16w .. q0 + 16w + 15; lane (g, t) holds rows g and g + 8 of them.
template <int D, bool CAUSAL, bool LSE>
__global__ void __launch_bounds__(kMmaThreads) sdpa_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    int Sq, int Skv, float scale, float* __restrict__ lse) {
  using namespace attn_mma;
  constexpr int BK = mma_bk<D>();  // keys per tile
  constexpr int KD = D / 16;       // k-steps over the head dim
  constexpr int ND = D / 8;        // 8-column blocks of O
  constexpr int NK = BK / 8;       // 8-key blocks of S
  constexpr bool kQRegs = D <= 128;  // Q's A fragments held in registers
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kMmaBQ * D;                  // [2][BK][D]
  bf16* sV = sK + 2 * BK * D;                  // [2][BK][D]

  const int bh = blockIdx.x;
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kMmaBQ;                  // causal: heaviest first
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;             // the warp's first q row
  // causal (Sq == Skv): no key past the tile's diagonal
  const int kend = CAUSAL ? min(q0 + kMmaBQ, Skv) : Skv;
  const int ntiles = (kend + BK - 1) / BK;
  const uint32_t cQ = smem_u32(sQ);

  load_tile<kMmaBQ, D, kMmaThreads, true>(sQ, q + qbase, q0, Sq, tid);
  load_tile<BK, D, kMmaThreads, true>(sK, k + kbase, 0, Skv, tid);
  load_tile<BK, D, kMmaThreads, true>(sV, v + kbase, 0, Skv, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[kQRegs ? KD : 1][4];
  if constexpr (kQRegs) {
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
      ldsm_x4(qf[kk], frag_addr<D>(cQ, warp * 16, kk * 16, lane));
  }

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};   // running row max, rows g and g + 8
  float l[2] = {0.f, 0.f};           // this lane's share of the row sum

  for (int j = 0; j < ntiles; ++j) {
    if (j > 0) {
      cp_async_wait<0>();  // tile j has landed
      __syncthreads();     // ... for every thread; tile j - 1 is released
    }
    if (j + 1 < ntiles) {
      const int stage = (j + 1) & 1;
      load_tile<BK, D, kMmaThreads, true>(sK + stage * BK * D, k + kbase,
                                          (j + 1) * BK, Skv, tid);
      load_tile<BK, D, kMmaThreads, true>(sV + stage * BK * D, v + kbase,
                                          (j + 1) * BK, Skv, tid);
    }
    cp_async_commit();
    const int k0 = j * BK;
    if (CAUSAL && k0 > wrow + 15) continue;  // every key above the rows
    const uint32_t cK = smem_u32(sK + (j & 1) * BK * D);
    const uint32_t cV = smem_u32(sV + (j & 1) * BK * D);

    float s[NK][4];
#pragma unroll
    for (int nb = 0; nb < NK; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
    if constexpr (kQRegs) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) qk_step<D>(s, qf[kk], cK, kk, lane);
    } else {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, frag_addr<D>(cQ, warp * 16, kk * 16, lane));
        qk_step<D>(s, a, cK, kk, lane);
      }
    }

    // scale; -1e30 above the diagonal on a tile that crosses it (the TPU
    // kernel's mask); keys past Skv, zero-filled by the copy, take no part
    // in the max and get p = 0; the tile's row max
    const bool diag = CAUSAL && k0 + BK - 1 > wrow;
    const bool tail = k0 + BK > Skv;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        const int key = k0 + nb * 8 + 2 * t + (e & 1);
        if (diag && key > wrow + g + (e >> 1) * 8) x = kNegInf;
        if (tail && key >= Skv) x = -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = quad_max(mx[i]);
      alpha[i] = exp2f((m[i] - mx[i]) * kLog2e);
      m[i] = mx[i];
    }
    // p = exp(s - m_new), unrounded into the row sums and, split into hi
    // and lo bf16 fragments, into PV
    float ps[2] = {0.f, 0.f};
#pragma unroll
    for (int nb = 0; nb < NK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nb][e] - m[e >> 1]) * kLog2e);  // masked: 0
        s[nb][e] = p;
        ps[e >> 1] += p;
      }
    }
    l[0] = alpha[0] * l[0] + ps[0];
    l[1] = alpha[1] * l[1] + ps[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t hi[4], lo[4];
      c_to_a_split(hi, lo, s, kk);
      pv_step_split<D>(acc, hi, lo, cV, kk, lane);
    }
  }

  // O = acc / max(l, 1e-30), one cast; rows past Sq are not stored; the
  // LSE variant also stores m + log(l) of rows g and g + 8
  float den[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float lt = quad_sum(l[i]);
    den[i] = fmaxf(lt, 1e-30f);
    if (LSE) {
      const int row = wrow + g + 8 * i;
      if (t == 0 && row < Sq)
        lse[static_cast<size_t>(bh) * Sq + row] = m[i] + logf(lt);
    }
  }
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] /= den[0];
    acc[nd][1] /= den[0];
    acc[nd][2] /= den[1];
    acc[nd][3] /= den[1];
  }
  store_rows<D>(o + qbase, acc, wrow, Sq, lane, 1.f, 1.f);
}

template <int D, bool CAUSAL, bool LSE>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               float* lse, int bh, int Sq, int Skv, float scale,
               cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_fwd_mma_kernel<D, CAUSAL, LSE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (Sq + kMmaBQ - 1) / kMmaBQ);
  sdpa_fwd_mma_kernel<D, CAUSAL, LSE><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      Sq, Skv, scale, lse);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: the fp32 FMA design; 1: mma.sync; the LSE variant when lse is
// given
template <int D, bool CAUSAL>
int launch_dtype(const void* q, const void* k, const void* v, void* o,
                 float* lse, int dtype, int bh, int Sq, int Skv, float scale,
                 cudaStream_t stream) {
  if (dtype == 0)
    return lse ? launch_fma<float, D, CAUSAL, true>(q, k, v, o, lse, bh, Sq,
                                                    Skv, scale, stream)
               : launch_fma<float, D, CAUSAL, false>(q, k, v, o, lse, bh, Sq,
                                                     Skv, scale, stream);
  if (dtype == 1)
    return lse ? launch_mma<D, CAUSAL, true>(q, k, v, o, lse, bh, Sq, Skv,
                                             scale, stream)
               : launch_mma<D, CAUSAL, false>(q, k, v, o, lse, bh, Sq, Skv,
                                              scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// head dims over 256, both dtypes: the wide design
template <int D, bool CAUSAL>
int launch_wide_dtype(const void* q, const void* k, const void* v, void* o,
                      float* lse, int dtype, int bh, int Sq, int Skv,
                      float scale, cudaStream_t stream) {
  if (dtype == 0)
    return lse ? launch_wide<float, D, CAUSAL, true>(q, k, v, o, lse, bh, Sq,
                                                     Skv, scale, stream)
               : launch_wide<float, D, CAUSAL, false>(q, k, v, o, lse, bh,
                                                      Sq, Skv, scale, stream);
  if (dtype == 1)
    return lse ? launch_wide<__nv_bfloat16, D, CAUSAL, true>(
                     q, k, v, o, lse, bh, Sq, Skv, scale, stream)
               : launch_wide<__nv_bfloat16, D, CAUSAL, false>(
                     q, k, v, o, lse, bh, Sq, Skv, scale, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int D>
int launch_causal(const void* q, const void* k, const void* v, void* o,
                  float* lse, int dtype, int bh, int Sq, int Skv, int causal,
                  float scale, cudaStream_t stream) {
  if (causal && Sq != Skv) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D <= 256) {
    if (causal)
      return launch_dtype<D, true>(q, k, v, o, lse, dtype, bh, Sq, Skv, scale,
                                   stream);
    return launch_dtype<D, false>(q, k, v, o, lse, dtype, bh, Sq, Skv, scale,
                                  stream);
  } else {
    if (causal)
      return launch_wide_dtype<D, true>(q, k, v, o, lse, dtype, bh, Sq, Skv,
                                        scale, stream);
    return launch_wide_dtype<D, false>(q, k, v, o, lse, dtype, bh, Sq, Skv,
                                       scale, stream);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o [bh, Sq, head_dim] and k/v [bh,
// Skv, head_dim], contiguous (16-byte aligned for bf16); head_dim a
// multiple of 64 up to 512 (64-256: the FMA design for float32 and
// mma.sync for bfloat16; 320-512: the wide design for both); causal only
// at Sq == Skv. lse NULL: the inference instance, no LSE; else [bh, Sq]
// fp32, m + log(l) of each row. Returns the launch's cudaError_t (0 on
// success).
extern "C" int sdpa_forward(const void* q, const void* k, const void* v,
                            void* o, void* lse, int dtype, int bh, int Sq,
                            int Skv, int head_dim, int causal, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  switch (head_dim) {
#define SDPA_FWD_CASE(D)                                                    \
    case D:                                                                 \
      return launch_causal<D>(q, k, v, o, l, dtype, bh, Sq, Skv, causal,    \
                              scale, st);
    SDPA_FWD_CASE(64)
    SDPA_FWD_CASE(128)
    SDPA_FWD_CASE(192)
    SDPA_FWD_CASE(256)
    SDPA_FWD_CASE(320)
    SDPA_FWD_CASE(384)
    SDPA_FWD_CASE(448)
    SDPA_FWD_CASE(512)
#undef SDPA_FWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
