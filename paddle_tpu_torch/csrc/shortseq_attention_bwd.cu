// Short-sequence (encoder) attention backward for Hopper (sm_90a), mask-free
// and key-masked.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_shortseq_bwd_kernel`
// and `_shortseq_bwd_kernel_masked` (entry `_shortseq_call_bwd`, the
// backward of `_shortseq_attention`'s custom_vjp). Plain PyTorch version
// and wrapper: paddle_tpu_torch/ops/flash_attention.py
// (`shortseq_attention_bwd`).
//
// What it computes, per (batch*head) of [BH, S, D] inputs, from the
// forward's output O, its per-row LSE ([BH, S] fp32) and the forward's key
// mask, as `_shortseq_bwd_core` does:
//   P  = exp(q k^T * scale + key_mask - lse)  (fp32; recomputed)
//   dV = P_b^T dO                             (P rounded to v's dtype first)
//   dP = dO v^T, delta = rowsum(dO * O)       (both fp32)
//   dS = P * (dP - delta) * scale             (rounded to q's dtype)
//   dQ = dS k, dK = dS^T q                    (fp32 sums, each cast once)
// The mask is added to s again, as it was in the forward. On a row whose
// keys are all masked at -1e30, s and lse both round to -1e30 and P = 1
// for every key (S times the dense softmax's 1/S): the TPU kernel's result,
// which this kernel and its plain version follow.
//
// Design. The TPU kernel does a whole head in one program from VMEM; a
// Hopper block cannot hold q, k, v, O and dO of one head at S 512 (320 KB
// in bf16, 640 KB as the fp32 tiles used here), and blocks of a grid run in
// parallel in no order. So, as the port's causal backward
// (csrc/causal_attention_bwd.cu), the work is three launches with no
// atomics that give the same bits on every run:
//   1. delta_kernel: delta = rowsum(dO * O) per row into a [BH, S] fp32
//      scratch the wrapper allocates;
//   2. dkdv_kernel: one CTA per (bh, 64-key tile) holds its K and V tile
//      and its fp32 dK/dV in registers and walks ALL q tiles;
//   3. dq_kernel: one CTA per (bh, 64-row q tile) holds its Q and dO tile
//      and walks ALL key tiles.
// Scores and dP are recomputed in both 2 and 3 (7 products of S x S x D
// instead of the TPU kernel's 5), the price of no atomics. The masked
// variant is a template flag: kernel 2 reads the mask of its own 64 keys,
// kernel 3 the sequence's mask row, once per CTA. S is a multiple of 128,
// so no tile is ragged.
//
// Bound on this card at the bench shape (B64 H12 S512 D64 bf16):
// operations. 10 * BH * S^2 * D = 128.8 GFLOP takes 0.130 ms at
// 989 TFLOP/s; reading q, k, v, O, dO and the LSE and writing dq, dk, dv,
// 404.2 MB, takes 0.121 ms at 3.35 TB/s. This first design is far from
// it: fp32 FMA from shared memory (no tensor cores: no mma.sync or wgmma),
// no TMA. Tiles are fp32 in dynamic shared memory (up to 166 KB at D 128),
// rows padded to D + 1 floats so column walks do not conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // q rows per q tile, keys per key tile
constexpr int kTPR = 4;          // threads per tile row
constexpr int kThreads = kB * kTPR;
constexpr int kMaxS = 512;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T and read back as float (exact for T = float)
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  // K, V, Q, dO tiles [kB][D + 1]; rounded P and dS [kB][kB + 1]; the q
  // tile's lse and delta
  return (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB) * sizeof(float);
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // Q, dO, K, V tiles [kB][D + 1]; rounded dS [kB][kB + 1]; the mask row
  return (4 * kB * (D + 1) + kB * (kB + 1) + kMaxS) * sizeof(float);
}

// rows [r0, r0 + kB) of a [S, D] slab at `base` into a [kB][D + 1] fp32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, int r0) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    dst[rr * (D + 1) + d] = to_f(src[base + static_cast<size_t>(r0 + rr) * D + d]);
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32, one warp per row.
template <typename T>
__global__ void shortseq_delta_kernel(const T* __restrict__ o,
                                      const T* __restrict__ dout,
                                      float* __restrict__ delta, int rows,
                                      int D) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32)
    s += to_f(dout[base + d]) * to_f(o[base + d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// grid (S / kB, BH), block kThreads. Thread (c, part) owns key c of the
// tile: for scores it takes q rows r = j * kTPR + part, for dK/dV it
// accumulates columns d = j * kTPR + part.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads) shortseq_dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int heads_per_row, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NJ = D / kTPR;
  constexpr int NR = kB / kTPR;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kB * DP;
  float* sQ = sV + kB * DP;
  float* sDO = sQ + kB * DP;
  float* sP = sDO + kB * DP;   // [q row][key]
  float* sDS = sP + kB * PP;   // [q row][key]
  float* sL = sDS + kB * PP;
  float* sD = sL + kB;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kB;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x;
  const int c = tid / kTPR;
  const int part = tid % kTPR;
  const int gk = k0 + c;
  const float mk =
      MASKED ? mask[static_cast<size_t>(bh / heads_per_row) * S + gk] : 0.f;

  load_tile<T, D>(sK, k, base, k0);
  load_tile<T, D>(sV, v, base, k0);
  float acc_dk[NJ], acc_dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_dk[j] = acc_dv[j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kB) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile<T, D>(sQ, q, base, q0);
    load_tile<T, D>(sDO, dout, base, q0);
    if (tid < kB) {
      sL[tid] = lse[rbase + q0 + tid];
      sD[tid] = delta[rbase + q0 + tid];
    }
    __syncthreads();

    float s[NR], dp[NR];
#pragma unroll
    for (int j = 0; j < NR; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float kd = sK[c * DP + d];
      const float vd = sV[c * DP + d];
#pragma unroll
      for (int j = 0; j < NR; ++j) {
        const int r = j * kTPR + part;
        s[j] += sQ[r * DP + d] * kd;
        dp[j] += sDO[r * DP + d] * vd;
      }
    }
#pragma unroll
    for (int j = 0; j < NR; ++j) {
      const int r = j * kTPR + part;
      float x = s[j] * scale;
      if (MASKED) x += mk;
      const float p = expf(x - sL[r]);
      sP[r * PP + c] = round_to<T>(p);
      sDS[r * PP + c] = round_to<T>(p * (dp[j] - sD[r]) * scale);
    }
    __syncthreads();

    for (int r = 0; r < kB; ++r) {
      const float pb = sP[r * PP + c];
      const float ds = sDS[r * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = j * kTPR + part;
        acc_dv[j] += pb * sDO[r * DP + d];
        acc_dk[j] += ds * sQ[r * DP + d];
      }
    }
  }

  const size_t at = base + static_cast<size_t>(gk) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    dk[at + j * kTPR + part] = from_f<T>(acc_dk[j]);
    dv[at + j * kTPR + part] = from_f<T>(acc_dv[j]);
  }
}

// grid (S / kB, BH), block kThreads. Thread (r, part) owns q row r of the
// tile: for scores it takes keys c = j * kTPR + part, for dQ it
// accumulates columns d = j * kTPR + part.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads) shortseq_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S,
    int heads_per_row, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NJ = D / kTPR;
  constexpr int NC = kB / kTPR;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kB * DP;
  float* sK = sDO + kB * DP;
  float* sV = sK + kB * DP;
  float* sDS = sV + kB * DP;   // [q row][key]
  float* sM = sDS + kB * PP;   // the mask row

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  const int gq = q0 + r;
  const float l = lse[rbase + gq];
  const float dl = delta[rbase + gq];

  load_tile<T, D>(sQ, q, base, q0);
  load_tile<T, D>(sDO, dout, base, q0);
  if (MASKED) {
    const float* mrow = mask + static_cast<size_t>(bh / heads_per_row) * S;
    for (int i = tid; i < S; i += kThreads) sM[i] = mrow[i];
  }
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kB) {
    __syncthreads();  // the previous key tile's reads are done
    load_tile<T, D>(sK, k, base, k0);
    load_tile<T, D>(sV, v, base, k0);
    __syncthreads();

    float s[NC], dp[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = dp[j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * DP + d];
      const float od = sDO[r * DP + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int c = j * kTPR + part;
        s[j] += qd * sK[c * DP + d];
        dp[j] += od * sV[c * DP + d];
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = j * kTPR + part;
      float x = s[j] * scale;
      if (MASKED) x += sM[k0 + c];
      const float p = expf(x - l);
      sDS[r * PP + c] = round_to<T>(p * (dp[j] - dl) * scale);
    }
    __syncwarp();  // a row's dS comes from its own warp

    for (int c = 0; c < kB; ++c) {
      const float ds = sDS[r * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += ds * sK[c * DP + j * kTPR + part];
    }
  }

  const size_t at = base + static_cast<size_t>(gq) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) dq[at + j * kTPR + part] = from_f<T>(acc[j]);
}

template <typename T, int D, bool MASKED>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* o, const void* dout, const void* lse, void* delta,
           void* dq, void* dk, void* dv, int bh, int S, int heads_per_row,
           float scale, cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* fm = static_cast<const float*>(mask);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  const int rows = bh * S;
  shortseq_delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), tdo, fdelta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(S / kB, bh);
  auto dkdv = shortseq_dkdv_kernel<T, D, MASKED>;
  constexpr size_t kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<grid, kThreads, kv_bytes, stream>>>(
      tq, tk, tv, fm, tdo, flse, fdelta, static_cast<T*>(dk),
      static_cast<T*>(dv), S, heads_per_row, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto dqk = shortseq_dq_kernel<T, D, MASKED>;
  constexpr size_t q_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<grid, kThreads, q_bytes, stream>>>(tq, tk, tv, fm, tdo, flse, fdelta,
                                           static_cast<T*>(dq), S,
                                           heads_per_row, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_masked_or_not(const void* q, const void* k, const void* v,
                         const void* mask, const void* o, const void* dout,
                         const void* lse, void* delta, void* dq, void* dk,
                         void* dv, int bh, int S, int heads_per_row,
                         float scale, cudaStream_t st) {
  if (mask != nullptr)
    return launch<T, D, true>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv,
                              bh, S, heads_per_row, scale, st);
  return launch<T, D, false>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv,
                             bh, S, heads_per_row, scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o/dout/dq/dk/dv [bh, S, head_dim]
// contiguous, lse [bh, S] fp32 (the forward's), delta [bh, S] fp32 scratch.
// mask: NULL (the mask-free kernels) or the forward's [bh / heads_per_row,
// S] fp32 key mask (the masked kernels). S % 128 == 0 and S <= 512;
// head_dim 64 or 128. Returns the first failing launch's cudaError_t (0 on
// success).
extern "C" int shortseq_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq,
                                      void* dk, void* dv, int dtype, int bh,
                                      int S, int head_dim, int heads_per_row,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 128 != 0 || S > kMaxS || heads_per_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 64)
    return launch_masked_or_not<float, 64>(q, k, v, mask, o, dout, lse, delta,
                                           dq, dk, dv, bh, S, heads_per_row,
                                           scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch_masked_or_not<float, 128>(q, k, v, mask, o, dout, lse,
                                            delta, dq, dk, dv, bh, S,
                                            heads_per_row, scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch_masked_or_not<__nv_bfloat16, 64>(q, k, v, mask, o, dout,
                                                   lse, delta, dq, dk, dv, bh,
                                                   S, heads_per_row, scale,
                                                   st);
  if (dtype == 1 && head_dim == 128)
    return launch_masked_or_not<__nv_bfloat16, 128>(q, k, v, mask, o, dout,
                                                    lse, delta, dq, dk, dv,
                                                    bh, S, heads_per_row,
                                                    scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
