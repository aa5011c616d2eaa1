// Causal self-attention backward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_causal_bwd_kernel`
// (entry `_causal_call_bwd`, the backward of `_causal_attention`'s
// custom_vjp). Plain PyTorch version and wrapper:
// paddle_tpu_torch/ops/flash_attention.py (`causal_attention_bwd`).
//
// What it computes, per (batch*head) of [BH, S, D] inputs, from the
// forward's output O and its per-row LSE ([BH, S] fp32):
//   P  = exp(q k^T * scale - lse)        (fp32, causal; recomputed)
//   dV = P_b^T dO                        (P rounded to v's dtype first)
//   dP = dO v^T, delta = rowsum(dO * O)  (both fp32)
//   dS = P * (dP - delta) * scale        (rounded to q's dtype)
//   dQ = dS k, dK = dS^T q               (fp32 sums, each cast once)
// The rounding points are the TPU kernel's, so an f32 run matches it to
// the order of fp32 sums and a bf16 run rounds P and dS where it does.
// Any S: ragged last tiles are zero-filled and masked here.
//
// Differences from the TPU kernel: the TPU walks the q blocks of one head
// in order inside one program and carries dK/dV in VMEM scratch across
// them. Blocks of a CUDA grid run in parallel in no order, so the work is
// split into three launches that need no atomics and give the same bits
// on every run:
//   1. delta_kernel: delta = rowsum(dO * O) once per row, into a [BH, S]
//      fp32 scratch the wrapper allocates;
//   2. dkdv_kernel: one CTA per (bh, 64-key tile) holds its K and V tile
//      and its fp32 dK/dV in registers, and walks the q tiles from the
//      diagonal to S;
//   3. dq_kernel: one CTA per (bh, 64-row q tile) holds its Q and dO tile
//      and walks the key tiles up to the diagonal.
// Scores and dP are recomputed in both 2 and 3 (7 products of the causal
// half instead of the TPU kernel's 5), the price of no atomics.
//
// Bound on this card: operations. 5 * BH * D * S * (S + 1) causal FLOP
// over 989 TFLOP/s bf16: at B2 H16 S2048 D128 that is 85.9 GFLOP, about
// 87 us; the bytes (q, k, v, O, dO read, dq, dk, dv written, ~134 MB) take
// 40 us at 3.35 TB/s. This first design is far from it: fp32 FMA from
// shared memory as in the forward, no tensor cores (no mma.sync or
// wgmma), no TMA. Tiles are fp32 in dynamic shared memory (up to 166 KB at
// D 128), rows padded to D + 1 floats so column walks do not conflict.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kB = 64;           // q rows per q tile, keys per key tile
constexpr int kTPR = 4;          // threads per tile row
constexpr int kThreads = kB * kTPR;

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
  // Q, dO, K, V tiles [kB][D + 1]; rounded dS [kB][kB + 1]
  return (4 * kB * (D + 1) + kB * (kB + 1)) * sizeof(float);
}

// rows [r0, r0 + kB) of a [S, D] slab at `base` into a [kB][D + 1] fp32
// tile, rows at or past S zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, int r0, int S) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int g = r0 + rr;
    dst[rr * (D + 1) + d] =
        g < S ? to_f(src[base + static_cast<size_t>(g) * D + d]) : 0.f;
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32, one warp per row.
template <typename T>
__global__ void delta_kernel(const T* __restrict__ o,
                             const T* __restrict__ dout,
                             float* __restrict__ delta, int rows, int D) {
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

// grid (ceil(S / kB), BH), block kThreads. Thread (c, part) owns key c of
// the tile: for scores it takes q rows r = j * kTPR + part, for dK/dV it
// accumulates columns d = j * kTPR + part.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int S, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NJ = D / kTPR;
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

  load_tile<T, D>(sK, k, base, k0, S);
  load_tile<T, D>(sV, v, base, k0, S);
  float acc_dk[NJ], acc_dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_dk[j] = acc_dv[j] = 0.f;

  // q tiles above the diagonal see none of these keys: start at it
  for (int q0 = k0; q0 < S; q0 += kB) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile<T, D>(sQ, q, base, q0, S);
    load_tile<T, D>(sDO, dout, base, q0, S);
    if (tid < kB) {
      const int g = q0 + tid;
      sL[tid] = g < S ? lse[rbase + g] : 0.f;
      sD[tid] = g < S ? delta[rbase + g] : 0.f;
    }
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kB / kTPR; ++j) {
      const int r = j * kTPR + part;
      const int gq = q0 + r;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += sQ[r * DP + d] * sK[c * DP + d];
        dp += sDO[r * DP + d] * sV[c * DP + d];
      }
      s *= scale;
      const bool live = gq < S && gk <= gq;
      const float p = live ? expf(s - sL[r]) : 0.f;
      sP[r * PP + c] = round_to<T>(p);
      sDS[r * PP + c] = round_to<T>(p * (dp - sD[r]) * scale);
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

  if (gk < S) {
    const size_t at = base + static_cast<size_t>(gk) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[at + j * kTPR + part] = from_f<T>(acc_dk[j]);
      dv[at + j * kTPR + part] = from_f<T>(acc_dv[j]);
    }
  }
}

// grid (ceil(S / kB), BH), block kThreads. Thread (r, part) owns q row r
// of the tile: for scores it takes keys c = j * kTPR + part, for dQ it
// accumulates columns d = j * kTPR + part.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int S, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NJ = D / kTPR;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kB * DP;
  float* sK = sDO + kB * DP;
  float* sV = sK + kB * DP;
  float* sDS = sV + kB * DP;   // [q row][key]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kB;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const size_t rbase = static_cast<size_t>(bh) * S;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  const int gq = q0 + r;
  const float l = gq < S ? lse[rbase + gq] : 0.f;
  const float dl = gq < S ? delta[rbase + gq] : 0.f;

  load_tile<T, D>(sQ, q, base, q0, S);
  load_tile<T, D>(sDO, dout, base, q0, S);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  const int kend = min(q0 + kB, S);  // keys past the tile's diagonal: none
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();  // the previous key tile's reads are done
    load_tile<T, D>(sK, k, base, k0, S);
    load_tile<T, D>(sV, v, base, k0, S);
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < kB / kTPR; ++j) {
      const int c = j * kTPR + part;
      const int gk = k0 + c;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += sQ[r * DP + d] * sK[c * DP + d];
        dp += sDO[r * DP + d] * sV[c * DP + d];
      }
      s *= scale;
      const bool live = gq < S && gk <= gq;
      const float p = live ? expf(s - l) : 0.f;
      sDS[r * PP + c] = round_to<T>(p * (dp - dl) * scale);
    }
    __syncwarp();  // a row's dS comes from its own warp

    for (int c = 0; c < kB; ++c) {
      const float ds = sDS[r * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += ds * sK[c * DP + j * kTPR + part];
    }
  }

  if (gq < S) {
    const size_t at = base + static_cast<size_t>(gq) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[at + j * kTPR + part] = from_f<T>(acc[j]);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int bh, int S, float scale,
           cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  const float* flse = static_cast<const float*>(lse);
  float* fdelta = static_cast<float*>(delta);
  const int rows = bh * S;
  delta_kernel<T><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), tdo, fdelta, rows, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((S + kB - 1) / kB, bh);
  constexpr size_t kv_bytes = dkdv_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_kernel<T, D><<<grid, kThreads, kv_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dk),
      static_cast<T*>(dv), S, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_kernel<T, D><<<grid, kThreads, q_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, static_cast<T*>(dq), S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o/dout/dq/dk/dv [bh, S, head_dim]
// contiguous, lse [bh, S] fp32 (the forward's), delta [bh, S] fp32 scratch.
// Returns the first failing launch's cudaError_t (0 on success).
extern "C" int causal_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv,
                                    int dtype, int bh, int S, int head_dim,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch<float, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh, S,
                             scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch<float, 128>(q, k, v, o, dout, lse, delta, dq, dk, dv, bh,
                              S, scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch<__nv_bfloat16, 64>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                     bh, S, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch<__nv_bfloat16, 128>(q, k, v, o, dout, lse, delta, dq, dk,
                                      dv, bh, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
