// Attention backward of the library route for Hopper (sm_90a).
//
// Replaces: the backward of jax's library flash kernel, which the JAX
// package's `flash_attention` (paddle_tpu/ops/pallas/flash_attention.py)
// takes on a TPU for the shapes `_shapes_ok_for_lib` admits: non-causal
// attention with any Sq and Skv, or causal with Sq == Skv; Sq and Skv
// multiples of 128; any head dim that is a multiple of 64. It has no Pallas
// kernel of its own. Its forward is B6 (sdpa_forward.cu) with the LSE.
// Plain PyTorch version and wrapper: paddle_tpu_torch/ops/flash_attention.py
// (`sdpa_backward_plain`, `sdpa_backward`).
//
// What it computes, per (batch*head) of q, O, dO [BH, Sq, D] and k, v
// [BH, Skv, D], from the forward's per-row LSE ([BH, Sq] fp32):
//   s  = q k^T * scale                   (fp32; causal: 0 above the diagonal
//                                         once through P)
//   P  = exp(s - lse), delta = rowsum(dO * O)           (both fp32)
//   dV = P_b^T dO, dS = P * (dP - delta) * scale, dP = dO v^T
//   dQ = dS_b k, dK = dS_b^T q           (fp32 sums, each cast once)
// where _b is the value rounded to the input dtype: the causal backward
// B2's rounding points (attention_bwd.cuh), so an f32 run matches the
// plain version to the order of fp32 sums and a bf16 run rounds P and dS
// where B2 does. Ragged: q rows past Sq and keys past Skv take no part.
//
// Three launches and no atomics, as B2: delta once per q row; one CTA per
// (bh, key tile) for dK and dV, walking the q tiles (from the diagonal when
// causal); one CTA per (bh, q tile) for dQ, walking the key tiles (up to
// the diagonal when causal). Scores and dP are computed in both.
//
// Bound on this card: operations. 10 * BH * Sq * Skv * D FLOP (half, with
// the diagonal, when causal) over 989 TFLOP/s bf16: the Transformer-base
// encoder's B8 H8 S1024 D64 is 43.0 GFLOP, 43.4 us; its bytes (q, k, v, O,
// dO and the LSE read, dq, dk, dv written, 67.4 MB) take 20.1 us at
// 3.35 TB/s.
//
// Two designs:
// - bfloat16 at head dims 64 to 256 (`sdpa_dkdv_mma_kernel`,
//   `sdpa_dq_mma_kernel`): attention_bwd.cuh's tensor-core bodies
//   (`mma.sync`, swizzled tiles filled by `cp.async`), the bodies of B2
//   and B13 made ragged (Sq, Skv). B2 stops at D 128; above it a lane
//   cannot hold the fp32 dK/dV accumulators of a whole row (2 x D / 2
//   registers), so at D 192 and 256 each CTA accumulates a chunk of DC =
//   D / 2 columns (grid z), the same accumulator shape as D 128, and
//   computes its scores over the whole head dim once per chunk (1.5x the
//   products). Shared memory 197,632 bytes at D 256.
// - float32 at every head dim and bfloat16 above 256 (`sdpa_dkdv_wide_kernel`,
//   `sdpa_dq_wide_kernel`, the wide design): scalar fp32 FMA from fp32
//   shared-memory tiles padded to D + 1 floats; a CTA owns 16 rows (keys
//   or q rows), 16 threads a row, each with D / 16 fp32 accumulators a
//   gradient (32 at D 512), and walks 32-row tiles: 201,600 bytes at D 512.
//   It serves the f32 parity runs, which hold the card to the CPU at 1e-5,
//   and head dims 320 to 512, which no register file holds a row of. One
//   CTA an SM is all its shared memory allows, and `__launch_bounds__(256,
//   1)` says so: without the 1, ptxas aimed at more CTAs an SM and spilled
//   at 48 to 64 registers.
// Neither is yet `wgmma` or TMA.

#include "attention_bwd.cuh"

namespace {

using attn_bwd::bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

// x rounded to T and back: P and dS as the products read them
template <typename T>
__device__ __forceinline__ float round_to(float x);
template <>
__device__ __forceinline__ float round_to<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_to<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32, one warp a row
template <typename T, int D>
__global__ void sdpa_delta_kernel(const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ delta, int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
#pragma unroll
  for (int d = lane; d < D; d += 32) s += to_f(dout[base + d]) * to_f(o[base + d]);
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bfloat16, head dims 64 to 256: attention_bwd.cuh's mma bodies, ragged
// ---------------------------------------------------------------------------
// the columns of dK, dV and dQ a CTA accumulates
template <int D>
__host__ __device__ constexpr int mma_dc() { return D > 128 ? D / 2 : D; }

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(attn_bwd::kMmaThreads) sdpa_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int Sq, int Skv,
    float scale) {
  attn_bwd::dkdv_mma<D, CAUSAL, false, mma_dc<D>()>(
      q, k, v, dout, lse, delta, nullptr, dk, dv, Sq, Skv, 1, scale);
}

template <int D, bool CAUSAL>
__global__ void __launch_bounds__(attn_bwd::kMmaThreads) sdpa_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int Sq, int Skv, float scale) {
  attn_bwd::dq_mma<D, CAUSAL, false, mma_dc<D>()>(
      q, k, v, dout, lse, delta, nullptr, dq, Sq, Skv, 1, scale);
}

// ---------------------------------------------------------------------------
// the wide design: scalar fp32 FMA, any head dim up to 512, both dtypes
// ---------------------------------------------------------------------------
constexpr int kWR = 16;               // rows a CTA owns (keys, or q rows)
constexpr int kWT = 32;               // rows of each tile it walks
constexpr int kWP = 16;               // threads per owned row
constexpr int kWThreads = kWR * kWP;  // 256

template <int D>
constexpr size_t wide_dkdv_smem_bytes() {
  // K, V [kWR][D + 1]; Q, dO [kWT][D + 1]; P, dS [kWT][kWR + 1]; the q
  // tile's lse and delta
  return ((2 * kWR + 2 * kWT) * (D + 1) + 2 * kWT * (kWR + 1) + 2 * kWT) *
         sizeof(float);
}

template <int D>
constexpr size_t wide_dq_smem_bytes() {
  // Q, dO [kWR][D + 1]; K, V [kWT][D + 1]; dS [kWR][kWT + 1]
  return ((2 * kWR + 2 * kWT) * (D + 1) + kWR * (kWT + 1)) * sizeof(float);
}

// rows [r0, r0 + ROWS) of a [S, D] slab into a [ROWS][D + 1] fp32 tile,
// rows at or past S zero-filled
template <int ROWS, int D, typename T>
__device__ __forceinline__ void wide_tile(float* dst, const T* __restrict__ src,
                                          int r0, int S) {
  for (int i = threadIdx.x; i < ROWS * D; i += kWThreads) {
    const int rr = i / D, d = i % D;
    const int g = r0 + rr;
    dst[rr * (D + 1) + d] =
        g < S ? to_f(src[static_cast<size_t>(g) * D + d]) : 0.f;
  }
}

// grid (ceil(Skv / kWR), BH), block kWThreads. Thread (c, part) owns key c
// of the CTA's keys: for scores it takes q rows r = j * kWP + part of the
// walked tile, for dK/dV it accumulates columns d = j * kWP + part.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kWThreads, 1) sdpa_dkdv_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Skv, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kWR + 1;
  constexpr int NJ = D / kWP;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + kWR * DP;
  float* sQ = sV + kWR * DP;
  float* sDO = sQ + kWT * DP;
  float* sP = sDO + kWT * DP;   // [q row][key]
  float* sDS = sP + kWT * PP;   // [q row][key]
  float* sL = sDS + kWT * PP;
  float* sDl = sL + kWT;

  const int bh = blockIdx.y;
  const int k0 = blockIdx.x * kWR;
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const size_t rbase = static_cast<size_t>(bh) * Sq;
  const int tid = threadIdx.x;
  const int c = tid / kWP;
  const int part = tid % kWP;
  const int gk = k0 + c;

  wide_tile<kWR, D>(sK, k + kbase, k0, Skv);
  wide_tile<kWR, D>(sV, v + kbase, k0, Skv);
  float acc_dk[NJ], acc_dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_dk[j] = acc_dv[j] = 0.f;

  // causal: q tiles wholly above the diagonal see none of these keys
  for (int q0 = CAUSAL ? k0 / kWT * kWT : 0; q0 < Sq; q0 += kWT) {
    __syncthreads();  // the previous q tile's reads are done
    wide_tile<kWT, D>(sQ, q + qbase, q0, Sq);
    wide_tile<kWT, D>(sDO, dout + qbase, q0, Sq);
    if (tid < kWT) {
      const int g = q0 + tid;
      sL[tid] = g < Sq ? lse[rbase + g] : 0.f;
      sDl[tid] = g < Sq ? delta[rbase + g] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kWT / kWP; ++j) {
      const int r = j * kWP + part;
      const int gq = q0 + r;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += sQ[r * DP + d] * sK[c * DP + d];
        dp += sDO[r * DP + d] * sV[c * DP + d];
      }
      s *= scale;
      const bool live = gq < Sq && gk < Skv && (!CAUSAL || gk <= gq);
      const float p = live ? expf(s - sL[r]) : 0.f;
      sP[r * PP + c] = round_to<T>(p);
      sDS[r * PP + c] = round_to<T>(p * (dp - sDl[r]) * scale);
    }
    __syncthreads();

    for (int r = 0; r < kWT; ++r) {
      const float pb = sP[r * PP + c];
      const float ds = sDS[r * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int d = j * kWP + part;
        acc_dv[j] += pb * sDO[r * DP + d];
        acc_dk[j] += ds * sQ[r * DP + d];
      }
    }
  }

  if (gk < Skv) {
    const size_t at = kbase + static_cast<size_t>(gk) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dk[at + j * kWP + part] = from_f<T>(acc_dk[j]);
      dv[at + j * kWP + part] = from_f<T>(acc_dv[j]);
    }
  }
}

// grid (ceil(Sq / kWR), BH), block kWThreads. Thread (r, part) owns q row
// r of the CTA's rows: for scores it takes keys c = j * kWP + part of the
// walked tile, for dQ it accumulates columns d = j * kWP + part.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kWThreads, 1) sdpa_dq_wide_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    T* __restrict__ dq, int Sq, int Skv, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kWT + 1;
  constexpr int NJ = D / kWP;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kWR * DP;
  float* sK = sDO + kWR * DP;
  float* sV = sK + kWT * DP;
  float* sDS = sV + kWT * DP;   // [q row][key]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kWR;
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const size_t rbase = static_cast<size_t>(bh) * Sq;
  const int tid = threadIdx.x;
  const int r = tid / kWP;
  const int part = tid % kWP;
  const int gq = q0 + r;
  const float l = gq < Sq ? lse[rbase + gq] : 0.f;
  const float dl = gq < Sq ? delta[rbase + gq] : 0.f;

  wide_tile<kWR, D>(sQ, q + qbase, q0, Sq);
  wide_tile<kWR, D>(sDO, dout + qbase, q0, Sq);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  // causal: keys past the CTA's last row see none of its rows
  const int kend = CAUSAL ? min(q0 + kWR, Skv) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kWT) {
    __syncthreads();  // the previous key tile's reads are done
    wide_tile<kWT, D>(sK, k + kbase, k0, Skv);
    wide_tile<kWT, D>(sV, v + kbase, k0, Skv);
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kWT / kWP; ++j) {
      const int c = j * kWP + part;
      const int gk = k0 + c;
      float s = 0.f, dp = 0.f;
#pragma unroll 16
      for (int d = 0; d < D; ++d) {
        s += sQ[r * DP + d] * sK[c * DP + d];
        dp += sDO[r * DP + d] * sV[c * DP + d];
      }
      s *= scale;
      const bool live = gq < Sq && gk < Skv && (!CAUSAL || gk <= gq);
      const float p = live ? expf(s - l) : 0.f;
      sDS[r * PP + c] = round_to<T>(p * (dp - dl) * scale);
    }
    __syncwarp();  // a row's dS comes from its own half-warp

    const int cend = min(kWT, Skv - k0);
    for (int c = 0; c < cend; ++c) {
      const float ds = sDS[r * PP + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += ds * sK[c * DP + j * kWP + part];
    }
  }

  if (gq < Sq) {
    const size_t at = qbase + static_cast<size_t>(gq) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[at + j * kWP + part] = from_f<T>(acc[j]);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------
template <typename T, int D>
int launch_delta(const void* o, const void* dout, float* delta, int rows,
                 cudaStream_t stream) {
  sdpa_delta_kernel<T, D><<<(rows + 7) / 8, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool CAUSAL>
int launch_mma(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* delta, void* dq,
               void* dk, void* dv, int bh, int Sq, int Skv, float scale,
               cudaStream_t stream) {
  constexpr int DC = mma_dc<D>();
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  int err = launch_delta<bf16, D>(o, dout, delta, bh * Sq, stream);
  if (err) return err;
  constexpr int B = attn_bwd::kMmaB;
  constexpr size_t kv_bytes = attn_bwd::dkdv_mma_smem_bytes<D, false>();
  cudaError_t e = cudaFuncSetAttribute(
      sdpa_dkdv_mma_kernel<D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kv_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  sdpa_dkdv_mma_kernel<D, CAUSAL>
      <<<dim3(bh, (Skv + B - 1) / B, D / DC), attn_bwd::kMmaThreads, kv_bytes,
         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dk),
                   static_cast<bf16*>(dv), Sq, Skv, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr size_t q_bytes = attn_bwd::dq_mma_smem_bytes<D, false>();
  e = cudaFuncSetAttribute(sdpa_dq_mma_kernel<D, CAUSAL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(q_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  sdpa_dq_mma_kernel<D, CAUSAL>
      <<<dim3(bh, (Sq + B - 1) / B, D / DC), attn_bwd::kMmaThreads, q_bytes,
         stream>>>(tq, tk, tv, tdo, lse, delta, static_cast<bf16*>(dq), Sq,
                   Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D, bool CAUSAL>
int launch_wide(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* delta, void* dq,
                void* dk, void* dv, int bh, int Sq, int Skv, float scale,
                cudaStream_t stream) {
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  int err = launch_delta<T, D>(o, dout, delta, bh * Sq, stream);
  if (err) return err;
  constexpr size_t kv_bytes = wide_dkdv_smem_bytes<D>();
  cudaError_t e = cudaFuncSetAttribute(
      sdpa_dkdv_wide_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kv_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  sdpa_dkdv_wide_kernel<T, D, CAUSAL>
      <<<dim3((Skv + kWR - 1) / kWR, bh), kWThreads, kv_bytes, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk),
          static_cast<T*>(dv), Sq, Skv, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr size_t q_bytes = wide_dq_smem_bytes<D>();
  e = cudaFuncSetAttribute(sdpa_dq_wide_kernel<T, D, CAUSAL>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(q_bytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  sdpa_dq_wide_kernel<T, D, CAUSAL>
      <<<dim3((Sq + kWR - 1) / kWR, bh), kWThreads, q_bytes, stream>>>(
          tq, tk, tv, tdo, lse, delta, static_cast<T*>(dq), Sq, Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

// dtype 1 (bfloat16): mma.sync up to D 256, the wide design above;
// dtype 0 (float32): the wide design
template <int D, bool CAUSAL>
int launch_dtype(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int dtype, int bh, int Sq, int Skv,
                 float scale, cudaStream_t stream) {
  if (dtype == 0)
    return launch_wide<float, D, CAUSAL>(q, k, v, o, dout, lse, delta, dq, dk,
                                         dv, bh, Sq, Skv, scale, stream);
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (D <= 256)
    return launch_mma<D, CAUSAL>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                 bh, Sq, Skv, scale, stream);
  else
    return launch_wide<bf16, D, CAUSAL>(q, k, v, o, dout, lse, delta, dq, dk,
                                        dv, bh, Sq, Skv, scale, stream);
}

template <int D>
int launch_causal(const void* q, const void* k, const void* v, const void* o,
                  const void* dout, const float* lse, float* delta, void* dq,
                  void* dk, void* dv, int dtype, int bh, int Sq, int Skv,
                  int causal, float scale, cudaStream_t stream) {
  if (!causal)
    return launch_dtype<D, false>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                                  dtype, bh, Sq, Skv, scale, stream);
  if (Sq != Skv) return static_cast<int>(cudaErrorInvalidValue);
  return launch_dtype<D, true>(q, k, v, o, dout, lse, delta, dq, dk, dv,
                               dtype, bh, Sq, Skv, scale, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o/dout/dq [bh, Sq, head_dim] and
// k/v/dk/dv [bh, Skv, head_dim], contiguous and 16-byte aligned; lse [bh,
// Sq] fp32 (the forward's), delta [bh, Sq] fp32 scratch; head_dim a
// multiple of 64 up to 512; causal only at Sq == Skv. Returns the first
// failing launch's cudaError_t (0 on success).
extern "C" int sdpa_backward(const void* q, const void* k, const void* v,
                             const void* o, const void* dout, const void* lse,
                             void* delta, void* dq, void* dk, void* dv,
                             int dtype, int bh, int Sq, int Skv, int head_dim,
                             int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (head_dim) {
#define SDPA_BWD_CASE(D)                                                    \
    case D:                                                                 \
      return launch_causal<D>(q, k, v, o, dout, l, dl, dq, dk, dv, dtype,   \
                              bh, Sq, Skv, causal, scale, st);
    SDPA_BWD_CASE(64)
    SDPA_BWD_CASE(128)
    SDPA_BWD_CASE(192)
    SDPA_BWD_CASE(256)
    SDPA_BWD_CASE(320)
    SDPA_BWD_CASE(384)
    SDPA_BWD_CASE(448)
    SDPA_BWD_CASE(512)
#undef SDPA_BWD_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
