// A linear layer over int8 weights with per-output-channel scales, for
// Hopper (sm_90a): y = x @ dequantize(q, s, x.dtype)^T + b.
//
// Replaces: no Pallas kernel. The JAX package serves int8 weights by
// dequantizing them inside its compiled steps
// (paddle_tpu/inference/engine.py `_materialize_state`), where XLA fuses
// the dequantize into the matmul so that the device reads int8 bytes. A
// dequantize and then a matmul in eager PyTorch would read the codes,
// write a bf16 weight and read it back: about 2.5 times the bytes of bf16
// serving. This kernel dequantizes in its mainloop instead.
// Wrapper and plain version: paddle_tpu_torch/ops/int8_linear.py.
//
// x [M, K] row-major in bf16 or f32, q int8 [N, K] row-major (torch's
// [out, in]), s [N] and b [N] (or null) in x's dtype, y [M, N]; K a
// multiple of 16, the bases 16-byte aligned (the wrapper checks).
//
// bf16, w8_linear_mma_kernel<BM>: a CTA of four warps computes a BM x 64
// tile of y (BM 16 for M <= 16, the decode step, else 64), over chunks of
// 64 along K copied by cp.async into two stages of shared memory (x rows
// and q rows past M, N or K zero-filled). Warp w owns columns 16w..16w+15
// and all BM rows: per 16-deep step it reads A fragments of x from shared
// memory and forms each B fragment element in registers as
// bf16(float(q) * float(s)), which is dequantize's bf16 product exactly
// (the fp32 product of an 8-bit integer and a bf16 scale is exact), then
// runs mma.sync.m16n8k16 with fp32 accumulators. The epilogue rounds the
// product to bf16 and then adds the bias with a second bf16 rounding, as
// the plain version's matmul and add do.
//
// f32, w8_linear_fma_kernel: the parity path, fp32 FMA over a 16 x 64
// tile, the codes dequantized to fp32 in shared memory (q * s in fp32, as
// dequantize) and each thread four rows of one column.
//
// Bound on this card: bytes at the serving shapes. The codes are read once
// (N K bytes; 16.8 MB for GPT-1.3B's fc1, 5.06 us at 3.35 TB/s), beside x
// and y (2 M K and 2 M N bytes) and the scales and bias; at M = 8 the
// FLOP (2 M N K) are under 1 % of that time at 989 TFLOP/s. The first
// design keeps the tiles small and the grid at N / 64 CTAs; a split along
// K for the decode step, TMA and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

using attn_mma::bf16;
using attn_mma::cp_async_16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::mma_bf16;
using attn_mma::pack_bf16x2;
using attn_mma::smem_u32;

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kXPitch = kBK + 8;    // bf16 elements: 144-byte rows
constexpr int kQPitch = kBK + 16;   // int8 elements: 80-byte rows

// two int8 codes at p times the channel's scale, as a bf16 pair
__device__ __forceinline__ uint32_t dequant2(const int8_t* p, float s) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return pack_bf16x2(__fmul_rn(static_cast<float>(v.x), s),
                     __fmul_rn(static_cast<float>(v.y), s));
}

template <int BM>
__global__ void __launch_bounds__(kThreads) w8_linear_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q,
    const bf16* __restrict__ scale, const bf16* __restrict__ bias,
    bf16* __restrict__ y, int M, int N, int K) {
  constexpr int MT = BM / 16;
  __shared__ __align__(16) bf16 xs[2][BM * kXPitch];
  __shared__ __align__(16) int8_t qs[2][kBN * kQPitch];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * BM;

  // copy the chunk at k0 into stage st: 16 bytes a thread a step
  auto copy_chunk = [&](int st, int k0) {
    for (int i = tid; i < BM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool in = m0 + r < M && k0 + c < K;
      cp_async_16(smem_u32(&xs[st][r * kXPitch + c]),
                  in ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x, in);
    }
    for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool in = n0 + r < N && k0 + c < K;
      cp_async_16(smem_u32(&qs[st][r * kQPitch + c]),
                  in ? q + static_cast<size_t>(n0 + r) * K + k0 + c : q, in);
    }
  };

  float sc[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int n = n0 + warp * 16 + j * 8 + g;
    sc[j] = n < N ? __bfloat162float(scale[n]) : 0.f;
  }
  float acc[MT][2][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int chunks = (K + kBK - 1) / kBK;
  copy_chunk(0, 0);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < chunks) copy_chunk(st ^ 1, (ch + 1) * kBK);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const bf16* xt = xs[st];
    const int8_t* qt = qs[st];
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t b[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int8_t* row = qt + (warp * 16 + j * 8 + g) * kQPitch
                            + kk * 16 + 2 * t;
        b[j][0] = dequant2(row, sc[j]);
        b[j][1] = dequant2(row + 8, sc[j]);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const bf16* lo = xt + (i * 16 + g) * kXPitch + kk * 16 + 2 * t;
        const bf16* hi = lo + 8 * kXPitch;
        const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(lo),
                               *reinterpret_cast<const uint32_t*>(hi),
                               *reinterpret_cast<const uint32_t*>(lo + 8),
                               *reinterpret_cast<const uint32_t*>(hi + 8)};
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16(acc[i][j], a, b[j][0], b[j][1]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + i * 16 + g + (e >> 1) * 8;
        const int n = n0 + warp * 16 + j * 8 + 2 * t + (e & 1);
        if (m >= M || n >= N) continue;
        bf16 v = __float2bfloat16_rn(acc[i][j][e]);
        if (bias)
          v = __float2bfloat16_rn(
              __fadd_rn(__bfloat162float(v), __bfloat162float(bias[n])));
        y[static_cast<size_t>(m) * N + n] = v;
      }
}

constexpr int kFmaThreads = 256;
constexpr int kFmaBM = 16;
constexpr int kFmaBK = 32;

__global__ void __launch_bounds__(kFmaThreads) w8_linear_fma_kernel(
    const float* __restrict__ x, const int8_t* __restrict__ q,
    const float* __restrict__ scale, const float* __restrict__ bias,
    float* __restrict__ y, int M, int N, int K) {
  __shared__ float xs[kFmaBM][kFmaBK + 1];
  __shared__ float ws[kBN][kFmaBK + 1];
  const int tid = threadIdx.x, nl = tid % kBN, mg = tid / kBN;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kFmaBM;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += kFmaBK) {
    for (int i = tid; i < kFmaBM * kFmaBK; i += kFmaThreads) {
      const int r = i / kFmaBK, c = i % kFmaBK;
      xs[r][c] = m0 + r < M && k0 + c < K
                     ? x[static_cast<size_t>(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int i = tid; i < kBN * kFmaBK; i += kFmaThreads) {
      const int r = i / kFmaBK, c = i % kFmaBK;
      ws[r][c] = n0 + r < N && k0 + c < K
                     ? __fmul_rn(static_cast<float>(
                           q[static_cast<size_t>(n0 + r) * K + k0 + c]),
                                 scale[n0 + r])
                     : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kFmaBK; ++k) {
      const float w = ws[nl][k];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i] = fmaf(xs[mg * 4 + i][k], w, acc[i]);
    }
    __syncthreads();
  }
  const int n = n0 + nl;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + mg * 4 + i;
    if (m < M)
      y[static_cast<size_t>(m) * N + n] =
          bias ? __fadd_rn(acc[i], bias[n]) : acc[i];
  }
}

}  // namespace

extern "C" {

// y [M, N] = x [M, K] @ dequantize(q [N, K], s [N])^T + b [N] (b may be
// null); dtype 1 for bf16 (tensor cores), 0 for f32 (FMA). Returns
// cudaGetLastError().
int w8_linear(const void* x, const void* q, const void* scale,
              const void* bias, void* y, int M, int N, int K, int dtype,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned gx = (N + kBN - 1) / kBN;
  if (dtype == 1) {
    const bf16* xb = static_cast<const bf16*>(x);
    const int8_t* qb = static_cast<const int8_t*>(q);
    const bf16* sb = static_cast<const bf16*>(scale);
    const bf16* bb = static_cast<const bf16*>(bias);
    bf16* yb = static_cast<bf16*>(y);
    if (M <= 16)
      w8_linear_mma_kernel<16><<<dim3(gx, (M + 15) / 16), kThreads, 0, s>>>(
          xb, qb, sb, bb, yb, M, N, K);
    else
      w8_linear_mma_kernel<64><<<dim3(gx, (M + 63) / 64), kThreads, 0, s>>>(
          xb, qb, sb, bb, yb, M, N, K);
  } else {
    w8_linear_fma_kernel<<<dim3(gx, (M + kFmaBM - 1) / kFmaBM), kFmaThreads,
                           0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(y), M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
