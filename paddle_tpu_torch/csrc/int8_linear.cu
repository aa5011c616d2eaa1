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
// bf16, the second design: K is split over the CTAs of a thread-block cluster
// of `split` CTAs (at most 8), rank r taking the share [r kc, (r + 1) kc) of K,
// kc = ceil(K / split) rounded up to 16. The wrapper's launch plan
// (paddle_tpu_torch/ops/int8_linear.py `_plan`) picks split from M and K alone,
// so a column's sum order is the same in a tensor-parallel shard's launch (N /
// mp rows of codes) as in the whole one, and a shard's output is bitwise the
// whole launch's columns. Each CTA leaves its fp32 partial tile in its shared
// memory; after `barrier.cluster` every rank sums a slice of the tile over all
// ranks' partials through distributed shared memory (`mapa`,
// `ld.shared::cluster`), always in rank order, and runs the epilogue on it: one
// launch, no atomics, no workspace in device memory, the same bits on every
// run. The epilogue rounds the product to bf16 and then adds the bias with a
// second bf16 rounding, as the plain version's matmul and add do. Each weight
// element enters the product as bf16(q * s), dequantize's bf16 product exactly:
// the int8 code becomes an exact bf16 (its fp32 value through a magic-number
// add, then the upper half) and one bf16x2 multiply by the scale pair rounds
// the exact product once.
//
// - w8_gemv_mma_kernel<MB>, M <= 16 (the decode step, MB 8 or 16 rows):
//   A and B are swapped, so the dequantized weight (16 output channels x
//   16 of K) is mma.sync.m16n8k16's A operand and x^T its n8 B operand:
//   M fills the n side, with no padding rows at M 8. A CTA of BN / 16
//   warps (BN 16, 32 or 64, from N) takes BN channels; each warp streams
//   its own 16 rows of codes through a private ring of 5 stages of 128 K
//   (2 KB a stage, filled by 16-byte cp.async, 8 KB in flight a warp),
//   rows stored 128-byte swizzled so a lane's 16-byte reads meet no bank
//   conflict. Lane (g, t) reads 16 codes a row at a time, the 16-byte chunk
//   2t + h of the stage's 128 K; its mma k-columns 2t, 2t + 1, 2t + 8, 2t + 9
//   of step j map to bytes 4j .. 4j + 3 of that chunk, and its x fragment
//   is the same 16 K of x's row g (read through the L1, one stage ahead):
//   every K position is counted once, in an order that does not depend on
//   N.
// - w8_linear_mma_kernel, M > 16 (the verify step, the prefill chunk): the
//   first design's tile, a CTA of four warps over 64 rows x 64 columns with
//   x as the A operand, two cp.async stages of 64 K, now over its rank's
//   share of K and reduced across the cluster as above.
//
// f32, w8_linear_fma_kernel: the parity path, fp32 FMA over a 16 x 64
// tile, the codes dequantized to fp32 in shared memory (q * s in fp32, as
// dequantize) and each thread four rows of one column; one CTA does all of
// K.
//
// Bound on this card: bytes at the serving shapes. The codes are read once
// (N K bytes; 16.8 MB for GPT-1.3B's fc1, 5.06 us at 3.35 TB/s), beside x
// and y (2 M K and 2 M N bytes) and the scales and bias; at M = 8 the
// FLOP (2 M N K) are under 1 % of that time at 989 TFLOP/s. The first
// design kept N / 64 CTAs with one 4 KB chunk each in flight; the split
// gives 256 to 512 CTAs at GPT-1.3B's decode shapes, each warp 8 KB in
// flight.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

using attn_mma::bf16;
using attn_mma::cp_async_16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::mma_bf16;
using attn_mma::smem_u32;

constexpr int kThreads = 128;
constexpr int kBN = 64;
constexpr int kBK = 64;
constexpr int kXPitch = kBK + 8;    // bf16 elements: 144-byte rows
constexpr int kQPitch = kBK + 16;   // int8 elements: 80-byte rows
constexpr int kMaxSplit = hopper::kPortableCluster;

// the share of K of each rank of a split over `split` CTAs
__host__ __device__ __forceinline__ int k_share(int K, int split) {
  return ((K + split - 1) / split + 15) / 16 * 16;
}

// four int8 codes (the bytes of w) as two bf16 pairs, each code times
// the channel's scale pair sc: bf16(q * s), rounded once
__device__ __forceinline__ void dequant4(uint32_t w, __nv_bfloat162 sc,
                                         uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // q + 128 in each byte
  // 2^23 + (q + 128) as fp32, minus 2^23 + 128: q, exact
  const float f0 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540)) -
                   8388736.f;
  const float f1 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7541)) -
                   8388736.f;
  const float f2 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7542)) -
                   8388736.f;
  const float f3 = __int_as_float(__byte_perm(u, 0x4B000000u, 0x7543)) -
                   8388736.f;
  // an 8-bit integer's fp32 value is its bf16 value: keep the upper halves
  uint32_t p01 = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
  uint32_t p23 = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  __nv_bfloat162 a = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&p01), sc);
  __nv_bfloat162 b = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&p23), sc);
  lo = *reinterpret_cast<uint32_t*>(&a);
  hi = *reinterpret_cast<uint32_t*>(&b);
}

// the epilogue of a cluster's partial tiles: the element at `off` floats
// into each rank's partial buffer `part`, summed over the ranks in rank
// order, four consecutive floats (rows m .. m + 3 of one column n, or
// columns n .. n + 3 of one row m, as the caller lays out the tile)
__device__ __forceinline__ float4 cluster_sum4(const float* part, int off,
                                               uint32_t ranks) {
  const float4* own = reinterpret_cast<const float4*>(part + off);
  if (ranks == 1) return *own;
  float4 v = hopper::ld_cluster_f32x4(hopper::map_rank(part + off, 0));
  for (uint32_t r = 1; r < ranks; ++r) {
    const float4 p = hopper::ld_cluster_f32x4(hopper::map_rank(part + off, r));
    v.x += p.x;
    v.y += p.y;
    v.z += p.z;
    v.w += p.w;
  }
  return v;
}

__device__ __forceinline__ void store_y(bf16* y, const bf16* bias, float v,
                                        int m, int n, int N) {
  bf16 o = __float2bfloat16_rn(v);
  if (bias)
    o = __float2bfloat16_rn(
        __fadd_rn(__bfloat162float(o), __bfloat162float(bias[n])));
  y[static_cast<size_t>(m) * N + n] = o;
}

// ---------------------------------------------------------------------------
// M <= 16: the weight as the A operand
// ---------------------------------------------------------------------------
constexpr int kGBK = 128;                    // K of a ring stage
constexpr int kGStages = 5;
constexpr int kGStageBytes = 16 * kGBK;      // a warp's 16 rows of codes

__host__ __device__ constexpr int gemv_smem_bytes(int warps, int mb) {
  return warps * kGStages * kGStageBytes + warps * 16 * mb * 4;
}

// grid (split, ceil(N / BN)), cluster (split, 1, 1), BN / 16 warps
template <int MB>
__global__ void __launch_bounds__(kThreads) w8_gemv_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q,
    const bf16* __restrict__ scale, const bf16* __restrict__ bias,
    bf16* __restrict__ y, int M, int N, int K, int kc) {
  constexpr int NB = MB / 8;                 // n8 blocks of x's rows
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = hopper::cluster_ctarank();
  const uint32_t ranks = hopper::cluster_nctarank();
  const int bn = warps * 16;
  const int nw = blockIdx.y * bn + warp * 16;  // the warp's first channel
  const int kbeg = static_cast<int>(rank) * kc;
  const int kend = min(K, kbeg + kc);
  const int chunks = kend > kbeg ? (kend - kbeg + kGBK - 1) / kGBK : 0;
  unsigned char* ring = smem + warp * kGStages * kGStageBytes;
  float* part = reinterpret_cast<float*>(smem + warps * kGStages *
                                                    kGStageBytes);

  // chunk ch's codes into its stage: row r's 16-byte chunk c at c ^ (r % 8)
  auto copy = [&](int ch) {
    if (ch < chunks) {
      const int k0 = kbeg + ch * kGBK;
      const uint32_t st = smem_u32(ring + (ch % kGStages) * kGStageBytes);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = lane + 32 * j, r = i >> 3, c = i & 7;
        const bool in = nw + r < N && k0 + 16 * c < kend;
        cp_async_16(st + r * kGBK + ((c ^ (r & 7)) << 4),
                    in ? q + static_cast<size_t>(nw + r) * K + k0 + 16 * c
                       : q,
                    in);
      }
    }
    cp_async_commit();
  };
  // the lane's x fragments of chunk ch: row 8 nb + g, the 16 K of chunk
  // 2t + h, zero past M, the share or K
  auto load_x = [&](uint4 (&xr)[2][NB][2], int ch) {
    const int k0 = kbeg + ch * kGBK;
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int m = 8 * nb + g, k = k0 + 16 * (2 * t + h);
        const bool in = ch < chunks && m < M && k < kend;
        const uint4* p = reinterpret_cast<const uint4*>(
            x + static_cast<size_t>(in ? m : 0) * K + (in ? k : 0));
        xr[h][nb][0] = in ? __ldg(p) : make_uint4(0, 0, 0, 0);
        xr[h][nb][1] = in ? __ldg(p + 1) : make_uint4(0, 0, 0, 0);
      }
  };

  __nv_bfloat162 sc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int n = nw + g + 8 * i;
    sc[i] = __bfloat162bfloat162(n < N ? scale[n] : __float2bfloat16(0.f));
  }
  float acc[NB][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

#pragma unroll
  for (int ch = 0; ch < kGStages - 1; ++ch) copy(ch);
  uint4 xr[2][NB][2], xn[2][NB][2];
  load_x(xr, 0);
  for (int ch = 0; ch < chunks; ++ch) {
    copy(ch + kGStages - 1);
    load_x(xn, ch + 1);
    cp_async_wait<kGStages - 1>();
    __syncwarp();
    const unsigned char* st = ring + (ch % kGStages) * kGStageBytes;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = ((2 * t + h) ^ g) << 4;
      const uint4 lo = *reinterpret_cast<const uint4*>(st + g * kGBK + c);
      const uint4 hi =
          *reinterpret_cast<const uint4*>(st + (g + 8) * kGBK + c);
      const uint32_t wl[4] = {lo.x, lo.y, lo.z, lo.w};
      const uint32_t wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t a[4];
        dequant4(wl[j], sc[0], a[0], a[2]);
        dequant4(wh[j], sc[1], a[1], a[3]);
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          const uint4& x0 = xr[h][nb][j >> 1];
          const uint32_t b0 = (j & 1) ? x0.z : x0.x;
          const uint32_t b1 = (j & 1) ? x0.w : x0.y;
          mma_bf16(acc[nb], a, b0, b1);
        }
      }
    }
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        xr[h][nb][0] = xn[h][nb][0];
        xr[h][nb][1] = xn[h][nb][1];
      }
  }
  cp_async_wait<0>();

  // the partial tile [BN channels][MB rows] in this CTA's shared memory
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[(warp * 16 + g + 8 * (e >> 1)) * MB + 8 * nb + 2 * t + (e & 1)] =
          acc[nb][e];
  if (ranks > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
  } else {
    __syncthreads();
  }
  const int n0 = blockIdx.y * bn;
  for (int i = (static_cast<int>(rank) * blockDim.x + tid) * 4; i < bn * MB;
       i += static_cast<int>(ranks * blockDim.x) * 4) {
    const float4 v = cluster_sum4(part, i, ranks);
    const int n = n0 + i / MB, m = i % MB;
    if (n >= N) continue;
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (m + e < M) store_y(y, bias, vs[e], m + e, n, N);
  }
  // no CTA leaves while another may still read its shared memory
  if (ranks > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
  }
}

// ---------------------------------------------------------------------------
// M > 16: x as the A operand, 64 x 64 tiles
// ---------------------------------------------------------------------------
// two int8 codes at p times the channel's scale, as a bf16 pair
__device__ __forceinline__ uint32_t dequant2(const int8_t* p, float s) {
  const char2 v = *reinterpret_cast<const char2*>(p);
  return attn_mma::pack_bf16x2(__fmul_rn(static_cast<float>(v.x), s),
                               __fmul_rn(static_cast<float>(v.y), s));
}

constexpr int kBM = 64;

// grid (split, ceil(N / 64), ceil(M / 64)), cluster (split, 1, 1)
__global__ void __launch_bounds__(kThreads) w8_linear_mma_kernel(
    const bf16* __restrict__ x, const int8_t* __restrict__ q,
    const bf16* __restrict__ scale, const bf16* __restrict__ bias,
    bf16* __restrict__ y, int M, int N, int K, int kc) {
  constexpr int MT = kBM / 16;
  __shared__ __align__(16) bf16 xs[2][kBM * kXPitch];
  __shared__ __align__(16) int8_t qs[2][kBN * kQPitch];
  static_assert(sizeof(xs) >= kBM * kBN * sizeof(float), "partial tile");
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3;
  const uint32_t rank = hopper::cluster_ctarank();
  const uint32_t ranks = hopper::cluster_nctarank();
  const int n0 = blockIdx.y * kBN, m0 = blockIdx.z * kBM;
  const int kbeg = static_cast<int>(rank) * kc;
  const int kend = min(K, kbeg + kc);

  // copy the chunk at k0 into stage st: 16 bytes a thread a step
  auto copy_chunk = [&](int st, int k0) {
    for (int i = tid; i < kBM * (kBK / 8); i += kThreads) {
      const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
      const bool in = m0 + r < M && k0 + c < kend;
      cp_async_16(smem_u32(&xs[st][r * kXPitch + c]),
                  in ? x + static_cast<size_t>(m0 + r) * K + k0 + c : x, in);
    }
    for (int i = tid; i < kBN * (kBK / 16); i += kThreads) {
      const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
      const bool in = n0 + r < N && k0 + c < kend;
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

  const int chunks = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  if (chunks > 0) copy_chunk(0, kbeg);
  cp_async_commit();
  for (int ch = 0; ch < chunks; ++ch) {
    const int st = ch & 1;
    if (ch + 1 < chunks) copy_chunk(st ^ 1, kbeg + (ch + 1) * kBK);
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
  cp_async_wait<0>();

  // the partial tile [64 rows][64 columns] over the dead x stages
  float* part = reinterpret_cast<float*>(&xs[0][0]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[(i * 16 + g + 8 * (e >> 1)) * kBN + warp * 16 + j * 8 + 2 * t +
             (e & 1)] = acc[i][j][e];
  if (ranks > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
  } else {
    __syncthreads();
  }
  for (int i = (static_cast<int>(rank) * kThreads + tid) * 4; i < kBM * kBN;
       i += static_cast<int>(ranks) * kThreads * 4) {
    const float4 v = cluster_sum4(part, i, ranks);
    const int m = m0 + i / kBN, n = n0 + i % kBN;
    if (m >= M) continue;
    const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (n + e < N) store_y(y, bias, vs[e], m, n + e, N);
  }
  if (ranks > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
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
// null); dtype 1 for bf16 (tensor cores), 0 for f32 (FMA). The bf16 plan
// (the wrapper's `_plan`): `split` CTAs a cluster share K (1 to 8), `bn`
// output channels a CTA (16, 32 or 64 at bm 8 or 16; 64 at bm 64), `bm`
// rows of x a tile (8 or 16 for M <= 16, else 64); f32 ignores it.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for a plan the
// kernels do not take.
int w8_linear(const void* x, const void* q, const void* scale,
              const void* bias, void* y, int M, int N, int K, int dtype,
              int split, int bn, int bm, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != 1) {
    w8_linear_fma_kernel<<<dim3((N + kBN - 1) / kBN,
                                (M + kFmaBM - 1) / kFmaBM),
                           kFmaThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(scale), static_cast<const float*>(bias),
        static_cast<float*>(y), M, N, K);
    return static_cast<int>(cudaGetLastError());
  }
  const bool gemv = bm == 8 || bm == 16;
  if (split < 1 || split > kMaxSplit || (gemv && M > bm) ||
      (!gemv && (bm != kBM || bn != kBN || M <= 16)) ||
      (gemv && bn != 16 && bn != 32 && bn != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  const int kc = k_share(K, split);
  const bf16* xb = static_cast<const bf16*>(x);
  const int8_t* qb = static_cast<const int8_t*>(q);
  const bf16* sb = static_cast<const bf16*>(scale);
  const bf16* bb = static_cast<const bf16*>(bias);
  bf16* yb = static_cast<bf16*>(y);
  cudaError_t e;
  if (gemv) {
    const dim3 grid(split, (N + bn - 1) / bn);
    const int smem = gemv_smem_bytes(bn / 16, bm);
    e = bm == 8
            ? hopper::launch_split(w8_gemv_mma_kernel<8>, grid, 2 * bn, smem,
                                   split, s, xb, qb, sb, bb, yb, M, N, K, kc)
            : hopper::launch_split(w8_gemv_mma_kernel<16>, grid, 2 * bn,
                                   smem, split, s, xb, qb, sb, bb, yb, M, N,
                                   K, kc);
  } else {
    const dim3 grid(split, (N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
    e = hopper::launch_split(w8_linear_mma_kernel, grid, kThreads, 0, split,
                             s, xb, qb, sb, bb, yb, M, N, K, kc);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
