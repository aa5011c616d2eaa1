// Short-sequence (encoder) attention forward for Hopper (sm_90a), mask-free
// and key-masked.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_shortseq_fwd_kernel`
// and `_shortseq_fwd_kernel_masked` (entry `_shortseq_call_fwd`, reached
// through `shortseq_attention` from `flash_attention` and from the key-mask
// route of `scaled_dot_product_attention`). Plain PyTorch version and
// wrapper: paddle_tpu_torch/ops/flash_attention.py
// (`shortseq_attention_fwd`).
//
// What it computes, per (batch*head) of [BH, S, D] inputs (S % 128 == 0,
// S <= 512, D 64 or 128), as `_shortseq_fwd_core` does:
//   s   = q k^T * scale (+ key_mask[key])   fp32 sums of input-dtype products
//   m   = rowmax(s), p = exp(s - m), l = rowsum(p)
//   O   = (p rounded to v's dtype) v / l   fp32 sums, one cast
//   LSE = m + log(l)                       [BH, S] fp32
// The key mask is additive fp32 data, [rows, S] with row bh / heads_per_row
// serving head bh (a [B, S] mask broadcast over heads, or [BH, S]). Its
// value is added as it is: -1e30 on every key of a row gives p = 1 per key
// and O the mean of v, as on the TPU (an -inf mask would give NaN there and
// here alike).
//
// Design. The TPU kernel keeps a whole head (q, k, v and the S x S scores)
// in VMEM. A Hopper block has 227 KB of shared memory, and S x S fp32
// scores at S 512 are 1 MB, so one CTA owns one (bh, 64-row q tile) and
// keeps its 64 x S fp32 score rows in dynamic shared memory (129 KB at
// S 512). That keeps the TPU's EXACT two-pass row softmax (the row max over
// all keys before any exp) rather than an online softmax, and with it the
// TPU's rounding points. K tiles stream through one shared buffer to fill
// the scores, then V tiles through the same buffer for PV. S is a multiple
// of 128, so no tile is ragged. 6144 CTAs at the bench shape.
//
// Bound on this card at the bench shape (B64 H12 S512 D64 bf16): bytes.
// 4 * BH * S^2 * D = 51.5 GFLOP takes 0.052 ms at 989 TFLOP/s; reading q,
// k, v and writing O and the LSE, 202.9 MB, takes 0.061 ms at 3.35 TB/s.
// This first design is far from it: fp32 FMA from shared memory (no tensor
// cores: no mma.sync or wgmma), no TMA, one CTA per SM at S 512.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // keys per K or V tile
constexpr int kTPR = 4;          // threads per q row
constexpr int kThreads = kBQ * kTPR;
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

// score rows padded to S + 4 floats: a warp's 8 rows x 4 columns land in 32
// distinct banks
__host__ __device__ constexpr int score_pitch(int S) { return S + 4; }

template <int D>
constexpr size_t smem_bytes(int S) {
  // Q tile and one K/V tile [64][D + 1], scores [64][S + 4], the mask row
  return (2 * kBQ * (D + 1) + kBQ * score_pitch(S) + S) * sizeof(float);
}

// rows [r0, r0 + 64) of a [S, D] slab at `base` into a [64][D + 1] fp32 tile
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          size_t base, int r0) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    dst[rr * (D + 1) + d] = to_f(src[base + static_cast<size_t>(r0 + rr) * D + d]);
  }
}

// grid (S / 64, BH), block kThreads. Thread (r, part) owns q row r of the
// tile: it scores keys c = j * kTPR + part of each K tile, takes the
// softmax over columns part, part + 4, ... of its row with its three
// neighbours, and accumulates output columns d = j * kTPR + part.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(kThreads) shortseq_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const float* __restrict__ mask,
    T* __restrict__ o, float* __restrict__ lse, int S, int heads_per_row,
    float scale) {
  constexpr int DP = D + 1;
  constexpr int NJ = D / kTPR;
  constexpr int NC = kBK / kTPR;
  extern __shared__ float smem[];
  const int SP = score_pitch(S);
  float* sQ = smem;
  float* sKV = sQ + kBQ * DP;
  float* sS = sKV + kBK * DP;      // [q row][key], pitch SP
  float* sM = sS + kBQ * SP;       // the mask row

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  float* row = sS + r * SP;

  load_tile<T, D>(sQ, q, base, q0);
  if (MASKED) {
    const float* mrow = mask + static_cast<size_t>(bh / heads_per_row) * S;
    for (int i = tid; i < S; i += kThreads) sM[i] = mrow[i];
  }

  // pass 1: every score of the 64 rows, K tile by K tile
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done (and sQ, sM set)
    load_tile<T, D>(sKV, k, base, k0);
    __syncthreads();
    float s[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = sQ[r * DP + d];
#pragma unroll
      for (int j = 0; j < NC; ++j) s[j] += qd * sKV[(j * kTPR + part) * DP + d];
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int c = k0 + j * kTPR + part;
      float x = s[j] * scale;
      if (MASKED) x += sM[c];
      row[c] = x;
    }
  }
  __syncthreads();

  // pass 2: exact row softmax over all S keys; p rounded to v's dtype stays
  // in place for PV, the row sum takes p unrounded
  float m = -INFINITY;
  for (int c = part; c < S; c += kTPR) m = fmaxf(m, row[c]);
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 2));
  float l = 0.f;
  for (int c = part; c < S; c += kTPR) {
    const float p = expf(row[c] - m);
    l += p;
    row[c] = round_to<T>(p);
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);

  // pass 3: O = P V, V tile by V tile
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // every row's pass 2 / the previous tile's reads
    load_tile<T, D>(sKV, v, base, k0);
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float p = row[k0 + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[j] += p * sKV[c * DP + j * kTPR + part];
    }
  }

  const int g = q0 + r;
  const size_t at = base + static_cast<size_t>(g) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[at + j * kTPR + part] = from_f<T>(acc[j] / l);
  if (part == 0) lse[static_cast<size_t>(bh) * S + g] = m + logf(l);
}

template <typename T, int D, bool MASKED>
int launch(const void* q, const void* k, const void* v, const void* mask,
           void* o, void* lse, int bh, int S, int heads_per_row, float scale,
           cudaStream_t stream) {
  auto kern = shortseq_fwd_kernel<T, D, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem_bytes<D>(kMaxS)));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kBQ, bh);
  kern<<<grid, kThreads, smem_bytes<D>(S), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(mask),
      static_cast<T*>(o), static_cast<float*>(lse), S, heads_per_row, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_masked_or_not(const void* q, const void* k, const void* v,
                         const void* mask, void* o, void* lse, int bh, int S,
                         int heads_per_row, float scale, cudaStream_t st) {
  if (mask != nullptr)
    return launch<T, D, true>(q, k, v, mask, o, lse, bh, S, heads_per_row,
                              scale, st);
  return launch<T, D, false>(q, k, v, mask, o, lse, bh, S, heads_per_row,
                             scale, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/k/v/o [bh, S, head_dim] contiguous,
// lse [bh, S] fp32. mask: NULL (the mask-free kernel) or [bh /
// heads_per_row, S] fp32 contiguous (the masked kernel). S % 128 == 0 and
// S <= 512; head_dim 64 or 128. Returns the launch's cudaError_t (0 on
// success).
extern "C" int shortseq_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* o, void* lse, int dtype, int bh,
                                      int S, int head_dim, int heads_per_row,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 128 != 0 || S > kMaxS || heads_per_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 0 && head_dim == 64)
    return launch_masked_or_not<float, 64>(q, k, v, mask, o, lse, bh, S,
                                           heads_per_row, scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch_masked_or_not<float, 128>(q, k, v, mask, o, lse, bh, S,
                                            heads_per_row, scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch_masked_or_not<__nv_bfloat16, 64>(q, k, v, mask, o, lse, bh,
                                                   S, heads_per_row, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_masked_or_not<__nv_bfloat16, 128>(q, k, v, mask, o, lse, bh,
                                                    S, heads_per_row, scale,
                                                    st);
  return static_cast<int>(cudaErrorInvalidValue);
}
