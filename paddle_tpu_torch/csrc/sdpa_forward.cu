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
// one CTA owns one (bh, 64-row q tile) and an in-CTA loop walks 64-key
// tiles, m, l and the accumulator in registers. Any Sq and Skv: the
// ragged edges are zero-filled and out-of-range keys get probability 0
// (the TPU kernel needs S % block == 0). Causal runs only at Sq == Skv;
// key tiles wholly above the diagonal are never loaded, as the TPU
// kernel's `run` skips them. No atomics: every output element is written
// once by one thread, so the result is the same bits from run to run.
//
// Bound on this card: operations. 4 * BH * Sq * Skv * D FLOP (QK and PV),
// about half of that when causal, over 989 TFLOP/s bf16: at the
// Transformer-base encoder's B8 H8 S1024 D64 that is 34.4 GFLOP, about
// 35 us. This first design is far from it: plain fp32 FMA from shared
// memory, no tensor cores (no mma.sync or wgmma), no TMA. Its tiles are
// fp32 in shared memory with rows padded to D + 1 floats, 214,016 bytes at
// D = 256 (one CTA an SM there), above the 48 KB default, so the launch
// asks for it with cudaFuncSetAttribute.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kTPR = 4;          // threads per q row
constexpr int kThreads = kBQ * kTPR;
constexpr float kNegInf = -1e30f;

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

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles with rows padded to D + 1 floats (no bank conflicts on
  // a column walk), plus the fp32 probability tile padded to kBK + 1.
  return (3 * kBQ * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

// grid (ceil(Sq / kBQ), BH), block kThreads. Thread (r, part) owns q row
// r of the tile; for QK it scores keys c = j * kTPR + part, for PV it
// accumulates output columns d = j * kTPR + part.
template <typename T, int D, bool CAUSAL>
__global__ void __launch_bounds__(kThreads) sdpa_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, int Sq, int Skv,
    float scale) {
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
  }
}

template <typename T, int D, bool CAUSAL>
int launch(const void* q, const void* k, const void* v, void* o, int bh,
           int Sq, int Skv, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      sdpa_fwd_kernel<T, D, CAUSAL>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Sq + kBQ - 1) / kBQ, bh);
  sdpa_fwd_kernel<T, D, CAUSAL><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_causal(const void* q, const void* k, const void* v, void* o,
                  int bh, int Sq, int Skv, int causal, float scale,
                  cudaStream_t stream) {
  if (causal) {
    if (Sq != Skv) return static_cast<int>(cudaErrorInvalidValue);
    return launch<T, D, true>(q, k, v, o, bh, Sq, Skv, scale, stream);
  }
  return launch<T, D, false>(q, k, v, o, bh, Sq, Skv, scale, stream);
}

template <typename T>
int launch_dim(const void* q, const void* k, const void* v, void* o, int bh,
               int Sq, int Skv, int head_dim, int causal, float scale,
               cudaStream_t stream) {
  switch (head_dim) {
    case 64:
      return launch_causal<T, 64>(q, k, v, o, bh, Sq, Skv, causal, scale,
                                  stream);
    case 128:
      return launch_causal<T, 128>(q, k, v, o, bh, Sq, Skv, causal, scale,
                                   stream);
    case 192:
      return launch_causal<T, 192>(q, k, v, o, bh, Sq, Skv, causal, scale,
                                   stream);
    case 256:
      return launch_causal<T, 256>(q, k, v, o, bh, Sq, Skv, causal, scale,
                                   stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/o [bh, Sq, head_dim] and k/v
// [bh, Skv, head_dim], contiguous; head_dim 64, 128, 192 or 256; causal
// only at Sq == Skv. Returns the launch's cudaError_t (0 on success).
extern "C" int sdpa_forward(const void* q, const void* k, const void* v,
                            void* o, int dtype, int bh, int Sq, int Skv,
                            int head_dim, int causal, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_dim<float>(q, k, v, o, bh, Sq, Skv, head_dim, causal,
                             scale, st);
  if (dtype == 1)
    return launch_dim<__nv_bfloat16>(q, k, v, o, bh, Sq, Skv, head_dim,
                                     causal, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
