// Causal self-attention forward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_causal_fwd_kernel`
// (entry `_causal_call_fwd`, reached through `chunked_causal_attention`).
// Plain PyTorch version and wrapper: paddle_tpu_torch/ops/flash_attention.py.
//
// What it computes, per (batch*head) row block of [BH, S, D] inputs:
// O = softmax(q k^T * scale, causal) v and the per-row LSE = m + log(l),
// with the logits, the softmax state and the PV accumulator in fp32,
// inputs entering the products at their own dtype (bf16 x bf16 products
// are exact in fp32), the probabilities rounded to the V dtype before PV
// and the output cast once. Any S: the kernel zero-fills and masks the
// ragged last tile itself. Tiles above the diagonal are never loaded.
//
// LSE layout: [BH, S] fp32. The TPU kernel wrote [BH, 8, S], a broadcast
// that exists only because a TPU block's last two dims tile as (8, 128);
// the eight rows were identical, so nothing is lost.
//
// Differences from the TPU kernel: the TPU kernel keeps a whole head in
// VMEM and takes an exact per-row softmax over the causal prefix; here
// one CTA owns one (bh, q tile) and walks key tiles up to the diagonal
// with an online softmax, because shared memory holds tiles, not heads.
//
// Bound on this card: operations. 2 * BH * S^2 * D causal FLOP (QK and
// PV, half the square each) over 989 TFLOP/s bf16: at B1 H16 S2048 D128
// that is 17.2 GFLOP, about 17 us.
//
// Two designs, by dtype:
// - bfloat16 (`causal_fwd_mma_kernel`): FlashAttention-2's shape on the
//   tensor cores through `mma.sync` (attention_mma.cuh). One CTA per (bh,
//   128-row q tile), 8 warps of 16 q rows. Q is loaded once and kept as A
//   fragments in registers; K and V come in 64-key tiles through a
//   two-stage `cp.async` ring into swizzled shared memory, the next tile's
//   copy in flight while the current one is computed. S = Q K^T stays in
//   registers; the row max and sum go through quad shuffles; P is rounded
//   to bf16 once, as it is packed into the A fragments of P V, with V read
//   through `ldmatrix.trans`. Only tiles that cross a warp's diagonal are
//   masked, and a warp skips a tile wholly above its rows. The heaviest q
//   tiles (the last) are launched first. Not yet `wgmma` or TMA.
// - float32 (`causal_fwd_fma_kernel`, the first design): scalar fp32 FMA
//   from fp32 shared-memory tiles, one CTA per (bh, 64-row q tile). It
//   serves the f32 parity runs, which hold the card to the CPU at 1e-5, a
//   bar a TF32 tensor-core product (about 1e-3) cannot meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // keys per tile
constexpr int kTPR = 4;          // threads per q row
constexpr int kThreads = kBQ * kTPR;
constexpr float kNegInf = -1e30f;

// the first design's loads and stores, instantiated for float only
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

template <int D>
constexpr size_t smem_bytes() {
  // Q, K, V tiles with rows padded to D + 1 floats (no bank conflicts on
  // a column walk), plus the probability tile padded to kBK + 1.
  return (3 * kBQ * (D + 1) + kBQ * (kBK + 1)) * sizeof(float);
}

// ---------------------------------------------------------------------------
// float32: the first design, scalar FMA
// ---------------------------------------------------------------------------
// grid (ceil(S / kBQ), BH), block kThreads. Thread (r, part) owns q row
// r of the tile; for QK it scores keys c = j * kTPR + part, for PV it
// accumulates output columns d = j * kTPR + part.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) causal_fwd_fma_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
    int S, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kBK + 1;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + kBQ * DP;
  float* sV = sK + kBK * DP;
  float* sP = sV + kBK * DP;

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x;
  const int r = tid / kTPR;
  const int part = tid % kTPR;
  const int gq = q0 + r;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int g = q0 + rr;
    sQ[rr * DP + d] = g < S ? to_f(q[base + static_cast<size_t>(g) * D + d])
                            : 0.f;
  }

  float m = kNegInf, l = 0.f;
  float acc[D / kTPR];
#pragma unroll
  for (int j = 0; j < D / kTPR; ++j) acc[j] = 0.f;

  const int kend = min(q0 + kBQ, S);  // keys past the tile's diagonal: none
  for (int k0 = 0; k0 < kend; k0 += kBK) {
    __syncthreads();  // the previous tile's K/V reads are done
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int rr = i / D, d = i % D;
      const int g = k0 + rr;
      const bool in = g < S;
      const size_t at = base + static_cast<size_t>(g) * D + d;
      sK[rr * DP + d] = in ? to_f(k[at]) : 0.f;
      sV[rr * DP + d] = in ? to_f(v[at]) : 0.f;
    }
    __syncthreads();

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
      if (gk > gq || gk >= S) dot = kNegInf;
      sc[j] = dot;
      tmax = fmaxf(tmax, dot);
    }
#pragma unroll
    for (int off = 1; off < kTPR; off <<= 1)
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, off));
    const float m_new = fmaxf(m, tmax);

    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kBK / kTPR; ++j) {
      const float p = expf(sc[j] - m_new);  // masked keys give 0
      psum += p;
      sP[r * PP + j * kTPR + part] = to_f(from_f<T>(p));
    }
#pragma unroll
    for (int off = 1; off < kTPR; off <<= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    const float alpha = expf(m - m_new);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();  // a row's probabilities come from its own warp

#pragma unroll
    for (int j = 0; j < D / kTPR; ++j) acc[j] *= alpha;
    for (int c = 0; c < kBK; ++c) {
      const float p = sP[r * PP + c];
#pragma unroll
      for (int j = 0; j < D / kTPR; ++j)
        acc[j] += p * sV[c * DP + j * kTPR + part];
    }
  }

  if (gq < S) {
    const float inv = 1.f / fmaxf(l, 1e-30f);
    const size_t at = base + static_cast<size_t>(gq) * D;
#pragma unroll
    for (int j = 0; j < D / kTPR; ++j)
      o[at + j * kTPR + part] = from_f<T>(acc[j] * inv);
    if (part == 0) lse[static_cast<size_t>(bh) * S + gq] = m + logf(l);
  }
}

template <typename T, int D>
int launch_fma(const void* q, const void* k, const void* v, void* o, void* lse,
           int bh, int S, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      causal_fwd_fma_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, bh);
  causal_fwd_fma_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      static_cast<float*>(lse), S, scale);
  return static_cast<int>(cudaGetLastError());
}


// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaBQ = 128;      // q rows per CTA, 16 per warp
constexpr int kMmaBK = 64;       // keys per tile
constexpr int kMmaThreads = 256;

template <int D>
constexpr size_t mma_smem_bytes() {
  // the Q tile and two stages of the K and V tiles, bf16
  return (kMmaBQ + 4 * kMmaBK) * D * sizeof(__nv_bfloat16);
}

// grid (BH, ceil(S / kMmaBQ)), block kMmaThreads. Warp w owns q rows
// q0 + 16w .. q0 + 16w + 15; lane (g, t) holds rows g and g + 8 of them.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) causal_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
    float* __restrict__ lse, int S, float scale) {
  using namespace attn_mma;
  constexpr int KD = D / 16;       // k-steps over the head dim
  constexpr int ND = D / 8;        // 8-column blocks of O
  constexpr int NK = kMmaBK / 8;   // 8-key blocks of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kMmaBQ * D;                  // [2][kMmaBK][D]
  bf16* sV = sK + 2 * kMmaBK * D;              // [2][kMmaBK][D]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kMmaBQ;  // heaviest first
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;             // the warp's first q row
  const int kend = min(q0 + kMmaBQ, S);        // no key past the diagonal
  const int ntiles = (kend + kMmaBK - 1) / kMmaBK;

  load_tile<kMmaBQ, D, kMmaThreads>(sQ, q + base, q0, S, tid);
  load_tile<kMmaBK, D, kMmaThreads>(sK, k + base, 0, S, tid);
  load_tile<kMmaBK, D, kMmaThreads>(sV, v + base, 0, S, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], frag_addr<D>(smem_u32(sQ), warp * 16, kk * 16, lane));

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
      load_tile<kMmaBK, D, kMmaThreads>(sK + stage * kMmaBK * D, k + base,
                                        (j + 1) * kMmaBK, S, tid);
      load_tile<kMmaBK, D, kMmaThreads>(sV + stage * kMmaBK * D, v + base,
                                        (j + 1) * kMmaBK, S, tid);
    }
    cp_async_commit();
    const int k0 = j * kMmaBK;
    if (k0 > wrow + 15) continue;  // every key above this warp's rows
    const uint32_t cK = smem_u32(sK + (j & 1) * kMmaBK * D);
    const uint32_t cV = smem_u32(sV + (j & 1) * kMmaBK * D);

    float s[NK][4];
#pragma unroll
    for (int nb = 0; nb < NK; ++nb)
      s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) qk_step<D>(s, qf[kk], cK, kk, lane);

    // scale, the causal mask on a tile that crosses the warp's diagonal,
    // and the tile's row max
    const bool diag = k0 + kMmaBK - 1 > wrow;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nb = 0; nb < NK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[nb][e] * scale;
        if (diag) {
          const int key = k0 + nb * 8 + 2 * t + (e & 1);
          const int row = wrow + g + (e >> 1) * 8;
          if (key > row) x = kNegInf;
        }
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
    // unrounded p into the row sums; rounded once into P's A fragments
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
    l[0] = l[0] * alpha[0] + ps[0];
    l[1] = l[1] * alpha[1] + ps[1];
#pragma unroll
    for (int nd = 0; nd < ND; ++nd) {
      acc[nd][0] *= alpha[0];
      acc[nd][1] *= alpha[0];
      acc[nd][2] *= alpha[1];
      acc[nd][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s, kk);
      pv_step<D>(acc, pa, cV, kk, lane);
    }
  }

  // the row sums over the quad, then O = acc / max(l, 1e-30) and the LSE
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] = quad_sum(l[i]);
    inv[i] = 1.f / fmaxf(l[i], 1e-30f);
  }
  store_rows<D>(o + base, acc, wrow, S, lane, inv[0], inv[1]);
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = wrow + g + 8 * i;
      if (row < S) lse[static_cast<size_t>(bh) * S + row] = m[i] + logf(l[i]);
    }
  }
}

template <int D>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int bh, int S, float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      causal_fwd_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(bh, (S + kMmaBQ - 1) / kMmaBQ);
  causal_fwd_mma_kernel<D><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (the fp32 FMA design), 1 = bfloat16 (mma.sync).
// q/k/v/o [bh, S, head_dim] contiguous and 16-byte aligned, lse [bh, S]
// fp32. Returns the launch's cudaError_t (0 on success).
extern "C" int causal_attention_fwd(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int dtype, int bh, int S, int head_dim,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64)
    return launch_fma<float, 64>(q, k, v, o, lse, bh, S, scale, st);
  if (dtype == 0 && head_dim == 128)
    return launch_fma<float, 128>(q, k, v, o, lse, bh, S, scale, st);
  if (dtype == 1 && head_dim == 64)
    return launch_mma<64>(q, k, v, o, lse, bh, S, scale, st);
  if (dtype == 1 && head_dim == 128)
    return launch_mma<128>(q, k, v, o, lse, bh, S, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
