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
// value is added as it is, in fp32 after the scale (never folded into a
// bf16 operand): -1e30 on every key of a row gives p = 1 per key and O the
// mean of v, as on the TPU (an -inf mask would give NaN there and here
// alike).
//
// The TPU kernel keeps a whole head (q, k, v and the S x S scores) in VMEM
// and takes an EXACT row softmax: the row max over all keys before any
// exp, so p is rounded to bf16 as exp(s - m) with the final m. Both designs
// here keep that (an online softmax would round exp(s - m_running) instead,
// a different function at that rounding point).
//
// Bound on this card at the bench shape (B64 H12 S512 D64 bf16): bytes.
// 4 * BH * S^2 * D = 51.5 GFLOP takes 0.052 ms at 989 TFLOP/s; reading q,
// k, v and writing O and the LSE, 202.9 MB, takes 0.061 ms at 3.35 TB/s.
//
// Two designs, by dtype:
// - bfloat16 (`shortseq_fwd_mma_kernel`): the tensor cores through
//   `mma.sync` (attention_mma.cuh). One CTA per (bh, 128-row q tile), 8
//   warps of 16 q rows, Q kept as A fragments in registers; 64-key K and V
//   tiles through a two-stage `cp.async` ring into swizzled shared memory
//   (50 KB at D 64 with the mask row). Two passes over the key
//   tiles: pass 1 computes S = Q K^T, scales it, adds the mask row and
//   keeps only the row max (quad shuffles at the end); pass 2 recomputes S
//   by the same instruction sequence (the same bits), takes p = exp(s -
//   m), adds p unrounded into l, rounds it to bf16 once as the A fragment
//   of P V and reads V through `ldmatrix.trans`. Three products where the
//   function counts two (1.5x the FLOP), in exchange for no S x S scores
//   in shared memory (256 KB at S 512 for 128 rows, over the 227 KB a CTA
//   may have). Pass 1 copies K tiles only. Not yet `wgmma` or TMA.
// - float32 (`shortseq_fwd_fma_kernel`, the first design): scalar fp32 FMA
//   from shared memory, one CTA per (bh, 64-row q tile) holding its 64 x S
//   fp32 score rows in dynamic shared memory (129 KB at S 512), K tiles
//   then V tiles through one buffer. It serves the f32 parity runs, which
//   hold the card to the CPU at 1e-5, a bar a TF32 tensor-core product
//   (about 1e-3) cannot meet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace {

constexpr int kMaxS = 512;

// ---------------------------------------------------------------------------
// float32: the first design, scalar FMA
// ---------------------------------------------------------------------------
constexpr int kBQ = 64;          // q rows per CTA
constexpr int kBK = 64;          // keys per K or V tile
constexpr int kTPR = 4;          // threads per q row
constexpr int kThreads = kBQ * kTPR;

// the first design's loads and stores, instantiated for float only
__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

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
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const T* __restrict__ src,
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
__global__ void __launch_bounds__(kThreads) shortseq_fwd_fma_kernel(
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

  load_tile_f32<T, D>(sQ, q, base, q0);
  if (MASKED) {
    const float* mrow = mask + static_cast<size_t>(bh / heads_per_row) * S;
    for (int i = tid; i < S; i += kThreads) sM[i] = mrow[i];
  }

  // pass 1: every score of the 64 rows, K tile by K tile
  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // the previous tile's reads are done (and sQ, sM set)
    load_tile_f32<T, D>(sKV, k, base, k0);
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
    load_tile_f32<T, D>(sKV, v, base, k0);
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
int launch_fma(const void* q, const void* k, const void* v, const void* mask,
               void* o, void* lse, int bh, int S, int heads_per_row,
               float scale, cudaStream_t stream) {
  auto kern = shortseq_fwd_fma_kernel<T, D, MASKED>;
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

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaBQ = 128;      // q rows per CTA, 16 per warp
constexpr int kMmaBK = 64;       // keys per tile
constexpr int kMmaThreads = 256;

template <int D>
constexpr size_t mma_smem_bytes() {
  // the Q tile and two stages of the K and V tiles, bf16; the mask row
  return (kMmaBQ + 4 * kMmaBK) * D * sizeof(__nv_bfloat16) +
         kMaxS * sizeof(float);
}

// The warp's 16 x 64 fp32 scores against the key tile at `kt` (keys k0 ..
// k0 + 63): q k^T, times the scale, plus the mask row when MASKED, each a
// rounding of its own (no contraction into an FMA), so both passes and the
// plain version round alike.
template <int D, bool MASKED>
__device__ __forceinline__ void tile_scores(
    float (&s)[kMmaBK / 8][4], const uint32_t (&qf)[D / 16][4], uint32_t kt,
    const float* sM, int k0, float scale, int lane) {
  using namespace attn_mma;
#pragma unroll
  for (int nb = 0; nb < kMmaBK / 8; ++nb)
    s[nb][0] = s[nb][1] = s[nb][2] = s[nb][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) qk_step<D>(s, qf[kk], kt, kk, lane);
  const int t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < kMmaBK / 8; ++nb) {
    float2 mv = make_float2(0.f, 0.f);
    if (MASKED)
      mv = *reinterpret_cast<const float2*>(sM + k0 + nb * 8 + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = __fmul_rn(s[nb][e], scale);
      if (MASKED) x = __fadd_rn(x, (e & 1) ? mv.y : mv.x);
      s[nb][e] = x;
    }
  }
}

// grid (S / kMmaBQ, BH): the q tiles of one head run side by side, so its
// K and V come from L2 after the first. Block kMmaThreads; warp w owns q
// rows q0 + 16w .. q0 + 16w + 15, lane (g, t) rows g and g + 8 of them.
// Step i of the walk (0 <= i < 2 nt, nt = S / 64 key tiles) is pass i /
// nt over tile i % nt and uses ring stage i % 2; the copy of step i + 1
// is in flight while step i computes.
template <int D, bool MASKED>
__global__ void __launch_bounds__(kMmaThreads) shortseq_fwd_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ mask,
    __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
    int heads_per_row, float scale) {
  using namespace attn_mma;
  constexpr int KD = D / 16;       // k-steps over the head dim
  constexpr int ND = D / 8;        // 8-column blocks of O
  constexpr int NK = kMmaBK / 8;   // 8-key blocks of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sK = sQ + kMmaBQ * D;                  // [2][kMmaBK][D]
  bf16* sV = sK + 2 * kMmaBK * D;              // [2][kMmaBK][D]
  float* sM = reinterpret_cast<float*>(sV + 2 * kMmaBK * D);  // [kMaxS]

  const int bh = blockIdx.y;
  const int q0 = blockIdx.x * kMmaBQ;
  const size_t base = static_cast<size_t>(bh) * S * D;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;             // the warp's first q row
  const int nt = S / kMmaBK;

  load_tile<kMmaBQ, D, kMmaThreads>(sQ, q + base, q0, S, tid);
  if (MASKED)
    load_row_values<kMaxS, kMmaThreads>(
        sM, mask + static_cast<size_t>(bh / heads_per_row) * S, 0, S, tid);
  load_tile<kMmaBK, D, kMmaThreads>(sK, k + base, 0, S, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qf[kk], frag_addr<D>(smem_u32(sQ), warp * 16, kk * 16, lane));

  // the copy of step i + 1: its K tile, and its V tile in pass 2
  auto prefetch = [&](int i) {
    if (i >= 2 * nt) return;
    const int stage = i & 1, k0 = (i % nt) * kMmaBK;
    load_tile<kMmaBK, D, kMmaThreads>(sK + stage * kMmaBK * D, k + base, k0,
                                      S, tid);
    if (i >= nt)
      load_tile<kMmaBK, D, kMmaThreads>(sV + stage * kMmaBK * D, v + base,
                                        k0, S, tid);
  };

  // pass 1: the row max over all S keys
  float mx[2] = {-INFINITY, -INFINITY};
  for (int i = 0; i < nt; ++i) {
    if (i > 0) {
      cp_async_wait<0>();  // step i has landed
      __syncthreads();     // ... for every thread; stage (i + 1) % 2 is free
    }
    prefetch(i + 1);
    cp_async_commit();
    float s[NK][4];
    tile_scores<D, MASKED>(s, qf, smem_u32(sK + (i & 1) * kMmaBK * D), sM,
                           i * kMmaBK, scale, lane);
#pragma unroll
    for (int nb = 0; nb < NK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
  }
  const float m[2] = {quad_max(mx[0]), quad_max(mx[1])};

  // pass 2: p = exp(s - m) from the same scores, l over unrounded p, P
  // rounded to bf16 once into PV
  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  float l[2] = {0.f, 0.f};           // this lane's share of the row sum
  for (int i = nt; i < 2 * nt; ++i) {
    cp_async_wait<0>();
    __syncthreads();
    prefetch(i + 1);
    cp_async_commit();
    const int stage = i & 1;
    float s[NK][4];
    tile_scores<D, MASKED>(s, qf, smem_u32(sK + stage * kMmaBK * D), sM,
                           (i - nt) * kMmaBK, scale, lane);
#pragma unroll
    for (int nb = 0; nb < NK; ++nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f((s[nb][e] - m[e >> 1]) * kLog2e);
        s[nb][e] = p;
        l[e >> 1] += p;
      }
    }
    const uint32_t cV = smem_u32(sV + stage * kMmaBK * D);
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s, kk);
      pv_step<D>(acc, pa, cV, kk, lane);
    }
  }

  // O = acc / l, one cast; LSE = m + log(l)
  const float lr[2] = {quad_sum(l[0]), quad_sum(l[1])};
#pragma unroll
  for (int nd = 0; nd < ND; ++nd) {
    acc[nd][0] /= lr[0];
    acc[nd][1] /= lr[0];
    acc[nd][2] /= lr[1];
    acc[nd][3] /= lr[1];
  }
  store_rows<D>(o + base, acc, wrow, S, lane, 1.f, 1.f);
  if (t == 0) {
    lse[static_cast<size_t>(bh) * S + wrow + g] = m[0] + logf(lr[0]);
    lse[static_cast<size_t>(bh) * S + wrow + g + 8] = m[1] + logf(lr[1]);
  }
}

template <int D, bool MASKED>
int launch_mma(const void* q, const void* k, const void* v, const void* mask,
               void* o, void* lse, int bh, int S, int heads_per_row,
               float scale, cudaStream_t stream) {
  constexpr size_t bytes = mma_smem_bytes<D>();
  auto kern = shortseq_fwd_mma_kernel<D, MASKED>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(S / kMmaBQ, bh);
  kern<<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(mask),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), S,
      heads_per_row, scale);
  return static_cast<int>(cudaGetLastError());
}

// dtype 0: the fp32 FMA design; 1: mma.sync. The masked variant when
// `mask` is not NULL.
template <int D>
int launch_dtype(const void* q, const void* k, const void* v,
                 const void* mask, void* o, void* lse, int dtype, int bh,
                 int S, int heads_per_row, float scale, cudaStream_t st) {
  const bool m = mask != nullptr;
  if (dtype == 0)
    return m ? launch_fma<float, D, true>(q, k, v, mask, o, lse, bh, S,
                                          heads_per_row, scale, st)
             : launch_fma<float, D, false>(q, k, v, mask, o, lse, bh, S,
                                           heads_per_row, scale, st);
  if (dtype == 1)
    return m ? launch_mma<D, true>(q, k, v, mask, o, lse, bh, S,
                                   heads_per_row, scale, st)
             : launch_mma<D, false>(q, k, v, mask, o, lse, bh, S,
                                    heads_per_row, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32 (the fp32 FMA design), 1 = bfloat16 (mma.sync).
// q/k/v/o [bh, S, head_dim] contiguous (16-byte aligned for bf16), lse
// [bh, S] fp32. mask: NULL (the mask-free kernel) or [bh / heads_per_row,
// S] fp32 contiguous (the masked kernel). S % 128 == 0 and S <= 512;
// head_dim 64 or 128. Returns the launch's cudaError_t (0 on success).
extern "C" int shortseq_attention_fwd(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      void* o, void* lse, int dtype, int bh,
                                      int S, int head_dim, int heads_per_row,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 128 != 0 || S > kMaxS || heads_per_row <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64)
    return launch_dtype<64>(q, k, v, mask, o, lse, dtype, bh, S,
                            heads_per_row, scale, st);
  if (head_dim == 128)
    return launch_dtype<128>(q, k, v, mask, o, lse, dtype, bh, S,
                             heads_per_row, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
