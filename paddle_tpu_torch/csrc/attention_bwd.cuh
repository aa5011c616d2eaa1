// The attention backward for Hopper (sm_90a), shared by
// causal_attention_bwd.cu (B2, causal) and shortseq_attention_bwd.cu (B13,
// whole-sequence, mask-free and key-masked), whose kernels take all of this
// file. Each of those files keeps its own thin `__global__` kernels (named
// apart, so a profile and the SASS tell them apart) and its C entry point;
// the bodies are the `__device__` templates here, on <D, CAUSAL, MASKED>.
//
// What it computes, per (batch*head) of [BH, S, D] inputs, from the
// forward's output O and its per-row LSE ([BH, S] fp32):
//   s  = q k^T * scale (+ key_mask[key])  (fp32; recomputed)
//   P  = exp(s - lse)                     (causal: 0 above the diagonal)
//   dV = P_b^T dO                         (P rounded to v's dtype first)
//   dP = dO v^T, delta = rowsum(dO * O)   (both fp32)
//   dS = P * (dP - delta) * scale         (rounded to q's dtype)
//   dQ = dS k, dK = dS^T q                (fp32 sums, each cast once)
// The rounding points are the TPU kernels' (`_causal_bwd_kernel`,
// `_shortseq_bwd_core`), so an f32 run matches them to the order of fp32
// sums and a bf16 run rounds P and dS where they do. MASKED adds the fp32
// key mask row bh / heads_per_row to the scaled score, as the forward
// did: scale first, then add, each rounded on its own (`__fmul_rn`,
// `__fadd_rn`). On a row whose keys are all masked at -1e30, s and the
// LSE both round to -1e30 and P = 1 for every key, the TPU kernel's
// result. Any S: ragged last tiles are zero-filled and masked. The mma
// bodies take q rows Sq and keys Skv apart (B2 and B13 pass S twice;
// CAUSAL only at Sq == Skv).
//
// The TPU kernels walk the q blocks of one head in order inside one
// program and carry dK/dV in VMEM scratch across them. Blocks of a CUDA
// grid run in parallel in no order, so the work is three launches that
// need no atomics and give the same bits on every run:
//   1. delta: delta = rowsum(dO * O) once per row, into a [BH, S] fp32
//      scratch the wrapper allocates;
//   2. dK/dV: one CTA per (bh, 64-key tile) holds its K and V tile and its
//      fp32 dK/dV in registers and walks the q tiles: from the diagonal
//      when CAUSAL, else all of them;
//   3. dQ: one CTA per (bh, 64-row q tile) holds its Q and dO tile and
//      walks the key tiles: up to the diagonal when CAUSAL, else all.
// Scores and dP are recomputed in both 2 and 3 (7 products where the TPU
// kernels do 5), the price of no atomics.
//
// Two designs, by dtype:
// - bfloat16 (`delta_mma`, `dkdv_mma`, `dq_mma`): the products on the
//   tensor cores through `mma.sync` (attention_mma.cuh), 4 warps a CTA,
//   each warp owning 16 rows of the tile the CTA holds. The dK/dV CTA
//   computes S^T = K Q^T and dP^T = V dO^T, so P^T and dS^T come out of
//   the fp32 C fragments already laid out as the A operands of dV += P^T
//   dO and dK += dS^T Q, which read dO and Q through `ldmatrix.trans`; Q,
//   dO, LSE and delta arrive double-buffered through `cp.async`, and the
//   CTA's 64 key-mask values once, with its K and V. The dQ CTA computes S
//   = Q K^T and dP = dO V^T, then dQ += dS K with K through
//   `ldmatrix.trans`; K, V and the key tile's mask values arrive
//   double-buffered. Only the causal diagonal tile and a ragged last one
//   are masked; a warp skips a block wholly above the diagonal, whose P
//   and dS are exact zeros. At D 128 the dK/dV CTA walks each 64-row q
//   tile in two 32-row halves, which keeps its 2 x 64 fp32 accumulators a
//   lane and the score fragments within the register file. delta reads 16
//   bytes a lane.
// - float32 (`delta_fma`, `dkdv_fma`, `dq_fma`, the first design): scalar
//   fp32 FMA from fp32 shared-memory tiles (rows padded to D + 1 floats).
//   It serves the f32 parity runs, which hold the card to the CPU at 1e-5,
//   a bar a TF32 tensor-core product (about 1e-3) cannot meet.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace attn_bwd {

using bf16 = __nv_bfloat16;

// ---------------------------------------------------------------------------
// float32: the first design, scalar FMA
// ---------------------------------------------------------------------------
constexpr int kB = 64;           // q rows per q tile, keys per key tile
constexpr int kTPR = 4;          // threads per tile row
constexpr int kThreads = kB * kTPR;

template <int D>
constexpr size_t dkdv_fma_smem_bytes() {
  // K, V, Q, dO tiles [kB][D + 1]; P and dS [kB][kB + 1]; the q tile's
  // lse and delta
  return (4 * kB * (D + 1) + 2 * kB * (kB + 1) + 2 * kB) * sizeof(float);
}

template <int D>
constexpr size_t dq_fma_smem_bytes() {
  // Q, dO, K, V tiles [kB][D + 1]; dS [kB][kB + 1]; the key tile's mask
  return (4 * kB * (D + 1) + kB * (kB + 1) + kB) * sizeof(float);
}

// rows [r0, r0 + kB) of a [S, D] slab at `base` into a [kB][D + 1] fp32
// tile, rows at or past S zero-filled
template <int D>
__device__ __forceinline__ void load_tile_f32(float* dst,
                                              const float* __restrict__ src,
                                              size_t base, int r0, int S) {
  for (int i = threadIdx.x; i < kB * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int g = r0 + rr;
    dst[rr * (D + 1) + d] =
        g < S ? src[base + static_cast<size_t>(g) * D + d] : 0.f;
  }
}

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32, one warp per row.
template <int D>
__device__ __forceinline__ void delta_fma(const float* __restrict__ o,
                                          const float* __restrict__ dout,
                                          float* __restrict__ delta,
                                          int rows) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;  // uniform across the warp
  const size_t base = static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) s += dout[base + d] * o[base + d];
#pragma unroll
  for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) delta[row] = s;
}

// grid (ceil(S / kB), BH), block kThreads. Thread (c, part) owns key c of
// the tile: for scores it takes q rows r = j * kTPR + part, for dK/dV it
// accumulates columns d = j * kTPR + part.
template <int D, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dkdv_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dk,
    float* __restrict__ dv, int S, int heads_per_row, float scale) {
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
  const float mk =
      MASKED && gk < S
          ? mask[static_cast<size_t>(bh / heads_per_row) * S + gk] : 0.f;

  load_tile_f32<D>(sK, k, base, k0, S);
  load_tile_f32<D>(sV, v, base, k0, S);
  float acc_dk[NJ], acc_dv[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc_dk[j] = acc_dv[j] = 0.f;

  // causal: q tiles above the diagonal see none of these keys
  for (int q0 = CAUSAL ? k0 : 0; q0 < S; q0 += kB) {
    __syncthreads();  // the previous q tile's reads are done
    load_tile_f32<D>(sQ, q, base, q0, S);
    load_tile_f32<D>(sDO, dout, base, q0, S);
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
      if (MASKED)
        s = __fadd_rn(__fmul_rn(s, scale), mk);
      else
        s *= scale;
      const bool live = gq < S && (!CAUSAL || gk <= gq);
      const float p = live ? expf(s - sL[r]) : 0.f;
      sP[r * PP + c] = p;
      sDS[r * PP + c] = p * (dp - sD[r]) * scale;
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
      dk[at + j * kTPR + part] = acc_dk[j];
      dv[at + j * kTPR + part] = acc_dv[j];
    }
  }
}

// grid (ceil(S / kB), BH), block kThreads. Thread (r, part) owns q row r
// of the tile: for scores it takes keys c = j * kTPR + part, for dQ it
// accumulates columns d = j * kTPR + part.
template <int D, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dq_fma(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dq, int S,
    int heads_per_row, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = kB + 1;
  constexpr int NJ = D / kTPR;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sDO = sQ + kB * DP;
  float* sK = sDO + kB * DP;
  float* sV = sK + kB * DP;
  float* sDS = sV + kB * DP;   // [q row][key]
  float* sM = sDS + kB * PP;   // the key tile's mask values

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
  const float* mrow =
      MASKED ? mask + static_cast<size_t>(bh / heads_per_row) * S : nullptr;

  load_tile_f32<D>(sQ, q, base, q0, S);
  load_tile_f32<D>(sDO, dout, base, q0, S);
  float acc[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j] = 0.f;

  // causal: keys past the tile's diagonal see none of its rows
  const int kend = CAUSAL ? min(q0 + kB, S) : S;
  for (int k0 = 0; k0 < kend; k0 += kB) {
    __syncthreads();  // the previous key tile's reads are done
    load_tile_f32<D>(sK, k, base, k0, S);
    load_tile_f32<D>(sV, v, base, k0, S);
    if (MASKED && tid < kB) sM[tid] = k0 + tid < S ? mrow[k0 + tid] : 0.f;
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
      if (MASKED)
        s = __fadd_rn(__fmul_rn(s, scale), sM[c]);
      else
        s *= scale;
      const bool live = gq < S && (CAUSAL ? gk <= gq : gk < S);
      const float p = live ? expf(s - l) : 0.f;
      sDS[r * PP + c] = p * (dp - dl) * scale;
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
    for (int j = 0; j < NJ; ++j) dq[at + j * kTPR + part] = acc[j];
  }
}

// ---------------------------------------------------------------------------
// bfloat16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
constexpr int kMmaB = 64;          // rows of every tile (q rows or keys)
constexpr int kMmaThreads = 128;   // 4 warps, 16 tile rows each

template <int D, bool MASKED>
constexpr size_t dkdv_mma_smem_bytes() {
  // K, V tiles; two stages of Q, dO (bf16) and of lse, delta (fp32); the
  // CTA's key-mask values
  return 6 * kMmaB * D * sizeof(bf16) + 4 * kMmaB * sizeof(float) +
         (MASKED ? kMmaB * sizeof(float) : 0);
}

template <int D, bool MASKED>
constexpr size_t dq_mma_smem_bytes() {
  // Q, dO tiles; two stages of K, V (bf16) and of the key-mask values
  return 6 * kMmaB * D * sizeof(bf16) +
         (MASKED ? 2 * kMmaB * sizeof(float) : 0);
}

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32, D / 8 lanes a row,
// 8 values (16 bytes) a lane
template <int D>
__device__ __forceinline__ void delta_mma(const bf16* __restrict__ o,
                                          const bf16* __restrict__ dout,
                                          float* __restrict__ delta,
                                          int rows) {
  constexpr int kLanes = D / 8;
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt / kLanes, c = gt % kLanes;
  float s = 0.f;
  if (row < rows) {
    const size_t at = static_cast<size_t>(row) * D + c * 8;
    const uint4 a = *reinterpret_cast<const uint4*>(o + at);
    const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
    const __nv_bfloat162* ha = reinterpret_cast<const __nv_bfloat162*>(&a);
    const __nv_bfloat162* hb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 fa = __bfloat1622float2(ha[i]);
      const float2 fb = __bfloat1622float2(hb[i]);
      s += fb.x * fa.x;
      s += fb.y * fa.y;
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (c == 0 && row < rows) delta[row] = s;
}

// grid (BH, ceil(Skv / kMmaB)), block kMmaThreads; blockIdx.y is
// the key tile, so under CAUSAL the longest walks (key tile 0) go first.
// Warp w owns keys k0 + 16w .. k0 + 16w + 15 (the rows of S^T); lane (g, t)
// holds keys g and g + 8 of them and q columns 2t, 2t + 1 of each 8-column
// block. Ragged: q rows run to Sq, keys to Skv (CAUSAL only at Sq == Skv).
template <int D, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dkdv_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Skv, int heads_per_row, float scale) {
  using namespace attn_mma;
  constexpr int KD = D / 16;                 // k-steps over the head dim
  constexpr int ND = D / 8;                  // 8-column blocks of dK, dV
  // q columns a step: 32 where the accumulators hold 2 x 64 fp32 a lane
  constexpr int QS = D >= 128 ? 32 : 64;
  constexpr int NQ = QS / 8;                 // 8-column blocks of S^T
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + kMmaB * D;
  bf16* sQ = sV + kMmaB * D;                 // [2][kMmaB][D]
  bf16* sDO = sQ + 2 * kMmaB * D;            // [2][kMmaB][D]
  float* sL = reinterpret_cast<float*>(sDO + 2 * kMmaB * D);  // [2][kMmaB]
  float* sDl = sL + 2 * kMmaB;                                // [2][kMmaB]
  float* sM = sDl + 2 * kMmaB;               // [kMmaB], MASKED only

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kMmaB;
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const size_t rbase = static_cast<size_t>(bh) * Sq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wkey = k0 + warp * 16;           // the warp's first key
  // causal: q tiles above the diagonal see none of these keys
  const int qstart = CAUSAL ? k0 : 0;
  const int ntiles = (Sq - qstart + kMmaB - 1) / kMmaB;

  load_tile<kMmaB, D, kMmaThreads>(sK, k + kbase, k0, Skv, tid);
  load_tile<kMmaB, D, kMmaThreads>(sV, v + kbase, k0, Skv, tid);
  load_tile<kMmaB, D, kMmaThreads>(sQ, q + qbase, qstart, Sq, tid);
  load_tile<kMmaB, D, kMmaThreads>(sDO, dout + qbase, qstart, Sq, tid);
  load_row_values<kMmaB, kMmaThreads>(sL, lse + rbase, qstart, Sq, tid);
  load_row_values<kMmaB, kMmaThreads>(sDl, delta + rbase, qstart, Sq, tid);
  if (MASKED)
    load_row_values<kMmaB, kMmaThreads>(
        sM, mask + static_cast<size_t>(bh / heads_per_row) * Skv, k0, Skv,
        tid);
  cp_async_commit();

  float acc_dk[ND][4], acc_dv[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[nd][e] = acc_dv[nd][e] = 0.f;
  const uint32_t cK = smem_u32(sK), cV = smem_u32(sV);

  for (int i = 0; i < ntiles; ++i) {
    cp_async_wait<0>();  // q tile i has landed
    __syncthreads();     // ... for every thread; q tile i - 1 is released
    const int q0 = qstart + i * kMmaB;
    if (i + 1 < ntiles) {
      const int stage = (i + 1) & 1;
      load_tile<kMmaB, D, kMmaThreads>(sQ + stage * kMmaB * D, q + qbase,
                                       q0 + kMmaB, Sq, tid);
      load_tile<kMmaB, D, kMmaThreads>(sDO + stage * kMmaB * D,
                                       dout + qbase, q0 + kMmaB, Sq, tid);
      load_row_values<kMmaB, kMmaThreads>(sL + stage * kMmaB, lse + rbase,
                                          q0 + kMmaB, Sq, tid);
      load_row_values<kMmaB, kMmaThreads>(sDl + stage * kMmaB, delta + rbase,
                                          q0 + kMmaB, Sq, tid);
    }
    cp_async_commit();
    const uint32_t cQ = smem_u32(sQ + (i & 1) * kMmaB * D);
    const uint32_t cDO = smem_u32(sDO + (i & 1) * kMmaB * D);
    const float* cL = sL + (i & 1) * kMmaB;
    const float* cDl = sDl + (i & 1) * kMmaB;
    // the causal diagonal tile and a ragged last one are masked, no other
    const bool edge = (CAUSAL && i == 0) || q0 + kMmaB > Sq;

#pragma unroll
    for (int sub = 0; sub < kMmaB; sub += QS) {
      // every q of the block before the warp's keys, or past Sq: P = dS = 0
      if (edge && ((CAUSAL && q0 + sub + QS - 1 < wkey) || q0 + sub >= Sq))
        continue;
      float st[NQ][4], dpt[NQ][4];
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[nb][e] = dpt[nb][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        uint32_t ak[4], av[4];
        ldsm_x4(ak, frag_addr<D>(cK, warp * 16, kk * 16, lane));
        ldsm_x4(av, frag_addr<D>(cV, warp * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, frag_addr<D>(cQ, sub + np * 16, kk * 16, lane));
          mma_bf16(st[2 * np], ak, b[0], b[2]);
          mma_bf16(st[2 * np + 1], ak, b[1], b[3]);
          ldsm_x4(b, frag_addr<D>(cDO, sub + np * 16, kk * 16, lane));
          mma_bf16(dpt[2 * np], av, b[0], b[2]);
          mma_bf16(dpt[2 * np + 1], av, b[1], b[3]);
        }
      }
      // p = exp(s - lse) and dS = p * (dp - delta) * scale, per (key, q)
#pragma unroll
      for (int nb = 0; nb < NQ; ++nb) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qi = sub + nb * 8 + 2 * t + (e & 1);
          const int key = wkey + g + (e >> 1) * 8;
          const bool live =
              !edge || (q0 + qi < Sq && (!CAUSAL || key <= q0 + qi));
          float p = 0.f;
          if (MASKED) {
            const float x = __fadd_rn(__fmul_rn(st[nb][e], scale),
                                      sM[key - k0]);
            if (live) p = exp2f((x - cL[qi]) * kLog2e);
          } else if (live) {
            p = exp2f((st[nb][e] * scale - cL[qi]) * kLog2e);
          }
          st[nb][e] = p;
          dpt[nb][e] = p * (dpt[nb][e] - cDl[qi]) * scale;
        }
      }
      // dV += P^T dO and dK += dS^T Q over the CTA's columns, P and dS
      // rounded to bf16 once
#pragma unroll
      for (int kk = 0; kk < QS / 16; ++kk) {
        uint32_t pa[4], dsa[4];
        c_to_a(pa, st, kk);
        c_to_a(dsa, dpt, kk);
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t b[4];
          ldsm_x4_trans(b, frag_addr<D>(cDO, sub + kk * 16, dp * 16, lane));
          mma_bf16(acc_dv[2 * dp], pa, b[0], b[1]);
          mma_bf16(acc_dv[2 * dp + 1], pa, b[2], b[3]);
          ldsm_x4_trans(b, frag_addr<D>(cQ, sub + kk * 16, dp * 16, lane));
          mma_bf16(acc_dk[2 * dp], dsa, b[0], b[1]);
          mma_bf16(acc_dk[2 * dp + 1], dsa, b[2], b[3]);
        }
      }
    }
  }

  store_rows<D>(dk + kbase, acc_dk, wkey, Skv, lane, 1.f, 1.f);
  store_rows<D>(dv + kbase, acc_dv, wkey, Skv, lane, 1.f, 1.f);
}

// grid (BH, ceil(Sq / kMmaB)), block kMmaThreads; under CAUSAL the
// q tile is blockIdx.y reversed, so the longest walks (the last q tile) go
// first. Warp w owns q rows q0 + 16w .. q0 + 16w + 15; lane (g, t) holds
// rows g and g + 8 and key columns 2t, 2t + 1 of each 8-key block. Ragged
// as dkdv_mma.
template <int D, bool CAUSAL, bool MASKED>
__device__ __forceinline__ void dq_mma(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, bf16* __restrict__ dq, int Sq, int Skv,
    int heads_per_row, float scale) {
  using namespace attn_mma;
  constexpr int KD = D / 16;
  constexpr int ND = D / 8;
  constexpr int NK = kMmaB / 8;              // 8-key blocks of S
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + kMmaB * D;
  bf16* sK = sDO + kMmaB * D;                // [2][kMmaB][D]
  bf16* sV = sK + 2 * kMmaB * D;             // [2][kMmaB][D]
  float* sM = reinterpret_cast<float*>(sV + 2 * kMmaB * D);  // [2][kMmaB]

  const int bh = blockIdx.x;
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kMmaB;
  // causal: key tiles up to the diagonal's
  const int nkt = CAUSAL ? qt + 1 : (Skv + kMmaB - 1) / kMmaB;
  const size_t qbase = static_cast<size_t>(bh) * Sq * D;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  const size_t rbase = static_cast<size_t>(bh) * Sq;
  const float* mrow =
      MASKED ? mask + static_cast<size_t>(bh / heads_per_row) * Skv : nullptr;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wrow = q0 + warp * 16;
  float rl[2], rd[2];  // lse and delta of rows g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow + g + 8 * i;
    rl[i] = row < Sq ? lse[rbase + row] : 0.f;
    rd[i] = row < Sq ? delta[rbase + row] : 0.f;
  }

  load_tile<kMmaB, D, kMmaThreads>(sQ, q + qbase, q0, Sq, tid);
  load_tile<kMmaB, D, kMmaThreads>(sDO, dout + qbase, q0, Sq, tid);
  load_tile<kMmaB, D, kMmaThreads>(sK, k + kbase, 0, Skv, tid);
  load_tile<kMmaB, D, kMmaThreads>(sV, v + kbase, 0, Skv, tid);
  if (MASKED) load_row_values<kMmaB, kMmaThreads>(sM, mrow, 0, Skv, tid);
  cp_async_commit();

  float acc[ND][4];
#pragma unroll
  for (int nd = 0; nd < ND; ++nd)
    acc[nd][0] = acc[nd][1] = acc[nd][2] = acc[nd][3] = 0.f;
  const uint32_t cQ = smem_u32(sQ), cDO = smem_u32(sDO);

  for (int j = 0; j < nkt; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < nkt) {
      const int stage = (j + 1) & 1;
      load_tile<kMmaB, D, kMmaThreads>(sK + stage * kMmaB * D, k + kbase,
                                       (j + 1) * kMmaB, Skv, tid);
      load_tile<kMmaB, D, kMmaThreads>(sV + stage * kMmaB * D, v + kbase,
                                       (j + 1) * kMmaB, Skv, tid);
      if (MASKED)
        load_row_values<kMmaB, kMmaThreads>(sM + stage * kMmaB, mrow,
                                            (j + 1) * kMmaB, Skv, tid);
    }
    cp_async_commit();
    const int k0 = j * kMmaB;
    const uint32_t cK = smem_u32(sK + (j & 1) * kMmaB * D);
    const uint32_t cV = smem_u32(sV + (j & 1) * kMmaB * D);
    const float* cM = sM + (j & 1) * kMmaB;
    // the causal diagonal tile, or a ragged last key tile
    const bool edge = CAUSAL ? j == qt : k0 + kMmaB > Skv;

    float s[NK][4], dp[NK][4];
#pragma unroll
    for (int nb = 0; nb < NK; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nb][e] = dp[nb][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t aq[4], ado[4];
      ldsm_x4(aq, frag_addr<D>(cQ, warp * 16, kk * 16, lane));
      ldsm_x4(ado, frag_addr<D>(cDO, warp * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < NK / 2; ++np) {
        uint32_t b[4];
        ldsm_x4(b, frag_addr<D>(cK, np * 16, kk * 16, lane));
        mma_bf16(s[2 * np], aq, b[0], b[2]);
        mma_bf16(s[2 * np + 1], aq, b[1], b[3]);
        ldsm_x4(b, frag_addr<D>(cV, np * 16, kk * 16, lane));
        mma_bf16(dp[2 * np], ado, b[0], b[2]);
        mma_bf16(dp[2 * np + 1], ado, b[1], b[3]);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NK; ++nb) {
      float2 mv = make_float2(0.f, 0.f);
      if (MASKED) mv = *reinterpret_cast<const float2*>(cM + nb * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nb * 8 + 2 * t + (e & 1);
        const int row = wrow + g + (e >> 1) * 8;
        const bool live =
            !edge || (CAUSAL ? row < Sq && key <= row : key < Skv);
        float p = 0.f;
        if (MASKED) {
          const float x = __fadd_rn(__fmul_rn(s[nb][e], scale),
                                    (e & 1) ? mv.y : mv.x);
          if (live) p = exp2f((x - rl[e >> 1]) * kLog2e);
        } else if (live) {
          p = exp2f((s[nb][e] * scale - rl[e >> 1]) * kLog2e);
        }
        dp[nb][e] = p * (dp[nb][e] - rd[e >> 1]) * scale;
      }
    }
    // dQ += dS K over the CTA's columns, dS rounded to bf16 once
#pragma unroll
    for (int kk = 0; kk < kMmaB / 16; ++kk) {
      uint32_t dsa[4];
      c_to_a(dsa, dp, kk);
#pragma unroll
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t b[4];
        ldsm_x4_trans(b, frag_addr<D>(cK, kk * 16, d2 * 16, lane));
        mma_bf16(acc[2 * d2], dsa, b[0], b[1]);
        mma_bf16(acc[2 * d2 + 1], dsa, b[2], b[3]);
      }
    }
  }

  store_rows<D>(dq + qbase, acc, wrow, Sq, lane, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// launches: the three kernels of one design, given by the including file
// ---------------------------------------------------------------------------
// Each returns the first failing launch's cudaError_t (0 on success).
// q/k/v/o/dout/dq/dk/dv [bh, S, D], lse and delta [bh, S] fp32; mask NULL
// or [bh / heads_per_row, S] fp32.
template <int D, bool MASKED, class DeltaK, class DkdvK, class DqK>
int launch_fma(DeltaK delta_k, DkdvK dkdv_k, DqK dq_k, const void* q,
               const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* mask,
               void* delta, void* dq, void* dk, void* dv, int bh, int S,
               int heads_per_row, float scale, cudaStream_t stream) {
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fm = static_cast<const float*>(mask);
  float* fdelta = static_cast<float*>(delta);
  const int rows = bh * S;
  delta_k<<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const float*>(o),
                                              tdo, fdelta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid((S + kB - 1) / kB, bh);
  constexpr size_t kv_bytes = dkdv_fma_smem_bytes<D>();
  err = cudaFuncSetAttribute(dkdv_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_k<<<grid, kThreads, kv_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fm, static_cast<float*>(dk),
      static_cast<float*>(dv), S, heads_per_row, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_fma_smem_bytes<D>();
  err = cudaFuncSetAttribute(dq_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_k<<<grid, kThreads, q_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fm, static_cast<float*>(dq), S,
      heads_per_row, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool MASKED, class DeltaK, class DkdvK, class DqK>
int launch_mma(DeltaK delta_k, DkdvK dkdv_k, DqK dq_k, const void* q,
               const void* k, const void* v, const void* o,
               const void* dout, const void* lse, const void* mask,
               void* delta, void* dq, void* dk, void* dv, int bh, int S,
               int heads_per_row, float scale, cudaStream_t stream) {
  const bf16* tq = static_cast<const bf16*>(q);
  const bf16* tk = static_cast<const bf16*>(k);
  const bf16* tv = static_cast<const bf16*>(v);
  const bf16* tdo = static_cast<const bf16*>(dout);
  const float* flse = static_cast<const float*>(lse);
  const float* fm = static_cast<const float*>(mask);
  float* fdelta = static_cast<float*>(delta);
  const int rows = bh * S;
  const int lanes = rows * (D / 8);
  delta_k<<<(lanes + 255) / 256, 256, 0, stream>>>(
      static_cast<const bf16*>(o), tdo, fdelta, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const dim3 grid(bh, (S + kMmaB - 1) / kMmaB);
  constexpr size_t kv_bytes = dkdv_mma_smem_bytes<D, MASKED>();
  err = cudaFuncSetAttribute(dkdv_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kv_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv_k<<<grid, kMmaThreads, kv_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fm, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), S, heads_per_row, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  constexpr size_t q_bytes = dq_mma_smem_bytes<D, MASKED>();
  err = cudaFuncSetAttribute(dq_k,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(q_bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  dq_k<<<grid, kMmaThreads, q_bytes, stream>>>(
      tq, tk, tv, tdo, flse, fdelta, fm, static_cast<bf16*>(dq), S,
      heads_per_row, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace attn_bwd
