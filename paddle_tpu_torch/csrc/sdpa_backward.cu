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
// the diagonal when causal). Scores and dP are computed in both: written
// per key tile, dQ's partials would be 8 x 16.8 MB at the encoder shape,
// more traffic than the recomputation costs.
//
// Bound on this card: operations. 10 * BH * Sq * Skv * D FLOP (half, with
// the diagonal, when causal) over 989 TFLOP/s bf16: the Transformer-base
// encoder's B8 H8 S1024 D64 is 43.0 GFLOP, 43.4 us; its bytes (q, k, v, O,
// dO and the LSE read, dq, dk, dv written, 67.4 MB) take 20.1 us at
// 3.35 TB/s.
//
// Two designs:
// - bfloat16 at head dims 64 to 256 (`sdpa_dkdv_wgmma_kernel`,
//   `sdpa_dq_wgmma_kernel`, the second design): `wgmma` on the tensor
//   cores (hopper.cuh), the only route to their full rate. q, k, v and dO
//   arrive as 128-byte-swizzled 64 x 64 boxes through TMA (tensor maps of
//   [BH, S, D], rows past S zero-filled) onto an mbarrier ring. A CTA is a
//   producer warpgroup, whose warp 0 issues the copies (and, in the dK/dV
//   kernel, loads each q tile's lse and delta), and consumer warpgroups,
//   which release a stage with one arrival a warp. Two consumers take the
//   producer's registers with setmaxnreg (240 a thread); a lone one has
//   255 without it.
//   dK/dV: up to D 128 a CTA owns 128 keys, 64 a consumer warpgroup, and
//   walks the q tiles (128 rows and 4 stages at D 64, 64 rows and 3 at
//   128). S^T = K Q^T and dP^T = V dO^T run with both operands in shared
//   memory; P^T and dS^T, rounded at B2's points, stay in registers as the
//   A operand of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major).
//   The exponentials are one MUFU each, masked by a select on edge tiles
//   only; the two warpgroups take turns to issue a tile's first products
//   (named barriers), so one's elementwise work overlaps the other's
//   products. At D 192 and 256 a row of dK and dV does not fit
//   one warpgroup's registers: the CTA owns 64 keys, one warpgroup
//   computes S^T and P, the other dP^T and dS, each hands the other its
//   bf16 fragments through shared memory (named barriers), and the two
//   split dK/dV's columns (128 + 64 at D 192, 128 + 128 at 256), so each
//   score product runs once a tile (the first design ran them once per
//   column half). 231,464 bytes of shared memory at D 256.
//   dQ: a consumer warpgroup owns 64 q rows (two a CTA up to D 128, one
//   above), recomputes S and dP over each key tile (128 keys at D 64, else
//   64) and runs dQ += dS K with dS from registers and K read MN-major; P
//   is formed while dP runs.
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
// The first bf16 design, attention_bwd.cuh's mma.sync bodies with D 192
// and 256 cut into two column chunks (grid z), is replaced; PERF.md keeps
// its times beside the second design's.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attention_mma.cuh"
#include "hopper.cuh"

namespace {

using attn_mma::bf16;

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

// lanes a row of the delta kernel: the largest power of two, up to 32,
// that divides the row's 16-byte pieces
template <typename T, int D>
__host__ __device__ constexpr int delta_lanes() {
  int n = D * static_cast<int>(sizeof(T)) / 16, l = 1;
  while (l < 32 && n % (2 * l) == 0) l *= 2;
  return l;
}

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32, `delta_lanes` lanes a
// row, 16 bytes of each a lane a step
template <typename T, int D>
__global__ void sdpa_delta_kernel(const T* __restrict__ o,
                                  const T* __restrict__ dout,
                                  float* __restrict__ delta, int rows) {
  constexpr int kVec = 16 / sizeof(T), kLanes = delta_lanes<T, D>();
  const int gt = blockIdx.x * blockDim.x + threadIdx.x;
  const int row = gt / kLanes, part = gt % kLanes;
  float s = 0.f;
  if (row < rows) {
#pragma unroll
    for (int c = part * kVec; c < D; c += kLanes * kVec) {
      const size_t at = static_cast<size_t>(row) * D + c;
      const uint4 a = *reinterpret_cast<const uint4*>(o + at);
      const uint4 b = *reinterpret_cast<const uint4*>(dout + at);
      const T* ta = reinterpret_cast<const T*>(&a);
      const T* tb = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int e = 0; e < kVec; ++e) s += to_f(tb[e]) * to_f(ta[e]);
    }
  }
#pragma unroll
  for (int off = kLanes / 2; off; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (part == 0 && row < rows) delta[row] = s;
}

// ---------------------------------------------------------------------------
// bfloat16, head dims 64 to 256: wgmma on tiles that TMA brings in
// ---------------------------------------------------------------------------
namespace wg {

using hopper::desc_sw128;

constexpr int kBox = 64;                 // rows (and bf16 columns) of a box
constexpr int kBoxBytes = kBox * 128;    // one 64 x 64 bf16 box: 8 KB
constexpr int kSbo = 1024;               // 8 swizzled rows
constexpr int kKmajorLbo = 16;           // unused by a K-major SW128 tile
constexpr int kProducerRegs = 24;

// dK/dV: a CTA owns 128 keys (64 a consumer warpgroup) up to D 128, and
// 64 keys above, where its two warpgroups split the columns of dK and dV
template <int D>
__host__ __device__ constexpr bool split_cols() { return D > 128; }
template <int D>
__host__ __device__ constexpr int dkdv_keys() {
  return split_cols<D>() ? 64 : 128;
}
template <int D>
__host__ __device__ constexpr int dkdv_stages() {
  return D == 64 ? 4 : D == 128 ? 3 : 2;
}
// dQ: a CTA owns 64 q rows a consumer warpgroup, two up to D 128, one above
template <int D>
__host__ __device__ constexpr int dq_wgs() { return D > 128 ? 1 : 2; }
template <int D>
__host__ __device__ constexpr int dq_stages() {
  return D == 64 ? 4 : D <= 192 ? 3 : 2;
}
// the dQ kernel's threads: the producer warpgroup and its consumers
template <int D>
constexpr int kDqThreads = 128 * (1 + dq_wgs<D>());
// the first warpgroup's dK/dV columns where the two split them
template <int D>
__host__ __device__ constexpr int split_n0() { return D > 128 ? 128 : D; }

// registers a thread at launch with two consumer warpgroups (384 threads:
// the launch bounds' cap, which ptxas takes for a kernel with setmaxnreg)
// and a consumer's after setmaxnreg: the producer warpgroup's surplus goes
// to the consumers, none is left over. With one consumer (the dQ kernel
// above D 128, 256 threads) every thread may hold 255 and none is moved.
constexpr int kLaunchRegs = 168;
constexpr int kConsumerRegs = kLaunchRegs + (kLaunchRegs - kProducerRegs) / 2;

// shared memory of the dK/dV kernel, byte offsets from a 1024-byte aligned
// base: K and V [D / 64][keys][64], the ring of Q and dO [D / 64][QT][64]
// a stage (QT q rows a tile: 128 at D 64, where a tile's products are
// short, else 64), the split's exchange of P and dS, lse * log2(e) and
// delta a stage, the barriers
template <int D>
struct DkdvSmem {
  static constexpr int KB = dkdv_keys<D>(), NS = dkdv_stages<D>();
  static constexpr int QT = D == 64 ? 128 : 64;
  static constexpr int kv_tile = KB * D * 2;
  static constexpr int q_tile = QT * D * 2;
  static constexpr int k_off = 0, v_off = kv_tile, q_off = 2 * kv_tile;
  static constexpr int x_off = q_off + NS * 2 * q_tile;
  // P fp32 [32][128], P bf16 pairs [16][128], dS bf16 pairs [16][128]
  static constexpr int x_bytes = split_cols<D>() ? 64 * 128 * 4 : 0;
  static constexpr int l_off = x_off + x_bytes;
  static constexpr int bar_off = l_off + NS * 2 * QT * 4;
  static constexpr int bytes = bar_off + (1 + 2 * NS) * 8;
};

// the dQ kernel's: Q and dO [D / 64][rows][64], the ring of K and V
// [D / 64][KT][64] a stage (KT keys a tile: 128 at D 64, where a tile's
// products are short, else 64), the barriers
template <int D>
struct DqSmem {
  static constexpr int QB = kBox * dq_wgs<D>(), NS = dq_stages<D>();
  static constexpr int KT = D == 64 ? 128 : 64;
  static constexpr int q_tile = QB * D * 2;
  static constexpr int kv_tile = KT * D * 2;
  static constexpr int q_off = 0, do_off = q_tile, k_off = 2 * q_tile;
  static constexpr int bar_off = k_off + NS * 2 * kv_tile;
  static constexpr int bytes = bar_off + (1 + 2 * NS) * 8;
};

// Two consumer warpgroups walking the same tiles would run in step: both
// on the tensor cores, then both on the exponentials. They take turns to
// issue a tile's first products instead (named barriers 3 and 4), so one
// warpgroup's elementwise work overlaps the other's products. The second
// warpgroup opens the first turn; the last turn's hand-over is skipped.
__device__ __forceinline__ void turn_open(int c) {
  if (c == 1) hopper::named_arrive(3, 256);
}

__device__ __forceinline__ void turn_wait(int c) {
  hopper::named_sync(3 + c, 256);
}

__device__ __forceinline__ void turn_pass(int c, bool last) {
  if (!(c == 1 && last)) hopper::named_arrive(4 - c, 256);
}

// a consumer warp is done with a stage: one arrival a warp (the empty
// barriers count warps; an arrival from each of 128 threads would queue
// on the barrier)
__device__ __forceinline__ void release(uint64_t* empty, int lane) {
  __syncwarp();
  if (lane == 0) hopper::mbar_arrive(empty);
}

__device__ __forceinline__ unsigned char* aligned_base(unsigned char* p) {
  const uint32_t a = hopper::smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

// the A fragment of k-step kk (accumulator columns 16 kk .. 16 kk + 15)
// of an m64nN accumulator, each value rounded to bf16 once
template <int NR>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[NR], int kk) {
  using attn_mma::pack_bf16x2;
  a[0] = pack_bf16x2(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16x2(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16x2(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16x2(c[8 * kk + 6], c[8 * kk + 7]);
}

// acc (N columns) += A (m64 x k16, registers) B, B the k-step at `b` of an
// MN-major 64-row tile: N / 128 m64n128k16 products, then an m64n64k16
// one for a remainder of 64 columns, each one column block pair further
template <int N>
__device__ __forceinline__ void mma_cols(float (&acc)[N / 2],
                                         const uint32_t (&a)[4],
                                         const unsigned char* b) {
  const uint64_t d = desc_sw128(b, kBoxBytes, kSbo);
#pragma unroll
  for (int c = 0; c < N / 128; ++c)
    hopper::wgmma_m64n128k16_rs(
        *reinterpret_cast<float(*)[64]>(acc + 64 * c), a,
        d + ((2 * c * kBoxBytes) >> 4), 1);
  if constexpr (N % 128 != 0)
    hopper::wgmma_m64n64k16_rs(
        *reinterpret_cast<float(*)[32]>(acc + 64 * (N / 128)), a,
        d + ((2 * (N / 128) * kBoxBytes) >> 4), 1);
}

// s = A B^T over the head dim: A the 64 rows at `a` of a K-major tile of
// `a_rows` rows a column block, B the N (64 or 128) rows of an N-row tile
// at `b`
template <int D, int N = 64>
__device__ __forceinline__ void mma_scores(float (&s)[N / 2],
                                           const unsigned char* a,
                                           int a_rows,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int cb = kk / 4, j = kk % 4;
    const uint64_t da =
        desc_sw128(a + cb * a_rows * 128 + 32 * j, kKmajorLbo, kSbo);
    const uint64_t db = desc_sw128(b + cb * N * 128 + 32 * j, kKmajorLbo,
                                   kSbo);
    if constexpr (N == 128)
      hopper::wgmma_m64n128k16_ss(s, da, db, kk > 0);
    else
      hopper::wgmma_m64n64k16_ss(s, da, db, kk > 0);
  }
}

// an accumulator of N columns (a row block of 64 rows, this thread's rows
// r0 + g and r0 + g + 8, columns c0 + 8 (i / 4) + 2t ..) into a [S, D] bf16
// slab, rows at or past S skipped
template <int D, int N>
__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[N / 2],
                                          int r0, int c0, int S, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < N / 2; i += 2) {
    const int row = r0 + g + 8 * ((i >> 1) & 1);
    const int col = c0 + 8 * (i >> 2) + 2 * t;
    if (row < S)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(row) * D + col) =
          attn_mma::pack_bf16x2(acc[i], acc[i + 1]);
  }
}

// the q tiles a dK/dV CTA walks: from the diagonal when causal
template <bool CAUSAL>
__device__ __forceinline__ int dkdv_qstart(int k0) { return CAUSAL ? k0 : 0; }

// 2^x, flushing a result below 2^-126 to 0: one MUFU.EX2, no branch
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// P^T = exp(S^T - lse) over an m64nN accumulator of the dK/dV kernel
// (rows keys, columns q), in place; lse arrives times log2(e). Only an
// edge tile is masked (past Sq, above the diagonal), and by a select, so
// the exponentials of a tile issue back to back.
template <bool CAUSAL, int NR>
__device__ __forceinline__ void p_of_s_t(float (&st)[NR], const float* cl,
                                         int q0, int key0, int Sq, bool edge,
                                         float scale_log2, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NR / 4; ++nb) {
    // the lse of this thread's two q columns of block nb
    const float2 l2 = *reinterpret_cast<const float2*>(cl + 8 * nb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * nb + e;
      st[i] = exp2_ftz(fmaf(st[i], scale_log2, (e & 1) ? -l2.y : -l2.x));
    }
  }
  if (!edge) return;
#pragma unroll
  for (int i = 0; i < NR; ++i) {
    const int qi = q0 + 8 * (i >> 2) + 2 * t + (i & 1);
    const int key = key0 + g + 8 * ((i >> 1) & 1);
    const bool live = (qi < Sq) & (!CAUSAL | (key <= qi));
    st[i] = live ? st[i] : 0.f;
  }
}

// dS^T = P^T * (dP^T - delta) * scale, in place of dP^T
template <int NR>
__device__ __forceinline__ void ds_of_dp_t(float (&dpt)[NR],
                                           const float (&pt)[NR],
                                           const float* cd, float scale,
                                           int lane) {
  const int t = lane & 3;
#pragma unroll
  for (int nb = 0; nb < NR / 4; ++nb) {
    const float2 d2 = *reinterpret_cast<const float2*>(cd + 8 * nb + 2 * t);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * nb + e;
      dpt[i] = pt[i] * (dpt[i] - ((e & 1) ? d2.y : d2.x)) * scale;
    }
  }
}

// the producer warp of the dK/dV kernel: K and V once, then each q tile's
// Q, dO (TMA) and lse * log2(e), delta (the warp's loads) into the ring
template <int D, bool CAUSAL>
__device__ __forceinline__ void dkdv_producer(
    unsigned char* base, const CUtensorMap* mq, const CUtensorMap* mk,
    const CUtensorMap* mv, const CUtensorMap* mdo, const float* lse,
    const float* delta, int bh, int k0, int Sq, int lane) {
  using L = DkdvSmem<D>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::bar_off);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::NS;
  if (lane == 0) {
    hopper::mbar_arrive_expect_tx(bars, 2 * L::kv_tile);
#pragma unroll
    for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
      for (int h = 0; h < L::KB / kBox; ++h) {
        const int off = cb * L::KB * 128 + h * kBoxBytes;
        hopper::tma_load_3d(base + L::k_off + off, mk, bars, 64 * cb,
                            k0 + kBox * h, bh);
        hopper::tma_load_3d(base + L::v_off + off, mv, bars, 64 * cb,
                            k0 + kBox * h, bh);
      }
  }
  constexpr int QT = L::QT;
  const int qstart = dkdv_qstart<CAUSAL>(k0);
  const int ntiles = (Sq - qstart + QT - 1) / QT;
  const size_t rb = static_cast<size_t>(bh) * Sq;
  float* ls = reinterpret_cast<float*>(base + L::l_off);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % L::NS, q0 = qstart + i * QT;
    // the tile's lse and delta, read while the stage may still be in use
    float lv[QT / 32], dl[QT / 32];
#pragma unroll
    for (int h = 0; h < QT / 32; ++h) {
      const int j = lane + 32 * h;
      const bool in = q0 + j < Sq;
      lv[h] = in ? lse[rb + q0 + j] * attn_mma::kLog2e : 0.f;
      dl[h] = in ? delta[rb + q0 + j] : 0.f;
    }
    hopper::mbar_wait(&empty[s], ((i / L::NS) & 1) ^ 1);
#pragma unroll
    for (int h = 0; h < QT / 32; ++h) {
      ls[s * 2 * QT + lane + 32 * h] = lv[h];
      ls[s * 2 * QT + QT + lane + 32 * h] = dl[h];
    }
    __syncwarp();  // the warp's lse and delta before lane 0's arrival
    if (lane == 0) {
      unsigned char* qs = base + L::q_off + s * 2 * L::q_tile;
      hopper::mbar_arrive_expect_tx(&full[s], 2 * L::q_tile);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
        for (int h = 0; h < QT / kBox; ++h) {
          const int off = cb * QT * 128 + h * kBoxBytes;
          hopper::tma_load_3d(qs + off, mq, &full[s], 64 * cb, q0 + kBox * h,
                              bh);
          hopper::tma_load_3d(qs + L::q_tile + off, mdo, &full[s], 64 * cb,
                              q0 + kBox * h, bh);
        }
    }
  }
}

// a consumer warpgroup of the dK/dV kernel up to D 128: its own 64 keys,
// all D columns of their dK and dV
template <int D, bool CAUSAL>
__device__ __forceinline__ void dkdv_consumer(
    unsigned char* base, bf16* dk, bf16* dv, int c, int k0, int Sq, int Skv,
    float scale, int wt) {
  using L = DkdvSmem<D>;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::bar_off);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::NS;
  const int ww = wt >> 5, lane = wt & 31;
  const int kw = k0 + kBox * c;                  // the warpgroup's keys
  const float scale_log2 = scale * attn_mma::kLog2e;
  const float* ls = reinterpret_cast<const float*>(base + L::l_off);
  float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(bars, 0);
  constexpr int QT = L::QT, NR = QT / 2;     // score accumulators a thread
  const int qstart = dkdv_qstart<CAUSAL>(k0);
  const int ntiles = (Sq - qstart + QT - 1) / QT;
  turn_open(c);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % L::NS, q0 = qstart + i * QT;
    hopper::mbar_wait(&full[s], (i / L::NS) & 1);
    turn_wait(c);
    // every q of the tile before the warpgroup's keys: P = dS = 0
    if (CAUSAL && q0 + QT - 1 < kw) {
      turn_pass(c, i == ntiles - 1);
    } else {
      const unsigned char* qs = base + L::q_off + s * 2 * L::q_tile;
      const unsigned char* dos = qs + L::q_tile;
      const float* cl = ls + s * 2 * QT;
      float st[NR], dpt[NR];
      hopper::wgmma_fence();
      mma_scores<D, QT>(st, base + L::k_off + c * kBoxBytes, L::KB, qs);
      mma_scores<D, QT>(dpt, base + L::v_off + c * kBoxBytes, L::KB, dos);
      hopper::wgmma_commit();
      turn_pass(c, i == ntiles - 1);
      hopper::wgmma_wait<0>();
      hopper::fence_acc(st);
      hopper::fence_acc(dpt);
      // P^T and dS^T in place, then both as bf16 A fragments
      const bool edge = (CAUSAL && q0 < kw + kBox) || q0 + QT > Sq;
      p_of_s_t<CAUSAL>(st, cl, q0, kw + 16 * ww, Sq, edge, scale_log2, lane);
      ds_of_dp_t(dpt, st, cl + QT, scale, lane);
      uint32_t pa[QT / 16][4], dsa[QT / 16][4];
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        acc_to_a(pa[kk], st, kk);
        acc_to_a(dsa[kk], dpt, kk);
      }
      hopper::wgmma_fence();
      // dO and Q read MN-major: a 128-row tile is one column block at D 64
      static_assert(QT == kBox || D == 64, "one column block");
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        mma_cols<D>(dv_acc, pa[kk], dos + kk * 16 * 128);
        mma_cols<D>(dk_acc, dsa[kk], qs + kk * 16 * 128);
      }
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dv_acc);
      hopper::fence_acc(dk_acc);
    }
    release(&empty[s], lane);
  }
  store_acc<D, D>(dk, dk_acc, kw + 16 * ww, 0, Skv, lane);
  store_acc<D, D>(dv, dv_acc, kw + 16 * ww, 0, Skv, lane);
}

// a consumer warpgroup of the dK/dV kernel at D 192 and 256: the CTA's 64
// keys, N of the columns of dK and dV from column C0. ROLE 0 computes S^T
// and P, ROLE 1 dP^T and dS; each hands the other its bf16 fragments
// through shared memory (named barriers 1 and 2), so each score product
// runs once a tile
template <int D, bool CAUSAL, int N, int C0, int ROLE>
__device__ __forceinline__ void dkdv_split_consumer(
    unsigned char* base, bf16* dk, bf16* dv, int k0, int Sq, int Skv,
    float scale, int wt) {
  using L = DkdvSmem<D>;
  static_assert(L::QT == kBox, "64-row q tiles");
  constexpr int kPair = 256;                     // both consumer warpgroups
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::bar_off);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::NS;
  const int ww = wt >> 5, lane = wt & 31;
  const float scale_log2 = scale * attn_mma::kLog2e;
  const float* ls = reinterpret_cast<const float*>(base + L::l_off);
  float* xp = reinterpret_cast<float*>(base + L::x_off);    // [32][128]
  uint32_t* xpb = reinterpret_cast<uint32_t*>(xp + 32 * 128);  // [16][128]
  uint32_t* xds = xpb + 16 * 128;                               // [16][128]
  float dk_acc[N / 2], dv_acc[N / 2];
#pragma unroll
  for (int i = 0; i < N / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  hopper::mbar_wait(bars, 0);
  const int qstart = dkdv_qstart<CAUSAL>(k0);
  const int ntiles = (Sq - qstart + kBox - 1) / kBox;
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % L::NS, q0 = qstart + i * kBox;
    hopper::mbar_wait(&full[s], (i / L::NS) & 1);
    const unsigned char* qs = base + L::q_off + s * 2 * L::q_tile;
    const unsigned char* dos = qs + L::q_tile;
    const float* cl = ls + s * 2 * L::QT;
    const float* cd = cl + kBox;
    float acc[32];
    hopper::wgmma_fence();
    mma_scores<D>(acc, base + (ROLE == 0 ? L::k_off : L::v_off), L::KB,
                  ROLE == 0 ? qs : dos);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(acc);
    uint32_t pa[4][4], dsa[4][4];
    if constexpr (ROLE == 0) {
      const bool edge = (CAUSAL && i == 0) || q0 + kBox > Sq;
      p_of_s_t<CAUSAL>(acc, cl, q0, k0 + 16 * ww, Sq, edge, scale_log2,
                       lane);
#pragma unroll
      for (int j = 0; j < 32; ++j) xp[j * 128 + wt] = acc[j];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(pa[kk], acc, kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) xpb[(4 * kk + e) * 128 + wt] = pa[kk][e];
      }
      hopper::named_arrive(1, kPair);
      hopper::named_sync(2, kPair);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) dsa[kk][e] = xds[(4 * kk + e) * 128 + wt];
    } else {
      hopper::named_sync(1, kPair);
      float pt[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) pt[j] = xp[j * 128 + wt];
      ds_of_dp_t(acc, pt, cd, scale, lane);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        acc_to_a(dsa[kk], acc, kk);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          xds[(4 * kk + e) * 128 + wt] = dsa[kk][e];
          pa[kk][e] = xpb[(4 * kk + e) * 128 + wt];
        }
      }
      hopper::named_arrive(2, kPair);
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      mma_cols<N>(dv_acc, pa[kk], dos + (C0 / 64) * kBoxBytes + kk * 16 * 128);
      mma_cols<N>(dk_acc, dsa[kk], qs + (C0 / 64) * kBoxBytes + kk * 16 * 128);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(dv_acc);
    hopper::fence_acc(dk_acc);
    release(&empty[s], lane);
  }
  store_acc<D, N>(dk, dk_acc, k0 + 16 * ww, C0, Skv, lane);
  store_acc<D, N>(dv, dv_acc, k0 + 16 * ww, C0, Skv, lane);
}

}  // namespace wg

// grid (BH, ceil(Skv / keys)), 384 threads: warpgroup 0 the producer (its
// warp 0 issues TMA), warpgroups 1 and 2 the consumers. blockIdx.y is the
// key tile, so under CAUSAL the longest walks (key tile 0) go first.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(384, 1) sdpa_dkdv_wgmma_kernel(
    const __grid_constant__ CUtensorMap mq,
    const __grid_constant__ CUtensorMap mk,
    const __grid_constant__ CUtensorMap mv,
    const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int Sq, int Skv, float scale) {
  using L = wg::DkdvSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = wg::aligned_base(smem_raw);
  const int tid = threadIdx.x, warpgroup = tid / 128;
  const int bh = blockIdx.x, k0 = blockIdx.y * L::KB;
  const size_t kbase = static_cast<size_t>(bh) * Skv * D;
  if (tid == 0) {
    uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::bar_off);
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < L::NS; ++s) {
      hopper::mbar_init(bars + 1 + s, 1);             // the producer warp
      hopper::mbar_init(bars + 1 + L::NS + s, 8);     // the consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warpgroup == 0) {
    hopper::setmaxnreg_dec<wg::kProducerRegs>();
    if (tid < 32)
      wg::dkdv_producer<D, CAUSAL>(base, &mq, &mk, &mv, &mdo, lse, delta, bh,
                                   k0, Sq, tid);
  } else {
    hopper::setmaxnreg_inc<wg::kConsumerRegs>();
    const int wt = tid - 128 * warpgroup;
    if constexpr (wg::split_cols<D>()) {
      constexpr int N0 = wg::split_n0<D>();
      if (warpgroup == 1)
        wg::dkdv_split_consumer<D, CAUSAL, N0, 0, 0>(
            base, dk + kbase, dv + kbase, k0, Sq, Skv, scale, wt);
      else
        wg::dkdv_split_consumer<D, CAUSAL, D - N0, N0, 1>(
            base, dk + kbase, dv + kbase, k0, Sq, Skv, scale, wt);
    } else {
      wg::dkdv_consumer<D, CAUSAL>(base, dk + kbase, dv + kbase,
                                   warpgroup - 1, k0, Sq, Skv, scale, wt);
    }
  }
}

// grid (BH, ceil(Sq / rows)), 128 (1 + consumers) threads: warpgroup 0 the
// producer (Q and dO once, then the ring of K and V), each consumer
// warpgroup 64 q rows and all D columns of their dQ. Under CAUSAL the q
// tile is blockIdx.y reversed, so the longest walks (the last q tile) go
// first.
template <int D, bool CAUSAL>
__global__ void __launch_bounds__(wg::kDqThreads<D>, 1)
    sdpa_dq_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         bf16* __restrict__ dq, int Sq, int Skv, float scale) {
  using L = wg::DqSmem<D>;
  constexpr int NC = wg::dq_wgs<D>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = wg::aligned_base(smem_raw);
  const int tid = threadIdx.x, warpgroup = tid / 128;
  const int bh = blockIdx.x;
  const int qt = CAUSAL ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * L::QB;
  // causal: keys past the CTA's last row see none of its rows
  const int kend = CAUSAL ? min(q0 + L::QB, Skv) : Skv;
  const int ntiles = (kend + L::KT - 1) / L::KT;
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::bar_off);
  uint64_t* full = bars + 1;
  uint64_t* empty = full + L::NS;
  if (tid == 0) {
    hopper::mbar_init(bars, 1);
    for (int s = 0; s < L::NS; ++s) {
      hopper::mbar_init(full + s, 1);
      hopper::mbar_init(empty + s, 4 * NC);           // the consumer warps
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (warpgroup == 0) {
    if constexpr (NC == 2) hopper::setmaxnreg_dec<wg::kProducerRegs>();
    if (tid == 0) {
      hopper::mbar_arrive_expect_tx(bars, 2 * L::q_tile);
#pragma unroll
      for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
        for (int h = 0; h < NC; ++h) {
          const int off = cb * L::QB * 128 + h * wg::kBoxBytes;
          hopper::tma_load_3d(base + L::q_off + off, &mq, bars, 64 * cb,
                              q0 + wg::kBox * h, bh);
          hopper::tma_load_3d(base + L::do_off + off, &mdo, bars, 64 * cb,
                              q0 + wg::kBox * h, bh);
        }
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % L::NS;
        hopper::mbar_wait(&empty[s], ((i / L::NS) & 1) ^ 1);
        unsigned char* ks = base + L::k_off + s * 2 * L::kv_tile;
        hopper::mbar_arrive_expect_tx(&full[s], 2 * L::kv_tile);
#pragma unroll
        for (int cb = 0; cb < D / 64; ++cb)
#pragma unroll
          for (int h = 0; h < L::KT / wg::kBox; ++h) {
            const int off = cb * L::KT * 128 + h * wg::kBoxBytes;
            const int k0 = i * L::KT + wg::kBox * h;
            hopper::tma_load_3d(ks + off, &mk, &full[s], 64 * cb, k0, bh);
            hopper::tma_load_3d(ks + L::kv_tile + off, &mv, &full[s],
                                64 * cb, k0, bh);
          }
      }
    }
    return;
  }
  if constexpr (NC == 2) hopper::setmaxnreg_inc<wg::kConsumerRegs>();
  const int c = warpgroup - 1, wt = tid - 128 * warpgroup;
  const int ww = wt >> 5, lane = wt & 31, g = lane >> 2, t = lane & 3;
  const int qw = q0 + wg::kBox * c;              // the warpgroup's rows
  const int r_lo = qw + 16 * ww + g, r_hi = r_lo + 8;
  const size_t rb = static_cast<size_t>(bh) * Sq;
  const float scale_log2 = scale * attn_mma::kLog2e;
  const float l_lo = r_lo < Sq ? lse[rb + r_lo] * attn_mma::kLog2e : 0.f;
  const float l_hi = r_hi < Sq ? lse[rb + r_hi] * attn_mma::kLog2e : 0.f;
  const float d_lo = r_lo < Sq ? delta[rb + r_lo] : 0.f;
  const float d_hi = r_hi < Sq ? delta[rb + r_hi] : 0.f;
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

  hopper::mbar_wait(bars, 0);
  if constexpr (NC == 2) wg::turn_open(c);
  for (int i = 0; i < ntiles; ++i) {
    const int s = i % L::NS, kt0 = i * L::KT;
    const bool last = i == ntiles - 1;
    hopper::mbar_wait(&full[s], (i / L::NS) & 1);
    if constexpr (NC == 2) wg::turn_wait(c);
    // every key of the tile after the warpgroup's rows: dS = 0
    if (CAUSAL && kt0 > qw + wg::kBox - 1) {
      if constexpr (NC == 2) wg::turn_pass(c, last);
    } else {
      const unsigned char* ks = base + L::k_off + s * 2 * L::kv_tile;
      // S, then dP: P is formed while dP runs
      constexpr int NR = L::KT / 2;                // accumulators a thread
      float st[NR], dpt[NR];
      hopper::wgmma_fence();
      wg::mma_scores<D, L::KT>(st, base + L::q_off + c * wg::kBoxBytes, L::QB,
                               ks);
      hopper::wgmma_commit();
      wg::mma_scores<D, L::KT>(dpt, base + L::do_off + c * wg::kBoxBytes,
                               L::QB, ks + L::kv_tile);
      hopper::wgmma_commit();
      if constexpr (NC == 2) wg::turn_pass(c, last);
      // one consumer at D 192 and 256 holds dQ's 128 columns: no room to
      // keep dP in flight
      if constexpr (NC == 2)
        hopper::wgmma_wait<1>();
      else
        hopper::wgmma_wait<0>();
      hopper::fence_acc(st);
#pragma unroll
      for (int j = 0; j < NR; ++j)
        st[j] = wg::exp2_ftz(
            fmaf(st[j], scale_log2, ((j >> 1) & 1) ? -l_hi : -l_lo));
      // only an edge tile is masked (past Skv or Sq, above the diagonal)
      if ((CAUSAL && kt0 + L::KT - 1 > qw) || kt0 + L::KT > Skv ||
          qw + wg::kBox > Sq) {
#pragma unroll
        for (int j = 0; j < NR; ++j) {
          const int row = ((j >> 1) & 1) ? r_hi : r_lo;
          const int key = kt0 + 8 * (j >> 2) + 2 * t + (j & 1);
          const bool live =
              (row < Sq) & (key < Skv) & (!CAUSAL | (key <= row));
          st[j] = live ? st[j] : 0.f;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_acc(dpt);
#pragma unroll
      for (int j = 0; j < NR; ++j)
        dpt[j] = st[j] * (dpt[j] - (((j >> 1) & 1) ? d_hi : d_lo)) * scale;
      uint32_t dsa[L::KT / 16][4];
#pragma unroll
      for (int kk = 0; kk < L::KT / 16; ++kk) wg::acc_to_a(dsa[kk], dpt, kk);
      hopper::wgmma_fence();
      // K read MN-major: a 128-key tile is one column block at D 64
      static_assert(L::KT == wg::kBox || D == 64, "one column block");
#pragma unroll
      for (int kk = 0; kk < L::KT / 16; ++kk)
        wg::mma_cols<D>(acc, dsa[kk], ks + kk * 16 * 128);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
    }
    wg::release(&empty[s], lane);
  }
  wg::store_acc<D, D>(dq + static_cast<size_t>(bh) * Sq * D, acc,
                      qw + 16 * ww, 0, Sq, lane);
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
  constexpr int kLanes = delta_lanes<T, D>();
  sdpa_delta_kernel<T, D>
      <<<(rows * kLanes + 255) / 256, 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout), delta, rows);
  return static_cast<int>(cudaGetLastError());
}

// a [bh, S, D] bf16 slab as a tensor map of 64 x 64 boxes, 128-byte
// swizzled, rows past S (of each bh) zero-filled
template <int D>
bool slab_map(CUtensorMap* map, const void* p, int S, int bh) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {wg::kBox, wg::kBox, 1};
  return hopper::encode_tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                                   p, dims, strides, box,
                                   CU_TENSOR_MAP_SWIZZLE_128B);
}

// before each launch, in the current device's context: the kernel's
// dynamic shared memory allowed, and, for a kernel that moves registers
// with setmaxnreg, its registers at launch those the move assumes (else it
// is not launched: a consumer would wait for ever)
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, bool moves_regs) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes a;
  e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return e;
  return !moves_regs || a.numRegs == wg::kLaunchRegs
             ? cudaSuccess : cudaErrorInvalidConfiguration;
}

template <int D, bool CAUSAL>
int launch_wgmma(const void* q, const void* k, const void* v, const void* o,
                 const void* dout, const float* lse, float* delta, void* dq,
                 void* dk, void* dv, int bh, int Sq, int Skv, float scale,
                 cudaStream_t stream) {
  int err = launch_delta<bf16, D>(o, dout, delta, bh * Sq, stream);
  if (err) return err;
  CUtensorMap mq, mk, mv, mdo;
  if (!slab_map<D>(&mq, q, Sq, bh) || !slab_map<D>(&mk, k, Skv, bh) ||
      !slab_map<D>(&mv, v, Skv, bh) || !slab_map<D>(&mdo, dout, Sq, bh))
    return static_cast<int>(cudaErrorNotSupported);
  using LK = wg::DkdvSmem<D>;
  using LQ = wg::DqSmem<D>;
  constexpr int NC = wg::dq_wgs<D>();
  constexpr int kv_smem = LK::bytes + 1024, q_smem = LQ::bytes + 1024;
  cudaError_t e = prepare(sdpa_dkdv_wgmma_kernel<D, CAUSAL>, kv_smem, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  sdpa_dkdv_wgmma_kernel<D, CAUSAL>
      <<<dim3(bh, (Skv + LK::KB - 1) / LK::KB), 384, kv_smem, stream>>>(
          mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), Sq, Skv, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  e = prepare(sdpa_dq_wgmma_kernel<D, CAUSAL>, q_smem, NC == 2);
  if (e != cudaSuccess) return static_cast<int>(e);
  sdpa_dq_wgmma_kernel<D, CAUSAL>
      <<<dim3(bh, (Sq + LQ::QB - 1) / LQ::QB), wg::kDqThreads<D>, q_smem,
         stream>>>(mq, mk, mv, mdo, lse, delta, static_cast<bf16*>(dq), Sq,
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

// dtype 1 (bfloat16): wgmma up to D 256, the wide design above;
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
    return launch_wgmma<D, CAUSAL>(q, k, v, o, dout, lse, delta, dq, dk, dv,
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
