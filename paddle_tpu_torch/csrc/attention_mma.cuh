// Fragment helpers for bf16 attention kernels on the tensor cores of
// Hopper (sm_90a) through warp-level `mma.sync`, shared by
// causal_attention.cu, causal_attention_bwd.cu, shortseq_attention.cu and
// sdpa_forward.cu.
//
// The product is `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`:
// A 16 x 16 (row-major), B 16 x 8 (k x n), C and D 16 x 8 fp32. In a warp,
// lane = 4 * g + t (g = lane / 4 in 0..7, t = lane % 4) holds
//   A: a[0] = (row g,     cols 2t, 2t+1)   a[1] = (row g + 8, cols 2t, 2t+1)
//      a[2] = (row g,     cols 2t+8, 2t+9) a[3] = (row g + 8, cols 2t+8, 2t+9)
//   B: b0 = (k 2t, 2t+1; n g)              b1 = (k 2t+8, 2t+9; n g)
//   C: c[0], c[1] = (row g, cols 2t, 2t+1) c[2], c[3] = (row g + 8, same)
// so the fp32 C fragments of two neighbouring 8-column blocks, rounded to
// bf16 pairs (`pack_bf16x2`), are the A fragment of a product whose k
// runs over those 16 columns (`c_to_a`): a score tile never leaves the
// registers between its two products. `c_to_a_split` gives the same
// fragment twice, hi = bf16(p) and lo = bf16(p - hi), for a product that
// keeps p at fp32 precision (hi + lo carries p to about 2^-16 relative).
// A row of a C tile lives in the four lanes of a quad (same g):
// `quad_max` and `quad_sum` reduce over them.
//
// Tiles live in shared memory as [rows][D] bf16, D a multiple of 64 (64 to
// 256: one row 128 to 512 bytes). `ldmatrix` reads eight rows at one
// column, which would all fall in the same four banks; the 16-byte chunks
// of each row are therefore stored XOR-swizzled by the row's low three
// bits (`swizzle`, which keeps a chunk inside its group of eight), and
// eight consecutive rows spread over all 32 banks.
//
// One address per lane (`frag_addr`: row r0 + lane % 16, column c0 + 8 *
// (lane / 16)) serves all three uses of `ldmatrix.x4` here:
//   - A at (r0, c0) of a row-major tile: r[0..3] = a[0..3];
//   - B = X^T from a row-major [n][k] tile X, rows r0.. as n, columns c0..
//     as k (S = Q K^T reads K so): b(n-block 0) = {r[0], r[2]},
//     b(n-block 1) = {r[1], r[3]};
//   - with `.trans`, B = X from a row-major [k][n] tile X, rows r0.. as k,
//     columns c0.. as n (O = P V reads V so): b(n-block 0) = {r[0], r[1]},
//     b(n-block 1) = {r[2], r[3]}.
//
// Tiles are copied from device memory with `cp.async` (16 bytes a thread,
// `load_tile`), rows at or past the sequence's end zero-filled by a source
// size of 0, so a ragged last tile needs no other bounds check. 16-byte
// copies need 16-byte aligned rows: the wrappers check the base pointers.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace attn_mma {

using bf16 = __nv_bfloat16;

constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of (row, col) in a [rows][D] bf16 tile, 16-byte chunks of
// each row XOR-swizzled by row % 8
template <int D>
__device__ __forceinline__ int swizzle(int row, int col) {
  return row * D + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
}

// 16 bytes global -> shared; zero-filled (nothing read) when !valid
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// 4 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows [r0, r0 + ROWS) of a [S, D] bf16 slab into a swizzled [ROWS][D]
// tile, rows at or past S zero-filled; THREADS threads share the copy.
// ROLLED keeps the copy loop rolled: fewer registers held for its
// addresses, for a kernel whose accumulators leave none to spare.
template <int ROWS, int D, int THREADS, bool ROLLED = false>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int r0,
                                          int S, int tid) {
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  static_assert((ROWS * kChunks) % THREADS == 0, "uneven tile copy");
  const uint32_t base = smem_u32(dst);
  auto copy = [&](int i) {
    const int r = i / kChunks, c = i % kChunks;
    const int g = r0 + r;
    const bool in = g < S;
    cp_async_16(base + 2 * swizzle<D>(r, c * 8),
                src + static_cast<size_t>(in ? g : 0) * D + c * 8, in);
  };
  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = tid; i < ROWS * kChunks; i += THREADS) copy(i);
  } else {
#pragma unroll
    for (int i = tid; i < ROWS * kChunks; i += THREADS) copy(i);
  }
}

// ROWS fp32 values v[r0 ..] into dst[0 .. ROWS), zero past S
template <int ROWS, int THREADS>
__device__ __forceinline__ void load_row_values(float* dst, const float* src,
                                                int r0, int S, int tid) {
  for (int i = tid; i < ROWS; i += THREADS) {
    const bool in = r0 + i < S;
    cp_async_4(smem_u32(dst + i), src + (in ? r0 + i : 0), in);
  }
}

// this lane's ldmatrix row address for the 16 x 16 block at (r0, c0) of a
// swizzled [rows][D] tile starting at shared address `tile`
template <int D>
__device__ __forceinline__ uint32_t frag_addr(uint32_t tile, int r0, int c0,
                                              int lane) {
  return tile + 2 * swizzle<D>(r0 + (lane & 15), c0 + ((lane >> 4) << 3));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a * b: bf16 operands, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two fp32 values rounded to nearest-even bf16, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the A fragment of k-step kk from fp32 C fragments c[2kk], c[2kk + 1]
// (16 rows x 16 columns), each value rounded to bf16 once
template <int N>
__device__ __forceinline__ void c_to_a(uint32_t (&a)[4], const float (&c)[N][4],
                                       int kk) {
  a[0] = pack_bf16x2(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16x2(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// two fp32 values split into bf16 pairs hi = bf16(x) and lo = bf16(x - hi)
// (x - hi is exact in fp32), lo in the low half of each
__device__ __forceinline__ void split_bf16x2(float x0, float x1, uint32_t& hi,
                                             uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// `c_to_a` without the rounding: the hi and lo A fragments of k-step kk,
// whose two products summed carry each value to about 2^-16 relative
template <int N>
__device__ __forceinline__ void c_to_a_split(uint32_t (&hi)[4],
                                             uint32_t (&lo)[4],
                                             const float (&c)[N][4], int kk) {
  split_bf16x2(c[2 * kk][0], c[2 * kk][1], hi[0], lo[0]);
  split_bf16x2(c[2 * kk][2], c[2 * kk][3], hi[1], lo[1]);
  split_bf16x2(c[2 * kk + 1][0], c[2 * kk + 1][1], hi[2], lo[2]);
  split_bf16x2(c[2 * kk + 1][2], c[2 * kk + 1][3], hi[3], lo[3]);
}

// max and sum of a C-fragment row over the four lanes of its quad
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// s += A K^T over head-dim step kk (16 columns) for one warp: A the 16 q
// rows' fragment of that step, K a swizzled [keys][D] tile at shared
// address `kt` whose first 8 * NK rows are the keys
template <int D, int NK>
__device__ __forceinline__ void qk_step(float (&s)[NK][4],
                                        const uint32_t (&a)[4], uint32_t kt,
                                        int kk, int lane) {
#pragma unroll
  for (int np = 0; np < NK / 2; ++np) {
    uint32_t b[4];
    ldsm_x4(b, frag_addr<D>(kt, np * 16, kk * 16, lane));
    mma_bf16(s[2 * np], a, b[0], b[2]);
    mma_bf16(s[2 * np + 1], a, b[1], b[3]);
  }
}

// acc += P V over key step kk (keys 16 kk .. 16 kk + 15 of a swizzled
// [keys][D] V tile at `vt`) for one warp, P the A fragment of that step
template <int D>
__device__ __forceinline__ void pv_step(float (&acc)[D / 8][4],
                                        const uint32_t (&pa)[4], uint32_t vt,
                                        int kk, int lane) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, frag_addr<D>(vt, kk * 16, dp * 16, lane));
    mma_bf16(acc[2 * dp], pa, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], pa, b[2], b[3]);
  }
}

// `pv_step` with P as its hi and lo fragments (`c_to_a_split`): acc +=
// hi V + lo V, both products on the same V fragments
template <int D>
__device__ __forceinline__ void pv_step_split(float (&acc)[D / 8][4],
                                              const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4],
                                              uint32_t vt, int kk, int lane) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldsm_x4_trans(b, frag_addr<D>(vt, kk * 16, dp * 16, lane));
    mma_bf16(acc[2 * dp], hi, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], hi, b[2], b[3]);
    mma_bf16(acc[2 * dp], lo, b[0], b[1]);
    mma_bf16(acc[2 * dp + 1], lo, b[2], b[3]);
  }
}

// store a 16 x D fp32 C-fragment tile (rows r_lo = row0 + g and r_lo + 8)
// as bf16 pairs into a [S, D] slab, rows at or past S skipped
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const float (&c)[D / 8][4],
                                           int row0, int S, int lane,
                                           float scale_lo, float scale_hi) {
  const int g = lane >> 2, t = lane & 3;
  const int r_lo = row0 + g, r_hi = r_lo + 8;
#pragma unroll
  for (int nd = 0; nd < D / 8; ++nd) {
    const int col = nd * 8 + 2 * t;
    if (r_lo < S)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r_lo) * D + col) =
          pack_bf16x2(c[nd][0] * scale_lo, c[nd][1] * scale_lo);
    if (r_hi < S)
      *reinterpret_cast<uint32_t*>(dst + static_cast<size_t>(r_hi) * D + col) =
          pack_bf16x2(c[nd][2] * scale_hi, c[nd][3] * scale_hi);
  }
}

}  // namespace attn_mma
