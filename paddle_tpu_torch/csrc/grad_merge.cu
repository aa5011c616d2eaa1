// Gradient merge and loss-scale unscaling, for Hopper (sm_90a).
//
// Replaces: the elementwise work that the JAX package fuses into its
// compiled steps (paddle_tpu/jit/api.py), which has no Pallas kernel:
// - grad_merge_kernel (K1): one micro-step of gradient merge, `b +
//   g.astype(f32)` into fp32 merge buffers (`make_accum_fns` `acc_fn`,
//   :616 and :637), and with a scaler the micro-step's non-finite test
//   over the scaled grads, OR-ed into a flag (:609-611);
// - grad_finish_kernel (K2): a window's end, `(b / scale / K)` or `b / K`
//   rounded to the parameter's dtype (`upd_fn`, :625 and :642);
// - grad_unscale_kernel (K2): the scaler step without merge
//   (`build_step_fn`, :527-530): the non-finite test over the scaled
//   grads, then `(g.astype(f32) / scale).astype(dtype)` in place.
// Wrappers and plain versions: paddle_tpu_torch/ops/grad_merge.py.
//
// Every op is an IEEE-rounded intrinsic, so nvcc fuses none and each
// result is the plain version's bits: the scale is divided (`__fdiv_rn`,
// never a multiply by 1 / scale, whose reciprocal is subnormal at large
// scales), then K is a multiply by its fp32 reciprocal (`__fmul_rn`), as
// jitted XLA folds the divide by that constant. At a window's first
// micro-step K1 stores `0 + g` instead of adding g to a buffer zeroed
// before: the same bits (the add turns -0 into +0, as the add to a zero
// buffer does), without a zeroing pass over the buffers.
//
// A flag is an int32 on the card. A thread that sees a value that is not
// finite stores 1 to it; every such store writes the same 1, so no atomic
// is needed. The host zeroes it before and reads it after.
//
// A table in device memory lists the grads of one dtype on one card
// (table_walk.cuh): per row, the grad's pointer (entry 0), its fp32
// buffer's (1; 0 for unscale), its element count and its first block in
// the grid. Each block finds its row by a binary search over the first
// blocks and takes kChunk consecutive elements, kUnroll of them a thread
// with every load issued first.
//
// Bound on this card: bytes. K1 reads g (2 bytes in bf16) and b (4) and
// writes b (4): 10 bytes an element (6 at a window's first micro-step);
// finish reads b and writes g: 6; unscale reads and writes g: 4.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "table_walk.cuh"

namespace {

using namespace table_walk;

__device__ __forceinline__ void raise_flags(int* a, int* b) {
  if (a) *a = 1;
  if (b) *b = 1;
}

// grid (total blocks), block kThreads. first: store 0 + g; flags may be
// null (no scaler).
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_merge_kernel(
    const long long* __restrict__ table, int n, int first, int* flag_a,
    int* flag_b) {
  const Span s = find_span(table, n);
  const T* __restrict__ g = reinterpret_cast<const T*>(s.row[0]);
  float* __restrict__ buf = reinterpret_cast<float*>(s.row[1]);
  float gv[kUnroll], bv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s.start + u * kThreads;
    if (i < s.numel) {
      gv[u] = load_f(g, i);
      bv[u] = first ? 0.f : buf[i];
    }
  }
  bool bad = false;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s.start + u * kThreads;
    if (i < s.numel) {
      bad |= !isfinite(gv[u]);
      buf[i] = __fadd_rn(bv[u], gv[u]);
    }
  }
  if (bad) raise_flags(flag_a, flag_b);
}

// grid (total blocks), block kThreads: g = (b / scale when has_scale) *
// inv_k, rounded to T.
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_finish_kernel(
    const long long* __restrict__ table, int n, int has_scale, float scale,
    float inv_k) {
  const Span s = find_span(table, n);
  T* __restrict__ g = reinterpret_cast<T*>(s.row[0]);
  const float* __restrict__ buf = reinterpret_cast<const float*>(s.row[1]);
  float bv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s.start + u * kThreads;
    if (i < s.numel) bv[u] = buf[i];
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s.start + u * kThreads;
    if (i < s.numel) {
      const float x = has_scale ? __fdiv_rn(bv[u], scale) : bv[u];
      store_t(g, i, __fmul_rn(x, inv_k));
    }
  }
}

// grid (total blocks), block kThreads: the flag raised if a g is not
// finite, then g = g / scale, rounded to T, in place.
template <typename T>
__global__ void __launch_bounds__(kThreads) grad_unscale_kernel(
    const long long* __restrict__ table, int n, float scale, int* flag) {
  const Span s = find_span(table, n);
  T* __restrict__ g = reinterpret_cast<T*>(s.row[0]);
  float gv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s.start + u * kThreads;
    if (i < s.numel) gv[u] = load_f(g, i);
  }
  bool bad = false;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = s.start + u * kThreads;
    if (i < s.numel) {
      bad |= !isfinite(gv[u]);
      store_t(g, i, __fdiv_rn(gv[u], scale));
    }
  }
  if (bad) raise_flags(flag, nullptr);
}

bool bad_group(int n, long long blocks, int dtype) {
  return table_walk::bad_grid(n, blocks) || (dtype != 0 && dtype != 1);
}

int launched() { return static_cast<int>(cudaGetLastError()); }

}  // namespace

// The block size the host sizes a table by: elements a block takes.
extern "C" int grad_merge_chunk() { return kChunk; }

// Every entry: table, n rows of kRow int64 on the card (table_walk.cuh:
// grad pointer, fp32 buffer pointer or 0, numel > 0, first block), in
// order of first block;
// blocks, the grid (the sum of ceil(numel / chunk)); dtype, the grads' (0
// float32, 1 bfloat16); flags, int32 on the card or null. Each returns the
// launch's cudaError_t (0 on success).

// K1: b = (first ? 0 : b) + float(g); both flags raised on a non-finite g.
extern "C" int grad_merge(const void* table, int n, long long blocks,
                          int dtype, int first, void* flag_a, void* flag_b,
                          void* stream) {
  if (bad_group(n, blocks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* t = static_cast<const long long*>(table);
  int* fa = static_cast<int*>(flag_a);
  int* fb = static_cast<int*>(flag_b);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    grad_merge_kernel<float><<<blocks, kThreads, 0, st>>>(t, n, first, fa, fb);
  else
    grad_merge_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(t, n, first,
                                                                  fa, fb);
  return launched();
}

// K2, a window's end: g = dtype((has_scale ? b / scale : b) * inv_k).
extern "C" int grad_finish(const void* table, int n, long long blocks,
                           int dtype, int has_scale, float scale,
                           float inv_k, void* stream) {
  if (bad_group(n, blocks, dtype)) return static_cast<int>(cudaErrorInvalidValue);
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    grad_finish_kernel<float><<<blocks, kThreads, 0, st>>>(t, n, has_scale,
                                                           scale, inv_k);
  else
    grad_finish_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(
        t, n, has_scale, scale, inv_k);
  return launched();
}

// K2, the scaler step: the flag raised on a non-finite g, then g =
// dtype(float(g) / scale) in place.
extern "C" int grad_unscale(const void* table, int n, long long blocks,
                            int dtype, float scale, void* flag,
                            void* stream) {
  if (bad_group(n, blocks, dtype) || flag == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long* t = static_cast<const long long*>(table);
  int* f = static_cast<int*>(flag);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    grad_unscale_kernel<float><<<blocks, kThreads, 0, st>>>(t, n, scale, f);
  else
    grad_unscale_kernel<__nv_bfloat16><<<blocks, kThreads, 0, st>>>(t, n,
                                                                    scale, f);
  return launched();
}
