// The walk of a device pointer table, shared by the training libraries
// (optimizer_update.cu, grad_merge.cu): one launch covers every tensor of
// one dtype on one card.
//
// A row is kRow int64: the pointers of up to four tensors (entries 0-3),
// the element count (kNumel), the row's first block in the grid (kFirst),
// a 32-bit word (kWord: the optimizer's per-parameter decay as fp32 bits)
// and a fifth pointer (7). Rows are in order of first block, each with
// elements; the grid is the sum of ceil(numel / kChunk). Each block finds
// its row by a binary search over the first blocks and takes kChunk
// consecutive elements, kUnroll a thread, kThreads apart. The host builds
// the table in paddle_tpu_torch/ops/optimizer_update.py `_Table`.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace table_walk {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kChunk = kThreads * kUnroll;  // elements a block
constexpr int kRow = 8;                     // int64 entries a row
constexpr int kNumel = 4, kFirst = 5, kWord = 6;

__device__ __forceinline__ float load_f(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f(const __nv_bfloat16* p,
                                        long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store_t(float* p, long long i, float x) {
  p[i] = x;
}
__device__ __forceinline__ void store_t(__nv_bfloat16* p, long long i,
                                        float x) {
  p[i] = __float2bfloat16_rn(x);
}

// The block's row (the last row whose first block <= blockIdx.x), its
// element count and the block's first element for this thread.
struct Span {
  const long long* row;
  int r;
  long long numel, start;
};

__device__ __forceinline__ Span find_span(const long long* table, int n) {
  __shared__ int s_row;
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * kRow + kFirst] <= b) lo = mid; else hi = mid - 1;
    }
    s_row = lo;
  }
  __syncthreads();
  const long long* row = table + static_cast<long long>(s_row) * kRow;
  return Span{row, s_row, row[kNumel], (b - row[kFirst]) * kChunk +
                                           threadIdx.x};
}

// A table the kernels cannot walk: no rows, or a grid out of range.
inline bool bad_grid(int n, long long blocks) {
  return n <= 0 || blocks <= 0 || blocks > 0x7fffffffLL;
}

}  // namespace table_walk
