// Batched paged LoRA for Hopper (sm_90a): one site of one layer, every
// slot under its own adapter page.
//
// Replaces: no Pallas kernel. The JAX package computes the per-slot delta
// in XLA inside its compiled serving steps (paddle_tpu/ops/lora.py
// `lora_linear_delta`, `lora_qkv_delta`: a gather of each slot's A and B
// pages, two einsums with fp32 accumulation, a scale, a cast, and the add
// to the base projection), where XLA fuses them. Eager PyTorch would run
// each of those as its own launch, and gather a copy of every slot's
// factors out of the pool, four sites a layer a step. This kernel is the
// fused delta-and-add. Wrapper and plain version:
// paddle_tpu_torch/ops/lora.py (`batched_lora`, `batched_lora_plain`).
//
// base[row, o] = T(base[row, o] + T(s * sum_r xr[row, r] * B[p, l, r, o']))
// xr[row, r]   = sum_i x[row, i] * A[p, l, r, i]            (both fp32)
// with p = rows[slot] the slot's page, s = scaling[p], and o' = o for the
// linear sites, o' = (h * 3 + t) * D + d for the qkv site, whose base is
// 3-major (o = (t * heads + h) * D + d) while its B page is head-grouped
// [heads, 3, D]. The two roundings are the plain version's: the delta is
// cast to T, then added to the T base (for T = float both are exact
// no-ops of the cast). A page-0 slot (the null adapter, zero factors and
// scaling) adds exact zeros: its CTAs return at once and leave the base as
// it is, the same bits up to the sign of a zero.
//
// Design (first): one kernel, grid (column tiles of kCols, row tiles of
// kRows rows of one slot, slots), kThreads threads.
// - The shrink: each thread takes one rank r and one of the 256 / R
//   segments of the input (chunks of 8 inputs, the segments interleaved
//   so that a rank's threads read consecutive chunks: 16-byte loads of A
//   and x, four chunks in flight a thread) and sums its share for every
//   row of the tile in fp32; the CTA then adds each (row, rank)'s segment
//   partials through shared memory in segment order.
// - The expand: each thread owns kCpt consecutive columns (one 8- or
//   16-byte load of a rank's B row for all of them) and sums the R ranks in
//   order for every row, four ranks' loads in flight; then the delta,
//   scaled and cast, is added to the base.
// The shrink is recomputed by every column tile of a row tile (R * in MACs
// a row, against R * kCols in the expand); its A page stays in L2. Both
// dtypes walk the same chunks in the same order, so a bf16 launch's fp32
// delta is an f32 launch's on the same values. No sum depends on another
// row or slot (batch independence: a mixed-tenant batch gives each row a
// dedicated engine's bits), and no atomic is used, so a rerun gives the
// same bits. A CTA reads its slot's whole A page of the layer (R * in
// values) alone, so at serving's few rows one SM's load rate bounds the
// kernel, not the card's.
//
// Bound on this card: bytes, at serving's rows. x and the base read once,
// the base written once, and each distinct page's A and B rows of this
// layer read once: at GPT-1.3B's fc1 with 8 decode rows of 8 pages at rank
// 16, 8 * 16 * (2048 + 8192) * 2 bytes = 2.6 MB, 0.8 us at 3.35 TB/s. The
// operations, 2 * rows * R * (in + out) fp32 FMA, stay far below the fp32
// rate until prefill's thousands of rows.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;        // rows of one slot a CTA
constexpr int kCpt = 4;         // consecutive columns a thread
constexpr int kCols = kThreads * kCpt;
constexpr int kMaxRank = 64;
constexpr int kChunk = 8;       // inputs a shrink load brings, both dtypes

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// N consecutive T at p (N * sizeof(T) bytes, aligned to that) as floats
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&v)[N]) {
  static_assert(N * sizeof(T) == 8 || N * sizeof(T) % 16 == 0, "width");
  if constexpr (N * sizeof(T) == 8) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = to_f(e[i]);
  } else {
    constexpr int per = 16 / sizeof(T);
#pragma unroll
    for (int q = 0; q < N / per; ++q) {
      const uint4 raw = *reinterpret_cast<const uint4*>(p + q * per);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < per; ++i) v[q * per + i] = to_f(e[i]);
    }
  }
}

// kChunk inputs of a row from i0: one vector load when `vec` (the chunk
// lies inside the row, aligned), else one load an input, zeros past n
template <typename T>
__device__ __forceinline__ void load_chunk(const T* row, int i0, int n,
                                           int vec, float (&v)[kChunk]) {
  if (vec) {
    load_vec<T, kChunk>(row + i0, v);
  } else {
#pragma unroll
    for (int i = 0; i < kChunk; ++i)
      v[i] = i0 + i < n ? to_f(row[i0 + i]) : 0.0f;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) lora_shrink_expand_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const T* __restrict__ b, const int* __restrict__ rows,
    const float* __restrict__ scaling, T* __restrict__ base, int S,
    int in_dim, int out_dim, int R, int L, int layer, int heads,
    int head_dim, int vec, int bvec) {
  const int slot = blockIdx.z;
  const int page = rows[slot];
  if (page == 0) return;               // the null adapter adds zeros
  const int row0 = blockIdx.y * kRows;
  const int nrows = min(kRows, S - row0);
  const long long first = static_cast<long long>(slot) * S + row0;
  const T* xs = x + first * in_dim;
  const T* ap = a + (static_cast<long long>(page) * L + layer) * R * in_dim;
  const T* bp = b + (static_cast<long long>(page) * L + layer) * R * out_dim;
  const float s = scaling[page];
  const int tid = threadIdx.x;

  // the shrink: thread (r, seg) sums chunks seg, seg + nseg, ... of rank r
  __shared__ float part[kThreads * kRows];   // [seg][row][r]
  __shared__ float xr[kRows][kMaxRank];
  const int nseg = kThreads / R;
  const int nchunks = (in_dim + kChunk - 1) / kChunk;
  if (tid < nseg * R) {
    const int r = tid / nseg, seg = tid % nseg;
    const T* ar = ap + static_cast<long long>(r) * in_dim;
    float acc[kRows];
#pragma unroll
    for (int t = 0; t < kRows; ++t) acc[t] = 0.0f;
#pragma unroll 4
    for (int j = seg; j < nchunks; j += nseg) {
      float av[kChunk];
      load_chunk(ar, j * kChunk, in_dim, vec, av);
#pragma unroll
      for (int t = 0; t < kRows; ++t) {
        if (t < nrows) {
          float xv[kChunk];
          load_chunk(xs + static_cast<long long>(t) * in_dim, j * kChunk,
                     in_dim, vec, xv);
#pragma unroll
          for (int e = 0; e < kChunk; ++e)
            if (vec || j * kChunk + e < in_dim)
              acc[t] = fmaf(xv[e], av[e], acc[t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t) part[(seg * kRows + t) * R + r] = acc[t];
  }
  __syncthreads();
  for (int p = tid; p < kRows * R; p += kThreads) {
    const int t = p / R, r = p % R;
    float v = part[t * R + r];
    for (int seg = 1; seg < nseg; ++seg)
      v = __fadd_rn(v, part[(seg * kRows + t) * R + r]);
    xr[t][r] = v;
  }
  __syncthreads();

  // the expand: columns c0 .. c0 + kCpt - 1
  const int c0 = blockIdx.x * kCols + tid * kCpt;
  if (c0 >= out_dim) return;
  int bcol[kCpt];
#pragma unroll
  for (int k = 0; k < kCpt; ++k) {
    const int c = c0 + k;
    if (heads > 0) {                   // 3-major base, head-grouped B
      const int d = c % head_dim, th = c / head_dim;
      const int t3 = th / heads, h = th % heads;
      bcol[k] = (h * 3 + t3) * head_dim + d;
    } else {
      bcol[k] = c;
    }
  }
  // one load for the thread's columns: they are whole and consecutive in B
  const bool whole = bvec && c0 + kCpt <= out_dim;
  float acc[kRows][kCpt];
#pragma unroll
  for (int t = 0; t < kRows; ++t)
#pragma unroll
    for (int k = 0; k < kCpt; ++k) acc[t][k] = 0.0f;
#pragma unroll 4
  for (int r = 0; r < R; ++r) {
    const T* br = bp + static_cast<long long>(r) * out_dim;
    float bv[kCpt];
    if (whole) {
      load_vec<T, kCpt>(br + bcol[0], bv);
    } else {
#pragma unroll
      for (int k = 0; k < kCpt; ++k)
        bv[k] = c0 + k < out_dim ? to_f(br[bcol[k]]) : 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kRows; ++t)
#pragma unroll
      for (int k = 0; k < kCpt; ++k)
        acc[t][k] = fmaf(xr[t][r], bv[k], acc[t][k]);
  }
#pragma unroll
  for (int t = 0; t < kRows; ++t) {
    if (t >= nrows) break;
    T* out = base + (first + t) * out_dim;
#pragma unroll
    for (int k = 0; k < kCpt; ++k) {
      if (c0 + k >= out_dim) break;
      const T delta = from_f<T>(__fmul_rn(acc[t][k], s));
      out[c0 + k] = from_f<T>(__fadd_rn(to_f(out[c0 + k]), to_f(delta)));
    }
  }
}

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* rows,
           const void* scaling, void* base, int slots, int S, int in_dim,
           int out_dim, int R, int L, int layer, int heads, int head_dim,
           int vec, int bvec, cudaStream_t stream) {
  const dim3 grid((out_dim + kCols - 1) / kCols, (S + kRows - 1) / kRows,
                  slots);
  lora_shrink_expand_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const int*>(rows),
      static_cast<const float*>(scaling), static_cast<T*>(base), S, in_dim,
      out_dim, R, L, layer, heads, head_dim, vec, bvec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// base [slots * S, out_dim] += the delta of x [slots * S, in_dim] under
// pages rows[slots] (int32) of a [P, L, R, in_dim] and b [P, L, R,
// out_dim] (head-grouped [heads, 3, head_dim] when heads > 0), scaling [P]
// f32; dtype 0 = float, 1 = bfloat16; R <= 64. vec 1 when in_dim is a
// multiple of 8 and x and a have 16-byte bases (the shrink then loads 8
// inputs at a time); bvec 1 when out_dim (and head_dim) are multiples of 4
// and b has a 16-byte base (the expand then loads 4 columns at a time).
// Returns cudaGetLastError().
int batched_lora(const void* x, const void* a, const void* b,
                 const void* rows, const void* scaling, void* base, int slots,
                 int S, int in_dim, int out_dim, int R, int L, int layer,
                 int heads, int head_dim, int dtype, int vec, int bvec,
                 void* stream) {
  if (R < 1 || R > kMaxRank) return static_cast<int>(cudaErrorInvalidValue);
  if (slots == 0 || S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, rows, scaling, base, slots, S,
                                 in_dim, out_dim, R, L, layer, heads,
                                 head_dim, vec, bvec, st);
  return launch<float>(x, a, b, rows, scaling, base, slots, S, in_dim,
                       out_dim, R, L, layer, heads, head_dim, vec, bvec, st);
}

}  // extern "C"
