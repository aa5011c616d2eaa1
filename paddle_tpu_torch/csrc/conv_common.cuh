// Shared pieces of the conv kernels for Hopper (sm_90a): conv_bn_relu.cu
// (the eval and train forwards) and conv_bn_relu_bwd.cu (the 1x1 backward
// and the 3x3 dWeight) include this header.
//
// - Vector loads and stores of 4 or 2 consecutive fp32 or bf16 elements as
//   fp32, and the rounding of an fp32 value to the element type.
// - `gemm_mainloop`: the fp32-FMA GEMM body every conv kernel runs. A CTA
//   of 256 threads owns a 128 x 64 tile of its output; the reduction walks
//   steps of 8, each staging an A tile (8 x 128) and a B tile (8 x 64) in
//   shared memory as fp32, double-buffered: the next step's global loads
//   go to registers while the current tiles are multiplied. Each thread
//   owns 8 x 4 outputs (rows ty*8.., columns tx*4..) and does 32 FMA per 3
//   16-byte shared loads. What A and B are (an input gathered by tap, a
//   dConv computed from dy on the fly, a weight) is the Loader's: it loads
//   one step into registers (`load`) and writes them to the shared tiles
//   (`store`).
// - `sum_rows_kernel`: out[c] = sum over r of in[r, c] in a fixed order,
//   the second pass of every cross-CTA sum (the batch statistics of the
//   train forward and both dWeights). The TPU kernels accumulate those in
//   one output block revisited by a sequential grid; CTAs run in no order,
//   so each writes fp32 partials and this kernel adds them, with no
//   atomics, so a result is the same from run to run.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// each kernel library compiles its own copy (ctypes loads them apart)
namespace conv {

constexpr int kBM = 128;          // output rows per CTA
constexpr int kBN = 64;           // output columns per CTA
constexpr int kBK = 8;            // reduction step
constexpr int kThreads = 256;
constexpr int kPitchA = kBM + 4;  // A rows padded: conflict-free stores

// four consecutive elements as fp32 (16 bytes of f32, 8 of bf16)
__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 t = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&t.y));
  v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// two consecutive elements as fp32
__device__ __forceinline__ void load2(const float* p, float v[2]) {
  const float2 t = *reinterpret_cast<const float2*>(p);
  v[0] = t.x; v[1] = t.y;
}
__device__ __forceinline__ void load2(const __nv_bfloat16* p, float v[2]) {
  const float2 t = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  v[0] = t.x; v[1] = t.y;
}

__device__ __forceinline__ void store4(float* p, const float v[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float v[4]) {
  uint2 t;
  *reinterpret_cast<__nv_bfloat162*>(&t.x) = __floats2bfloat162_rn(v[0], v[1]);
  *reinterpret_cast<__nv_bfloat162*>(&t.y) = __floats2bfloat162_rn(v[2], v[3]);
  *reinterpret_cast<uint2*>(p) = t;
}

// v rounded to T, as fp32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <class Loader>
__device__ __forceinline__ void gemm_mainloop(Loader& ld, const int steps,
                                              float (&acc)[8][4]) {
  __shared__ __align__(16) float As[2][kBK][kPitchA];
  __shared__ __align__(16) float Bs[2][kBK][kBN];
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  ld.load(0);
  ld.store(As[0], Bs[0]);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) ld.load(step + 1);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 8]);
      const float4 a1 = *reinterpret_cast<const float4*>(&As[buf][k][ty * 8 + 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[buf][k][tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bb[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bb[j], acc[i][j]);
    }
    // the other buffer was last read before the previous step's barrier
    if (more) ld.store(As[buf ^ 1], Bs[buf ^ 1]);
    __syncthreads();
  }
}

// A thread of a "rows x 4 consecutive" A loader: row tid / 2, columns
// (tid % 2) * 4 .. +3 of the step's 8 (the forward's gather of x)
__device__ __forceinline__ void store_a_rowmajor(float (*As)[kPitchA], int row,
                                                 int c, const float v[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) As[c + j][row] = v[j];
}

// An A tile loaded transposed: step row k = tid / 32, output rows
// (tid % 32) * 4 .. +3 (a dWeight's reduction runs over pixels)
__device__ __forceinline__ void store_a_kmajor(float (*As)[kPitchA], int k,
                                               int row, const float v[4]) {
  *reinterpret_cast<float4*>(&As[k][row]) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store_b(float (*Bs)[kBN], int k, int col,
                                        const float v[2]) {
  *reinterpret_cast<float2*>(&Bs[k][col]) = make_float2(v[0], v[1]);
}

// out[c] = sum over r < R of in[r * C + c]. Block (32, G): 32 columns, G
// row groups; group g adds rows g, g + G, ... in four interleaved partial
// sums, then group 0 adds the G group sums in order. The order depends on
// the shape alone.
__global__ void __launch_bounds__(1024)
sum_rows_kernel(const float* __restrict__ in, float* __restrict__ out,
                const int R, const long long C) {
  __shared__ float part[32][33];
  const int lane = threadIdx.x;
  const int grp = threadIdx.y;
  const int G = blockDim.y;
  const long long c = (long long)blockIdx.x * 32 + lane;
  float t0 = 0.f, t1 = 0.f, t2 = 0.f, t3 = 0.f;
  if (c < C) {
    int r = grp;
    for (; r + 3 * G < R; r += 4 * G) {
      t0 += in[(long long)r * C + c];
      t1 += in[(long long)(r + G) * C + c];
      t2 += in[(long long)(r + 2 * G) * C + c];
      t3 += in[(long long)(r + 3 * G) * C + c];
    }
    for (; r < R; r += G) t0 += in[(long long)r * C + c];
  }
  part[grp][lane] = (t0 + t1) + (t2 + t3);
  __syncthreads();
  if (grp == 0 && c < C) {
    float s = 0.f;
    for (int g = 0; g < G; ++g) s += part[g][lane];
    out[c] = s;
  }
}

// launch sum_rows_kernel over [R, C]; returns the launch's cudaError_t
inline int sum_rows(const float* in, float* out, int R, long long C,
                    cudaStream_t stream) {
  int G = R / 16;
  G = G < 1 ? 1 : (G > 32 ? 32 : G);
  const dim3 grid((unsigned)((C + 31) / 32));
  sum_rows_kernel<<<grid, dim3(32, G), 0, stream>>>(in, out, R, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace conv
