// Fused conv + BatchNorm affine + ReLU for eval, for Hopper (sm_90a): the
// 1x1 and 3x3 kernels.
//
// Replaces: paddle_tpu/ops/pallas/conv.py `_conv1x1_kernel` (B7, entry
// `_conv1x1_call`) and `_conv3x3_kernel` (B8, entry `_conv3x3_call`), both
// reached through `fused_conv_bn_relu` from `ConvBNReLU._forward_fused` (every
// bottleneck and downsample conv of a ResNet in eval). Plain PyTorch version
// and wrappers: paddle_tpu_torch/ops/conv.py (`conv_bn_relu_plain`,
// `conv1x1_bn_relu`, `conv3x3_bn_relu`).
//
// What it computes, for x NHWC [N, H, W, Cin], w HWIO [K, K, Cin, Cout]
// (K 1 or 3), fp32 scale and shift [Cout]:
//   acc[m, co] = sum over taps (dy, dx) and ci of
//                x[n, ho*s - pad_t + dy, wo*s - pad_l + dx, ci] * w[dy, dx, ci, co]
//                (fp32 sums of exact fp32 products; taps outside x read 0)
//   y = acc * scale[co] + shift[co]   (fp32, a multiply then an add)
//   y = max(y, 0) with relu;  out[n, ho, wo, co] = y cast once to x's dtype
// with m = (n * Ho + ho) * Wo + wo. A stride-2 1x1 (pads 0) is the TPU
// kernel's pre-sliced x[:, ::2, ::2], read in place; a 3x3 reads the zero
// halo by bounds check, in place of the TPU wrapper's padded copy, so
// symmetric, SAME's asymmetric and VALID padding all take this one path.
//
// Design. An implicit GEMM: the output [M, Cout] is tiled 128 x 64 per CTA;
// the reduction walks the taps and, inside each, Cin in steps of 8 (Cin is a
// multiple of 8, so a step never straddles two taps). Each step stages an
// A tile (128 output pixels x 8 input channels of one tap, gathered from x
// with the bounds check) and a B tile (8 x 64 of w) in shared memory as
// fp32, double-buffered: the next step's global loads go to registers while
// the current tiles are multiplied. Each of the 256 threads owns 8 x 4
// outputs and does 32 fp32 FMA per 3 16-byte shared loads. The epilogue
// applies scale, shift and ReLU in registers and stores each row's 4
// channels at once. The TPU kernel's VMEM slab walk, its double-buffered
// DMA and its row and width tiles have no counterpart here.
//
// Bound on this card at the bench's stage-2 shapes (batch 256, 56 x 56,
// bf16): bytes for the 1x1 64 -> 256 (514 MB, 0.153 ms at 3.35 TB/s),
// bytes and FLOP alike for the 3x3 64 -> 64 (206 MB, 0.061 ms; 59.2 GFLOP,
// 0.060 ms at 989 TFLOP/s). This first design is far from either: fp32 FMA
// (no tensor cores: no mma.sync or wgmma), no TMA or cp.async, a step of
// only 8 input channels.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;          // output pixels per CTA
constexpr int kBN = 64;           // output channels per CTA
constexpr int kBK = 8;            // input channels per reduction step
constexpr int kThreads = 256;
constexpr int kPitchA = kBM + 4;  // A rows padded: conflict-free stores

struct Geometry {
  int N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, M;
};

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

template <typename T, int K>
__device__ __forceinline__ void conv_bn_relu_tile(
    const T* __restrict__ x, const T* __restrict__ w,
    const float* __restrict__ scale, const float* __restrict__ shift,
    T* __restrict__ out, const Geometry g, const int relu) {
  __shared__ __align__(16) float As[2][kBK][kPitchA];
  __shared__ __align__(16) float Bs[2][kBK][kBN];

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;

  // A loader: one output pixel (row) and 4 of the step's 8 channels
  const int a_row = tid >> 1;
  const int a_c = (tid & 1) * 4;
  const int m = m0 + a_row;
  const bool m_ok = m < g.M;
  int hb = 0, wb = 0;
  const T* x_img = x;
  if (m_ok) {
    const int wo = m % g.Wo;
    const int t = m / g.Wo;
    hb = (t % g.Ho) * g.stride - g.pad_t;
    wb = wo * g.stride - g.pad_l;
    x_img = x + (size_t)(t / g.Ho) * g.H * g.W * g.Cin;
  }
  // B loader: one of the step's 8 weight rows, 2 of the tile's 64 columns
  const int b_k = tid >> 5;
  const int b_n = (tid & 31) * 2;
  const bool n_ok = n0 + b_n < g.Cout;

  const int cchunks = g.Cin / kBK;
  const int steps = K * K * cchunks;
  float a_reg[4], b_reg[2];

  auto load_tiles = [&](int step) {
    const int tap = step / cchunks;
    const int c0 = (step - tap * cchunks) * kBK;
    const int hi = hb + tap / K;
    const int wi = wb + tap % K;
    if (m_ok && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W) {
      load4(x_img + ((size_t)hi * g.W + wi) * g.Cin + c0 + a_c, a_reg);
    } else {
      a_reg[0] = a_reg[1] = a_reg[2] = a_reg[3] = 0.f;
    }
    if (n_ok) {
      load2(w + (size_t)(tap * g.Cin + c0 + b_k) * g.Cout + n0 + b_n, b_reg);
    } else {
      b_reg[0] = b_reg[1] = 0.f;
    }
  };
  auto store_tiles = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) As[buf][a_c + j][a_row] = a_reg[j];
    *reinterpret_cast<float2*>(&Bs[buf][b_k][b_n]) = make_float2(b_reg[0], b_reg[1]);
  };

  // compute: rows ty*8 .. ty*8+7, columns tx*4 .. tx*4+3 of the tile
  const int tx = tid & 15;
  const int ty = tid >> 4;
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  load_tiles(0);
  store_tiles(0);
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    const bool more = step + 1 < steps;
    if (more) load_tiles(step + 1);
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
    if (more) store_tiles(buf ^ 1);
    __syncthreads();
  }

  // epilogue: BatchNorm affine and ReLU in fp32, one cast, one store per row
  const int col = n0 + tx * 4;
  if (col >= g.Cout) return;  // Cout % 8 == 0: 4 columns are all in or out
  float sc[4], sh[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    sc[j] = scale[col + j];
    sh[j] = shift[col + j];
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= g.M) break;
    float y[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      y[j] = __fadd_rn(__fmul_rn(acc[i][j], sc[j]), sh[j]);
      if (relu) y[j] = fmaxf(y[j], 0.f);
    }
    store4(out + (size_t)row * g.Cout + col, y);
  }
}

// B7 and B8: one kernel each, so that a profile tells them apart
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift, T* __restrict__ out,
                       const Geometry g, const int relu) {
  conv_bn_relu_tile<T, 1>(x, w, scale, shift, out, g, relu);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ scale,
                       const float* __restrict__ shift, T* __restrict__ out,
                       const Geometry g, const int relu) {
  conv_bn_relu_tile<T, 3>(x, w, scale, shift, out, g, relu);
}

template <typename T, int K>
int launch(const void* x, const void* w, const void* scale, const void* shift,
           void* out, int N, int H, int W, int Cin, int Cout, int Ho, int Wo,
           int stride, int pad_t, int pad_l, int relu, cudaStream_t stream) {
  const Geometry g{N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l,
                   N * Ho * Wo};
  const dim3 grid((g.M + kBM - 1) / kBM, (Cout + kBN - 1) / kBN);
  auto kernel = K == 1 ? conv1x1_bn_relu_kernel<T> : conv3x3_bn_relu_kernel<T>;
  kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<T*>(out), g, relu);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(const void* x, const void* w, const void* scale,
             const void* shift, void* out, int dtype, int N, int H, int W,
             int Cin, int Cout, int Ho, int Wo, int stride, int pad_t,
             int pad_l, int relu, void* stream) {
  // the wrapper checks shapes, dtypes, contiguity and 16-byte alignment
  if (Cin % kBK || Cout % 8 || (dtype != 0 && dtype != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) {
    return launch<__nv_bfloat16, K>(x, w, scale, shift, out, N, H, W, Cin,
                                    Cout, Ho, Wo, stride, pad_t, pad_l, relu,
                                    s);
  }
  return launch<float, K>(x, w, scale, shift, out, N, H, W, Cin, Cout, Ho, Wo,
                          stride, pad_t, pad_l, relu, s);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Returns the launch's cudaError_t.
int conv1x1_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, void* out, int dtype, int N, int H,
                    int W, int Cin, int Cout, int Ho, int Wo, int stride,
                    int pad_t, int pad_l, int relu, void* stream) {
  return dispatch<1>(x, w, scale, shift, out, dtype, N, H, W, Cin, Cout, Ho,
                     Wo, stride, pad_t, pad_l, relu, stream);
}

int conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, void* out, int dtype, int N, int H,
                    int W, int Cin, int Cout, int Ho, int Wo, int stride,
                    int pad_t, int pad_l, int relu, void* stream) {
  return dispatch<3>(x, w, scale, shift, out, dtype, N, H, W, Cin, Cout, Ho,
                     Wo, stride, pad_t, pad_l, relu, stream);
}

}  // extern "C"
