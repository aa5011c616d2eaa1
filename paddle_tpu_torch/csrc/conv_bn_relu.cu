// Fused conv + BatchNorm for Hopper (sm_90a): the 1x1 and 3x3 kernels of
// eval (folded affine + ReLU) and of training (batch statistics).
//
// Replaces: paddle_tpu/ops/pallas/conv.py `_conv1x1_kernel` (B7, entry
// `_conv1x1_call`) and `_conv3x3_kernel` (B8, entry `_conv3x3_call`), both
// reached through `fused_conv_bn_relu` from `ConvBNReLU._forward_fused` (every
// bottleneck and downsample conv of a ResNet in eval; B8 is also the 3x3
// dInput walk of the training backward), and `_conv1x1_train_kernel` (B9a)
// and `_conv3x3_train_kernel` (B9b), reached through
// `fused_conv_bn_relu_train` from `ConvBNReLU._forward_fused_train`. Plain
// PyTorch versions and wrappers: paddle_tpu_torch/ops/conv.py
// (`conv_bn_relu_plain`, `conv1x1_bn_relu`, `conv3x3_bn_relu`;
// `conv_train_plain`, `conv1x1_train`, `conv3x3_train`).
//
// What it computes, for x NHWC [N, H, W, Cin], w HWIO [K, K, Cin, Cout]
// (K 1 or 3):
//   acc[m, co] = sum over taps (dy, dx) and ci of
//                x[n, ho*s - pad_t + dy, wo*s - pad_l + dx, ci] * w[dy, dx, ci, co]
//                (fp32 sums of exact fp32 products; taps outside x read 0)
// with m = (n * Ho + ho) * Wo + wo, then one of two epilogues:
//   eval (B7/B8): y = acc * scale[co] + shift[co] (fp32, a multiply then an
//     add), y = max(y, 0) with relu, out = y cast once to x's dtype;
//   train (B9):   out = acc cast to x's dtype, and the SAME cast values feed
//     fp32 per-channel sums of out and out^2, written per CTA as partials
//     [row tiles, 2, Cout] that `sum_rows_kernel` adds in a fixed order into
//     sums [2, Cout] (the TPU kernel's revisited [2, Cout] accumulator).
//     Rows past M add nothing (a bounds check, no padding).
// A stride-2 1x1 (pads 0) is the TPU kernel's pre-sliced x[:, ::2, ::2],
// read in place; a 3x3 reads the zero halo by bounds check, in place of the
// TPU wrapper's padded copy, so symmetric, SAME's asymmetric and VALID
// padding all take this one path.
//
// Design. An implicit GEMM through conv_common.cuh's `gemm_mainloop`: the
// output [M, Cout] is tiled 128 x 64 per CTA; the reduction walks the taps
// and, inside each, Cin in steps of 8 (Cin is a multiple of 8, so a step
// never straddles two taps). The A tile gathers 128 output pixels x 8
// input channels of one tap from x with the bounds check, the B tile is
// 8 x 64 of w. The epilogue is a template parameter, so the eval and train
// kernels share one body, as B9 is the B7/B8 walk with the epilogue
// replaced on the TPU. The TPU kernel's VMEM slab walk, its double-buffered
// DMA and its row and width tiles have no counterpart here.
//
// Bound on this card at the bench's stage-2 shapes (batch 256, 56 x 56,
// bf16): bytes for the 1x1 64 -> 256 (514 MB, 0.153 ms at 3.35 TB/s),
// bytes and FLOP alike for the 3x3 64 -> 64 (206 MB, 0.061 ms; 59.2 GFLOP,
// 0.060 ms at 989 TFLOP/s); the train epilogue adds the partials (a few
// MB). This first design is far from either: fp32 FMA (no tensor cores: no
// mma.sync or wgmma), no TMA or cp.async, a step of only 8 input channels.

#include "conv_common.cuh"

namespace {

using namespace conv;

struct Geometry {
  int N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, M;
};

// A: 128 output pixels x 8 input channels of one tap, gathered from x (zero
// outside it); B: 8 x 64 of w. Thread tid loads pixel tid / 2, channels
// (tid % 2) * 4 .. +3, and w row tid / 32, columns (tid % 32) * 2 .. +1.
template <typename T, int K>
struct ConvLoader {
  const T* w;
  Geometry g;
  int a_row, a_c, b_k, b_n, n0, hb, wb, cchunks;
  bool m_ok, n_ok;
  const T* x_img;
  float a_reg[4], b_reg[2];

  __device__ ConvLoader(const T* x, const T* w_, const Geometry& g_, int m0,
                        int n0_)
      : w(w_), g(g_), n0(n0_) {
    const int tid = threadIdx.x;
    a_row = tid >> 1;
    a_c = (tid & 1) * 4;
    const int m = m0 + a_row;
    m_ok = m < g.M;
    hb = wb = 0;
    x_img = x;
    if (m_ok) {
      const int wo = m % g.Wo;
      const int t = m / g.Wo;
      hb = (t % g.Ho) * g.stride - g.pad_t;
      wb = wo * g.stride - g.pad_l;
      x_img = x + (size_t)(t / g.Ho) * g.H * g.W * g.Cin;
    }
    b_k = tid >> 5;
    b_n = (tid & 31) * 2;
    n_ok = n0 + b_n < g.Cout;
    cchunks = g.Cin / kBK;
  }

  __device__ int steps() const { return K * K * cchunks; }

  __device__ void load(int step) {
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
  }

  __device__ void store(float (*As)[kPitchA], float (*Bs)[kBN]) {
    store_a_rowmajor(As, a_row, a_c, a_reg);
    store_b(Bs, b_k, b_n, b_reg);
  }
};

// eval epilogue (B7/B8): BatchNorm affine and ReLU in fp32, one cast, one
// store per row
template <typename T>
struct AffineEpilogue {
  const float* scale;
  const float* shift;
  T* out;
  int relu;

  __device__ void operator()(const float (&acc)[8][4], const Geometry& g,
                             int m0, int n0) const {
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const int col = n0 + tx * 4;
    if (col >= g.Cout) return;  // Cout % 8 == 0: 4 columns all in or out
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
};

// train epilogue (B9): the conv cast once to T and stored; the cast values'
// fp32 sum and sum of squares per channel over the CTA's rows (each thread
// its 8 rows, then the 16 row groups in order) written to this row tile's
// partials [2, Cout]
template <typename T>
struct StatsEpilogue {
  T* out;
  float* partial;  // [row tiles, 2, Cout]

  __device__ void operator()(const float (&acc)[8][4], const Geometry& g,
                             int m0, int n0) const {
    __shared__ float red[2][16][kBN];
    const int tx = threadIdx.x & 15;
    const int ty = threadIdx.x >> 4;
    const int col = n0 + tx * 4;
    float s[4] = {0.f, 0.f, 0.f, 0.f}, q[4] = {0.f, 0.f, 0.f, 0.f};
    if (col < g.Cout) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int row = m0 + ty * 8 + i;
        if (row >= g.M) break;
        float y[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          y[j] = round_to<T>(acc[i][j]);
          s[j] = __fadd_rn(s[j], y[j]);
          q[j] = __fadd_rn(q[j], __fmul_rn(y[j], y[j]));
        }
        store4(out + (size_t)row * g.Cout + col, y);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      red[0][ty][tx * 4 + j] = s[j];
      red[1][ty][tx * 4 + j] = q[j];
    }
    __syncthreads();
    if (threadIdx.x < 2 * kBN) {
      const int which = threadIdx.x / kBN;
      const int c = threadIdx.x % kBN;
      float t = 0.f;
      for (int r = 0; r < 16; ++r) t += red[which][r][c];
      if (n0 + c < g.Cout) {
        partial[((size_t)blockIdx.x * 2 + which) * g.Cout + n0 + c] = t;
      }
    }
  }
};

template <typename T, int K, class Epilogue>
__device__ __forceinline__ void conv_tile(const T* __restrict__ x,
                                          const T* __restrict__ w,
                                          const Geometry& g,
                                          const Epilogue& epi) {
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  ConvLoader<T, K> ld(x, w, g, m0, n0);
  float acc[8][4];
  gemm_mainloop(ld, ld.steps(), acc);
  epi(acc, g, m0, n0);
}

// one kernel per filter size and epilogue, so that a profile tells them
// apart: B7, B8, B9a, B9b
template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const Geometry g, const AffineEpilogue<T> epi) {
  conv_tile<T, 1>(x, w, g, epi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_bn_relu_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const Geometry g, const AffineEpilogue<T> epi) {
  conv_tile<T, 3>(x, w, g, epi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_train_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const Geometry g, const StatsEpilogue<T> epi) {
  conv_tile<T, 1>(x, w, g, epi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_train_kernel(const T* __restrict__ x, const T* __restrict__ w,
                     const Geometry g, const StatsEpilogue<T> epi) {
  conv_tile<T, 3>(x, w, g, epi);
}

Geometry geometry(int N, int H, int W, int Cin, int Cout, int Ho, int Wo,
                  int stride, int pad_t, int pad_l) {
  return Geometry{N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l,
                  N * Ho * Wo};
}

dim3 grid_of(const Geometry& g) {
  return dim3((g.M + kBM - 1) / kBM, (g.Cout + kBN - 1) / kBN);
}

template <typename T>
int launch_eval(int K, const void* x, const void* w, const void* scale,
                const void* shift, void* out, const Geometry& g, int relu,
                cudaStream_t stream) {
  const AffineEpilogue<T> epi{static_cast<const float*>(scale),
                              static_cast<const float*>(shift),
                              static_cast<T*>(out), relu};
  auto kernel = K == 1 ? conv1x1_bn_relu_kernel<T> : conv3x3_bn_relu_kernel<T>;
  kernel<<<grid_of(g), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), g, epi);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_train(int K, const void* x, const void* w, void* out,
                 void* partial, void* sums, const Geometry& g,
                 cudaStream_t stream) {
  const StatsEpilogue<T> epi{static_cast<T*>(out),
                             static_cast<float*>(partial)};
  auto kernel = K == 1 ? conv1x1_train_kernel<T> : conv3x3_train_kernel<T>;
  const dim3 grid = grid_of(g);
  kernel<<<grid, kThreads, 0, stream>>>(static_cast<const T*>(x),
                                        static_cast<const T*>(w), g, epi);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_rows(static_cast<const float*>(partial),
                  static_cast<float*>(sums), grid.x, 2LL * g.Cout, stream);
}

bool bad_args(int dtype, int Cin, int Cout) {
  // the wrapper checks shapes, dtypes, contiguity and 16-byte alignment
  return Cin % kBK || Cout % 8 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Each returns the launches' cudaError_t.

// B7 / B8: out = relu?(conv(x, w) * scale + shift), NHWC
int conv1x1_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, void* out, int dtype, int N, int H,
                    int W, int Cin, int Cout, int Ho, int Wo, int stride,
                    int pad_t, int pad_l, int relu, void* stream) {
  if (bad_args(dtype, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_eval<__nv_bfloat16>(1, x, w, scale, shift, out, g, relu, s)
      : launch_eval<float>(1, x, w, scale, shift, out, g, relu, s);
}

int conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, void* out, int dtype, int N, int H,
                    int W, int Cin, int Cout, int Ho, int Wo, int stride,
                    int pad_t, int pad_l, int relu, void* stream) {
  if (bad_args(dtype, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_eval<__nv_bfloat16>(3, x, w, scale, shift, out, g, relu, s)
      : launch_eval<float>(3, x, w, scale, shift, out, g, relu, s);
}

// B9a (K 1) / B9b (K 3): out = conv(x, w) in x's dtype, NHWC; sums
// [2, Cout] fp32 of out and out^2; partial: fp32 scratch
// [ceil(M / 128), 2, Cout]
int conv_train(const void* x, const void* w, void* out, void* partial,
               void* sums, int K, int dtype, int N, int H, int W, int Cin,
               int Cout, int Ho, int Wo, int stride, int pad_t, int pad_l,
               void* stream) {
  if (bad_args(dtype, Cin, Cout) || (K != 1 && K != 3)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_train<__nv_bfloat16>(K, x, w, out, partial, sums, g, s)
      : launch_train<float>(K, x, w, out, partial, sums, g, s);
}

}  // extern "C"
