// The conv+BatchNorm+ReLU training backward for Hopper (sm_90a): the whole
// 1x1 backward and the 3x3 dWeight.
//
// Replaces: paddle_tpu/ops/pallas/conv.py `_conv1x1_bwd_kernel` (B10, entry
// `_conv1x1_bwd_call`) and `_conv3x3_dw_kernel` (B11, entry
// `_conv3x3_dw_call`), reached through the backward of
// `fused_conv_bn_relu_train` (`_train_bwd_impl`) for every bottleneck and
// downsample conv of a ResNet in training. Plain PyTorch versions and
// wrappers: paddle_tpu_torch/ops/conv.py (`conv1x1_bwd_plain`,
// `conv1x1_bwd`, `conv3x3_dw_plain`, `conv3x3_dw`). The 3x3 dInput has no
// kernel of its own: it is B8 (conv_bn_relu.cu) over the dilated dConv.
//
// B10, for x NHWC [N, H, W, Cin] read at the stride's sampled pixels (M of
// them, pixel m at (n, ho*s, wo*s)), dy and the saved conv y [M, Cout] in
// x's dtype, the fp32 bundle rows [8, Cout] = [mean_n, inv_n, gamma, beta,
// mean32, rstd32, c1, c2] and wt [Cout, Cin] (the filter transposed):
//   pre   = ((y - mean_n) * inv_n) * gamma + beta     (fp32, with relu)
//   dz    = pre > 0 ? dy : 0                           (dy without relu)
//   xh    = (y - mean32) * rstd32
//   dconv = T((gamma * rstd32) * ((dz - c1) - xh * c2))
//   dx[m, ci] = T(sum over co of dconv[m, co] * wt[co, ci])   written at the
//               sampled pixel (the wrapper zeroes the rest for stride 2)
//   dw[ci, co] = sum over m of x[m, ci] * dconv[m, co]        (fp32)
// each op rounded as written (no contraction), so the mask and dConv are
// the plain version's bit for bit. The mask is the TPU kernel's: from the
// dtype-cast statistics in fp32, not the forward's staging. dConv is
// computed from dy and y where it is read, never stored.
//
// B11, for x NHWC [N, H, W, Cin] and the materialised dConv g [N, Ho, Wo,
// Cout] in x's dtype, stride s and pads (top, left):
//   dw[dy, dx, ci, co] = sum over (n, ho, wo) of
//       x[n, ho*s - pad_t + dy, wo*s - pad_l + dx, ci] * g[n, ho, wo, co]
// (fp32, taps outside x read 0): the nine shifted taps of the TPU kernel as
// one GEMM whose rows are (tap, ci).
//
// Design. Three GEMMs on conv_common.cuh's `gemm_mainloop` (128 x 64 fp32
// tiles, steps of 8): B10's dX (rows pixels, columns Cin, reduction over
// Cout, the A tile dConv computed from dy and y), B10's dW and B11's dW
// (rows Cin or (tap, Cin), columns Cout, reduction over pixels). The TPU
// accumulates each dW in one output block across a sequential grid. Here
// the pixels are cut into `splits` chunks, one per grid z; each CTA writes
// its fp32 partial [rows, Cout] and `sum_rows_kernel` adds the splits in a
// fixed order: deterministic, no atomics. B10 is three launches (dX, dW
// partials, the sum), B11 two.
//
// Bound on this card at the bench's stage-2 shapes (batch 256, 56 x 56,
// bf16): B10 at 64 -> 256 by bytes (x, dy, y read and dx written, 1.03 GB,
// 0.307 ms at 3.35 TB/s; its two products 53 GFLOP); B11 at 3x3 64 -> 64 by
// bytes and FLOP alike (0.061 ms). This first design reads dy and y once per
// 64 input channels of dX and once per 64 output channels of dW, uses fp32
// FMA (no tensor cores), no TMA or cp.async.

#include "conv_common.cuh"

namespace {

using namespace conv;

// pixel m of the sampled grid -> its offset in x (elements)
struct Sampler {
  int H, W, Cin, Ho, Wo, stride;
  __device__ size_t offset(int m) const {
    const int wo = m % Wo;
    const int t = m / Wo;
    return (((size_t)(t / Ho) * H + (t % Ho) * stride) * W + wo * stride) *
           Cin;
  }
};

// one channel's dConv from its bundle r = [mean_n, inv_n, gamma, beta,
// mean32, rstd32, c1, c2], every op rounded on its own
__device__ __forceinline__ float dconv(float yv, float dz, const float r[8],
                                       int relu) {
  if (relu) {
    const float pre = __fadd_rn(
        __fmul_rn(__fmul_rn(__fsub_rn(yv, r[0]), r[1]), r[2]), r[3]);
    if (!(pre > 0.f)) dz = 0.f;
  }
  const float xh = __fmul_rn(__fsub_rn(yv, r[4]), r[5]);
  return __fmul_rn(__fmul_rn(r[2], r[5]),
                   __fsub_rn(__fsub_rn(dz, r[6]), __fmul_rn(xh, r[7])));
}

// B10's dX: A[m, co] = dconv (pixel tid / 2, channels (tid % 2) * 4 .. +3 of
// the step's 8), B[co, ci] = wt (row tid / 32, columns (tid % 32) * 2 .. +1)
template <typename T>
struct DxLoader {
  const T *dy, *y, *wt;
  const float* rows;
  int Cin, Cout, relu, a_row, a_c, b_k, b_n, n0;
  bool m_ok, n_ok;
  size_t m_off;
  float a_reg[4], b_reg[2];

  __device__ DxLoader(const T* dy_, const T* y_, const T* wt_,
                      const float* rows_, int M, int Cin_, int Cout_,
                      int relu_, int m0, int n0_)
      : dy(dy_), y(y_), wt(wt_), rows(rows_), Cin(Cin_), Cout(Cout_),
        relu(relu_), n0(n0_) {
    const int tid = threadIdx.x;
    a_row = tid >> 1;
    a_c = (tid & 1) * 4;
    m_ok = m0 + a_row < M;
    m_off = (size_t)(m0 + a_row) * Cout;
    b_k = tid >> 5;
    b_n = (tid & 31) * 2;
    n_ok = n0 + b_n < Cin;
  }

  __device__ void load(int step) {
    const int c0 = step * kBK + a_c;
    if (m_ok) {
      float d[4], yv[4];
      load4(dy + m_off + c0, d);
      load4(y + m_off + c0, yv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float r[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) r[q] = __ldg(rows + q * Cout + c0 + j);
        a_reg[j] = round_to<T>(dconv(yv[j], d[j], r, relu));
      }
    } else {
      a_reg[0] = a_reg[1] = a_reg[2] = a_reg[3] = 0.f;
    }
    if (n_ok) {
      load2(wt + (size_t)(step * kBK + b_k) * Cin + n0 + b_n, b_reg);
    } else {
      b_reg[0] = b_reg[1] = 0.f;
    }
  }

  __device__ void store(float (*As)[kPitchA], float (*Bs)[kBN]) {
    store_a_rowmajor(As, a_row, a_c, a_reg);
    store_b(Bs, b_k, b_n, b_reg);
  }
};

// B10's dW: A[m, ci] = x at sampled pixel m (pixel tid / 32 of the step,
// channels (tid % 32) * 4 .. +3), B[m, co] = dconv (the same pixel,
// channels (tid % 32) * 2 .. +1, whose bundles stay in registers)
template <typename T>
struct Dw1x1Loader {
  const T *x, *dy, *y;
  Sampler smp;
  int Cout, relu, k, a_r, b_n, r0, n0, m_begin, m_end;
  bool a_ok, n_ok;
  float rr[2][8];
  float a_reg[4], b_reg[2];

  __device__ Dw1x1Loader(const T* x_, const T* dy_, const T* y_,
                         const float* rows, const Sampler& smp_, int Cout_,
                         int relu_, int r0_, int n0_, int m_begin_,
                         int m_end_)
      : x(x_), dy(dy_), y(y_), smp(smp_), Cout(Cout_), relu(relu_), r0(r0_),
        n0(n0_), m_begin(m_begin_), m_end(m_end_) {
    const int tid = threadIdx.x;
    k = tid >> 5;
    a_r = (tid & 31) * 4;
    b_n = (tid & 31) * 2;
    a_ok = r0 + a_r < smp.Cin;
    n_ok = n0 + b_n < Cout;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        rr[j][q] = n_ok ? rows[q * Cout + n0 + b_n + j] : 0.f;
      }
  }

  __device__ void load(int step) {
    const int m = m_begin + step * kBK + k;
    const bool ok = m < m_end;
    if (ok && a_ok) {
      load4(x + smp.offset(m) + r0 + a_r, a_reg);
    } else {
      a_reg[0] = a_reg[1] = a_reg[2] = a_reg[3] = 0.f;
    }
    if (ok && n_ok) {
      float d[2], yv[2];
      load2(dy + (size_t)m * Cout + n0 + b_n, d);
      load2(y + (size_t)m * Cout + n0 + b_n, yv);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        b_reg[j] = round_to<T>(dconv(yv[j], d[j], rr[j], relu));
      }
    } else {
      b_reg[0] = b_reg[1] = 0.f;
    }
  }

  __device__ void store(float (*As)[kPitchA], float (*Bs)[kBN]) {
    store_a_kmajor(As, k, a_r, a_reg);
    store_b(Bs, k, b_n, b_reg);
  }
};

// B11: A[m, (tap, ci)] = x at pixel m shifted by the tap (zero outside x;
// 4 consecutive rows are 4 channels of one tap, as Cin % 8 == 0),
// B[m, co] = g
template <typename T>
struct Dw3x3Loader {
  const T *x, *g;
  int H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l;
  int k, a_r, b_n, n0, m_begin, m_end, tdy, tdx, ci;
  bool a_ok, n_ok;
  float a_reg[4], b_reg[2];

  __device__ Dw3x3Loader(const T* x_, const T* g_, int H_, int W_, int Cin_,
                         int Cout_, int Ho_, int Wo_, int stride_, int pad_t_,
                         int pad_l_, int r0, int n0_, int m_begin_,
                         int m_end_)
      : x(x_), g(g_), H(H_), W(W_), Cin(Cin_), Cout(Cout_), Ho(Ho_), Wo(Wo_),
        stride(stride_), pad_t(pad_t_), pad_l(pad_l_), n0(n0_),
        m_begin(m_begin_), m_end(m_end_) {
    const int tid = threadIdx.x;
    k = tid >> 5;
    a_r = (tid & 31) * 4;
    b_n = (tid & 31) * 2;
    const int row = r0 + a_r;
    a_ok = row < 9 * Cin;
    const int tap = a_ok ? row / Cin : 0;
    ci = row - tap * Cin;
    tdy = tap / 3;
    tdx = tap % 3;
    n_ok = n0 + b_n < Cout;
  }

  __device__ void load(int step) {
    const int m = m_begin + step * kBK + k;
    const bool ok = m < m_end;
    bool in = false;
    size_t off = 0;
    if (ok && a_ok) {
      const int wo = m % Wo;
      const int t = m / Wo;
      const int hi = (t % Ho) * stride - pad_t + tdy;
      const int wi = wo * stride - pad_l + tdx;
      in = hi >= 0 && hi < H && wi >= 0 && wi < W;
      off = (((size_t)(t / Ho) * H + hi) * W + wi) * Cin + ci;
    }
    if (in) {
      load4(x + off, a_reg);
    } else {
      a_reg[0] = a_reg[1] = a_reg[2] = a_reg[3] = 0.f;
    }
    if (ok && n_ok) {
      load2(g + (size_t)m * Cout + n0 + b_n, b_reg);
    } else {
      b_reg[0] = b_reg[1] = 0.f;
    }
  }

  __device__ void store(float (*As)[kPitchA], float (*Bs)[kBN]) {
    store_a_kmajor(As, k, a_r, a_reg);
    store_b(Bs, k, b_n, b_reg);
  }
};

// a dW tile of split blockIdx.z: rows r0.., columns n0.. of partial
// [splits, R, Cout]
template <class Loader>
__device__ __forceinline__ void dw_tile(Loader& ld, int steps,
                                        float* __restrict__ partial, int R,
                                        int Cout, int r0, int n0) {
  float acc[8][4];
  gemm_mainloop(ld, steps, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int col = n0 + tx * 4;
  if (col >= Cout) return;
  float* base = partial + (size_t)blockIdx.z * R * Cout;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = r0 + ty * 8 + i;
    if (row >= R) break;
    store4(base + (size_t)row * Cout + col, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_bwd_dx_kernel(const T* __restrict__ dy, const T* __restrict__ y,
                      const float* __restrict__ rows,
                      const T* __restrict__ wt, T* __restrict__ dx,
                      const Sampler smp, const int Cout, const int M,
                      const int relu) {
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  DxLoader<T> ld(dy, y, wt, rows, M, smp.Cin, Cout, relu, m0, n0);
  float acc[8][4];
  gemm_mainloop(ld, Cout / kBK, acc);
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int col = n0 + tx * 4;
  if (col >= smp.Cin) return;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + ty * 8 + i;
    if (row >= M) break;
    store4(dx + smp.offset(row) + col, acc[i]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv1x1_bwd_dw_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                      const T* __restrict__ y, const float* __restrict__ rows,
                      float* __restrict__ partial, const Sampler smp,
                      const int Cout, const int M, const int chunk,
                      const int relu) {
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int mb = blockIdx.z * chunk;
  const int me = min(M, mb + chunk);
  Dw1x1Loader<T> ld(x, dy, y, rows, smp, Cout, relu, r0, n0, mb, me);
  dw_tile(ld, me > mb ? (me - mb + kBK - 1) / kBK : 0, partial, smp.Cin,
          Cout, r0, n0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
conv3x3_dw_kernel(const T* __restrict__ x, const T* __restrict__ g,
                  float* __restrict__ partial, const int H, const int W,
                  const int Cin, const int Cout, const int Ho, const int Wo,
                  const int stride, const int pad_t, const int pad_l,
                  const int M, const int chunk) {
  const int r0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int mb = blockIdx.z * chunk;
  const int me = min(M, mb + chunk);
  Dw3x3Loader<T> ld(x, g, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, r0,
                    n0, mb, me);
  dw_tile(ld, me > mb ? (me - mb + kBK - 1) / kBK : 0, partial, 9 * Cin,
          Cout, r0, n0);
}

template <typename T>
int launch_1x1(const void* x, const void* dy, const void* y,
               const void* rows, const void* wt, void* dx, void* dw,
               void* partial, const Sampler& smp, int M, int Cout, int relu,
               int splits, int chunk, cudaStream_t stream) {
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const T* yt = static_cast<const T*>(y);
  const float* r = static_cast<const float*>(rows);
  float* part = static_cast<float*>(partial);
  conv1x1_bwd_dx_kernel<T><<<dim3((M + kBM - 1) / kBM,
                                  (smp.Cin + kBN - 1) / kBN),
                             kThreads, 0, stream>>>(
      dyt, yt, r, static_cast<const T*>(wt), static_cast<T*>(dx), smp, Cout,
      M, relu);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  conv1x1_bwd_dw_kernel<T><<<dim3((smp.Cin + kBM - 1) / kBM,
                                  (Cout + kBN - 1) / kBN, splits),
                             kThreads, 0, stream>>>(
      xt, dyt, yt, r, part, smp, Cout, M, chunk, relu);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_rows(part, static_cast<float*>(dw), splits,
                  (long long)smp.Cin * Cout, stream);
}

template <typename T>
int launch_3x3_dw(const void* x, const void* g, void* dw, void* partial,
                  int N, int H, int W, int Cin, int Cout, int Ho, int Wo,
                  int stride, int pad_t, int pad_l, int splits, int chunk,
                  cudaStream_t stream) {
  float* part = static_cast<float*>(partial);
  conv3x3_dw_kernel<T><<<dim3((9 * Cin + kBM - 1) / kBM,
                              (Cout + kBN - 1) / kBN, splits),
                         kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), part, H, W, Cin,
      Cout, Ho, Wo, stride, pad_t, pad_l, N * Ho * Wo, chunk);
  const int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_rows(part, static_cast<float*>(dw), splits,
                  9LL * Cin * Cout, stream);
}

bool bad_args(int dtype, int Cin, int Cout, int splits, int chunk) {
  // the wrapper checks shapes, dtypes, contiguity and 16-byte alignment
  return Cin % kBK || Cout % kBK || (dtype != 0 && dtype != 1) ||
         splits < 1 || splits > 65535 || chunk < 1;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Each returns the launches' cudaError_t.

// B10: x [N, H, W, Cin] (read at pixels (n, ho*s, wo*s)), dy and y [N, Ho,
// Wo, Cout], rows [8, Cout] fp32, wt [Cout, Cin] -> dx [N, H, W, Cin]
// (written at the sampled pixels only), dw [Cin, Cout] fp32; partial: fp32
// scratch [splits, Cin, Cout], the pixels cut into chunks of `chunk`
int conv1x1_bwd(const void* x, const void* dy, const void* y,
                const void* rows, const void* wt, void* dx, void* dw,
                void* partial, int dtype, int N, int H, int W, int Cin,
                int Cout, int Ho, int Wo, int stride, int relu, int splits,
                int chunk, void* stream) {
  if (bad_args(dtype, Cin, Cout, splits, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Sampler smp{H, W, Cin, Ho, Wo, stride};
  const int M = N * Ho * Wo;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_1x1<__nv_bfloat16>(x, dy, y, rows, wt, dx, dw, partial, smp,
                                  M, Cout, relu, splits, chunk, s)
      : launch_1x1<float>(x, dy, y, rows, wt, dx, dw, partial, smp, M, Cout,
                          relu, splits, chunk, s);
}

// B11: x [N, H, W, Cin], g [N, Ho, Wo, Cout] -> dw [3, 3, Cin, Cout] fp32;
// partial: fp32 scratch [splits, 9 * Cin, Cout]
int conv3x3_dw(const void* x, const void* g, void* dw, void* partial,
               int dtype, int N, int H, int W, int Cin, int Cout, int Ho,
               int Wo, int stride, int pad_t, int pad_l, int splits,
               int chunk, void* stream) {
  if (bad_args(dtype, Cin, Cout, splits, chunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dtype == 1
      ? launch_3x3_dw<__nv_bfloat16>(x, g, dw, partial, N, H, W, Cin, Cout,
                                     Ho, Wo, stride, pad_t, pad_l, splits,
                                     chunk, s)
      : launch_3x3_dw<float>(x, g, dw, partial, N, H, W, Cin, Cout, Ho, Wo,
                             stride, pad_t, pad_l, splits, chunk, s);
}

}  // extern "C"
