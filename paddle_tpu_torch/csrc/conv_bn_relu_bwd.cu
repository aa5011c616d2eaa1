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
// Design. The f32 paths of B10 and B11 run on conv_common.cuh's
// `gemm_mainloop` (128 x 64 fp32-FMA tiles, steps of 8): B10's dX (rows
// pixels, columns Cin, reduction over Cout, the A tile dConv computed from
// dy and y), B10's dW and B11's dW (rows Cin or (tap, Cin), columns Cout,
// reduction over pixels). The bf16 paths run on the tensor cores
// (`conv3x3_dw_mma_kernel`, `conv1x1_bwd_dx_mma_kernel`,
// `conv1x1_bwd_dw_mma_kernel`, below). The TPU accumulates each dW in one
// output block across a sequential grid. Here the pixels are cut into
// `splits` ranges, one per grid z; each CTA writes its fp32 partial [rows,
// Cout] and `sum_rows_kernel` adds the splits in a fixed order:
// deterministic, no atomics. B10 is three launches (dX, dW partials, the
// sum), B11 two.
//
// Bound on this card at the bench's stage-2 shapes (batch 256, 56 x 56,
// bf16): B10 at 64 -> 256 by bytes (x, dy, y read and dx written, 1.03 GB,
// 0.307 ms at 3.35 TB/s; its two products 53 GFLOP); B11 at 3x3 64 -> 64 by
// bytes and FLOP alike (59.2 GFLOP, 205.5 MB: 0.061 ms). B10's dX and dW
// are two launches, so dy and y leave device memory twice (at 64 -> 256,
// 0.49 ms of bytes alone): one CTA holding a pixel tile's whole dConv for
// both products would need its dW tile of Cin x Cout in registers across
// the split, more than a CTA holds at ResNet-50's widths.

#include <algorithm>

#include "conv_common.cuh"
#include "conv_mma.cuh"

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

// ---------------------------------------------------------------------------
// B11 in bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
// The nine taps' GEMM on `mma.sync` (conv_mma.cuh's fragments): rows (tap,
// ci), columns co, k = 16 output pixels. A CTA owns one filter row dy (three
// taps dx), 64 input channels and 64 output channels of dw, and walks its
// split's pixels in chunks: TH consecutive output rows (n, ho) of TW
// columns (a row wider than kDwPix in segments), at most kDwPix pixels. For
// each chunk it copies, once, the x patch those pixels read at row dy (TH
// input rows of XW = (TW - 1) * stride + 3 columns, 64 channels, zero
// outside x) and the g tile (the chunk's pixels in the split, 64 channels,
// zero elsewhere) into swizzled shared memory with cp.async,
// double-buffered across chunks. x and g thus leave device memory once per
// chunk and filter row, not once per tap. The three taps read A = x^T from
// the one patch at slots shifted by dx (stride 2 takes every other slot)
// through `ldmatrix.trans`, one slot address per lane; B = g likewise. A
// warp owns 3 taps x 16 ci x 32 co (12 products a k-step). Each chunk's
// products are summed on the tensor cores from zero, then added into an
// fp32 register sum: a two-level sum, since the tensor cores' fp32
// accumulation truncates rather than rounding to nearest at each add, and
// no run of it is longer than one chunk. 128 registers and 2 x 47 KB of
// shared memory at most let two CTAs share an SM, so one's copies overlap
// the other's products.
constexpr int kDwPix = 192;       // output pixels a chunk holds (12 k-steps)
constexpr int kDwSlots = 245;     // x patch slots a chunk holds
constexpr int kDwThreads = 256;   // 8 warps: 4 (16 ci) x 2 (32 co)

struct DwGeom {
  int H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, M;
  int TH, TW, XW, nseg;   // chunk rows and columns, patch width, chunks a row
};

// chunk i of a split whose output rows start at t_first: its first row t0
// and column c0, its first pixel's index m, and the pixels [p_lo, p_hi) of
// it inside the split [mb, me) (pixel p is m + p)
struct DwChunk {
  int t0, c0, p_lo, p_hi;
  long long m;
  __device__ DwChunk(const DwGeom& geo, int i, int t_first, int mb, int me) {
    const int rg = i / geo.nseg, seg = i - rg * geo.nseg;
    t0 = t_first + rg * geo.TH;
    c0 = seg * geo.TW;
    m = static_cast<long long>(t0) * geo.Wo + c0;
    const int peff = geo.nseg == 1 ? geo.TH * geo.TW : min(geo.TW, geo.Wo - c0);
    p_lo = static_cast<int>(max(0LL, mb - m));
    p_hi = static_cast<int>(min(static_cast<long long>(peff), me - m));
  }
};

__global__ void __launch_bounds__(kDwThreads, 2)
conv3x3_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ g,
                      float* __restrict__ partial, const DwGeom geo,
                      const int chunk) {
  using namespace conv_mma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2;   // 16 ci block, 32 co block
  const int dy = blockIdx.x % 3;
  const int ci0 = (blockIdx.x / 3) * kCh;
  const int co0 = blockIdx.y * kCh;
  const int s = geo.stride;
  const int xslots = geo.TH * geo.XW;
  const uint32_t stage_bytes = (xslots + kDwPix) * kRowBytes;
  const uint32_t smem0 = smem_u32(smem_raw);
  const int rows_total = geo.M / geo.Wo;    // N * Ho

  const int mb = blockIdx.z * chunk;
  const int me = min(geo.M, mb + chunk);
  const int t_first = mb / geo.Wo;
  const int nch = ((me - 1) / geo.Wo - t_first) / geo.TH * geo.nseg +
                  geo.nseg;

  // this thread's copies: chunk cc (8 channels) of slots / pixel rows
  // tid / 8, tid / 8 + 32, ...
  const int cc = tid & 7;
  const int xr0 = (tid >> 3) / geo.XW, xj0 = (tid >> 3) - xr0 * geo.XW;
  const bool ci_ok = ci0 + cc * 8 < geo.Cin;
  const bool co_ok = co0 + cc * 8 < geo.Cout;

  auto load = [&](int i, uint32_t xt) {
    const DwChunk ch(geo, i, t_first, mb, me);
    const uint32_t gt = xt + xslots * kRowBytes;
    int j = xj0, t = ch.t0 + xr0;
    int n = t / geo.Ho, ho = t - n * geo.Ho;
    for (int slot = tid >> 3; slot < xslots; slot += kDwThreads / 8) {
      const int hi = ho * s - geo.pad_t + dy;
      const int wi = ch.c0 * s - geo.pad_l + j;
      const bool ok = ci_ok && t < rows_total && hi >= 0 && hi < geo.H &&
                      wi >= 0 && wi < geo.W;
      const __nv_bfloat16* src =
          ok ? x + ((static_cast<size_t>(n) * geo.H + hi) * geo.W + wi) *
                       geo.Cin + ci0 + cc * 8
             : x;
      copy_chunk(xt, slot, cc, src, ok);
      for (j += kDwThreads / 8; j >= geo.XW; j -= geo.XW) {
        ++t;
        if (++ho == geo.Ho) { ho = 0; ++n; }
      }
    }
    const int p_end = (ch.p_hi + 15) & ~15;
    for (int p = (ch.p_lo & ~15) + (tid >> 3); p < p_end;
         p += kDwThreads / 8) {
      const bool ok = co_ok && p >= ch.p_lo && p < ch.p_hi;
      const __nv_bfloat16* src =
          ok ? g + static_cast<size_t>(ch.m + p) * geo.Cout + co0 + cc * 8
             : g;
      copy_chunk(gt, p, cc, src, ok);
    }
  };

  float sum[3][4][4];
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[dx][nb][e] = 0.f;

  load(0, smem0);
  cp_async_commit();
  const int apix = a_pixel(lane);
  const int slot_max = xslots - 3;
  for (int i = 0; i < nch; ++i) {
    cp_async_wait<0>();  // chunk i has landed
    __syncthreads();     // ... for every thread; chunk i - 1 is released
    if (i + 1 < nch) load(i + 1, smem0 + ((i + 1) & 1) * stage_bytes);
    cp_async_commit();
    const DwChunk ch(geo, i, t_first, mb, me);
    const uint32_t xt = smem0 + (i & 1) * stage_bytes;
    const uint32_t gt = xt + xslots * kRowBytes;
    float acc[3][4][4];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[dx][nb][e] = 0.f;
    // this lane's A pixel of the first k-step: (row r, column c), its slot
    const int ks_lo = ch.p_lo >> 4, ks_hi = (ch.p_hi + 15) >> 4;
    int c = ks_lo * 16 + apix;
    const int r = c / geo.TW;
    c -= r * geo.TW;
    int slot = r * geo.XW + c * s;
#pragma unroll 2
    for (int ks = ks_lo; ks < ks_hi; ++ks) {
      // a pixel past the chunk's last reads a slot inside the patch; its g
      // row is zero
      const int sl = min(slot, slot_max);
      uint32_t a[3][4], b[2][4];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx) a_trans(a[dx], xt, sl + dx, wr, lane);
      b_trans(b[0], gt, ks * 16, 2 * wc, lane);
      b_trans(b[1], gt, ks * 16, 2 * wc + 1, lane);
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16(acc[dx][nb], a[dx], b[nb >> 1][(nb & 1) * 2],
                   b[nb >> 1][(nb & 1) * 2 + 1]);
      for (c += 16, slot += 16 * s; c >= geo.TW; c -= geo.TW)
        slot += geo.XW - geo.TW * s;
    }
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) sum[dx][nb][e] += acc[dx][nb][e];
  }

  // C fragment: rows ci (g and g + 8 of the warp's 16), columns co (2t,
  // 2t + 1 of each 8-column block)
  const int gq = lane >> 2, t4 = lane & 3;
  float* out = partial + static_cast<size_t>(blockIdx.z) * 9 * geo.Cin *
                             geo.Cout;
#pragma unroll
  for (int dx = 0; dx < 3; ++dx)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb) {
      const int co = co0 + wc * 32 + nb * 8 + 2 * t4;
      if (co >= geo.Cout) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = ci0 + wr * 16 + gq + 8 * h;
        if (ci < geo.Cin)
          *reinterpret_cast<float2*>(
              out + static_cast<size_t>((dy * 3 + dx) * geo.Cin + ci) *
                        geo.Cout + co) =
              make_float2(sum[dx][nb][2 * h], sum[dx][nb][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// B10 in bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
// dX on `mma.sync`: rows pixels, columns Cin, k = Cout. A CTA owns 128
// pixels and 64 input channels and walks Cout in chunks of 64. A chunk's
// dy and y [128 px][64 co], wt [64 co][64 ci] and bundle rows arrive by
// cp.async into a ring of two stages, one chunk ahead of its use. Then
// A = dConv is built where it is read (`build_dconv`): each lane holds the
// bundle of two channels in registers and applies `dconv` unchanged to
// those channels of one pixel row after another (4 bytes of dy and of y
// from shared memory, a warp a 128-byte row, no bank conflict), rounds to
// bf16 and stores into the swizzled A tile; a barrier, then the products,
// B = wt through `ldmatrix.trans`. A warp owns 32 pixels x 32 ci. 100 KB of
// shared memory and at most 128 registers let two CTAs share an SM, so
// one's dConv build overlaps the other's products.
// dW on `mma.sync`: rows Cin, columns Cout, k = pixels of the CTA's split,
// B11's product with one tap. A chunk's x at the sampled pixels [64 px][64
// ci] and dy and y [64 px][64 co] arrive by cp.async into a ring of three
// stages, two chunks ahead; B = dConv is built as in dX from the CTA's 64
// channels' bundle (staged once), A = x^T through `ldmatrix.trans`. A warp
// owns 16 ci x 32 co. Both sum at most kFold chunks (12 k-steps) on the
// tensor cores from zero before an fp32 register sum takes them (B11's
// two-level sum), and store no atomics.
constexpr int k1x1Threads = 256;
constexpr int kDxPix = 128;       // dX: pixels a CTA holds
constexpr int kDxStages = 2;      // dX: the ring's chunks
constexpr int kDwStep = 64;       // dW: pixels a chunk holds (4 k-steps)
constexpr int kDwStages = 3;      // dW: the ring's chunks
constexpr int kFold = 3;          // chunks the tensor cores sum alone
constexpr int kBundle = 8 * conv_mma::kCh;   // bundle floats a chunk holds
constexpr int kTile = conv_mma::kCh * conv_mma::kRowBytes;     // 8 KB
constexpr int kDxRaw = kDxPix * conv_mma::kRowBytes;           // 16 KB
// a dX stage: dy, y, wt and the bundle; the A tile after the stages
constexpr int kDxStage = 2 * kDxRaw + kTile + kBundle * 4;
constexpr int kDxSmem = kDxStages * kDxStage + kDxRaw;         // 100 KB
// a dW stage: x, dy and y; the dConv tile and the bundle after the stages
constexpr int kDwStage = 3 * kTile;
constexpr int kDwSmem = kDwStages * kDwStage + kTile + kBundle * 4;  // 82 KB

// cp.async of bundle rows [8, Cout] at channels [c0, c0 + 64) into R
// [8][64]; channels past Cout read 0
__device__ __forceinline__ void stage_bundle(float* R, const float* rows,
                                             int Cout, int c0, int tid) {
  for (int e = tid; e < kBundle; e += k1x1Threads) {
    const int q = e >> 6, c = c0 + (e & 63);
    const bool ok = c < Cout;
    conv_mma::cp_async_4(conv_mma::smem_u32(R + e),
                         rows + (ok ? q * Cout + c : 0), ok);
  }
}

// the dConv of a [P rows][64 channels] chunk: `dst` (swizzled) <- dconv of
// the same rows and channels of the raw dy and y tiles, rounded to bf16, 0
// for rows at or past `valid_rows` or channels past Cout. Lane pc of each
// warp owns channels 2 pc, 2 pc + 1 and holds their bundle (from R [8][64])
// in registers; warp w takes rows w, w + 8, ...: a warp reads and writes
// one 128-byte row at a time, without bank conflicts.
template <int P>
__device__ __forceinline__ void build_dconv(unsigned char* dst,
                                            const unsigned char* dyt,
                                            const unsigned char* yt,
                                            const float* R, int valid_rows,
                                            bool ch_ok, int relu, int tid) {
  const int pc = tid & 31, w = tid >> 5;
  float r0[8], r1[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    const float2 v = *reinterpret_cast<const float2*>(R + q * 64 + 2 * pc);
    r0[q] = v.x;
    r1[q] = v.y;
  }
#pragma unroll 4
  for (int p = w; p < P; p += k1x1Threads / 32) {
    const uint32_t off = conv_mma::tile_offset(p, pc >> 2) + (pc & 3) * 4;
    uint32_t v = 0;
    if (ch_ok && p < valid_rows) {
      const float2 df = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(dyt + off));
      const float2 yf = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(yt + off));
      v = conv_mma::pack_bf16x2(dconv(yf.x, df.x, r0, relu),
                                dconv(yf.y, df.y, r1, relu));
    }
    *reinterpret_cast<uint32_t*>(dst + off) = v;
  }
}

__global__ void __launch_bounds__(k1x1Threads, 2)
conv1x1_bwd_dx_mma_kernel(const __nv_bfloat16* __restrict__ dy,
                          const __nv_bfloat16* __restrict__ y,
                          const float* __restrict__ rows,
                          const __nv_bfloat16* __restrict__ wt,
                          __nv_bfloat16* __restrict__ dx, const Sampler smp,
                          const int Cout, const int M, const int relu) {
  using namespace conv_mma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* a_ptr = smem_raw + kDxStages * kDxStage;
  const uint32_t s_u32 = smem_u32(smem_raw), a_u32 = smem_u32(a_ptr);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wc = warp >> 2;   // 32 pixel block, 32 ci block
  const int m0 = blockIdx.x * kDxPix, ci0 = blockIdx.y * kCh;
  const int Cin = smp.Cin;
  const int nch = (Cout + kCh - 1) / kCh;
  // this thread's rows and 16-byte chunk: pixels p0 + 32 i, chunk cc
  const int cc = tid & 7, p0 = tid >> 3;

  // chunk k -> stage st: dy, y [128 px][64 co], wt [64 co][64 ci], bundle
  auto load = [&](int k, int st) {
    const uint32_t b = s_u32 + st * kDxStage;
    const int co = k * kCh + cc * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int p = p0 + 32 * i, m = m0 + p;
      const bool ok = m < M && co < Cout;
      const size_t off = ok ? static_cast<size_t>(m) * Cout + co : 0;
      copy_chunk(b, p, cc, dy + off, ok);
      copy_chunk(b + kDxRaw, p, cc, y + off, ok);
    }
    const int ci = ci0 + cc * 8;
    for (int r = tid >> 3; r < kCh; r += k1x1Threads / 8) {
      const int cr = k * kCh + r;
      const bool ok = cr < Cout && ci < Cin;
      copy_chunk(b + 2 * kDxRaw, r, cc,
                 ok ? wt + static_cast<size_t>(cr) * Cin + ci : wt, ok);
    }
    stage_bundle(reinterpret_cast<float*>(smem_raw + st * kDxStage +
                                          2 * kDxRaw + kTile),
                 rows, Cout, k * kCh, tid);
  };

  float acc[2][4][4], sum[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = sum[mt][nb][e] = 0.f;

  for (int i = 0; i < kDxStages - 1; ++i) {
    if (i < nch) load(i, i);
    cp_async_commit();
  }
  for (int k = 0; k < nch; ++k) {
    cp_async_wait<kDxStages - 2>();  // chunk k has landed
    __syncthreads();  // ... for every thread; chunk k - 1 is released
    const int nxt = k + kDxStages - 1;
    if (nxt < nch) load(nxt, nxt % kDxStages);
    cp_async_commit();
    const int st = k % kDxStages;
    const unsigned char* base = smem_raw + st * kDxStage;
    build_dconv<kDxPix>(
        a_ptr, base, base + kDxRaw,
        reinterpret_cast<const float*>(base + 2 * kDxRaw + kTile), M - m0,
        k * kCh + 2 * (tid & 31) < Cout, relu, tid);
    __syncthreads();  // A(k)
    const uint32_t bt = s_u32 + st * kDxStage + 2 * kDxRaw;
#pragma unroll
    for (int kk = 0; kk < kCh / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
      a_rows(a[0], a_u32, wm * 32 + a_row(lane), kk, lane);
      a_rows(a[1], a_u32, wm * 32 + 16 + a_row(lane), kk, lane);
      b_trans(b[0], bt, kk * 16, 2 * wc, lane);
      b_trans(b[1], bt, kk * 16, 2 * wc + 1, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16(acc[mt][nb], a[mt], b[nb >> 1][(nb & 1) * 2],
                   b[nb >> 1][(nb & 1) * 2 + 1]);
    }
    if ((k + 1) % kFold == 0 || k + 1 == nch) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[mt][nb][e] += acc[mt][nb][e];
            acc[mt][nb][e] = 0.f;
          }
    }
  }
  cp_async_wait<0>();

  // C fragment: rows pixels (g and g + 8 of each m-tile), columns ci (2t,
  // 2t + 1 of each 8-column block), written at the sampled pixel
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 32 + mt * 16 + gq + 8 * h;
      if (m >= M) continue;
      __nv_bfloat16* out = dx + smp.offset(m);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int ci = ci0 + wc * 32 + nb * 8 + 2 * t4;
        if (ci < Cin) {
          *reinterpret_cast<__nv_bfloat162*>(out + ci) =
              __floats2bfloat162_rn(sum[mt][nb][2 * h],
                                    sum[mt][nb][2 * h + 1]);
        }
      }
    }
}

__global__ void __launch_bounds__(k1x1Threads, 2)
conv1x1_bwd_dw_mma_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ dy,
                          const __nv_bfloat16* __restrict__ y,
                          const float* __restrict__ rows,
                          float* __restrict__ partial, const Sampler smp,
                          const int Cout, const int M, const int chunk,
                          const int relu) {
  using namespace conv_mma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* d_ptr = smem_raw + kDwStages * kDwStage;
  float* R = reinterpret_cast<float*>(d_ptr + kTile);
  const uint32_t s_u32 = smem_u32(smem_raw), d_u32 = smem_u32(d_ptr);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wr = warp & 3, wc = warp >> 2;   // 16 ci block, 32 co block
  const int ci0 = blockIdx.x * kCh, co0 = blockIdx.y * kCh;
  const int Cin = smp.Cin;
  const int mb = blockIdx.z * chunk;
  const int me = min(M, mb + chunk);
  const int nst = me > mb ? (me - mb + kDwStep - 1) / kDwStep : 0;
  // this thread's rows and 16-byte chunk: pixels p0 and p0 + 32, chunk cc
  const int cc = tid & 7, p0 = tid >> 3;
  const bool ci_ok = ci0 + cc * 8 < Cin, co_ok = co0 + cc * 8 < Cout;

  // chunk k -> stage st: x [64 px][64 ci], dy and y [64 px][64 co]
  auto load = [&](int k, int st) {
    const uint32_t b = s_u32 + st * kDwStage;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int p = p0 + 32 * i, m = mb + k * kDwStep + p;
      const bool in = m < me;
      copy_chunk(b, p, cc, in && ci_ok ? x + smp.offset(m) + ci0 + cc * 8
                                       : x, in && ci_ok);
      const size_t off =
          in && co_ok ? static_cast<size_t>(m) * Cout + co0 + cc * 8 : 0;
      copy_chunk(b + kTile, p, cc, dy + off, in && co_ok);
      copy_chunk(b + 2 * kTile, p, cc, y + off, in && co_ok);
    }
  };

  float acc[4][4], sum[4][4];
#pragma unroll
  for (int nb = 0; nb < 4; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = sum[nb][e] = 0.f;

  stage_bundle(R, rows, Cout, co0, tid);
  for (int i = 0; i < kDwStages - 1; ++i) {
    if (i < nst) load(i, i);
    cp_async_commit();
  }
  const int apix = a_pixel(lane);
  for (int k = 0; k < nst; ++k) {
    cp_async_wait<kDwStages - 2>();  // chunk k (and the bundle) landed
    __syncthreads();  // ... for every thread; chunk k - 1 is released
    const int nxt = k + kDwStages - 1;
    if (nxt < nst) load(nxt, nxt % kDwStages);
    cp_async_commit();
    const int st = k % kDwStages;
    const unsigned char* base = smem_raw + st * kDwStage;
    build_dconv<kDwStep>(d_ptr, base + kTile, base + 2 * kTile, R,
                         me - mb - k * kDwStep, co0 + 2 * (tid & 31) < Cout,
                         relu, tid);
    __syncthreads();  // D(k)
    const uint32_t xt = s_u32 + st * kDwStage;
#pragma unroll
    for (int ks = 0; ks < kDwStep / 16; ++ks) {
      uint32_t a[4], b[2][4];
      a_trans(a, xt, ks * 16 + apix, wr, lane);
      b_trans(b[0], d_u32, ks * 16, 2 * wc, lane);
      b_trans(b[1], d_u32, ks * 16, 2 * wc + 1, lane);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        mma_bf16(acc[nb], a, b[nb >> 1][(nb & 1) * 2],
                 b[nb >> 1][(nb & 1) * 2 + 1]);
    }
    if ((k + 1) % kFold == 0 || k + 1 == nst) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[nb][e] += acc[nb][e];
          acc[nb][e] = 0.f;
        }
    }
  }
  cp_async_wait<0>();

  // C fragment: rows ci (g and g + 8 of the warp's 16), columns co (2t,
  // 2t + 1 of each 8-column block)
  const int gq = lane >> 2, t4 = lane & 3;
  float* out = partial + static_cast<size_t>(blockIdx.z) * Cin * Cout;
#pragma unroll
  for (int nb = 0; nb < 4; ++nb) {
    const int co = co0 + wc * 32 + nb * 8 + 2 * t4;
    if (co >= Cout) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ci = ci0 + wr * 16 + gq + 8 * h;
      if (ci < Cin)
        *reinterpret_cast<float2*>(out + static_cast<size_t>(ci) * Cout +
                                   co) =
            make_float2(sum[nb][2 * h], sum[nb][2 * h + 1]);
    }
  }
}

int launch_1x1_mma(const void* x, const void* dy, const void* y,
                   const void* rows, const void* wt, void* dx, void* dw,
                   void* partial, const Sampler& smp, int M, int Cout,
                   int relu, int splits, int chunk, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const bf16* dyt = static_cast<const bf16*>(dy);
  const bf16* yt = static_cast<const bf16*>(y);
  const float* r = static_cast<const float*>(rows);
  float* part = static_cast<float*>(partial);
  const int ch = conv_mma::kCh;
  int err = static_cast<int>(cudaFuncSetAttribute(
      conv1x1_bwd_dx_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDxSmem));
  if (!err) {
    err = static_cast<int>(cudaFuncSetAttribute(
        conv1x1_bwd_dw_mma_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kDwSmem));
  }
  if (err) return err;
  conv1x1_bwd_dx_mma_kernel<<<dim3((M + kDxPix - 1) / kDxPix,
                                   (smp.Cin + ch - 1) / ch),
                              k1x1Threads, kDxSmem, stream>>>(
      dyt, yt, r, static_cast<const bf16*>(wt), static_cast<bf16*>(dx), smp,
      Cout, M, relu);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  conv1x1_bwd_dw_mma_kernel<<<dim3((smp.Cin + ch - 1) / ch,
                                   (Cout + ch - 1) / ch, splits),
                              k1x1Threads, kDwSmem, stream>>>(
      static_cast<const bf16*>(x), dyt, yt, r, part, smp, Cout, M, chunk,
      relu);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_rows(part, static_cast<float*>(dw), splits,
                  (long long)smp.Cin * Cout, stream);
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

int launch_3x3_dw_mma(const void* x, const void* g, void* dw, void* partial,
                      int N, int H, int W, int Cin, int Cout, int Ho, int Wo,
                      int stride, int pad_t, int pad_l, int splits, int chunk,
                      cudaStream_t stream) {
  if (stride != 1 && stride != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DwGeom geo{H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l, N * Ho * Wo,
             0, 0, 0, 0};
  // a row's chunk columns: all of it, or segments of at most kDwPix pixels
  // whose patch fits kDwSlots; several rows a chunk when they fit
  geo.TW = std::min({Wo, kDwPix, (kDwSlots - 3) / stride + 1});
  geo.XW = (geo.TW - 1) * stride + 3;
  geo.nseg = (Wo + geo.TW - 1) / geo.TW;
  geo.TH = geo.nseg > 1 ? 1 : std::min(kDwPix / geo.TW, kDwSlots / geo.XW);
  const int bytes = 2 * (geo.TH * geo.XW + kDwPix) * conv_mma::kRowBytes;
  int err = static_cast<int>(cudaFuncSetAttribute(
      conv3x3_dw_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes));
  if (err) return err;
  conv3x3_dw_mma_kernel<<<dim3(3 * ((Cin + conv_mma::kCh - 1) / conv_mma::kCh),
                               (Cout + conv_mma::kCh - 1) / conv_mma::kCh,
                               splits),
                          kDwThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(g), static_cast<float*>(partial),
      geo, chunk);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return sum_rows(static_cast<float*>(partial), static_cast<float*>(dw),
                  splits, 9LL * Cin * Cout, stream);
}

bool bad_args(int dtype, int Cin, int Cout, int splits, int chunk) {
  // the wrapper checks shapes, dtypes, contiguity and 16-byte alignment
  return Cin % kBK || Cout % kBK || (dtype != 0 && dtype != 1) ||
         splits < 1 || splits > 65535 || chunk < 1;
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Each returns the launches' cudaError_t.

// B10 (bf16 on the tensor cores): x [N, H, W, Cin] (read at pixels (n,
// ho*s, wo*s)), dy and y [N, Ho, Wo, Cout], rows [8, Cout] fp32, wt [Cout,
// Cin] -> dx [N, H, W, Cin] (written at the sampled pixels only), dw [Cin,
// Cout] fp32; partial: fp32 scratch [splits, Cin, Cout], the pixels cut
// into chunks of `chunk`
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
      ? launch_1x1_mma(x, dy, y, rows, wt, dx, dw, partial, smp, M, Cout,
                       relu, splits, chunk, s)
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
      ? launch_3x3_dw_mma(x, g, dw, partial, N, H, W, Cin, Cout, Ho, Wo,
                          stride, pad_t, pad_l, splits, chunk, s)
      : launch_3x3_dw<float>(x, g, dw, partial, N, H, W, Cin, Cout, Ho, Wo,
                             stride, pad_t, pad_l, splits, chunk, s);
}

}  // extern "C"
