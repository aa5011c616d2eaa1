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
//     fp32 per-channel sums of out and out^2, written per pixel tile as
//     partials [tiles, 2, Cout] that `sum_rows_kernel` adds in a fixed
//     order into sums [2, Cout] (the TPU kernel's revisited [2, Cout]
//     accumulator). Pixels outside the output and channels past Cout add
//     nothing (a bounds check, no padding).
// A stride-2 1x1 (pads 0) is the TPU kernel's pre-sliced x[:, ::2, ::2],
// read in place; a 3x3 reads the zero halo by bounds check, in place of the
// TPU wrapper's padded copy, so symmetric, SAME's asymmetric and VALID
// padding all take this one path.
//
// Design. Two by dtype. The bf16 kernels run on the tensor cores: B8 and
// B9b share one mainloop (`conv3x3_mma_tile`, below), B7 and B9a another
// (`conv1x1_mma_tile`), each a template on its epilogue, as B9 is the B7/B8
// walk with the epilogue replaced on the TPU; kernels are named apart per
// epilogue so that a profile tells them apart. The train kernels' epilogue
// (`StatsMmaEpilogue`) sums the stored bf16 values of each channel in a
// fixed order with no atomic: each thread its rows of the C fragment, the
// eight lanes of a column by xor shuffles, the four pixel warps in order
// through shared memory, then the tiles in `sum_rows_kernel`. The f32
// kernels, which the f32 parity runs hold to the CPU, keep the first
// design, an implicit GEMM through conv_common.cuh's `gemm_mainloop`: the
// output [M, Cout] is tiled 128 x 64 per CTA; the reduction walks the taps
// and, inside each, Cin in steps of 8 (Cin is a multiple of 8, so a step
// never straddles two taps). The A tile gathers 128 output pixels x 8 input
// channels of one tap from x with the bounds check, the B tile is 8 x 64
// of w; the epilogue is again a template parameter. The TPU kernel's VMEM
// slab walk, its double-buffered DMA and its row and width tiles have no
// counterpart here.
//
// Bound on this card at the bench's shapes (batch 256, bf16): bytes for
// the stage-2 1x1 64 -> 256 (x 103 MB in, the output 411 MB out: 514 MB,
// 0.153 ms at 3.35 TB/s), bytes and FLOP alike for the 3x3 64 -> 64 (206
// MB, 0.061 ms; 59.2 GFLOP, 0.060 ms at 989 TFLOP/s), FLOP for the stage-5
// 1x1 512 -> 2048 (26.3 GFLOP, 0.0266 ms); the train epilogue adds the
// partials (a few MB). The FMA design is far from either: fp32 FMA (no
// tensor cores), no TMA or cp.async, a step of only 8 input channels.
// The bf16 B7 reads x once, keeps the next tile's copies in flight and
// writes the output in 16-byte stores; what holds it back is `mma.sync`
// (a quarter of `wgmma`'s rate at best) and two CTAs an SM, each of which
// stages and stores its output tile between two tiles' products.

#include <algorithm>

#include "conv_common.cuh"
#include "conv_mma.cuh"

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

// train epilogue of the f32 B9: the conv cast once to T and stored; the
// cast values' fp32 sum and sum of squares per channel over the CTA's rows
// (each thread its 8 rows, then the 16 row groups in order) written to
// this row tile's partials [2, Cout]
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
// apart: B7, B8 (f32), B9a, B9b (f32)
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

// ---------------------------------------------------------------------------
// B8 in bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
// An implicit GEMM on `mma.sync` (conv_mma.cuh's fragments): rows output
// pixels, columns Cout, k = (tap, ci). A CTA owns a tile of output pixels,
// TH consecutive output rows (n, ho) of TW columns (a row wider than that
// in segments), at most kFwdPix pixels, and 64 output channels. For each
// chunk of 64 input channels it copies, once, the x patch the tile reads
// through all nine taps into swizzled shared memory with cp.async,
// zero-filled outside x (halo, pads, channels past Cin): its rows are the
// input rows of the tile's output rows, shared between neighbouring output
// rows of one image; an image boundary inside the tile opens a new run of
// rows (patch row of output row r and filter row dy: r * s + dy + (images
// crossed) * (3 - s)), and each row holds XW = (TW - 1) * s + 3 columns.
// So x leaves device memory once per chunk, not once per tap. The nine
// taps read A = x from that one patch at slots shifted by (dy * XW + dx)
// through `ldmatrix`, one slot address per lane (stride 2 takes every
// other slot); B = w's [64 ci][64 co] tile of the tap through
// `ldmatrix.trans`, from a ring of four (chunk, tap) tiles that runs three
// taps ahead. Patches are double-buffered: the next chunk's is copied while
// this chunk's nine taps run. A warp owns 32 pixels x 32 co. Each chunk's
// 36 k-steps are summed on the tensor cores from zero, then added into an
// fp32 register sum: the tensor cores' fp32 accumulation truncates, so no
// run of it is longer than one chunk. The epilogue is a functor on (pixel,
// column pair, two values) and a `finish` the whole CTA calls: the affine
// and ReLU for B8 (`conv3x3_bn_relu_mma_kernel`), the cast and the channel
// statistics for B9b (`conv3x3_train_mma_kernel`).
constexpr int kFwdThreads = 256;    // 8 warps: 4 (32 pixels) x 2 (32 co)
constexpr int kFwdPix = 128;        // output pixels a tile holds
constexpr int kFwdSlots = 640;      // x patch slots a stage holds (80 KB)
constexpr int kFwdRows = 64;        // x patch rows at most
constexpr int kFwdWStages = 4;      // ring of (chunk, tap) filter tiles
constexpr int kFwdTileBytes = conv_mma::kCh * conv_mma::kRowBytes;  // 8 KB

struct FwdGeom {
  int N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l;
  int TH, TW, XW, PR, nseg;  // tile rows, columns; patch width, rows;
                             // segments a row
};

// eval epilogue of the mma kernels (B8, B7): the BatchNorm affine and
// ReLU in fp32 on two neighbouring columns, one cast (`pair`); B8 stores
// the pair (4 bytes) where it is, B7 stages it for 16-byte stores
struct AffineMmaEpilogue {
  const float* scale;
  const float* shift;
  __nv_bfloat16* out;
  int Cout, relu;

  __device__ __forceinline__ uint32_t pair(int co, float v0,
                                           float v1) const {
    float y0 = __fadd_rn(__fmul_rn(v0, __ldg(scale + co)), __ldg(shift + co));
    float y1 = __fadd_rn(__fmul_rn(v1, __ldg(scale + co + 1)),
                         __ldg(shift + co + 1));
    if (relu) {
      y0 = fmaxf(y0, 0.f);
      y1 = fmaxf(y1, 0.f);
    }
    return conv_mma::pack_bf16x2(y0, y1);
  }

  // B8: one valid pixel's column pair (its 8-column block nb) stored
  __device__ __forceinline__ void operator()(long long m, int /*nb*/, int co,
                                             float v0, float v1) const {
    *reinterpret_cast<uint32_t*>(out + m * Cout + co) = pair(co, v0, v1);
  }
  __device__ __forceinline__ void finish(int, int, int, long long,
                                         int) const {}
  // B7: around the staged tile's stores
  __device__ __forceinline__ void staged(uint32_t, long long, int, int, int,
                                         int) const {}
  __device__ __forceinline__ void stored(long long, int) const {}
};

// The statistics epilogue of the mma kernels (B9b, B9a): the conv cast once
// to bf16 and stored, and the fp32 sum and sum of squares of each channel's
// stored values over a tile, in a fixed order with no atomic:
//   1. each thread its rows of the C fragment, in order: pixels gq, gq + 8
//      of m-tile 0, then of m-tile 1 (gq = lane / 4), skipping pixels
//      outside the output;
//   2. the eight gq lanes of a column by xor shuffles over lanes 4, 8, 16
//      (gq bits 0, 1, 2);
//   3. the four pixel warps (wm) in order, through `red` in shared memory;
// then row `tile` of partial [tiles, 2, Cout] holds the tile's 64 channels,
// and sum_rows_kernel adds the tiles in order. A bf16 value's square is
// exact in fp32 (16 significant bits).
struct StatsMmaEpilogue {
  __nv_bfloat16* out;
  float* partial;  // [tiles, 2, Cout]
  int Cout;
};

// a thread's sums over its rows, [8-column block nb][column of the pair]
struct StatsSums {
  const StatsMmaEpilogue& e;
  float (*red)[4][conv_mma::kCh];  // [sum, squares][wm][column], shared
  float s[4][2], q[4][2];

  __device__ __forceinline__ StatsSums(const StatsMmaEpilogue& e_,
                                       float (*red_)[4][conv_mma::kCh])
      : e(e_), red(red_) {
    zero();
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j) s[nb][j] = q[nb][j] = 0.f;
  }

  // the next row's stored pair of block nb (lo in the low half)
  __device__ __forceinline__ void add(int nb, uint32_t v) {
    const float y0 = __uint_as_float(v << 16);
    const float y1 = __uint_as_float(v & 0xffff0000u);
    s[nb][0] = __fadd_rn(s[nb][0], y0);
    s[nb][1] = __fadd_rn(s[nb][1], y1);
    q[nb][0] = __fadd_rn(q[nb][0], __fmul_rn(y0, y0));
    q[nb][1] = __fadd_rn(q[nb][1], __fmul_rn(y1, y1));
  }

  // steps 2 and 3 up to `red`: the warp's column sums, written by the
  // lanes of gq 0 (every lane of the warp must call this)
  __device__ __forceinline__ void to_shared(int wm, int wc, int lane) {
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s[nb][j] = __fadd_rn(s[nb][j],
                               __shfl_xor_sync(0xffffffffu, s[nb][j], o));
          q[nb][j] = __fadd_rn(q[nb][j],
                               __shfl_xor_sync(0xffffffffu, q[nb][j], o));
        }
    if (lane < 4) {
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = wc * 32 + nb * 8 + 2 * lane + j;
          red[0][wm][col] = s[nb][j];
          red[1][wm][col] = q[nb][j];
        }
    }
  }

  // after a barrier: the four warps in order into row `tile` of partial
  __device__ __forceinline__ void to_partial(long long tile, int co0) const {
    const int tid = threadIdx.x;
    if (tid >= 2 * conv_mma::kCh) return;
    const int which = tid / conv_mma::kCh, c = tid % conv_mma::kCh;
    if (co0 + c >= e.Cout) return;
    float t = red[which][0][c];
#pragma unroll
    for (int r = 1; r < 4; ++r) t = __fadd_rn(t, red[which][r][c]);
    e.partial[(tile * 2 + which) * e.Cout + co0 + c] = t;
  }

  // a column pair's bits: the cast alone
  __device__ __forceinline__ uint32_t pair(int, float v0, float v1) const {
    return conv_mma::pack_bf16x2(v0, v1);
  }

  // B9b: one valid pixel's column pair stored and summed
  __device__ __forceinline__ void operator()(long long m, int nb, int co,
                                             float v0, float v1) {
    const uint32_t v = pair(co, v0, v1);
    *reinterpret_cast<uint32_t*>(e.out + m * e.Cout + co) = v;
    add(nb, v);
  }
  __device__ __forceinline__ void finish(int wm, int wc, int lane,
                                         long long tile, int co0) {
    to_shared(wm, wc, lane);
    __syncthreads();
    to_partial(tile, co0);
  }

  // B9a, after the barrier that follows the staging: this thread's own
  // pairs read back from the staging tile [128 pixels][64 co] (pixel m0 +
  // p valid below M) into sums from zero, then steps 2 and 3 up to `red`
  __device__ __forceinline__ void staged(uint32_t stage, long long m0, int M,
                                         int wm, int wc, int lane) {
    const int gq = lane >> 2, t4 = lane & 3;
    zero();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * 32 + mt * 16 + gq + 8 * h;
        const bool ok = m0 + p < M;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int col = wc * 32 + nb * 8 + 2 * t4;
          uint32_t v;
          asm volatile("ld.shared.u32 %0, [%1];\n"
                       : "=r"(v)
                       : "r"(stage + conv_mma::tile_offset(p, col >> 3) +
                             (col & 7) * 2));
          if (ok) add(nb, v);
        }
      }
    to_shared(wm, wc, lane);
  }
  // B9a, after the tile's stores: a barrier, then row `tile` of partial
  __device__ __forceinline__ void stored(long long tile, int co0) const {
    __syncthreads();
    to_partial(tile, co0);
  }
};

template <class Epilogue>
__device__ __forceinline__ void conv3x3_mma_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const FwdGeom& geo, Epilogue& epi) {
  using namespace conv_mma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __shared__ int row_n[kFwdRows], row_hi[kFwdRows];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wc = warp >> 2;   // 32 pixel block, 32 co block
  const int s = geo.stride;
  const int rows_total = geo.N * geo.Ho;
  const int rg = blockIdx.x / geo.nseg, seg = blockIdx.x - rg * geo.nseg;
  const int t0 = rg * geo.TH, c0 = seg * geo.TW;
  const int n0 = t0 / geo.Ho;
  const int co0 = blockIdx.y * kCh;
  const int xslots = geo.PR * geo.XW;
  const uint32_t xbytes = xslots * kRowBytes;
  const uint32_t smem0 = smem_u32(smem_raw);
  const uint32_t wring = smem0 + 2 * xbytes;

  // patch row -> its image and input row; an image past the batch reads 0
  if (tid < geo.PR) {
    int n = n0, ho = t0 - n0 * geo.Ho, r = 0, base = 0;
    int pn = geo.N, phi = 0;
    while (r < geo.TH) {
      const int cnt = min(geo.TH - r, geo.Ho - ho);
      const int span = (cnt - 1) * s + 3;
      if (tid < base + span) {
        pn = n;
        phi = ho * s - geo.pad_t + (tid - base);
        break;
      }
      base += span;
      r += cnt;
      ho = 0;
      ++n;
    }
    row_n[tid] = pn;
    row_hi[tid] = phi;
  }

  // this lane's A pixel in each of its two m-tiles -> its tap-0 slot (a
  // pixel past the tile reads slot 0 and is never stored)
  int abase[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = wm * 32 + mt * 16 + a_row(lane);
    const int r = p / geo.TW, c = p - r * geo.TW;
    abase[mt] = r < geo.TH
        ? (r * s + ((t0 + r) / geo.Ho - n0) * (3 - s)) * geo.XW + c * s
        : 0;
  }

  // this thread's copies: chunk cc (8 channels) of slots / rows tid / 8,
  // tid / 8 + 32, ...
  const int cc = tid & 7;
  auto load_x = [&](int kc, uint32_t xt) {
    const int ci = kc * kCh + cc * 8;
    const bool ci_ok = ci < geo.Cin;
    int pr = (tid >> 3) / geo.XW, j = (tid >> 3) - pr * geo.XW;
    for (int slot = tid >> 3; slot < xslots; slot += kFwdThreads / 8) {
      const int n = row_n[pr], hi = row_hi[pr];
      const int wi = c0 * s - geo.pad_l + j;
      const bool ok = ci_ok && n < geo.N && hi >= 0 && hi < geo.H &&
                      wi >= 0 && wi < geo.W;
      const __nv_bfloat16* src =
          ok ? x + ((static_cast<size_t>(n) * geo.H + hi) * geo.W + wi) *
                       geo.Cin + ci
             : x;
      copy_chunk(xt, slot, cc, src, ok);
      for (j += kFwdThreads / 8; j >= geo.XW; j -= geo.XW) ++pr;
    }
  };
  // step i = (chunk kc, tap): w[tap][kc * 64 .., co0 ..] as [64 ci][64 co]
  auto load_w = [&](int i, uint32_t wt) {
    const int kc = i / 9, tap = i - kc * 9;
    const int co = co0 + cc * 8;
    for (int r = tid >> 3; r < kCh; r += kFwdThreads / 8) {
      const int ci = kc * kCh + r;
      const bool ok = ci < geo.Cin && co < geo.Cout;
      const __nv_bfloat16* src =
          ok ? w + (static_cast<size_t>(tap) * geo.Cin + ci) * geo.Cout + co
             : w;
      copy_chunk(wt, r, cc, src, ok);
    }
  };

  float acc[2][4][4], sum[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = sum[mt][nb][e] = 0.f;

  const int nch = (geo.Cin + kCh - 1) / kCh;
  const int steps = 9 * nch;
  __syncthreads();  // the row table
  load_x(0, smem0);
  for (int i = 0; i < kFwdWStages - 1; ++i) {
    if (i < steps) load_w(i, wring + i * kFwdTileBytes);
    cp_async_commit();
  }
  int kc = 0, tap = 0;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<kFwdWStages - 2>();  // step i's tile (and patch) landed
    __syncthreads();  // ... for every thread; step i - 1 is released
    const int nxt = i + kFwdWStages - 1;
    if (nxt < steps) load_w(nxt, wring + (nxt % kFwdWStages) * kFwdTileBytes);
    if (tap == 0 && kc + 1 < nch) {
      load_x(kc + 1, smem0 + ((kc + 1) & 1) * xbytes);
    }
    cp_async_commit();
    const uint32_t xt = smem0 + (kc & 1) * xbytes;
    const uint32_t wt = wring + (i % kFwdWStages) * kFwdTileBytes;
    const int off = (tap / 3) * geo.XW + tap % 3;
#pragma unroll
    for (int kk = 0; kk < kCh / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
      a_rows(a[0], xt, abase[0] + off, kk, lane);
      a_rows(a[1], xt, abase[1] + off, kk, lane);
      b_trans(b[0], wt, kk * 16, 2 * wc, lane);
      b_trans(b[1], wt, kk * 16, 2 * wc + 1, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16(acc[mt][nb], a[mt], b[nb >> 1][(nb & 1) * 2],
                   b[nb >> 1][(nb & 1) * 2 + 1]);
    }
    if (++tap == 9) {
      tap = 0;
      ++kc;
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

  // C fragment: rows pixels (g and g + 8 of each m-tile), columns co (2t,
  // 2t + 1 of each 8-column block)
  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int p = wm * 32 + mt * 16 + gq + 8 * h;
      const int r = p / geo.TW, c = p - r * geo.TW;
      if (r >= geo.TH || t0 + r >= rows_total || c0 + c >= geo.Wo) continue;
      const long long m = static_cast<long long>(t0 + r) * geo.Wo + c0 + c;
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        const int co = co0 + wc * 32 + nb * 8 + 2 * t4;
        if (co < geo.Cout) {
          epi(m, nb, co, sum[mt][nb][2 * h], sum[mt][nb][2 * h + 1]);
        }
      }
    }
  epi.finish(wm, wc, lane, blockIdx.x, co0);
}

__global__ void __launch_bounds__(kFwdThreads, 2)
conv3x3_bn_relu_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const FwdGeom geo, const AffineMmaEpilogue epi) {
  conv3x3_mma_tile(x, w, geo, epi);
}

// B9b: B8's walk with the statistics epilogue; partial row = blockIdx.x
__global__ void __launch_bounds__(kFwdThreads, 2)
conv3x3_train_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const FwdGeom geo, const StatsMmaEpilogue epi) {
  __shared__ float red[2][4][conv_mma::kCh];
  StatsSums st(epi, red);
  conv3x3_mma_tile(x, w, geo, st);
}

// ---------------------------------------------------------------------------
// B7 in bf16: mma.sync on the tensor cores
// ---------------------------------------------------------------------------
// An implicit GEMM on `mma.sync` (conv_mma.cuh's fragments): rows output
// pixels, columns Cout, k = ci. A tile is 128 output pixels x 64 output
// channels, eight warps of 32 pixels x 32 co, as B8. Per chunk of 64 input
// channels, each of the tile's pixels (the sampled pixel at stride 2,
// read in place) is one slot of an x tile and w's [64 ci][64 co] is a B
// tile, both copied with cp.async into swizzled shared memory, zero-filled
// past M, Cin and Cout; A comes through `ldmatrix`, B through
// `ldmatrix.trans`. Each chunk's four k-steps sum on the tensor cores from
// zero and then add into an fp32 register sum (B8's two-level sum). The
// epilogue (`AffineMmaEpilogue::pair`) writes the bf16 tile into a
// staging tile, swizzled, and the CTA stores it as 16-byte row chunks:
// eight lanes write one pixel's 128 bytes. CTA b takes tiles b, b +
// grid, ..., and its (tile, chunk) steps run through one ring of three
// stages. Below three chunks a tile (Cin <= 128) the grid is persistent,
// two CTAs an SM, so that the next tile's copies are in flight while this
// tile is multiplied and stored (at Cin 64 a tile is one chunk); from
// three chunks on, a tile's own chunks fill the ring and each CTA takes
// one tile. Tiles are numbered with the co tile fastest (and a persistent
// grid is a multiple of the co tiles, so a CTA keeps one co tile): the
// CTAs that read one pixel tile run together, x leaves device memory
// once, and L2 serves the other co tiles.
constexpr int k1Threads = 256;   // 8 warps: 4 (32 pixels) x 2 (32 co)
constexpr int k1Pix = 128;       // output pixels a tile holds
constexpr int k1Stages = 3;      // ring of (tile, Cin chunk) steps
constexpr int k1XBytes = k1Pix * conv_mma::kRowBytes;       // 16 KB
constexpr int k1StageBytes = k1XBytes + kFwdTileBytes;       // 24 KB
constexpr int k1Bytes = k1Stages * k1StageBytes + k1XBytes;  // + staging
constexpr int k1PerSM = 2;       // CTAs an SM (__launch_bounds__)

// The epilogue gives each column pair's bf16 bits (`pair`) and is called
// around the staged tile's stores (`staged` after the barrier that
// follows the staging, `stored` after the stores): nothing for B7
// (`conv1x1_bn_relu_mma_kernel`), the channel statistics for B9a
// (`conv1x1_train_mma_kernel`, partial row = the tile's pixel block t /
// nco).
template <class Epilogue>
__device__ __forceinline__ void conv1x1_mma_tile(
    const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
    const Geometry& g, Epilogue& epi, __nv_bfloat16* out,
    int ntiles) {
  using namespace conv_mma;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp & 3, wc = warp >> 2;   // 32 pixel block, 32 co block
  const int nco = (g.Cout + kCh - 1) / kCh;
  const int nch = (g.Cin + kCh - 1) / kCh;
  const int steps =
      (ntiles - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x *
      nch;
  const uint32_t smem0 = smem_u32(smem_raw);
  const uint32_t stage_out = smem0 + k1Stages * k1StageBytes;
  const int cc = tid & 7;
  // stride 1, no padding: output pixel m reads x pixel m
  const bool dense = g.stride == 1 && g.pad_t == 0 && g.pad_l == 0 &&
                     g.Ho == g.H && g.Wo == g.W;

  // the next step to copy: chunk lkc of tile lt (pixels from lm0, co
  // from lco), advanced step by step so that a chunk costs no division
  int lt = blockIdx.x, lkc = 0;
  long long lm0 = static_cast<long long>(lt / nco) * k1Pix;
  int lco = (lt % nco) * kCh;
  // chunk cc (8 channels) of slots tid / 8 + 32 j, each the x pixel its
  // output pixel samples, and w's rows tid / 8 + 32 j; then the cursor on
  auto load_next = [&](uint32_t st) {
    const long long m0 = lm0;
    const int kc = lkc;
    const int ci = kc * kCh + cc * 8;
    const bool ci_ok = ci < g.Cin;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const long long m = m0 + (tid >> 3) + 32 * j;
      bool ok = ci_ok && m < g.M;
      long long px = m;
      if (!dense) {
        const int wo = static_cast<int>(m % g.Wo);
        const long long r = m / g.Wo;
        const int hi = static_cast<int>(r % g.Ho) * g.stride - g.pad_t;
        const int wi = wo * g.stride - g.pad_l;
        ok = ok && hi >= 0 && hi < g.H && wi >= 0 && wi < g.W;
        px = (r / g.Ho * g.H + hi) * g.W + wi;
      }
      copy_chunk(st, (tid >> 3) + 32 * j, cc, ok ? x + px * g.Cin + ci : x,
                 ok);
    }
    const int co = lco + cc * 8;
#pragma unroll
    for (int r = tid >> 3; r < kCh; r += k1Threads / 8) {
      const int ck = kc * kCh + r;
      const bool ok = ck < g.Cin && co < g.Cout;
      copy_chunk(st + k1XBytes, r, cc,
                 ok ? w + static_cast<size_t>(ck) * g.Cout + co : w, ok);
    }
    if (++lkc == nch) {
      lkc = 0;
      lt += gridDim.x;
      lm0 = static_cast<long long>(lt / nco) * k1Pix;
      lco = (lt % nco) * kCh;
    }
  };

  float acc[2][4][4], sum[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nb = 0; nb < 4; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nb][e] = sum[mt][nb][e] = 0.f;

  for (int i = 0; i < k1Stages - 1; ++i) {
    if (i < steps) load_next(smem0 + i * k1StageBytes);
    cp_async_commit();
  }
  const int gq = lane >> 2, t4 = lane & 3;
  int kc = 0, t = blockIdx.x;
  for (int i = 0; i < steps; ++i) {
    cp_async_wait<k1Stages - 2>();  // step i landed
    __syncthreads();  // ... for every thread; step i - 1 and the staging
                      // tile are released
    const int nxt = i + k1Stages - 1;
    if (nxt < steps) load_next(smem0 + (nxt % k1Stages) * k1StageBytes);
    cp_async_commit();
    const uint32_t xt = smem0 + (i % k1Stages) * k1StageBytes;
    const uint32_t wt = xt + k1XBytes;
#pragma unroll
    for (int kk = 0; kk < kCh / 16; ++kk) {
      uint32_t a[2][4], b[2][4];
      a_rows(a[0], xt, wm * 32 + a_row(lane), kk, lane);
      a_rows(a[1], xt, wm * 32 + 16 + a_row(lane), kk, lane);
      b_trans(b[0], wt, kk * 16, 2 * wc, lane);
      b_trans(b[1], wt, kk * 16, 2 * wc + 1, lane);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nb = 0; nb < 4; ++nb)
          mma_bf16(acc[mt][nb], a[mt], b[nb >> 1][(nb & 1) * 2],
                   b[nb >> 1][(nb & 1) * 2 + 1]);
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sum[mt][nb][e] += acc[mt][nb][e];
          acc[mt][nb][e] = 0.f;
        }
    if (++kc < nch) continue;

    // tile t done: C fragment (rows pixels g and g + 8 of each m-tile,
    // columns co 2t, 2t + 1 of each 8-column block) -> the bf16 staging
    // tile [128 pixels][64 co], swizzled: a warp's 32 pairs fill 32 banks
    const long long m0 = static_cast<long long>(t / nco) * k1Pix;
    const int co0 = (t % nco) * kCh;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = wm * 32 + mt * 16 + gq + 8 * h;
#pragma unroll
        for (int nb = 0; nb < 4; ++nb) {
          const int col = wc * 32 + nb * 8 + 2 * t4;
          const uint32_t v = co0 + col < g.Cout
              ? epi.pair(co0 + col, sum[mt][nb][2 * h],
                         sum[mt][nb][2 * h + 1])
              : 0u;
          sum[mt][nb][2 * h] = sum[mt][nb][2 * h + 1] = 0.f;
          asm volatile("st.shared.u32 [%0], %1;\n"
                       :: "r"(stage_out + tile_offset(p, col >> 3) +
                              (col & 7) * 2),
                          "r"(v) : "memory");
        }
      }
    __syncthreads();
    epi.staged(stage_out, m0, g.M, wm, wc, lane);
    // the tile out in 16-byte chunks: lanes 8 r .. 8 r + 7 one pixel's row
#pragma unroll
    for (int j = tid; j < k1Pix * 8; j += k1Threads) {
      const int r = j >> 3, c = j & 7;
      const long long m = m0 + r;
      const int co = co0 + c * 8;
      if (m < g.M && co < g.Cout) {
        uint4 v;
        asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
                     : "r"(stage_out + tile_offset(r, c)));
        *reinterpret_cast<uint4*>(out + m * g.Cout + co) = v;
      }
    }
    epi.stored(t / nco, co0);
    kc = 0;
    t += gridDim.x;
  }
}

__global__ void __launch_bounds__(k1Threads, k1PerSM)
conv1x1_bn_relu_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ w,
                           const Geometry g, const AffineMmaEpilogue epi,
                           int ntiles) {
  conv1x1_mma_tile(x, w, g, epi, epi.out, ntiles);
}

__global__ void __launch_bounds__(k1Threads, k1PerSM)
conv1x1_train_mma_kernel(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ w,
                         const Geometry g, const StatsMmaEpilogue epi,
                         int ntiles) {
  __shared__ float red[2][4][conv_mma::kCh];
  StatsSums st(epi, red);
  conv1x1_mma_tile(x, w, g, st, epi.out, ntiles);
}

// the most image boundaries TH consecutive output rows starting at a
// multiple of TH cross (the starts repeat modulo Ho)
int boundaries(int TH, int Ho) {
  int most = 0;
  for (int k = 0; k < Ho; ++k) {
    const long long t0 = static_cast<long long>(k) * TH;
    most = std::max(most, static_cast<int>((t0 + TH - 1) / Ho - t0 / Ho));
  }
  return most;
}

Geometry geometry(int N, int H, int W, int Cin, int Cout, int Ho, int Wo,
                  int stride, int pad_t, int pad_l) {
  return Geometry{N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l,
                  N * Ho * Wo};
}

dim3 grid_of(const Geometry& g) {
  return dim3((g.M + kBM - 1) / kBM, (g.Cout + kBN - 1) / kBN);
}

template <typename T, int K>
int launch_eval(const void* x, const void* w, const void* scale,
                const void* shift, void* out, const Geometry& g, int relu,
                cudaStream_t stream) {
  const AffineEpilogue<T> epi{static_cast<const float*>(scale),
                              static_cast<const float*>(shift),
                              static_cast<T*>(out), relu};
  void (*kernel)(const T*, const T*, const Geometry, const AffineEpilogue<T>);
  if constexpr (K == 1) {
    kernel = conv1x1_bn_relu_kernel<T>;
  } else {
    kernel = conv3x3_bn_relu_kernel<T>;
  }
  kernel<<<grid_of(g), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), g, epi);
  return static_cast<int>(cudaGetLastError());
}

// B8's tile, which B9b shares: a tile's columns are the whole row, or
// segments whose three patch rows fit a stage; several rows a tile when
// the patch fits too (stride 1 or 2)
FwdGeom fwd_geom(const Geometry& g) {
  const int s = g.stride;
  FwdGeom geo{g.N, g.H, g.W, g.Cin, g.Cout, g.Ho, g.Wo, s, g.pad_t, g.pad_l,
              0, 0, 0, 0, 0};
  geo.TW = std::min({g.Wo, kFwdPix, (kFwdSlots / 3 - 3) / s + 1});
  geo.XW = (geo.TW - 1) * s + 3;
  geo.nseg = (g.Wo + geo.TW - 1) / geo.TW;
  geo.TH = geo.nseg > 1 ? 1 : kFwdPix / geo.TW;
  for (;; --geo.TH) {
    geo.PR = (geo.TH - 1) * s + 3 + boundaries(geo.TH, g.Ho) * (3 - s);
    if (geo.TH == 1 ||
        (geo.PR <= kFwdRows && geo.PR * geo.XW <= kFwdSlots)) {
      break;
    }
  }
  return geo;
}

// the tiles of B8's grid: segments x groups of TH output rows
long long fwd_tiles(const FwdGeom& geo) {
  const long long rows = static_cast<long long>(geo.N) * geo.Ho;
  return geo.nseg * ((rows + geo.TH - 1) / geo.TH);
}

// B8 (affine epilogue) or B9b (statistics) on B8's tile
template <class Epi>
int launch_3x3_mma(void (*kernel)(const __nv_bfloat16*,
                                  const __nv_bfloat16*, const FwdGeom,
                                  const Epi),
                   const void* x, const void* w, const Geometry& g,
                   const Epi& epi, cudaStream_t stream) {
  if (g.stride != 1 && g.stride != 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const FwdGeom geo = fwd_geom(g);
  const int bytes = 2 * geo.PR * geo.XW * conv_mma::kRowBytes +
                    kFwdWStages * kFwdTileBytes;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err) return err;
  const dim3 grid(static_cast<unsigned>(fwd_tiles(geo)),
                  (g.Cout + conv_mma::kCh - 1) / conv_mma::kCh);
  kernel<<<grid, kFwdThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), geo, epi);
  return static_cast<int>(cudaGetLastError());
}

// the pixel tiles of B7's (and B9a's) walk
long long pixel_tiles_1x1(const Geometry& g) {
  return (static_cast<long long>(g.M) + k1Pix - 1) / k1Pix;
}

// B7 (affine epilogue) or B9a (statistics) on B7's walk
template <class Epi>
int launch_1x1_mma(void (*kernel)(const __nv_bfloat16*,
                                  const __nv_bfloat16*, const Geometry,
                                  const Epi, int),
                   const void* x, const void* w, const Geometry& g,
                   const Epi& epi, cudaStream_t stream) {
  int dev = 0, sms = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (!err) {
    err = static_cast<int>(cudaDeviceGetAttribute(
        &sms, cudaDevAttrMultiProcessorCount, dev));
  }
  if (!err) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, k1Bytes));
  }
  if (err) return err;
  // tiles numbered co tile fastest. A tile of fewer chunks than the ring
  // has stages cannot keep its own copies in flight: then the grid is
  // persistent, k1PerSM CTAs an SM, a multiple of the co tiles (one co
  // tile a CTA); else one tile a CTA, and the SMs balance the tail
  const int nco = (g.Cout + conv_mma::kCh - 1) / conv_mma::kCh;
  const int nch = (g.Cin + conv_mma::kCh - 1) / conv_mma::kCh;
  const long long ntiles = pixel_tiles_1x1(g) * nco;
  const int slots = k1PerSM * sms;
  const long long ctas = nch >= k1Stages ? ntiles : std::min<long long>(
      ntiles, slots >= nco ? slots / nco * nco : slots);
  kernel<<<static_cast<unsigned>(ctas), k1Threads, k1Bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), g, epi,
      static_cast<int>(ntiles));
  return static_cast<int>(cudaGetLastError());
}

// the f32 B9a / B9b: the first design, then the tiles' sums
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

// the rows of partial a train launch writes, one per pixel tile of the
// kernel that runs: 128 pixels a tile for f32 (B9's first design) and
// the bf16 1x1 (B7's walk), B8's tile for the bf16 3x3
long long train_tiles(int K, int dtype, const Geometry& g) {
  if (dtype == 0) return grid_of(g).x;
  return K == 1 ? pixel_tiles_1x1(g) : fwd_tiles(fwd_geom(g));
}

bool bad_args(int dtype, int Cin, int Cout) {
  // the wrapper checks shapes, dtypes, contiguity and 16-byte alignment
  return Cin % kBK || Cout % 8 || (dtype != 0 && dtype != 1);
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16. Each returns the launches' cudaError_t.

// B7 / B8: out = relu?(conv(x, w) * scale + shift), NHWC; the bf16 paths
// on the tensor cores
int conv1x1_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, void* out, int dtype, int N, int H,
                    int W, int Cin, int Cout, int Ho, int Wo, int stride,
                    int pad_t, int pad_l, int relu, void* stream) {
  if (bad_args(dtype, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_eval<float, 1>(x, w, scale, shift, out, g, relu, s);
  return launch_1x1_mma(
      conv1x1_bn_relu_mma_kernel, x, w, g,
      AffineMmaEpilogue{static_cast<const float*>(scale),
                        static_cast<const float*>(shift),
                        static_cast<__nv_bfloat16*>(out), Cout, relu}, s);
}

int conv3x3_bn_relu(const void* x, const void* w, const void* scale,
                    const void* shift, void* out, int dtype, int N, int H,
                    int W, int Cin, int Cout, int Ho, int Wo, int stride,
                    int pad_t, int pad_l, int relu, void* stream) {
  if (bad_args(dtype, Cin, Cout)) return static_cast<int>(cudaErrorInvalidValue);
  const Geometry g = geometry(N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_eval<float, 3>(x, w, scale, shift, out, g, relu, s);
  return launch_3x3_mma(
      conv3x3_bn_relu_mma_kernel, x, w, g,
      AffineMmaEpilogue{static_cast<const float*>(scale),
                        static_cast<const float*>(shift),
                        static_cast<__nv_bfloat16*>(out), Cout, relu}, s);
}

// B9a (K 1) / B9b (K 3): out = conv(x, w) in x's dtype, NHWC; sums
// [2, Cout] fp32 of out and out^2; partial: fp32 scratch [partial_rows, 2,
// Cout], at least one row per pixel tile of the kernel that runs
// (`train_tiles`; the wrapper sizes it with ops/conv.py
// `conv_train_partial_rows`); a smaller buffer is refused. The bf16 paths
// on the tensor cores, stride 1 or 2.
int conv_train(const void* x, const void* w, void* out, void* partial,
               void* sums, int partial_rows, int K, int dtype, int N, int H,
               int W, int Cin, int Cout, int Ho, int Wo, int stride,
               int pad_t, int pad_l, void* stream) {
  if (bad_args(dtype, Cin, Cout) || (K != 1 && K != 3) ||
      (dtype == 1 && stride != 1 && stride != 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geometry g = geometry(N, H, W, Cin, Cout, Ho, Wo, stride, pad_t, pad_l);
  const long long tiles = train_tiles(K, dtype, g);
  if (partial_rows < tiles) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_train<float>(K, x, w, out, partial, sums, g, s);
  }
  const StatsMmaEpilogue epi{static_cast<__nv_bfloat16*>(out),
                             static_cast<float*>(partial), Cout};
  const int err = K == 1
      ? launch_1x1_mma(conv1x1_train_mma_kernel, x, w, g, epi, s)
      : launch_3x3_mma(conv3x3_train_mma_kernel, x, w, g, epi, s);
  if (err) return err;
  return sum_rows(static_cast<const float*>(partial),
                  static_cast<float*>(sums), static_cast<int>(tiles),
                  2LL * Cout, s);
}

}  // extern "C"
