// The optimizer update as one pass, for Hopper (sm_90a).
//
// Replaces: the JAX package's optimizer step, one jitted and donated XLA
// program over every parameter (paddle_tpu/optimizer/optimizer.py
// `update_all`), in which XLA fuses each parameter's `_single_update` into
// one pass over its bytes. It has no Pallas kernel. The port's per-parameter
// loop (paddle_tpu_torch/optimizer/optimizers.py `_single_update`) stays as
// the plain version; wrapper: paddle_tpu_torch/ops/optimizer_update.py
// (`optimizer_update`, `optimizer_norms`).
//
// What it computes, for every element of every parameter of one dtype on
// one card, in one launch: the `_single_update` of AdamW, Adam, Momentum,
// SGD, Adagrad, RMSProp (centered or not), Adadelta, Lars or Lamb, op for
// op as the loop's PyTorch ops round them, so the elementwise rules give
// the loop's bits. Each op is written with an IEEE-rounded intrinsic
// (`__fmul_rn`, `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`, `__fsqrt_rn`), so
// nvcc contracts nothing into an FMA; a Python scalar enters as PyTorch
// casts it, to fp32; a tensor divided by a Python scalar is PyTorch's
// multiply by the scalar's fp32 reciprocal, taken on the host (`inv_c1`,
// `inv_c2`, from the bias corrections 1 - beta^t that the host takes in
// fp32). The parameter is read and written in its own dtype (fp32 or bf16,
// rounded to nearest even), the grad read in the parameter's dtype, the
// accumulators read and written once, in fp32, or for Adam and AdamW with
// `multi_precision=False` in bf16 (then `beta * moment` takes beta rounded
// to bf16 and rounds the product to bf16, as PyTorch multiplies two bf16
// tensors and as the JAX package's weakly typed scalar rounds).
//
// A table in device memory (table_walk.cuh) lists the parameters: per
// row, the pointers of p, g and the first two accumulators, the element
// count, the first block of the parameter in the grid, its decay (AdamW's
// and Lars' per-parameter decay, as fp32 bits) and the third accumulator
// (centered RMSProp's mean_grad). The host uploads it in one copy a step: the grads are new
// tensors every step. Each block finds its row by a binary search over the
// first blocks and updates kChunk consecutive elements, kUnroll of them a
// thread with every load issued before any arithmetic.
//
// Lars and Lamb scale a parameter's step by norms over the whole parameter
// (||p|| and ||g||, or ||p|| and ||r|| with Lamb's r = mhat / (sqrt(vhat) +
// eps) + wd * p). Those take two launches before the update, without
// atomics: `optimizer_norms_kernel` writes each block's two sums of squares
// to a scratch row, and `optimizer_norms_reduce_kernel`, one CTA a
// parameter, sums its blocks' rows in a fixed order and takes the square
// roots. Every sum runs in a fixed order (each thread's elements in turn,
// xor shuffles within a warp, the warps in turn), so the norms are the same
// bits from run to run; the order is not torch.sum's, so Lars and Lamb
// agree with the loop to rounding, not to the bit. Lamb's r is rebuilt
// from the old moments in both the norm pass and the update, by the same
// code, so both see the same bits.
//
// Bound on this card: bytes. AdamW reads p and g (2 + 2 bytes in bf16) and
// m, v (4 + 4) and writes p, m, v (2 + 4 + 4): 22 bytes a bf16 parameter;
// Momentum, Lars 14, SGD 6, Adagrad 14, RMSProp and Adadelta 22, centered
// RMSProp 30, AdamW with bf16 moments 14, Lamb 22 (and its norm pass reads
// 12 more). GPT-1.3B's 1,279,905,792 parameters take 28.16 GB under AdamW,
// 8.41 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "table_walk.cuh"

namespace {

using namespace table_walk;

constexpr int kHyper = 13;  // floats of Hyper, in order

enum Kind {
  kAdamW = 0, kAdam = 1, kMomentum = 2, kSgd = 3, kAdagrad = 4,
  kRmsprop = 5, kAdadelta = 6, kLars = 7, kLamb = 8
};

struct Hyper {
  float b1, omb1, b2, omb2;   // beta1, 1 - beta1, beta2, 1 - beta2 (fp32)
  float inv_c1, inv_c2;       // 1 / (1 - beta^t) in fp32
  float eps, lr, mom, wd;     // wd: the L2 term (Lamb: its decay)
  float rho, omrho, coeff;    // RMSProp's, Adadelta's rho; Lars' coeff
  int flag;                   // Momentum: Nesterov; RMSProp: centered
};

// the accumulators a rule reads and writes (centered RMSProp a third)
__host__ __device__ constexpr int num_acc(int kind) {
  return kind == kSgd ? 0
         : (kind == kMomentum || kind == kAdagrad || kind == kLars) ? 1
                                                                    : 2;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// beta * a for an accumulator of type A: fp32 takes beta in fp32; bf16
// takes beta rounded to bf16, and the product is rounded to bf16
__device__ __forceinline__ float decayed(float beta, float a, float) {
  return __fmul_rn(beta, a);
}
__device__ __forceinline__ float decayed(float beta, float a,
                                         __nv_bfloat16) {
  return round_bf16(__fmul_rn(round_bf16(beta), a));
}

// Adam's new moments m, v (from the old ones, in place) and their bias-
// corrected values
template <typename A>
__device__ __forceinline__ void adam_moments(const Hyper& h, float g,
                                             float& m, float& v,
                                             float& mhat, float& vhat) {
  m = __fadd_rn(decayed(h.b1, m, A()), __fmul_rn(h.omb1, g));
  v = __fadd_rn(decayed(h.b2, v, A()), __fmul_rn(h.omb2, __fmul_rn(g, g)));
  mhat = __fmul_rn(m, h.inv_c1);
  vhat = __fmul_rn(v, h.inv_c2);
}

// Lamb's r = mhat / (sqrt(vhat) + eps) + wd * p, with the new moments
// left in m and v
__device__ __forceinline__ float lamb_r(const Hyper& h, float pf, float g,
                                        float& m, float& v) {
  float mhat, vhat;
  adam_moments<float>(h, g, m, v, mhat, vhat);
  return __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), h.eps)),
                   __fmul_rn(h.wd, pf));
}

// The block's sums of (x, y) over its threads, in a fixed order, on
// thread 0: xor shuffles within each warp, then the warps in turn.
__device__ __forceinline__ void block_sum2(float& x, float& y) {
  __shared__ float s_x[kThreads / 32], s_y[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, o));
    y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, o));
  }
  const int warp = threadIdx.x / 32;
  if ((threadIdx.x & 31) == 0) {
    s_x[warp] = x;
    s_y[warp] = y;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    x = s_x[0];
    y = s_y[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      x = __fadd_rn(x, s_x[w]);
      y = __fadd_rn(y, s_y[w]);
    }
  }
}

// grid (total blocks), block kThreads. T: parameter and grad; A: the
// accumulators (bf16 for Adam and AdamW without multi-precision only).
// norms: Lars' and Lamb's two norms a row, from the norm pass.
template <typename T, typename A, int KIND>
__global__ void __launch_bounds__(kThreads) optimizer_update_kernel(
    const long long* __restrict__ table, int n, Hyper h,
    const float* __restrict__ norms) {
  constexpr int NA = num_acc(KIND);
  const Span s = find_span(table, n);
  const long long* row = s.row;
  const int r = s.r;
  T* __restrict__ p = reinterpret_cast<T*>(row[0]);
  const T* __restrict__ g = reinterpret_cast<const T*>(row[1]);
  A* __restrict__ a0 = reinterpret_cast<A*>(row[2]);
  A* __restrict__ a1 = reinterpret_cast<A*>(row[3]);
  A* __restrict__ a2 = reinterpret_cast<A*>(row[7]);
  const long long numel = s.numel, start = s.start;
  const float decay = __int_as_float(static_cast<int>(row[kWord]));
  const bool third = KIND == kRmsprop && h.flag;
  float n0 = 0.f, n1 = 0.f;
  if (KIND == kLars || KIND == kLamb) {
    n0 = norms[2 * r];
    n1 = norms[2 * r + 1];
  }

  float pv[kUnroll], gv[kUnroll], av[kUnroll], cv[kUnroll], ev[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i < numel) {
      pv[u] = load_f(p, i);
      gv[u] = load_f(g, i);
      if (NA > 0) av[u] = load_f(a0, i);
      if (NA > 1) cv[u] = load_f(a1, i);
      if (third) ev[u] = load_f(a2, i);
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i >= numel) continue;
    const float pf = pv[u];
    float gr = gv[u];
    float pn;
    // the L2 term of a float weight_decay: g + wd * p
    if ((KIND == kAdam || KIND == kMomentum || KIND == kSgd ||
         KIND == kAdagrad || KIND == kRmsprop || KIND == kAdadelta) &&
        h.wd != 0.f)
      gr = __fadd_rn(gr, __fmul_rn(h.wd, pf));
    if (KIND == kMomentum) {
      // v = momentum * v + g; p - lr * (v, or g + momentum * v)
      const float vn = __fadd_rn(__fmul_rn(h.mom, av[u]), gr);
      const float upd = h.flag ? __fadd_rn(gr, __fmul_rn(h.mom, vn)) : vn;
      pn = __fsub_rn(pf, __fmul_rn(h.lr, upd));
      av[u] = vn;
    } else if (KIND == kSgd) {
      pn = __fsub_rn(pf, __fmul_rn(h.lr, gr));
    } else if (KIND == kAdagrad) {
      // moment += g^2; p - lr * g / (sqrt(moment) + eps)
      const float mom = __fadd_rn(av[u], __fmul_rn(gr, gr));
      pn = __fsub_rn(pf, __fdiv_rn(__fmul_rn(h.lr, gr),
                                   __fadd_rn(__fsqrt_rn(mom), h.eps)));
      av[u] = mom;
    } else if (KIND == kRmsprop) {
      // ms = rho ms + (1 - rho) g^2; centered: mg likewise on g and
      // sqrt(ms - mg^2 + eps), else sqrt(ms + eps); the momentum buffer
      // mom * buf + lr * g / denom is subtracted from p
      const float ms = __fadd_rn(__fmul_rn(h.rho, av[u]),
                                 __fmul_rn(h.omrho, __fmul_rn(gr, gr)));
      float den;
      if (third) {
        const float mg = __fadd_rn(__fmul_rn(h.rho, ev[u]),
                                   __fmul_rn(h.omrho, gr));
        den = __fsqrt_rn(__fadd_rn(__fsub_rn(ms, __fmul_rn(mg, mg)), h.eps));
        ev[u] = mg;
      } else {
        den = __fsqrt_rn(__fadd_rn(ms, h.eps));
      }
      const float mom = __fadd_rn(__fmul_rn(h.mom, cv[u]),
                                  __fdiv_rn(__fmul_rn(h.lr, gr), den));
      pn = __fsub_rn(pf, mom);
      av[u] = ms;
      cv[u] = mom;
    } else if (KIND == kAdadelta) {
      // asg = rho asg + (1 - rho) g^2; upd = g sqrt(asu + eps) /
      // sqrt(asg + eps); asu = rho asu + (1 - rho) upd^2; p - lr upd
      const float asg = __fadd_rn(__fmul_rn(h.rho, av[u]),
                                  __fmul_rn(h.omrho, __fmul_rn(gr, gr)));
      const float upd =
          __fdiv_rn(__fmul_rn(gr, __fsqrt_rn(__fadd_rn(cv[u], h.eps))),
                    __fsqrt_rn(__fadd_rn(asg, h.eps)));
      const float asu = __fadd_rn(__fmul_rn(h.rho, cv[u]),
                                  __fmul_rn(h.omrho, __fmul_rn(upd, upd)));
      pn = __fsub_rn(pf, __fmul_rn(h.lr, upd));
      av[u] = asg;
      cv[u] = asu;
    } else if (KIND == kLars) {
      // local_lr = coeff ||p|| / (||g|| + decay ||p|| + eps) where both
      // norms are positive, else 1; v = momentum v + (lr local_lr) (g +
      // decay p); p - v
      const float ll =
          (n0 > 0.f && n1 > 0.f)
              ? __fdiv_rn(__fmul_rn(h.coeff, n0),
                          __fadd_rn(__fadd_rn(n1, __fmul_rn(decay, n0)),
                                    h.eps))
              : 1.f;
      const float vn = __fadd_rn(
          __fmul_rn(h.mom, av[u]),
          __fmul_rn(__fmul_rn(h.lr, ll), __fadd_rn(gr, __fmul_rn(decay, pf))));
      pn = __fsub_rn(pf, vn);
      av[u] = vn;
    } else if (KIND == kLamb) {
      // trust = ||p|| / ||r|| where both are positive, else 1;
      // p - (lr trust) r
      const float rr = lamb_r(h, pf, gr, av[u], cv[u]);
      const float trust = (n0 > 0.f && n1 > 0.f) ? __fdiv_rn(n0, n1) : 1.f;
      pn = __fsub_rn(pf, __fmul_rn(__fmul_rn(h.lr, trust), rr));
    } else {
      float mhat, vhat;
      adam_moments<A>(h, gr, av[u], cv[u], mhat, vhat);
      const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
      if (KIND == kAdamW) {
        // p - lr * (mhat / (sqrt(vhat) + eps) + decay * p)
        const float upd = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(decay, pf));
        pn = __fsub_rn(pf, __fmul_rn(h.lr, upd));
      } else {
        // p - lr * mhat / (sqrt(vhat) + eps)
        pn = __fsub_rn(pf, __fdiv_rn(__fmul_rn(h.lr, mhat), den));
      }
    }
    pv[u] = pn;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i < numel) {
      store_t(p, i, pv[u]);
      if (NA > 0) store_t(a0, i, av[u]);
      if (NA > 1) store_t(a1, i, cv[u]);
      if (third) store_t(a2, i, ev[u]);
    }
  }
}

// Pass 1 of Lars' and Lamb's norms. grid (total blocks), block kThreads:
// each block's sums of p^2 and of g^2 (Lars) or r^2 (Lamb) over its
// elements, into partials[2 b], partials[2 b + 1].
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads) optimizer_norms_kernel(
    const long long* __restrict__ table, int n, Hyper h,
    float* __restrict__ partials) {
  const Span s = find_span(table, n);
  const long long* row = s.row;
  const T* __restrict__ p = reinterpret_cast<const T*>(row[0]);
  const T* __restrict__ g = reinterpret_cast<const T*>(row[1]);
  const float* __restrict__ m = reinterpret_cast<const float*>(row[2]);
  const float* __restrict__ v = reinterpret_cast<const float*>(row[3]);
  const long long numel = s.numel, start = s.start;

  float pv[kUnroll], gv[kUnroll], mv[kUnroll], vv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i < numel) {
      pv[u] = load_f(p, i);
      gv[u] = load_f(g, i);
      if (KIND == kLamb) {
        mv[u] = m[i];
        vv[u] = v[i];
      }
    }
  }
  float sw = 0.f, sx = 0.f;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i >= numel) continue;
    const float x = KIND == kLamb ? lamb_r(h, pv[u], gv[u], mv[u], vv[u])
                                  : gv[u];
    sw = __fadd_rn(sw, __fmul_rn(pv[u], pv[u]));
    sx = __fadd_rn(sx, __fmul_rn(x, x));
  }
  block_sum2(sw, sx);
  if (threadIdx.x == 0) {
    const long long b = blockIdx.x;
    partials[2 * b] = sw;
    partials[2 * b + 1] = sx;
  }
}

// Pass 2. grid (rows), block kThreads: each parameter's partial sums in
// order of its blocks, then the two square roots into norms[2 r], [2 r + 1].
__global__ void __launch_bounds__(kThreads) optimizer_norms_reduce_kernel(
    const long long* __restrict__ table, const float* __restrict__ partials,
    float* __restrict__ norms) {
  const int r = blockIdx.x;
  const long long* row = table + static_cast<long long>(r) * kRow;
  const long long first = row[kFirst];
  const long long nb = (row[kNumel] + kChunk - 1) / kChunk;
  float sw = 0.f, sx = 0.f;
  for (long long j = threadIdx.x; j < nb; j += kThreads) {
    sw = __fadd_rn(sw, partials[2 * (first + j)]);
    sx = __fadd_rn(sx, partials[2 * (first + j) + 1]);
  }
  block_sum2(sw, sx);
  if (threadIdx.x == 0) {
    norms[2 * r] = __fsqrt_rn(sw);
    norms[2 * r + 1] = __fsqrt_rn(sx);
  }
}

template <typename T, typename A, int KIND>
int launch_update(const long long* t, int n, long long blocks,
                  const Hyper& h, const float* norms, cudaStream_t st) {
  optimizer_update_kernel<T, A, KIND><<<blocks, kThreads, 0, st>>>(t, n, h,
                                                                   norms);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_kind(const long long* t, int n, long long blocks, int kind,
                int bf16_acc, const Hyper& h, const float* norms,
                cudaStream_t st) {
  using F = float;
  if (bf16_acc) {
    // moments in the parameter's dtype: Adam and AdamW on bf16 only
    if (kind == kAdamW)
      return launch_update<T, __nv_bfloat16, kAdamW>(t, n, blocks, h, norms,
                                                     st);
    if (kind == kAdam)
      return launch_update<T, __nv_bfloat16, kAdam>(t, n, blocks, h, norms,
                                                    st);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (kind) {
    case kAdamW: return launch_update<T, F, kAdamW>(t, n, blocks, h, norms, st);
    case kAdam: return launch_update<T, F, kAdam>(t, n, blocks, h, norms, st);
    case kMomentum:
      return launch_update<T, F, kMomentum>(t, n, blocks, h, norms, st);
    case kSgd: return launch_update<T, F, kSgd>(t, n, blocks, h, norms, st);
    case kAdagrad:
      return launch_update<T, F, kAdagrad>(t, n, blocks, h, norms, st);
    case kRmsprop:
      return launch_update<T, F, kRmsprop>(t, n, blocks, h, norms, st);
    case kAdadelta:
      return launch_update<T, F, kAdadelta>(t, n, blocks, h, norms, st);
    case kLars: return launch_update<T, F, kLars>(t, n, blocks, h, norms, st);
    case kLamb: return launch_update<T, F, kLamb>(t, n, blocks, h, norms, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int launch_norms(const long long* t, int n, long long blocks, int kind,
                 const Hyper& h, float* partials, float* norms,
                 cudaStream_t st) {
  if (kind == kLars)
    optimizer_norms_kernel<T, kLars><<<blocks, kThreads, 0, st>>>(t, n, h,
                                                                  partials);
  else if (kind == kLamb)
    optimizer_norms_kernel<T, kLamb><<<blocks, kThreads, 0, st>>>(t, n, h,
                                                                  partials);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  int err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  optimizer_norms_reduce_kernel<<<n, kThreads, 0, st>>>(t, partials, norms);
  return static_cast<int>(cudaGetLastError());
}

Hyper make_hyper(const float* f, int flag) {
  return Hyper{f[0], f[1], f[2],  f[3],  f[4],  f[5],  f[6],
               f[7], f[8], f[9], f[10], f[11], f[12], flag};
}

}  // namespace

// The block size the host sizes the table by: elements a block updates.
extern "C" int optimizer_update_chunk() { return kChunk; }

// The number of floats `hyper` holds, in Hyper's order.
extern "C" int optimizer_update_hyper() { return kHyper; }

// table: n rows of kRow int64 on the card (table_walk.cuh: p, g, acc1,
// acc2 pointers; numel; first block; decay as fp32 bits; acc3 pointer),
// rows in order of first block, each numel > 0; blocks: the grid, the sum of ceil(numel / chunk).
// kind: 0 AdamW, 1 Adam, 2 Momentum, 3 SGD, 4 Adagrad, 5 RMSProp, 6
// Adadelta, 7 Lars, 8 Lamb; dtype: 0 float32, 1 bfloat16 (p and g);
// bf16_acc: the accumulators are bfloat16 (Adam, AdamW on bfloat16); hyper:
// kHyper floats on the host; flag: Nesterov or centered; norms: Lars' and
// Lamb's two norms a row on the card (from optimizer_norms), else null.
// Returns the launch's cudaError_t (0 on success).
extern "C" int optimizer_update(const void* table, int n, long long blocks,
                                int kind, int dtype, int bf16_acc,
                                const float* hyper, int flag,
                                const void* norms, void* stream) {
  if (bad_grid(n, blocks) ||
      ((kind == kLars || kind == kLamb) && norms == nullptr) ||
      (bf16_acc && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h = make_hyper(hyper, flag);
  const long long* t = static_cast<const long long*>(table);
  const float* nm = static_cast<const float*>(norms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_kind<float>(t, n, blocks, kind, 0, h, nm, st);
  if (dtype == 1)
    return launch_kind<__nv_bfloat16>(t, n, blocks, kind, bf16_acc, h, nm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Lars' (kind 7) or Lamb's (kind 8) norms over the same table: partials,
// 2 * blocks floats of scratch on the card; norms, 2 * n floats on the card
// (||p|| and ||g|| or ||r|| a row). Two launches; returns the first
// failure's cudaError_t (0 on success).
extern "C" int optimizer_norms(const void* table, int n, long long blocks,
                               int kind, int dtype, const float* hyper,
                               void* partials, void* norms, void* stream) {
  if (bad_grid(n, blocks)) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h = make_hyper(hyper, 0);
  const long long* t = static_cast<const long long*>(table);
  float* pa = static_cast<float*>(partials);
  float* nm = static_cast<float*>(norms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_norms<float>(t, n, blocks, kind, h, pa, nm, st);
  if (dtype == 1)
    return launch_norms<__nv_bfloat16>(t, n, blocks, kind, h, pa, nm, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
