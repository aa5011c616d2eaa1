// The optimizer update as one pass, for Hopper (sm_90a).
//
// Replaces: the JAX package's optimizer step, one jitted and donated XLA
// program over every parameter (paddle_tpu/optimizer/optimizer.py
// `update_all`), in which XLA fuses each parameter's `_single_update` into
// one pass over its bytes. It has no Pallas kernel. The port's per-parameter
// loop (paddle_tpu_torch/optimizer/optimizers.py `_single_update`) stays as
// the plain version; wrapper: paddle_tpu_torch/ops/optimizer_update.py
// (`optimizer_update`).
//
// What it computes, for every element of every parameter of one dtype on
// one card, in one launch: AdamW, Adam or Momentum's `_single_update`, op
// for op as the loop's PyTorch ops round them, so the result is the loop's
// bits. Each op is written with an IEEE-rounded intrinsic (`__fmul_rn`,
// `__fadd_rn`, `__fsub_rn`, `__fdiv_rn`, `__fsqrt_rn`), so nvcc contracts
// nothing into an FMA; a Python scalar enters as PyTorch casts it, to
// fp32; a tensor divided by a Python scalar is PyTorch's multiply by the
// scalar's fp32 reciprocal, taken on the host (`inv_c1`, `inv_c2`, from
// the bias corrections 1 - beta^t that the host takes in fp32). The
// parameter is read and written in its own dtype (fp32 or bf16, rounded
// to nearest even), the grad read in the parameter's dtype, the fp32
// accumulators read and written once.
//
// A table in device memory lists the parameters: per row, the pointers of
// p, g and the two accumulators (Momentum's velocity, Adam's moments), the
// element count, the first block of the parameter in the grid and its
// decay (AdamW's per-parameter decay, as fp32 bits). The host uploads it
// in one copy a step: the grads are new tensors every step. Each block
// finds its row by a binary search over the first blocks and updates
// kChunk consecutive elements, kUnroll of them a thread with every load
// issued before any arithmetic.
//
// Bound on this card: bytes. AdamW reads p and g (2 + 2 bytes in bf16) and
// m, v (4 + 4) and writes p, m, v (2 + 4 + 4): 22 bytes a bf16 parameter;
// Momentum 14. GPT-1.3B's 1,279,905,792 parameters take 28.16 GB, 8.41 ms
// at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;
constexpr int kChunk = kThreads * kUnroll;  // elements a block
constexpr int kRow = 8;                     // int64 entries a table row

enum Kind { kAdamW = 0, kAdam = 1, kMomentum = 2 };

struct Hyper {
  float b1, omb1, b2, omb2;   // beta1, 1 - beta1, beta2, 1 - beta2 (fp32)
  float inv_c1, inv_c2;       // 1 / (1 - beta^t) in fp32
  float eps, lr, mom, wd;     // Adam's / Momentum's wd: the L2 term
  int nesterov;
};

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

// grid (total blocks), block kThreads
template <typename T, int KIND>
__global__ void __launch_bounds__(kThreads) optimizer_update_kernel(
    const long long* __restrict__ table, int n, Hyper h) {
  __shared__ int s_row;
  const long long b = blockIdx.x;
  if (threadIdx.x == 0) {
    int lo = 0, hi = n - 1;  // the last row whose first block <= b
    while (lo < hi) {
      const int mid = (lo + hi + 1) / 2;
      if (table[mid * kRow + 5] <= b) lo = mid; else hi = mid - 1;
    }
    s_row = lo;
  }
  __syncthreads();
  const long long* row = table + static_cast<long long>(s_row) * kRow;
  T* __restrict__ p = reinterpret_cast<T*>(row[0]);
  const T* __restrict__ g = reinterpret_cast<const T*>(row[1]);
  float* __restrict__ a = reinterpret_cast<float*>(row[2]);
  float* __restrict__ c = reinterpret_cast<float*>(row[3]);
  const long long numel = row[4];
  const long long start = (b - row[5]) * kChunk + threadIdx.x;
  const float decay = __int_as_float(static_cast<int>(row[6]));

  float pv[kUnroll], gv[kUnroll], av[kUnroll], cv[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i < numel) {
      pv[u] = load_f(p, i);
      gv[u] = load_f(g, i);
      av[u] = a[i];
      if (KIND != kMomentum) cv[u] = c[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i >= numel) continue;
    const float pf = pv[u];
    float gr = gv[u];
    float pn;
    if (KIND == kMomentum) {
      // g + wd * p; v = momentum * v + g; p - lr * (v, or g + momentum * v)
      if (h.wd != 0.f) gr = __fadd_rn(gr, __fmul_rn(h.wd, pf));
      const float vn = __fadd_rn(__fmul_rn(h.mom, av[u]), gr);
      const float upd = h.nesterov ? __fadd_rn(gr, __fmul_rn(h.mom, vn)) : vn;
      pn = __fsub_rn(pf, __fmul_rn(h.lr, upd));
      av[u] = vn;
    } else {
      if (KIND == kAdam && h.wd != 0.f)
        gr = __fadd_rn(gr, __fmul_rn(h.wd, pf));
      const float m = __fadd_rn(__fmul_rn(h.b1, av[u]), __fmul_rn(h.omb1, gr));
      const float v = __fadd_rn(__fmul_rn(h.b2, cv[u]),
                                __fmul_rn(h.omb2, __fmul_rn(gr, gr)));
      const float mhat = __fmul_rn(m, h.inv_c1);
      const float vhat = __fmul_rn(v, h.inv_c2);
      const float den = __fadd_rn(__fsqrt_rn(vhat), h.eps);
      if (KIND == kAdamW) {
        // p - lr * (mhat / (sqrt(vhat) + eps) + decay * p)
        const float upd = __fadd_rn(__fdiv_rn(mhat, den), __fmul_rn(decay, pf));
        pn = __fsub_rn(pf, __fmul_rn(h.lr, upd));
      } else {
        // p - lr * mhat / (sqrt(vhat) + eps)
        pn = __fsub_rn(pf, __fdiv_rn(__fmul_rn(h.lr, mhat), den));
      }
      av[u] = m;
      cv[u] = v;
    }
    pv[u] = pn;
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = start + u * kThreads;
    if (i < numel) {
      store_t(p, i, pv[u]);
      a[i] = av[u];
      if (KIND != kMomentum) c[i] = cv[u];
    }
  }
}

template <typename T>
int launch(const long long* table, int n, long long blocks, int kind,
           const Hyper& h, cudaStream_t st) {
  if (kind == kAdamW)
    optimizer_update_kernel<T, kAdamW><<<blocks, kThreads, 0, st>>>(table, n,
                                                                    h);
  else if (kind == kAdam)
    optimizer_update_kernel<T, kAdam><<<blocks, kThreads, 0, st>>>(table, n,
                                                                   h);
  else if (kind == kMomentum)
    optimizer_update_kernel<T, kMomentum><<<blocks, kThreads, 0, st>>>(
        table, n, h);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The block size the host sizes the table by: elements a block updates.
extern "C" int optimizer_update_chunk() { return kChunk; }

// table: n rows of 8 int64 on the card (p, g, acc1, acc2 pointers; numel;
// first block; decay as fp32 bits; unused), rows in order of first block,
// each numel > 0; blocks: the grid, the sum of ceil(numel / chunk). kind:
// 0 AdamW, 1 Adam, 2 Momentum; dtype: 0 float32, 1 bfloat16 (p and g).
// Returns the launch's cudaError_t (0 on success).
extern "C" int optimizer_update(const void* table, int n, long long blocks,
                                int kind, int dtype, float b1, float omb1,
                                float b2, float omb2, float inv_c1,
                                float inv_c2, float eps, float lr, float mom,
                                float wd, int nesterov, void* stream) {
  if (n <= 0 || blocks <= 0 || blocks > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, inv_c1, inv_c2, eps, lr, mom, wd,
                nesterov};
  const long long* t = static_cast<const long long*>(table);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(t, n, blocks, kind, h, st);
  if (dtype == 1) return launch<__nv_bfloat16>(t, n, blocks, kind, h, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
