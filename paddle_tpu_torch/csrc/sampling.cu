// Per-row draws of the sampler, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package draws inside its compiled
// decode and verify programs (paddle_tpu/ops/sampling.py
// `_draw_categorical`, `_draw_uniform`), where XLA fuses jax.random's
// threefry hashes, the Gumbel and the argmax into the step. Eager PyTorch
// would run each of those as its own launch: a threefry hash is some
// hundred elementwise ops. These two kernels are the fused draws.
// Wrappers and plain versions: paddle_tpu_torch/ops/sampling.py and
// paddle_tpu_torch/ops/threefry.py.
//
// - sample_draw_kernel: one CTA a row of the masked fp32 logits [N, V].
//   Every thread derives the row's key fold_in(fold_in(key, pos), salt) in
//   registers (two hashes), then walks the vocabulary at a stride of the
//   block: the hash of (0, v) gives jax's partitionable bits (b1 ^ b2), the
//   bits its uniform on [tiny, 1), the uniform the "low" Gumbel -log(-log
//   u), plus the logit (-inf at the row's excluded index). Each thread
//   keeps its best (value, index); a warp reduces with shuffles, the warps
//   through shared memory, in a fixed order and with no atomic: the
//   larger value wins, the lower index on a tie (jnp.argmax's rule), a NaN
//   above every number.
// - sample_uniform_kernel: one thread a row: the hash of (0, 0) under the
//   row's key, jax.random.uniform's f32 on [0, 1).
//
// Arithmetic: uint32 adds, xors and rotations are exact; the uniform is
// built from bits and its affine step is a correctly rounded multiply and
// add (__fmul_rn, __fadd_rn, so nvcc contracts nothing); the logs are
// logf (the flags have no fast-math), as torch's log on the card. So the
// kernel's Gumbel values are the plain version's bits on the card and its
// tokens the plain version's.
//
// Bound on this card: bytes, the logits read once (4 N V bytes: 0.48 us at
// N 8 and 2.40 us at N 40, V 50,304, at 3.35 TB/s); integer work has no
// peak in that table. The hashes are ~130 integer ops a vocab entry, about
// 52 M at N 8: a few microseconds at the SMs' integer rate if every SM
// took a share, but one CTA a row puts the work on N of 132 SMs, so the
// first design is latency-bound there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1.17549435e-38f;   // FLT_MIN, jax's Gumbel minval

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// Threefry-2x32, 20 rounds (jax's _threefry2x32_lowering).
__device__ __forceinline__ void threefry2x32(uint32_t k1, uint32_t k2,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
}

// fold_in(key, data): the hash of (0, data); the key is replaced.
__device__ __forceinline__ void fold_in(uint32_t& k1, uint32_t& k2,
                                        uint32_t data) {
  uint32_t a = 0u, b = data;
  threefry2x32(k1, k2, a, b);
  k1 = a;
  k2 = b;
}

__device__ __forceinline__ void row_key(const long long* key_rows,
                                        const int* positions, int salt,
                                        int row, uint32_t& k1,
                                        uint32_t& k2) {
  k1 = static_cast<uint32_t>(key_rows[2 * row]);
  k2 = static_cast<uint32_t>(key_rows[2 * row + 1]);
  fold_in(k1, k2, static_cast<uint32_t>(positions[row]));
  fold_in(k1, k2, static_cast<uint32_t>(salt));
}

// jax.random.uniform's f32 from 32 random bits, on [minval, 1).
__device__ __forceinline__ float uniform_of(uint32_t bits, float minval) {
  const float u = __fsub_rn(__uint_as_float((bits >> 9) | 0x3F800000u),
                            1.0f);
  return fmaxf(minval,
               __fadd_rn(__fmul_rn(u, __fsub_rn(1.0f, minval)), minval));
}

// (value, index) b beats a: larger value, lower index on a tie, NaN first.
__device__ __forceinline__ bool beats(float bv, int bi, float av, int ai) {
  const bool bn = isnan(bv), an = isnan(av);
  if (bn || an) return bn && (!an || bi < ai);
  return bv > av || (bv == av && bi < ai);
}

__global__ void __launch_bounds__(kThreads) sample_draw_kernel(
    const float* __restrict__ logits, const long long* __restrict__ key_rows,
    const int* __restrict__ positions, const int* __restrict__ exclude,
    int salt, int V, int* __restrict__ out) {
  const int row = blockIdx.x;
  uint32_t k1, k2;
  row_key(key_rows, positions, salt, row, k1, k2);
  const int skip = exclude ? exclude[row] : -1;
  const float* lg = logits + static_cast<long long>(row) * V;
  float best = -INFINITY;
  int arg = 0x7FFFFFFF;
  for (int v = threadIdx.x; v < V; v += kThreads) {
    uint32_t a = 0u, b = static_cast<uint32_t>(v);
    threefry2x32(k1, k2, a, b);
    const float u = uniform_of(a ^ b, kTiny);
    const float g = -logf(-logf(u));
    const float val = __fadd_rn(g, v == skip ? -INFINITY : lg[v]);
    if (beats(val, v, best, arg)) {
      best = val;
      arg = v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, arg, off);
    if (beats(ov, oi, best, arg)) {
      best = ov;
      arg = oi;
    }
  }
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = arg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    best = s_val[0];
    arg = s_idx[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (beats(s_val[w], s_idx[w], best, arg)) {
        best = s_val[w];
        arg = s_idx[w];
      }
    }
    out[row] = arg;
  }
}

__global__ void sample_uniform_kernel(const long long* __restrict__ key_rows,
                                      const int* __restrict__ positions,
                                      int salt, int N,
                                      float* __restrict__ out) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  uint32_t k1, k2;
  row_key(key_rows, positions, salt, row, k1, k2);
  uint32_t a = 0u, b = 0u;
  threefry2x32(k1, k2, a, b);
  out[row] = uniform_of(a ^ b, 0.0f);
}

}  // namespace

extern "C" {

// One categorical draw a row of the fp32 logits [N, V] (row-major), keys
// int64 [N, 2] holding uint32 values, positions int32 [N], exclude int32
// [N] or null (-1 for none); out int32 [N]. Returns cudaGetLastError().
int sample_draw(const void* logits, const void* key_rows,
                const void* positions, const void* exclude, int salt, int N,
                int V, void* out, void* stream) {
  sample_draw_kernel<<<N, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits),
      static_cast<const long long*>(key_rows),
      static_cast<const int*>(positions), static_cast<const int*>(exclude),
      salt, V, static_cast<int*>(out));
  return static_cast<int>(cudaGetLastError());
}

// One U[0, 1) a row under the same keys; out fp32 [N].
int sample_uniform(const void* key_rows, const void* positions, int salt,
                   int N, void* out, void* stream) {
  const int threads = 128;
  sample_uniform_kernel<<<(N + threads - 1) / threads, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(key_rows),
      static_cast<const int*>(positions), salt, N,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
