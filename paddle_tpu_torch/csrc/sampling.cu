// Per-row draws of the sampler, for Hopper (sm_90a).
//
// Replaces: no Pallas kernel. The JAX package draws inside its compiled
// decode and verify programs (paddle_tpu/ops/sampling.py
// `_draw_categorical`, `_draw_uniform`), where XLA fuses jax.random's
// threefry hashes, the Gumbel and the argmax into the step. Eager PyTorch
// would run each of those as its own launch: a threefry hash is some
// hundred elementwise ops. These kernels are the fused draws: the decode
// step's draw, and the verify step's draw and coin in one launch.
// Wrappers and plain versions: paddle_tpu_torch/ops/sampling.py and
// paddle_tpu_torch/ops/threefry.py.
//
// - sample_draw_kernel: the categorical draw over the masked fp32 logits
//   [N, V]. Each vocabulary entry v takes the hash of (0, v) under the
//   row's key fold_in(fold_in(key, pos), salt): jax's partitionable bits
//   (b1 ^ b2), their uniform on [tiny, 1), the "low" Gumbel -log(-log u),
//   plus the logit (-inf at the row's excluded index); the token is the
//   argmax, the larger value winning, the lower index on a tie (jnp.argmax's
//   rule) and a NaN above every number. That order is total, so the token
//   does not depend on how the entries are split or joined.
//   Design (second): a thread-block cluster of C CTAs a row, grid (C N),
//   256 threads a CTA. The wrapper's plan (ops/sampling.py `_draw_cluster`)
//   takes C from N alone, about 2 x 132 / N rounded to a power of two, 1
//   to 16: 16 at the decode step's N 8, 8 at the verify step's N 40. Rank c
//   walks the contiguous share [c vs, (c + 1) vs) of the vocabulary, vs =
//   ceil(V / C) rounded up to 4: 16-byte loads of the logits from the
//   share's first 16-byte boundary, single loads before it and past its
//   last whole four, four threefry hashes in flight a thread. Thread 0
//   derives the row's key once a CTA (two hashes) into shared memory. Each
//   CTA joins its threads by shuffles and shared memory; rank 0 then joins
//   the C partial (value, index) pairs in rank order through distributed
//   shared memory and writes the token, and the others wait at a cluster
//   barrier until it has read them. One launch, no atomic.
// - sample_draw_coin_kernel: the same draw, and in the same launch the
//   acceptance coin of the verify step, one U[0, 1) a row under the row's
//   key with the coin's salt, fold_in(fold_in(key, pos), coin_salt): the
//   hash of (0, 0), jax.random.uniform's f32 on [0, 1). The coin and the
//   draw share the rows, positions and base keys and differ only in the
//   salt (JAX computes both inside one compiled verify program), so the
//   last thread of each row's rank 0 derives the coin's key (two hashes)
//   while thread 0 derives the draw's, and hashes the coin after its walk
//   of the fours, which is one four shorter than thread 0's unless the
//   fours divide evenly over the threads: three hashes a row in a thread
//   that would otherwise wait. (Lane 0 of warp 1, the first design, kept
//   the first barrier one hash longer and walked the most fours: 6-7 %
//   slower than the draw alone.) Both kernels are thin instances of one
//   body (`draw_row<COIN>`); the decode step's draw takes the coin-free
//   one.
//
// Arithmetic: uint32 adds, xors and rotations are exact; the uniform is
// built from bits and its affine step is a correctly rounded multiply and
// add (__fmul_rn, __fadd_rn, so nvcc contracts nothing); the logs are
// logf (the flags have no fast-math), as torch's log on the card. So the
// kernel's Gumbel values are the plain version's bits on the card and its
// tokens the plain version's.
//
// Bound on this card: the integer work of the hashes, not the bytes. The
// logits are read once (4 N V bytes: 0.48 us at N 8 and 2.40 us at N 40,
// V 50,304, at 3.35 TB/s), but every entry costs a 20-round threefry and
// the bits' uniform, some hundred integer instructions (chip_smoke.py's
// phase sampling counts them in the loop of the SASS), against the SMs'
// 64 integer lanes each. The first design ran one CTA a row, N of the 132
// SMs at work; the cluster puts every SM to work at the decode step.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

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

// the entry v of logit l under the row's key: its Gumbel plus the logit,
// -inf at the excluded index, kept as the thread's best where it beats it
__device__ __forceinline__ void take(uint32_t a, uint32_t b, int v, float l,
                                     int skip, float& best, int& arg) {
  const float u = uniform_of(a ^ b, kTiny);
  const float g = -logf(-logf(u));
  const float val = __fadd_rn(g, v == skip ? -INFINITY : l);
  if (beats(val, v, best, arg)) {
    best = val;
    arg = v;
  }
}

// the lanes' best by a xor butterfly of shuffles: every lane ends with it
__device__ __forceinline__ void warp_best(float& best, int& arg) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(0xFFFFFFFFu, best, off);
    const int oi = __shfl_xor_sync(0xFFFFFFFFu, arg, off);
    if (beats(ov, oi, best, arg)) {
      best = ov;
      arg = oi;
    }
  }
}

// grid (C N), cluster (C, 1, 1): rank c of row n's cluster walks the share
// [c vs, (c + 1) vs) of the vocabulary; with COIN, rank 0 also writes the
// row's coin u[row] under `coin_salt`
template <bool COIN>
__device__ __forceinline__ void draw_row(
    const float* __restrict__ logits, const long long* __restrict__ key_rows,
    const int* __restrict__ positions, const int* __restrict__ exclude,
    int salt, int V, int vs, int* __restrict__ out, int coin_salt,
    float* __restrict__ u) {
  const uint32_t rank = hopper::cluster_ctarank();
  const uint32_t ranks = hopper::cluster_nctarank();
  const int row = blockIdx.x / ranks;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  __shared__ uint32_t s_key[2];
  __shared__ float s_val[kThreads / 32];
  __shared__ int s_idx[kThreads / 32];
  __shared__ __align__(8) uint32_t s_best[2];   // (value bits, index)
  if (tid == 0) {
    uint32_t k1, k2;
    row_key(key_rows, positions, salt, row, k1, k2);
    s_key[0] = k1;
    s_key[1] = k2;
  }
  // the coin's key beside the draw's (two hashes each, so the barrier
  // below waits no longer), in the last thread, which walks no more fours
  // than thread 0
  constexpr int kCoin = kThreads - 1;
  uint32_t c1 = 0u, c2 = 0u;
  if (COIN && rank == 0 && tid == kCoin)
    row_key(key_rows, positions, coin_salt, row, c1, c2);
  const int skip = exclude ? exclude[row] : -1;
  const float* lg = logits + static_cast<long long>(row) * V;
  const int v0 = min(V, static_cast<int>(rank) * vs);
  const int v1 = min(V, v0 + vs);
  // [v0, vb) before the first 16-byte boundary, [vb, vt) in fours, then
  // [vt, v1)
  const int skew = static_cast<int>(
      (reinterpret_cast<uintptr_t>(lg + v0) >> 2) & 3);
  const int vb = min(v1, v0 + ((4 - skew) & 3));
  const int n4 = (v1 - vb) / 4;
  const int vt = vb + 4 * n4;
  // the logits do not wait for the key: two fours a thread in flight
  // ahead of the one being hashed
  const float4* lg4 = reinterpret_cast<const float4*>(lg + vb);
  const float4 none = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 next = tid < n4 ? __ldg(lg4 + tid) : none;
  float4 after = tid + kThreads < n4 ? __ldg(lg4 + tid + kThreads) : none;
  __syncthreads();
  const uint32_t k1 = s_key[0], k2 = s_key[1];
  float best = -INFINITY;
  int arg = 0x7FFFFFFF;
  // one iteration four entries (chip_smoke.py counts its SASS)
#pragma unroll 1
  for (int i = tid; i < n4; i += kThreads) {
    const float4 l = next;
    next = after;
    if (i + 2 * kThreads < n4) after = __ldg(lg4 + i + 2 * kThreads);
    const int v = vb + 4 * i;
    uint32_t a[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = 0u;
      b[e] = static_cast<uint32_t>(v + e);
    }
    // four independent hashes, interleaved by the compiler
#pragma unroll
    for (int e = 0; e < 4; ++e) threefry2x32(k1, k2, a[e], b[e]);
    take(a[0], b[0], v, l.x, skip, best, arg);
    take(a[1], b[1], v + 1, l.y, skip, best, arg);
    take(a[2], b[2], v + 2, l.z, skip, best, arg);
    take(a[3], b[3], v + 3, l.w, skip, best, arg);
  }
  // the coin's hash of (0, 0): where the fours do not divide evenly over
  // the threads, the last one walks one four fewer than thread 0 and
  // hashes the coin while thread 0 finishes its walk
  if (COIN && rank == 0 && tid == kCoin) {
    uint32_t a = 0u, b = 0u;
    threefry2x32(c1, c2, a, b);
    u[row] = uniform_of(a ^ b, 0.0f);
  }
  // the at most three entries on each side of the fours
  if (tid < 8) {
    const int v = tid < 4 ? v0 + tid : vt + tid - 4;
    if (v < (tid < 4 ? vb : v1)) {
      uint32_t a = 0u, b = static_cast<uint32_t>(v);
      threefry2x32(k1, k2, a, b);
      take(a, b, v, lg[v], skip, best, arg);
    }
  }
  warp_best(best, arg);
  if (lane == 0) {
    s_val[warp] = best;
    s_idx[warp] = arg;
  }
  __syncthreads();
  if (warp == 0) {
    best = lane < kThreads / 32 ? s_val[lane] : -INFINITY;
    arg = lane < kThreads / 32 ? s_idx[lane] : 0x7FFFFFFF;
    warp_best(best, arg);
    if (lane == 0) {
      s_best[0] = __float_as_uint(best);
      s_best[1] = static_cast<uint32_t>(arg);
    }
  }
  if (ranks == 1) {
    if (tid == 0) out[row] = arg;
    return;
  }
  hopper::cluster_arrive();
  hopper::cluster_wait();
  if (rank == 0 && tid == 0) {
    // every partial's load issued before the first join
    uint2 o[hopper::kMaxCluster];
#pragma unroll
    for (int c = 1; c < hopper::kMaxCluster; ++c)
      if (c < static_cast<int>(ranks))
        o[c] = hopper::ld_cluster_u32x2(hopper::map_rank(s_best, c));
#pragma unroll
    for (int c = 1; c < hopper::kMaxCluster; ++c)
      if (c < static_cast<int>(ranks) &&
          beats(__uint_as_float(o[c].x), static_cast<int>(o[c].y), best,
                arg)) {
        best = __uint_as_float(o[c].x);
        arg = static_cast<int>(o[c].y);
      }
    out[row] = arg;
  }
  // no CTA leaves before rank 0 has read its partial
  hopper::cluster_arrive();
  hopper::cluster_wait();
}

__global__ void __launch_bounds__(kThreads) sample_draw_kernel(
    const float* __restrict__ logits, const long long* __restrict__ key_rows,
    const int* __restrict__ positions, const int* __restrict__ exclude,
    int salt, int V, int vs, int* __restrict__ out) {
  draw_row<false>(logits, key_rows, positions, exclude, salt, V, vs, out, 0,
                  nullptr);
}

__global__ void __launch_bounds__(kThreads) sample_draw_coin_kernel(
    const float* __restrict__ logits, const long long* __restrict__ key_rows,
    const int* __restrict__ positions, const int* __restrict__ exclude,
    int salt, int V, int vs, int* __restrict__ out, int coin_salt,
    float* __restrict__ u) {
  draw_row<true>(logits, key_rows, positions, exclude, salt, V, vs, out,
                 coin_salt, u);
}

// each rank's share of the vocabulary, whole fours but the last
int share_of(int V, int cluster) {
  const int vs = ((V + cluster - 1) / cluster + 3) / 4 * 4;
  return vs;
}

}  // namespace

extern "C" {

// One categorical draw a row of the fp32 logits [N, V] (row-major), keys
// int64 [N, 2] holding uint32 values, positions int32 [N], exclude int32
// [N] or null (-1 for none); out int32 [N]. `cluster` CTAs share a row (1
// to 16, the wrapper's `_draw_cluster`). Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a cluster the kernel does not take.
int sample_draw(const void* logits, const void* key_rows,
                const void* positions, const void* exclude, int salt, int N,
                int V, int cluster, void* out, void* stream) {
  if (cluster < 1 || cluster > hopper::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaError_t e = hopper::launch_split(
      sample_draw_kernel, dim3(cluster * N), kThreads, 0, cluster,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(logits),
      static_cast<const long long*>(key_rows),
      static_cast<const int*>(positions), static_cast<const int*>(exclude),
      salt, V, share_of(V, cluster), static_cast<int*>(out));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The verify step's two draws in one launch: sample_draw's token a row
// under `salt` into out, and the row's coin, one U[0, 1) under the same
// key row and position with `coin_salt`, into u (fp32 [N]).
int sample_draw_coin(const void* logits, const void* key_rows,
                     const void* positions, const void* exclude, int salt,
                     int coin_salt, int N, int V, int cluster, void* out,
                     void* u, void* stream) {
  if (cluster < 1 || cluster > hopper::kMaxCluster)
    return static_cast<int>(cudaErrorInvalidValue);
  if (N == 0) return 0;
  const cudaError_t e = hopper::launch_split(
      sample_draw_coin_kernel, dim3(cluster * N), kThreads, 0, cluster,
      static_cast<cudaStream_t>(stream), static_cast<const float*>(logits),
      static_cast<const long long*>(key_rows),
      static_cast<const int*>(positions), static_cast<const int*>(exclude),
      salt, V, share_of(V, cluster), static_cast<int*>(out), coin_salt,
      static_cast<float*>(u));
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
