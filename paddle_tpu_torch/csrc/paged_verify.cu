// Paged speculative-verify attention for Hopper (sm_90a): one verify step
// of the continuous-batching engine over a fixed [slots, W] token window
// (W = K + 1: the feed token plus up to K drafted tokens), for one layer.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_verify_kernel`
// (entry `paged_verify_attention`) and, as the template variant over int8
// pools, `_verify_kernel_int8`. Plain PyTorch versions and wrappers:
// paddle_tpu_torch/ops/paged_verify.py.
//
// What it computes, per (slot s, head h), with pos = positions[s] and
// dlen = draft_lens[s]:
//   1. writes the window's W k/v rows into the pools in place: row i is
//      live iff i <= dlen and lands at (table[min((pos+i)//bs,
//      max_blocks-1)], (pos+i) % bs); a dead row lands in the null block
//      0 at (pos+i) % bs;
//   2. walks the slot's blocks 0..(pos+dlen)//bs through the block table,
//      one block per tile, never reading a table entry past that block;
//   3. carries an online softmax per window row, fp32 m, l and output
//      accumulator; row i sees keys <= pos+i (causal by absolute
//      position), q rounded to the pool dtype before QK and
//      probabilities rounded to the V dtype before PV (the
//      `_dense_verify` numerics policy);
//   4. writes acc / max(l, 1e-30) per row, cast once.
// Pool bytes after the step equal the plain version's outside the null
// block: the kernel only copies the new rows, in the pool dtype.
//
// The null block is a race, not a reference. Dead rows of every slot,
// idle lanes (position 0, draft length 0, all-zero table) and, at W > bs,
// two dead rows of one slot all write block 0, and the CTAs run at once;
// the JAX package scatters them with duplicate indices, which leaves the
// winner unspecified too. Nothing live reads block 0 (a live lane's table
// is real up to (pos+dlen)//bs), so the tests and chip_smoke.py compare
// pools outside block 0 and outputs on live rows of live slots only.
//
// Every window reads its own rows (its last live row is the walk's last
// key); no other slot reads them (the engine copies a shared block before
// any window write lands in it). How each design orders that is below.
//
// Bound on this card: bytes. The step must read the live context once:
// the distinct pool rows the tables reach below each slot's window
// (keys 0..pos_s - 1; a block shared by several slots counted once)
// times heads * D * 2 (k and v) * itemsize, plus q, the new rows and the
// output, over 3.35 TB/s; chip_smoke.py computes it from its run's
// tables. The W rows share one walk, which is the point of speculative
// decoding: the context is read once for W scored positions.
//
// Two designs, by the pool's dtype.
//
// fp32 pools: the first design (`paged_verify_kernel<float, float, D>`),
// kept for the f32 token gates. One CTA of D threads per (slot, head),
// plain loads through the cache, no cp.async and no split of long
// contexts: each warp loads a key row once (lane c reads columns c, c+32,
// ...: coalesced) and forms its W dot products with a shuffle reduction
// per (key, row); each thread owns one output column of all W rows. The
// window's rows are written, then read back from the pool: a CTA writes
// only its own head's slice of each row and reads back only that slice,
// so the __syncthreads() after the writes is the only ordering needed.
//
// bf16 pools (B4) and int8 pools (B5b, q in bf16 or f32): the split walk
// (`paged_verify_split_kernel`, then `paged_verify_combine_kernel`), the
// shape of flash-decoding, whose bodies paged_split.cuh holds at R = kMaxW
// rows (the decode kernels B3 and B5a run them at R = 1): one CTA of D
// threads per (range of 128 keys, head, slot), fp32 partials per range,
// then a combine in range order. Its design, its numerics (the int8 pools'
// dequant order of `_dense_verify_q` among them) and what holds it back
// are written there.
//
// Shared memory of the first design: W <= 9 rows of at most 64 keys in
// three f32 planes plus per-row softmax state, ~7 KB, all static. Neither
// q (registers) nor the K/V tiles (read once each, straight from the
// cache) are staged there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_split.cuh"

namespace {

using paged_split::from_f;
using paged_split::kMaxBs;
using paged_split::kNegInf;
using paged_split::to_f;

constexpr int kMaxW = 9;

// grid (slots, heads), block D threads. T is the dtype of q and out, P the
// pool's: T for the fp kernel, int8_t for the int8 one.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(D) paged_verify_kernel(
    const T* __restrict__ q, const P* __restrict__ knew,
    const P* __restrict__ vnew, P* kpool, P* vpool,
    const float* __restrict__ kv_scales,
    const int32_t* __restrict__ tables,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, T* __restrict__ out, int W,
    int layer, int num_blocks, int bs, int heads, int max_blocks,
    float scale) {
  constexpr bool kQ = std::is_same<P, int8_t>::value;
  constexpr int kWarps = D / 32;
  constexpr int kPer = D / 32;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int pos = positions[s];
  const int dlen = draft_lens[s];
  const int32_t* table = tables + static_cast<size_t>(s) * max_blocks;
  const size_t row_stride = static_cast<size_t>(heads) * D;
  const size_t block_stride = static_cast<size_t>(bs) * row_stride;
  const size_t plane = static_cast<size_t>(layer) * num_blocks * block_stride
                       + static_cast<size_t>(h) * D;
  auto win = [&](int w) {  // offset of window row w, this head
    return (static_cast<size_t>(s * W + w) * heads + h) * D;
  };

  // 1. fused in-place writes of the window's rows (this head's slice)
  for (int i = 0; i < W; ++i) {
    const int wp = pos + i;
    const int bid = i <= dlen ? table[min(wp / bs, max_blocks - 1)] : 0;
    const size_t dst = plane + bid * block_stride + (wp % bs) * row_stride
                       + tid;
    kpool[dst] = knew[win(i) + tid];
    vpool[dst] = vnew[win(i) + tid];
  }

  __shared__ float s_logit[kMaxW][kMaxBs];
  __shared__ float s_p[kMaxW][kMaxBs];   // fp32 probabilities (for l)
  __shared__ float s_pv[kMaxW][kMaxBs];  // rounded to the V dtype (for PV)
  __shared__ float s_m[kMaxW], s_mnew[kMaxW], s_l[kMaxW], s_alpha[kMaxW];

  // fp: q rounded to the pool dtype, which is q's own; int8: q in f32
  float qf[kMaxW][kPer];
  float acc[kMaxW];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) {
    acc[w] = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      qf[w][i] = w < W ? to_f(q[win(w) + lane + 32 * i]) : 0.f;
  }
  if (tid < kMaxW) {
    s_m[tid] = kNegInf;
    s_l[tid] = 0.f;
  }
  // the walk reads back the rows written above
  __syncthreads();

  const int nblk = (pos + dlen) / bs + 1;
  for (int j = 0; j < nblk; ++j) {
    const int bid = table[j];
    const size_t base = plane + bid * block_stride;
    float ks = 1.f, vs = 1.f;
    if constexpr (kQ) {
      ks = kv_scales[2 * bid];
      vs = kv_scales[2 * bid + 1];
    }
    // logits of every window row against this block's keys
    for (int k = warp; k < bs; k += kWarps) {
      const P* krow = kpool + base + k * row_stride;
      float kv[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) kv[i] = to_f(krow[lane + 32 * i]);
      const int t = j * bs + k;
#pragma unroll
      for (int w = 0; w < kMaxW; ++w) {
        if (w < W) {  // block-uniform branch
          float part = 0.f;
#pragma unroll
          for (int i = 0; i < kPer; ++i) part += qf[w][i] * kv[i];
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, off);
          float logit = part * scale;
          if constexpr (kQ) logit = logit * ks;  // fused dequant (K)
          if (lane == 0) s_logit[w][k] = t <= pos + w ? logit : kNegInf;
        }
      }
    }
    __syncthreads();

    // per-row block max: one warp per row
    for (int w = warp; w < W; w += kWarps) {
      float mx = kNegInf;
      for (int k = lane; k < bs; k += 32) mx = fmaxf(mx, s_logit[w][k]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) s_mnew[w] = fmaxf(s_m[w], mx);
    }
    __syncthreads();

    for (int idx = tid; idx < W * bs; idx += D) {
      const int w = idx / bs;
      const int k = idx - w * bs;
      const float p = expf(s_logit[w][k] - s_mnew[w]);  // masked: 0
      s_p[w][k] = p;
      if constexpr (kQ) {
        s_pv[w][k] = p;                                 // int8: not rounded
      } else {
        s_pv[w][k] = to_f(from_f<P>(p));
      }
    }
    __syncthreads();

    // per-row l and alpha (one warp per row), while every thread forms
    // its column of p.v for all rows
    for (int w = warp; w < W; w += kWarps) {
      float ps = 0.f;
      for (int k = lane; k < bs; k += 32) ps += s_p[w][k];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, off);
      if (lane == 0) {
        const float alpha = expf(s_m[w] - s_mnew[w]);
        s_alpha[w] = alpha;
        s_l[w] = alpha * s_l[w] + ps;
        s_m[w] = s_mnew[w];
      }
    }
    float pv[kMaxW];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) pv[w] = 0.f;
    for (int k = 0; k < bs; ++k) {
      const float v = to_f(vpool[base + k * row_stride + tid]);
#pragma unroll
      for (int w = 0; w < kMaxW; ++w)
        if (w < W) pv[w] += s_pv[w][k] * v;
    }
    __syncthreads();  // s_alpha is ready
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) {
      if (w < W) {
        if constexpr (kQ) {
          acc[w] = acc[w] * s_alpha[w] + pv[w] * vs;   // fused dequant (V)
        } else {
          acc[w] = acc[w] * s_alpha[w] + pv[w];
        }
      }
    }
  }
#pragma unroll
  for (int w = 0; w < kMaxW; ++w)
    if (w < W) out[win(w) + tid] = from_f<T>(acc[w] / fmaxf(s_l[w], 1e-30f));
}

// The split walk (bf16 pools: B4, int8 pools: B5b), bodies in
// paged_split.cuh at kMaxW rows: grid (ranges, heads, slots), block D
// threads, the ring in dynamic shared memory
template <typename T, typename P, int D>
__global__ void __launch_bounds__(D) paged_verify_split_kernel(
    const T* __restrict__ q, const P* __restrict__ knew,
    const P* __restrict__ vnew, P* kpool, P* vpool,
    const float* __restrict__ kv_scales,
    const int32_t* __restrict__ tables,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int W, int layer, int num_blocks, int bs,
    int heads, int max_blocks, float scale) {
  paged_split::walk<T, P, D, kMaxW>(q, knew, vnew, kpool, vpool, kv_scales,
                                    tables, positions, draft_lens, part_acc,
                                    part_ml, W, layer, num_blocks, bs, heads,
                                    max_blocks, scale);
}

// grid (heads, slots), block D threads: each (slot, head, row)'s ranges
// combined in range order, cast once
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_verify_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, T* __restrict__ out, int W,
    int heads, int nranges) {
  paged_split::combine<T, D, kMaxW>(part_acc, part_ml, positions, draft_lens,
                                    out, W, heads, nranges);
}

template <typename T, typename P, int D>
int launch(const void* q, const void* knew, const void* vnew, void* kpool,
           void* vpool, const void* kv_scales, const void* tables,
           const void* positions, const void* draft_lens, void* out,
           void* part_acc, void* part_ml, int slots, int W, int heads,
           int layer, int num_blocks, int block_size, int max_blocks,
           float scale, cudaStream_t stream) {
  if constexpr (std::is_same<P, float>::value) {  // the first design
    paged_verify_kernel<T, P, D><<<dim3(slots, heads), D, 0, stream>>>(
        static_cast<const T*>(q), static_cast<const P*>(knew),
        static_cast<const P*>(vnew), static_cast<P*>(kpool),
        static_cast<P*>(vpool), static_cast<const float*>(kv_scales),
        static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(positions),
        static_cast<const int32_t*>(draft_lens), static_cast<T*>(out), W,
        layer, num_blocks, block_size, heads, max_blocks, scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    return paged_split::launch<T, P, D>(
        paged_verify_split_kernel<T, P, D>, paged_verify_combine_kernel<T, D>,
        q, knew, vnew, kpool, vpool, kv_scales, tables, positions,
        draft_lens, out, part_acc, part_ml, slots, W, heads, layer,
        num_blocks, block_size, max_blocks, scale, stream);
  }
}

bool bad_args(int W, int block_size, int range_keys) {
  return W < 1 || W > kMaxW ||
         paged_split::bad_range(block_size, range_keys);
}

}  // namespace

// dtype (of q, the new rows, the pools and out): 0 = float32,
// 1 = bfloat16. head_dim in {64, 128}, 2 <= W <= 9, block_size <= 64.
// bf16: part_acc and part_ml are fp32 scratch [slots, heads, ranges, W,
// head_dim] and [slots, heads, ranges, W, 2], ranges = ceil(max_blocks *
// block_size / range_keys), and range_keys must be kRangeKeys; f32 reads
// neither. Returns the launches' cudaError_t (0 on success); the wrapper
// validated everything else.
extern "C" int paged_verify(const void* q, const void* knew,
                            const void* vnew, void* kpool, void* vpool,
                            const void* tables, const void* positions,
                            const void* draft_lens, void* out,
                            void* part_acc, void* part_ml, int dtype,
                            int slots, int W, int heads, int head_dim,
                            int layer, int num_blocks, int block_size,
                            int max_blocks, int range_keys, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(W, block_size, range_keys))
    return static_cast<int>(cudaErrorInvalidValue);
#define PV_LAUNCH(T, D)                                                     \
  return launch<T, T, D>(q, knew, vnew, kpool, vpool, nullptr, tables,    \
                         positions, draft_lens, out, part_acc, part_ml,   \
                         slots, W, heads, layer, num_blocks, block_size,  \
                         max_blocks, scale, st)
  if (dtype == 0 && head_dim == 64) PV_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PV_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PV_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PV_LAUNCH(__nv_bfloat16, 128);
#undef PV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools: knew/vnew are the quantized int8 rows, kv_scales this
// layer's [num_blocks, 2] f32 plane; dtype (of q and out) as above; the
// split walk at either dtype, with its scratch as above.
extern "C" int paged_verify_int8(const void* q, const void* knew,
                                 const void* vnew, void* kpool, void* vpool,
                                 const void* kv_scales, const void* tables,
                                 const void* positions,
                                 const void* draft_lens, void* out,
                                 void* part_acc, void* part_ml, int dtype,
                                 int slots, int W, int heads, int head_dim,
                                 int layer, int num_blocks, int block_size,
                                 int max_blocks, int range_keys, float scale,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bad_args(W, block_size, range_keys))
    return static_cast<int>(cudaErrorInvalidValue);
#define PV_LAUNCH(T, D)                                                    \
  return launch<T, int8_t, D>(q, knew, vnew, kpool, vpool, kv_scales,    \
                              tables, positions, draft_lens, out,        \
                              part_acc, part_ml, slots, W, heads, layer, \
                              num_blocks, block_size, max_blocks, scale, \
                              st)
  if (dtype == 0 && head_dim == 64) PV_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PV_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PV_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PV_LAUNCH(__nv_bfloat16, 128);
#undef PV_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
