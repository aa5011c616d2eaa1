// Paged decode attention for Hopper (sm_90a): one batched decode step of
// the continuous-batching engine, for one layer.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_decode_kernel`
// (entry `paged_decode_attention`) and, over int8 pools,
// `_decode_kernel_int8`. Plain PyTorch versions and wrappers:
// paddle_tpu_torch/ops/paged_decode.py.
//
// What it computes, per (slot s, head h):
//   1. writes this token's k/v row into the pool in place at
//      (table[s, pos // bs], pos % bs) -- the fused KV write;
//   2. walks the slot's keys 0..pos through the block table (blocks
//      0..pos // bs, keys > pos masked), never reading a table entry
//      past pos // bs;
//   3. online softmax with m, l and the output accumulator in fp32,
//      q rounded to the pool dtype before QK, probabilities rounded to
//      the V dtype before PV (the `_dense_step` numerics policy);
//   4. writes acc / max(l, 1e-30), cast once.
// Pool bytes after the step equal the plain version's bit for bit: the
// kernel only copies the new rows, in the pool dtype.
//
// Null-block semantics: idle lanes ride (position 0, all-zero table), so
// every idle lane writes row 0 of the null block 0, from concurrent CTAs.
// Those writes are benign only because the rows are identical: the
// engine feeds idle lanes token 0 at position 0, so each writes the same
// k/v bytes. Their outputs are garbage the engine discards. A live lane
// never reads the null block, since its table is real up to pos // bs.
// Blocks shared read-only between slots are never written (the engine
// copies a shared block before a write lands in it).
//
// Bound on this card: bytes. The step must read the live context once:
// the distinct pool rows the tables reach for keys 0..pos_s - 1 of every
// slot (a block shared by several slots counted once) times
// heads * D * 2 (k and v) * itemsize, plus q, the new rows and the output,
// over 3.35 TB/s. chip_smoke.py computes it from its run's tables.
//
// Two designs, by the pool's dtype.
//
// bf16 pools (B3) and int8 pools (B5a, q in bf16 or f32): the split walk
// of paged_split.cuh at one row (R = 1), which the verify kernels B4 and
// B5b run at nine: `paged_decode_split_kernel`, one CTA of D threads per
// (range of 128 keys, head, slot), the range's K and V through a two-stage
// cp.async ring into swizzled shared memory, the key at pos read from
// knew/vnew, fp32 partials (m_r, l_r, acc_r) per range; then
// `paged_decode_combine_kernel` in range order. Two threads split each
// key's dot product and join it with one shuffle. The range-0 CTA writes
// the new row in place and no CTA reads it back, so the pools end as the
// first design left them, bit for bit. p is rounded to bf16 against its
// range's max (the first design: the running max of its 64-key tiles).
// int8 keeps `_dense_step_q`'s order: logits (q.k) * scale * ks, p not
// rounded, each block's (p.v) * vs into the accumulator. The grid is
// (max_blocks * bs / 128, heads, slots), from shapes alone; a CTA whose
// range starts past pos exits at once.
//
// f32 pools: the first design (`paged_decode_kernel<D>`), kept for the f32
// token gates (generate_parity, spec_parity's K=0 run). One CTA of D
// threads per (slot, head) walks the whole context in tiles of 64 keys,
// plain loads through the cache, no cp.async and no split: the new row is
// written, then read back from the pool (a CTA writes only its own head's
// slice of a row and reads back only that slice, so the __syncthreads()
// after the write is the only ordering the walk needs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "paged_split.cuh"

namespace {

using paged_split::kNegInf;
using paged_split::kTileKeys;

// f32 pools. grid (slots, heads), block D threads: thread `tid` owns output
// column `tid`; for QK each warp takes keys warp, warp + D/32, ... of a
// tile and each lane a contiguous D/32 slice of the dot product.
template <int D>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const float* __restrict__ q, const float* __restrict__ knew,
    const float* __restrict__ vnew, float* kpool, float* vpool,
    const int32_t* __restrict__ tables,
    const int32_t* __restrict__ positions, float* __restrict__ out,
    int layer, int num_blocks, int bs, int heads, int max_blocks,
    float scale) {
  constexpr int kWarps = D / 32;
  constexpr int kPer = D / 32;
  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int pos = positions[s];
  const int32_t* table = tables + static_cast<size_t>(s) * max_blocks;
  const size_t row_stride = static_cast<size_t>(heads) * D;
  const size_t block_stride = static_cast<size_t>(bs) * row_stride;
  const size_t plane = static_cast<size_t>(layer) * num_blocks * block_stride
                       + static_cast<size_t>(h) * D;
  const size_t qoff = (static_cast<size_t>(s) * heads + h) * D;

  // 1. fused in-place write of this token's row (this head's slice)
  {
    const size_t dst = plane + table[pos / bs] * block_stride
                       + (pos % bs) * row_stride + tid;
    kpool[dst] = knew[qoff + tid];
    vpool[dst] = vnew[qoff + tid];
  }

  __shared__ float s_logit[kTileKeys];
  __shared__ float s_p[kTileKeys];    // probabilities
  __shared__ size_t s_row[kTileKeys]; // pool offset of each key's row

  float qf[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) qf[i] = q[qoff + lane * kPer + i];

  // the walk's last tile reads back the row written above
  __syncthreads();

  float m = kNegInf, l = 0.f, acc = 0.f;
  const int nkeys = pos + 1;
  for (int t0 = 0; t0 < nkeys; t0 += kTileKeys) {
    for (int k = warp; k < kTileKeys; k += kWarps) {
      const int t = t0 + k;
      float dot = kNegInf;
      if (t < nkeys) {  // warp-uniform branch
        const int bid = table[t / bs];
        const size_t row = plane + bid * block_stride + (t % bs) * row_stride;
        const float* krow = kpool + row + lane * kPer;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) part += qf[i] * krow[i];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        dot = part * scale;
        if (lane == 0) s_row[k] = row;
      }
      if (lane == 0) s_logit[k] = dot;
    }
    __syncthreads();

    float tmax = kNegInf;
#pragma unroll 8
    for (int k = 0; k < kTileKeys; ++k) tmax = fmaxf(tmax, s_logit[k]);
    const float m_new = fmaxf(m, tmax);
    if (tid < kTileKeys)
      s_p[tid] = expf(s_logit[tid] - m_new);  // masked keys give 0
    __syncthreads();

    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll 8
    for (int k = 0; k < kTileKeys; ++k) psum += s_p[k];
    l = alpha * l + psum;
    const int kend = min(kTileKeys, nkeys - t0);
    float pv = 0.f;
    for (int k = 0; k < kend; ++k) pv += s_p[k] * vpool[s_row[k] + tid];
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // s_logit / s_p / s_row are rewritten next tile
  }
  out[qoff + tid] = acc / fmaxf(l, 1e-30f);
}

// bf16 and int8 pools: the split walk at one row, bodies in
// paged_split.cuh. grid (ranges, heads, slots), block D threads, the ring
// in dynamic shared memory; draft_lens is not read.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(D) paged_decode_split_kernel(
    const T* __restrict__ q, const P* __restrict__ knew,
    const P* __restrict__ vnew, P* kpool, P* vpool,
    const float* __restrict__ kv_scales,
    const int32_t* __restrict__ tables,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int W, int layer, int num_blocks, int bs,
    int heads, int max_blocks, float scale) {
  paged_split::walk<T, P, D, 1>(q, knew, vnew, kpool, vpool, kv_scales,
                                tables, positions, draft_lens, part_acc,
                                part_ml, W, layer, num_blocks, bs, heads,
                                max_blocks, scale);
}

// grid (heads, slots), block D threads: each (slot, head)'s ranges
// combined in range order, cast once
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_decode_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, T* __restrict__ out, int W,
    int heads, int nranges) {
  paged_split::combine<T, D, 1>(part_acc, part_ml, positions, draft_lens,
                                out, W, heads, nranges);
}

template <typename T, typename P, int D>
int launch(const void* q, const void* knew, const void* vnew, void* kpool,
           void* vpool, const void* kv_scales, const void* tables,
           const void* positions, void* out, void* part_acc, void* part_ml,
           int slots, int heads, int layer, int num_blocks, int block_size,
           int max_blocks, float scale, cudaStream_t stream) {
  if constexpr (std::is_same<P, float>::value) {  // the first design
    paged_decode_kernel<D><<<dim3(slots, heads), D, 0, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(knew),
        static_cast<const float*>(vnew), static_cast<float*>(kpool),
        static_cast<float*>(vpool), static_cast<const int32_t*>(tables),
        static_cast<const int32_t*>(positions), static_cast<float*>(out),
        layer, num_blocks, block_size, heads, max_blocks, scale);
    return static_cast<int>(cudaGetLastError());
  } else {
    return paged_split::launch<T, P, D>(
        paged_decode_split_kernel<T, P, D>, paged_decode_combine_kernel<T, D>,
        q, knew, vnew, kpool, vpool, kv_scales, tables, positions, nullptr,
        out, part_acc, part_ml, slots, 1, heads, layer, num_blocks,
        block_size, max_blocks, scale, stream);
  }
}

}  // namespace

// dtype (of q, the new rows, the pools and out): 0 = float32,
// 1 = bfloat16. head_dim in {64, 128}, block_size <= 64. bf16: part_acc
// and part_ml are fp32 scratch [slots, heads, ranges, head_dim] and
// [slots, heads, ranges, 2], ranges = ceil(max_blocks * block_size /
// range_keys), and range_keys must be the walk's kRangeKeys; f32 reads
// neither. Returns the launches' cudaError_t (0 on success); the wrapper
// validated everything else.
extern "C" int paged_decode(const void* q, const void* knew,
                            const void* vnew, void* kpool, void* vpool,
                            const void* tables, const void* positions,
                            void* out, void* part_acc, void* part_ml,
                            int dtype, int slots, int heads, int head_dim,
                            int layer, int num_blocks, int block_size,
                            int max_blocks, int range_keys, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (paged_split::bad_range(block_size, range_keys))
    return static_cast<int>(cudaErrorInvalidValue);
#define PD_LAUNCH(T, D)                                                     \
  return launch<T, T, D>(q, knew, vnew, kpool, vpool, nullptr, tables,    \
                         positions, out, part_acc, part_ml, slots, heads, \
                         layer, num_blocks, block_size, max_blocks, scale, \
                         st)
  if (dtype == 0 && head_dim == 64) PD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PD_LAUNCH(__nv_bfloat16, 128);
#undef PD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools: knew/vnew are the quantized int8 rows, kv_scales this
// layer's [num_blocks, 2] f32 plane; dtype (of q and out) as above; the
// split walk at either dtype, with its scratch as above.
extern "C" int paged_decode_int8(const void* q, const void* knew,
                                 const void* vnew, void* kpool, void* vpool,
                                 const void* kv_scales, const void* tables,
                                 const void* positions, void* out,
                                 void* part_acc, void* part_ml, int dtype,
                                 int slots, int heads, int head_dim,
                                 int layer, int num_blocks, int block_size,
                                 int max_blocks, int range_keys,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (paged_split::bad_range(block_size, range_keys))
    return static_cast<int>(cudaErrorInvalidValue);
#define PD_LAUNCH(T, D)                                                    \
  return launch<T, int8_t, D>(q, knew, vnew, kpool, vpool, kv_scales,    \
                              tables, positions, out, part_acc, part_ml, \
                              slots, heads, layer, num_blocks,           \
                              block_size, max_blocks, scale, st)
  if (dtype == 0 && head_dim == 64) PD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PD_LAUNCH(__nv_bfloat16, 128);
#undef PD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
