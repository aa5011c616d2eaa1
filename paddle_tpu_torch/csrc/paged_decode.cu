// Paged decode attention for Hopper (sm_90a): one batched decode step of
// the continuous-batching engine, for one layer.
//
// Replaces: paddle_tpu/ops/pallas/paged_attention.py `_decode_kernel`
// (entry `paged_decode_attention`) and, as the template variant over int8
// pools, `_decode_kernel_int8`. Plain PyTorch versions and wrappers:
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
// every idle lane's CTA writes row 0 of the null block 0, concurrently.
// Those writes are benign only because the rows are identical: the
// engine feeds idle lanes token 0 at position 0, so each writes the same
// k/v bytes. Their outputs are garbage the engine discards. A live lane
// never reads the null block, since its table is real up to pos // bs.
// A CTA writes only its own head's slice of a row and reads back only
// that slice, so the __syncthreads() after the write is the only
// ordering the walk needs; blocks shared read-only between slots are
// never written (the engine copies a shared block before a write lands
// in it).
//
// Bound on this card: bytes. The step must read the live context once:
// the distinct pool rows the tables reach for keys 0..pos_s - 1 of every
// slot (a block shared by several slots counted once) times
// heads * D * 2 (k and v) * itemsize, plus q, the new rows and the output,
// over 3.35 TB/s. chip_smoke.py computes it from its run's tables.
// This first design does nothing about that bound yet: one CTA of D
// threads per (slot, head), 64 keys per tile, plain loads through the
// cache, no cp.async/TMA pipelining and no split of long contexts across
// CTAs. At 8 slots x 16 heads the grid is 128 CTAs of 128 threads.
//
// int8 variant (pool element P = int8_t): the pools hold int8 codes and
// `kv_scales` is this layer's [num_blocks, 2] f32 K/V grid. The new rows
// arrive already quantized (the op layer grows the written block's grid,
// requantizes it and updates its scale row first), so the write is the
// same copy. q stays in f32 (no rounding to the pool dtype), codes are
// cast to f32, and the dequant follows `_dense_step_q`'s order: logits
// (q.k) * scale * ks per key; probabilities not rounded; each block's
// p.v scaled by its vs before it joins the accumulator. The bound halves
// the cached bytes (one byte a code, plus 8 bytes of scales a block).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTileKeys = 64;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// grid (slots, heads), block D threads: thread `tid` owns output column
// `tid`; for QK each warp takes keys warp, warp + D/32, ... of a tile and
// each lane a contiguous D/32 slice of the dot product. T is the dtype of
// q and out, P the pool's: T for the fp kernel, int8_t for the int8 one.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(D) paged_decode_kernel(
    const T* __restrict__ q, const P* __restrict__ knew,
    const P* __restrict__ vnew, P* kpool, P* vpool,
    const float* __restrict__ kv_scales,
    const int32_t* __restrict__ tables,
    const int32_t* __restrict__ positions, T* __restrict__ out, int layer,
    int num_blocks, int bs, int heads, int max_blocks, float scale) {
  constexpr bool kQ = std::is_same<P, int8_t>::value;
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
  __shared__ float s_p[kTileKeys];    // fp32 probabilities (for l)
  __shared__ float s_pv[kTileKeys];   // rounded to the V dtype (for PV)
  __shared__ size_t s_row[kTileKeys]; // pool offset of each key's row
  __shared__ float s_vs[kTileKeys];   // int8: V scale of each key's block

  // fp: q rounded to the pool dtype, which is q's own; int8: q in f32
  float qf[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i) qf[i] = to_f(q[qoff + lane * kPer + i]);

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
        const P* krow = kpool + row + lane * kPer;
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < kPer; ++i) part += qf[i] * to_f(krow[i]);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        dot = part * scale;
        if constexpr (kQ) dot = dot * kv_scales[2 * bid];  // fused dequant
        if (lane == 0) {
          s_row[k] = row;
          if constexpr (kQ) s_vs[k] = kv_scales[2 * bid + 1];
        }
      }
      if (lane == 0) s_logit[k] = dot;
    }
    __syncthreads();

    float tmax = kNegInf;
#pragma unroll 8
    for (int k = 0; k < kTileKeys; ++k) tmax = fmaxf(tmax, s_logit[k]);
    const float m_new = fmaxf(m, tmax);
    if (tid < kTileKeys) {
      const float p = expf(s_logit[tid] - m_new);  // masked keys give 0
      s_p[tid] = p;
      if constexpr (kQ) {
        s_pv[tid] = p;                             // int8: not rounded
      } else {
        s_pv[tid] = to_f(from_f<T>(p));
      }
    }
    __syncthreads();

    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll 8
    for (int k = 0; k < kTileKeys; ++k) psum += s_p[k];
    l = alpha * l + psum;
    const int kend = min(kTileKeys, nkeys - t0);
    float pv = 0.f;
    if constexpr (kQ) {
      // each block's p.v scaled once by its grid (tiles are whole blocks:
      // bs divides kTileKeys and t0 is a multiple of it)
      float pvb = 0.f;
      for (int k = 0; k < kend; ++k) {
        pvb += s_pv[k] * to_f(vpool[s_row[k] + tid]);
        if ((t0 + k + 1) % bs == 0 || k + 1 == kend) {
          pv += pvb * s_vs[k];
          pvb = 0.f;
        }
      }
    } else {
      for (int k = 0; k < kend; ++k)
        pv += s_pv[k] * to_f(vpool[s_row[k] + tid]);
    }
    acc = acc * alpha + pv;
    m = m_new;
    __syncthreads();  // s_logit / s_p / s_row are rewritten next tile
  }
  out[qoff + tid] = from_f<T>(acc / fmaxf(l, 1e-30f));
}

template <typename T, typename P, int D>
int launch(const void* q, const void* knew, const void* vnew, void* kpool,
           void* vpool, const void* kv_scales, const void* tables,
           const void* positions, void* out, int slots, int heads, int layer,
           int num_blocks, int block_size, int max_blocks, float scale,
           cudaStream_t stream) {
  dim3 grid(slots, heads);
  paged_decode_kernel<T, P, D><<<grid, D, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(knew),
      static_cast<const P*>(vnew), static_cast<P*>(kpool),
      static_cast<P*>(vpool), static_cast<const float*>(kv_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions), static_cast<T*>(out), layer,
      num_blocks, block_size, heads, max_blocks, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype (of q, the new rows, the pools and out): 0 = float32,
// 1 = bfloat16. head_dim in {64, 128}. Returns the launch's cudaError_t (0
// on success); the wrapper validated everything.
extern "C" int paged_decode(const void* q, const void* knew,
                            const void* vnew, void* kpool, void* vpool,
                            const void* tables, const void* positions,
                            void* out, int dtype, int slots, int heads,
                            int head_dim, int layer, int num_blocks,
                            int block_size, int max_blocks, float scale,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_LAUNCH(T, D)                                                     \
  return launch<T, T, D>(q, knew, vnew, kpool, vpool, nullptr, tables,    \
                         positions, out, slots, heads, layer, num_blocks, \
                         block_size, max_blocks, scale, st)
  if (dtype == 0 && head_dim == 64) PD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PD_LAUNCH(__nv_bfloat16, 128);
#undef PD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// int8 pools: knew/vnew are the quantized int8 rows, kv_scales this
// layer's [num_blocks, 2] f32 plane; dtype (of q and out) as above.
extern "C" int paged_decode_int8(const void* q, const void* knew,
                                 const void* vnew, void* kpool, void* vpool,
                                 const void* kv_scales, const void* tables,
                                 const void* positions, void* out,
                                 int dtype, int slots, int heads,
                                 int head_dim, int layer, int num_blocks,
                                 int block_size, int max_blocks,
                                 float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PD_LAUNCH(T, D)                                                    \
  return launch<T, int8_t, D>(q, knew, vnew, kpool, vpool, kv_scales,    \
                              tables, positions, out, slots, heads,      \
                              layer, num_blocks, block_size, max_blocks, \
                              scale, st)
  if (dtype == 0 && head_dim == 64) PD_LAUNCH(float, 64);
  if (dtype == 0 && head_dim == 128) PD_LAUNCH(float, 128);
  if (dtype == 1 && head_dim == 64) PD_LAUNCH(__nv_bfloat16, 64);
  if (dtype == 1 && head_dim == 128) PD_LAUNCH(__nv_bfloat16, 128);
#undef PD_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}
