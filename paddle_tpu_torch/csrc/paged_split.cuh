// The split-context walk of the paged attention kernels for Hopper
// (sm_90a), shared by paged_decode.cu (B3 on bf16 pools, B5a on int8
// pools: one query row a slot) and paged_verify.cu (B4, B5b: a window of
// W <= 9 rows a slot). Each of those files keeps its own thin `__global__`
// kernels, named apart so that a profile and the SASS tell decode from
// verify, and its C entry points; the bodies are the `__device__`
// templates here, on <T, P, D, R>: T the dtype of q and out, P the pool's
// (T, or int8_t), R the most rows a window holds. At R = 1 (decode) the row
// count is a compile-time 1 and there are no draft lengths; at R = 9
// (verify) the launch's W <= R rows are live up to each slot's draft
// length.
//
// The shape of flash-decoding. A slot's keys 0..pos+dlen (dlen = 0 at
// decode) are cut into ranges of kRangeKeys; one CTA of D threads per
// (range, head, slot) walks its range, and a second launch combines each
// (slot, head, row)'s ranges in range order (no atomics: the same bits
// every run). The grid comes from max_blocks and the slot count alone
// (reading positions on the host would sync every layer); a CTA whose range
// starts past its slot's last key exits at once. In a CTA:
//   - K and V of the range go to shared memory by 16-byte cp.async copies
//     (rows XOR-swizzled by 16-byte chunk, so the reads below are free of
//     bank conflicts), in a ring of two stages of kTileKeys keys: the
//     second stage is in flight while the first is scored;
//   - keys at positions pos..pos+dlen (the window's own, live rows) are
//     copied from knew/vnew, older keys from the pool: the same bits, as
//     the pool write copies the rows unchanged, so no CTA reads a row
//     another CTA writes, and the range-0 CTA's in-place writes need no
//     ordering against any read;
//   - two threads own a key. At R > 1 each takes half the window rows (q
//     from shared memory, fp32 rows padded apart) and forms full D-long
//     dot products: no reduction across lanes per key. At R = 1 each takes
//     half the key's chunks against its half of q in registers, and one
//     shuffle joins the halves; the halves differ in one chunk bit
//     (`Tile::half_chunk`), so a quarter-warp's eight reads fill eight bank
//     groups;
//   - one warp per window row takes the range's max m_r, p = exp(s - m_r)
//     (0 for a key the row may not see), l_r = sum p, and p rounded to the
//     V dtype (fp) in place of the logit;
//   - each thread owns one output column of all rows: acc_r = sum p v, per
//     block (int8: times the block's V scale), into fp32 partials (m_r,
//     l_r, acc_r[W][D]) that the wrapper allocates.
// The combine takes M = max m_r, out = sum_r e^(m_r - M) acc_r / max(sum_r
// e^(m_r - M) l_r, 1e-30), cast once. p is rounded against its range's
// max, not the running max of the whole walk: a difference of the order
// of one bf16 rounding of p (tests/test_torch_paged_verify_split.py and
// tests/test_torch_paged_decode_split.py emulate the ranges and hold them
// to the plain versions). At W <= 9 the walk does ~5 FLOP a byte, far
// below the card's ridge: the FMA pipes suffice, and what counts is the
// bytes in flight. What holds it back: two launches, a fixed range length
// (short contexts leave SMs idle, and the partials add ~4 % to the bytes
// at W 5), and a ring that holds the whole range of one (slot, head) at D
// 128 (64 KB, three CTAs an SM).
//
// Numerics, by the pool's dtype. bf16: q is in the pool dtype already, p
// is rounded to bf16 before PV. int8 (kv_scales this layer's [num_blocks,
// 2] f32 K/V grid; the rows arrive already quantized by the op layer's
// quant-on-write): q in f32 (bf16 or f32 in the tensor), codes cast to
// f32, logits (q.k) * scale * ks, p not rounded, each block's (p.v) * vs
// into the accumulator (`_dense_step_q` and `_dense_verify_q`'s order).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace paged_split {

constexpr float kNegInf = -1e30f;
constexpr int kRangeKeys = 128;  // keys a CTA walks (ops/paged_decode.py
                                 // RANGE_KEYS); a multiple of every bs
constexpr int kTileKeys = 64;    // keys a stage of the ring holds
constexpr int kStages = kRangeKeys / kTileKeys;
static_assert(kStages == 2, "the walk waits on two stages by name");

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

// a [kTileKeys][D] tile of P: 16-byte chunks, chunk c of row r stored at
// c ^ (r & kSwz), so four (or eight) rows read at one chunk fill distinct
// banks
template <typename P, int D>
struct Tile {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(P));
  static constexpr int kChunks = kRowBytes / 16;
  static constexpr int kElems = 16 / static_cast<int>(sizeof(P));
  static constexpr int kBytes = kTileKeys * kRowBytes;
  static constexpr int kSwz = kChunks < 8 ? kChunks - 1 : 7;
  __host__ __device__ static constexpr int offset(int r, int c) {
    return r * kRowBytes + ((c ^ (r & kSwz)) << 4);
  }
  // chunk i of half hf of a row, when two threads split a key: the halves
  // differ in chunk bit kSplit, which the swizzle maps to the other four
  // bank groups (rows of 128 bytes or more) or the other half of a bank
  // group (64-byte rows, two a bank line)
  static constexpr int kSplit = kChunks < 8 ? 1 : 4;
  __host__ __device__ static constexpr int half_chunk(int i, int hf) {
    return (i & (kSplit - 1)) | (hf * kSplit) | ((i & ~(kSplit - 1)) << 1);
  }
};

// 16 bytes of the pool dtype as floats: 8 bf16 or 16 int8 codes
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[16]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    f[i] = static_cast<float>(static_cast<int8_t>(w[i >> 2] >> (8 * (i & 3))));
}

// The walk of one (range, head, slot) = blockIdx (x, y, z), D threads;
// dynamic shared memory: the ring, kStages x (K, V) tiles. draft_lens is
// not read at R = 1; `rows` is the window's W (R = 1: 1).
template <typename T, typename P, int D, int R>
__device__ __forceinline__ void walk(
    const T* __restrict__ q, const P* __restrict__ knew,
    const P* __restrict__ vnew, P* kpool, P* vpool,
    const float* __restrict__ kv_scales,
    const int32_t* __restrict__ tables,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, float* __restrict__ part_acc,
    float* __restrict__ part_ml, int rows, int layer, int num_blocks, int bs,
    int heads, int max_blocks, float scale) {
  using Tl = Tile<P, D>;
  constexpr bool kQ = std::is_same<P, int8_t>::value;
  constexpr int kQPitch = D + 4;  // rows w, w + 1 four banks apart
  constexpr int kMaxBlocks = kRangeKeys / 8;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(16) float s_q[R][kQPitch];
  __shared__ __align__(16) float s_p[R][kRangeKeys];  // logits, then p
  __shared__ float s_m[R], s_l[R];
  __shared__ int s_bid[kMaxBlocks];
  __shared__ float s_vs[kMaxBlocks], s_ks[kMaxBlocks];

  const int W = R == 1 ? 1 : rows;
  const int r = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[s];
  const int last = pos + (R == 1 ? 0 : draft_lens[s]);  // the last key
  const int k0 = r * kRangeKeys;
  if (k0 > last) return;
  const int nkeys = min(kRangeKeys, last + 1 - k0);
  const int nb = (nkeys - 1) / bs + 1;   // blocks of the range walked
  const int32_t* table = tables + static_cast<size_t>(s) * max_blocks;
  const size_t row_stride = static_cast<size_t>(heads) * D;
  const size_t block_stride = static_cast<size_t>(bs) * row_stride;
  const size_t plane = static_cast<size_t>(layer) * num_blocks * block_stride
                       + static_cast<size_t>(h) * D;
  auto win = [&](int w) {  // offset of window row w, this head
    return (static_cast<size_t>(s) * W + w) * row_stride +
           static_cast<size_t>(h) * D;
  };

  // the range-0 CTA lands the window's rows (this head's slice) in place;
  // no CTA reads them back from the pool
  if (r == 0) {
    for (int i = tid; i < W * Tl::kChunks; i += D) {
      const int w = i / Tl::kChunks, c = i - w * Tl::kChunks;
      const int wp = pos + w;
      const int bid = w <= last - pos
          ? table[min(wp / bs, max_blocks - 1)] : 0;
      const size_t dst = plane + static_cast<size_t>(bid) * block_stride +
                         static_cast<size_t>(wp % bs) * row_stride +
                         c * Tl::kElems;
      const size_t src = win(w) + c * Tl::kElems;
      *reinterpret_cast<uint4*>(kpool + dst) =
          *reinterpret_cast<const uint4*>(knew + src);
      *reinterpret_cast<uint4*>(vpool + dst) =
          *reinterpret_cast<const uint4*>(vnew + src);
    }
  }
  if (tid < nb) {
    const int bid = table[k0 / bs + tid];
    s_bid[tid] = bid;
    if constexpr (kQ) {
      s_ks[tid] = kv_scales[2 * bid];
      s_vs[tid] = kv_scales[2 * bid + 1];
    }
  }
  // fp: q is in the pool dtype already; int8: q in f32
  for (int w = 0; w < W; ++w) s_q[w][tid] = to_f(q[win(w) + tid]);
  __syncthreads();  // the block ids

  // stage `st` <- keys k0 + 64 st .. of K and V, zero past the walk's end
  const uint32_t ring0 = attn_mma::smem_u32(ring);
  auto copy_stage = [&](int st) {
    const uint32_t kt = ring0 + st * 2 * Tl::kBytes, vt = kt + Tl::kBytes;
    for (int i = tid; i < kTileKeys * Tl::kChunks; i += D) {
      const int kl = i / Tl::kChunks, c = i - kl * Tl::kChunks;
      const int lk = st * kTileKeys + kl, t = k0 + lk;
      const bool ok = t <= last;
      size_t off = 0;
      const P *kb = kpool, *vb = vpool;
      if (ok && t >= pos) {  // the window's own row
        off = win(t - pos);
        kb = knew;
        vb = vnew;
      } else if (ok) {
        off = plane + static_cast<size_t>(s_bid[lk / bs]) * block_stride +
              static_cast<size_t>(lk % bs) * row_stride;
      }
      off += c * Tl::kElems;
      const uint32_t o = Tl::offset(kl, c);
      attn_mma::cp_async_16(kt + o, kb + off, ok);
      attn_mma::cp_async_16(vt + o, vb + off, ok);
    }
  };
  copy_stage(0);
  attn_mma::cp_async_commit();
  if (nkeys > kTileKeys) copy_stage(1);
  attn_mma::cp_async_commit();

  // logits: two threads a key (tid / 2); R > 1: rows tid % 2, tid % 2 + 2,
  // ...; R = 1: half tid % 2 of the key's chunks
  const int hf = tid & 1;
  float qh[R == 1 ? D / 2 : 1];  // R = 1: this thread's half of q
  if constexpr (R == 1) {
#pragma unroll
    for (int i = 0; i < Tl::kChunks / 2; ++i) {
#pragma unroll
      for (int e = 0; e < Tl::kElems; e += 4) {
        const float4 q4 = *reinterpret_cast<const float4*>(
            &s_q[0][Tl::half_chunk(i, hf) * Tl::kElems + e]);
        qh[i * Tl::kElems + e] = q4.x;
        qh[i * Tl::kElems + e + 1] = q4.y;
        qh[i * Tl::kElems + e + 2] = q4.z;
        qh[i * Tl::kElems + e + 3] = q4.w;
      }
    }
  }
  for (int st = 0; st < kStages; ++st) {
    if (st == 0) {
      attn_mma::cp_async_wait<1>();
    } else {
      attn_mma::cp_async_wait<0>();
    }
    __syncthreads();  // stage st landed for every thread
    const unsigned char* kt = ring + st * 2 * Tl::kBytes;
    if constexpr (R == 1) {
      for (int kl = tid >> 1; kl < kTileKeys; kl += D / 2) {
        const int lk = st * kTileKeys + kl;
        // the warp's first key: the break is warp-uniform, so every lane
        // of the warp reaches the shuffle (keys past the walk's end are
        // zero-filled and not stored)
        if (lk - (lane >> 1) >= nkeys) break;
        float dot = 0.f;
#pragma unroll
        for (int i = 0; i < Tl::kChunks / 2; ++i) {
          float kf[Tl::kElems];
          unpack(*reinterpret_cast<const uint4*>(
                     kt + Tl::offset(kl, Tl::half_chunk(i, hf))), kf);
#pragma unroll
          for (int e = 0; e < Tl::kElems; ++e)
            dot = fmaf(qh[i * Tl::kElems + e], kf[e], dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 1);
        if (hf == 0 && lk < nkeys) {
          float logit = dot * scale;
          if constexpr (kQ) logit = logit * s_ks[lk / bs];  // dequant (K)
          s_p[0][lk] = logit;
        }
      }
    } else {
      for (int kl = tid >> 1; kl < kTileKeys; kl += D / 2) {
        const int lk = st * kTileKeys + kl;
        if (lk >= nkeys) break;
        float dot[(R + 1) / 2];
#pragma unroll
        for (int j = 0; j < (R + 1) / 2; ++j) dot[j] = 0.f;
#pragma unroll 2
        for (int c = 0; c < Tl::kChunks; ++c) {
          float kf[Tl::kElems];
          unpack(*reinterpret_cast<const uint4*>(kt + Tl::offset(kl, c)),
                 kf);
#pragma unroll
          for (int j = 0; j < (R + 1) / 2; ++j) {
            const int w = hf + 2 * j;
            if (w < W) {
              const float* qr = &s_q[w][c * Tl::kElems];
#pragma unroll
              for (int e = 0; e < Tl::kElems; e += 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qr + e);
                dot[j] = fmaf(q4.x, kf[e], dot[j]);
                dot[j] = fmaf(q4.y, kf[e + 1], dot[j]);
                dot[j] = fmaf(q4.z, kf[e + 2], dot[j]);
                dot[j] = fmaf(q4.w, kf[e + 3], dot[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < (R + 1) / 2; ++j) {
          const int w = hf + 2 * j;
          if (w < W) {
            float logit = dot[j] * scale;
            if constexpr (kQ) logit = logit * s_ks[lk / bs];  // dequant (K)
            s_p[w][lk] = logit;
          }
        }
      }
    }
  }
  __syncthreads();

  // one warp a row: the range's max, p, l; p rounded to the V dtype (fp)
  // in place of the logit, 0 where the row may not see the key
  for (int w = warp; w < W; w += D / 32) {
    const int see = min(pos + w, last) - k0;  // the row's last key, local
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kRangeKeys / 32; ++j) {
      const int lk = lane + 32 * j;
      if (lk <= see) mx = fmaxf(mx, s_p[w][lk]);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float ps = 0.f;
#pragma unroll
    for (int j = 0; j < kRangeKeys / 32; ++j) {
      const int lk = lane + 32 * j;
      const float p = lk <= see ? expf(s_p[w][lk] - mx) : 0.f;
      ps += p;
      if constexpr (kQ) {
        s_p[w][lk] = p;                          // int8: not rounded
      } else {
        s_p[w][lk] = to_f(from_f<P>(p));
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(0xffffffffu, ps, off);
    if (lane == 0) {
      s_m[w] = mx;
      s_l[w] = ps;
    }
  }
  __syncthreads();

  // p.v: thread tid owns column tid of every row, block by block
  const int c = tid / Tl::kElems, e = tid - c * Tl::kElems;
  float acc[R];
#pragma unroll
  for (int w = 0; w < R; ++w) acc[w] = 0.f;
  for (int j = 0; j < nb; ++j) {
    float pv[R];
#pragma unroll
    for (int w = 0; w < R; ++w) pv[w] = 0.f;
    for (int k = j * bs; k < (j + 1) * bs; k += 4) {
      float v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int lk = k + u, st = lk / kTileKeys, kl = lk - st * kTileKeys;
        v[u] = to_f(*reinterpret_cast<const P*>(
            ring + st * 2 * Tl::kBytes + Tl::kBytes + Tl::offset(kl, c) +
            e * static_cast<int>(sizeof(P))));
      }
#pragma unroll
      for (int w = 0; w < R; ++w) {
        if (w < W) {
          const float4 p4 = *reinterpret_cast<const float4*>(&s_p[w][k]);
          pv[w] = fmaf(p4.x, v[0], pv[w]);
          pv[w] = fmaf(p4.y, v[1], pv[w]);
          pv[w] = fmaf(p4.z, v[2], pv[w]);
          pv[w] = fmaf(p4.w, v[3], pv[w]);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < R; ++w) {
      if (w < W) {
        if constexpr (kQ) {
          acc[w] += pv[w] * s_vs[j];             // dequant (V)
        } else {
          acc[w] += pv[w];
        }
      }
    }
  }
  const size_t part = (static_cast<size_t>(s) * heads + h) * gridDim.x + r;
#pragma unroll
  for (int w = 0; w < R; ++w)
    if (w < W) part_acc[(part * W + w) * D + tid] = acc[w];
  if (tid < W) {
    part_ml[(part * W + tid) * 2] = s_m[tid];
    part_ml[(part * W + tid) * 2 + 1] = s_l[tid];
  }
}

// (head, slot) = blockIdx (x, y), D threads: each (slot, head, row)'s
// ranges combined in range order, cast once
template <typename T, int D, int R>
__device__ __forceinline__ void combine(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, T* __restrict__ out, int rows,
    int heads, int nranges) {
  const int W = R == 1 ? 1 : rows;
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int last = positions[s] + (R == 1 ? 0 : draft_lens[s]);
  const int nr = min(last / kRangeKeys + 1, nranges);
  const size_t part = (static_cast<size_t>(s) * heads + h) * nranges;
  for (int w = 0; w < W; ++w) {
    float mx = kNegInf;
    for (int r = 0; r < nr; ++r)
      mx = fmaxf(mx, part_ml[((part + r) * W + w) * 2]);
    float l = 0.f, a = 0.f;
    for (int r = 0; r < nr; ++r) {
      const size_t i = (part + r) * W + w;
      const float f = expf(part_ml[i * 2] - mx);
      l += f * part_ml[i * 2 + 1];
      a += f * part_acc[i * D + tid];
    }
    out[((static_cast<size_t>(s) * W + w) * heads + h) * D + tid] =
        from_f<T>(a / fmaxf(l, 1e-30f));
  }
}

template <typename T, typename P>
using WalkKernel = void (*)(const T*, const P*, const P*, P*, P*,
                            const float*, const int32_t*, const int32_t*,
                            const int32_t*, float*, float*, int, int, int,
                            int, int, int, float);
template <typename T>
using CombineKernel = void (*)(const float*, const float*, const int32_t*,
                               const int32_t*, T*, int, int, int);

// the walk on grid (ranges, heads, slots), then the combine on (heads,
// slots), D threads each, ranges = ceil(max_blocks * block_size /
// kRangeKeys). Returns the first launch's cudaError_t, 0 on success.
template <typename T, typename P, int D>
int launch(WalkKernel<T, P> walk_kernel, CombineKernel<T> combine_kernel,
           const void* q, const void* knew, const void* vnew, void* kpool,
           void* vpool, const void* kv_scales, const void* tables,
           const void* positions, const void* draft_lens, void* out,
           void* part_acc, void* part_ml, int slots, int W, int heads,
           int layer, int num_blocks, int block_size, int max_blocks,
           float scale, cudaStream_t stream) {
  constexpr int bytes = kStages * 2 * Tile<P, D>::kBytes;
  int err = static_cast<int>(cudaFuncSetAttribute(
      walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
  if (err) return err;
  const int nranges = (max_blocks * block_size + kRangeKeys - 1) / kRangeKeys;
  walk_kernel<<<dim3(nranges, heads, slots), D, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(knew),
      static_cast<const P*>(vnew), static_cast<P*>(kpool),
      static_cast<P*>(vpool), static_cast<const float*>(kv_scales),
      static_cast<const int32_t*>(tables),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(draft_lens), static_cast<float*>(part_acc),
      static_cast<float*>(part_ml), W, layer, num_blocks, block_size, heads,
      max_blocks, scale);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  combine_kernel<<<dim3(heads, slots), D, 0, stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<const int32_t*>(positions),
      static_cast<const int32_t*>(draft_lens), static_cast<T*>(out), W,
      heads, nranges);
  return static_cast<int>(cudaGetLastError());
}

// what the walk takes of a launch: a range a whole number of blocks of at
// most kMaxBs keys, and the wrapper's range length the kernel's
constexpr int kMaxBs = 64;
inline bool bad_range(int block_size, int range_keys) {
  return block_size > kMaxBs || kRangeKeys % block_size ||
         range_keys != kRangeKeys;
}

}  // namespace paged_split
