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
// shape of flash-decoding. A slot's keys 0..pos+dlen are cut into ranges
// of kRangeKeys; one CTA of D threads per (range, head, slot) walks its
// range, and a second launch combines each (slot, head, row)'s ranges in
// range order (no atomics: the same bits every run). The grid comes from
// max_blocks and the slot count alone (reading positions on the host
// would sync every layer); a CTA whose range starts past its slot's last
// key exits at once. In a CTA:
//   - K and V of the range go to shared memory by 16-byte cp.async copies
//     (rows XOR-swizzled by 16-byte chunk, so the reads below are free of
//     bank conflicts), in a ring of two stages of kTileKeys keys: the
//     second stage is in flight while the first is scored;
//   - keys at positions pos..pos+dlen (the window's own, live rows) are
//     copied from knew/vnew, older keys from the pool: the same bits, as
//     the pool write copies the rows unchanged, so no CTA reads a row
//     another CTA writes, and the range-0 CTA's in-place writes need no
//     ordering against any read;
//   - two threads own a key, each for half the window rows (q from shared
//     memory, fp32 rows padded apart), and form full D-long dot products:
//     no reduction across lanes per key;
//   - one warp per window row takes the range's max m_r, p = exp(s - m_r)
//     (0 for a masked key), l_r = sum p, and p rounded to the V dtype
//     (fp) in place of the logit;
//   - each thread owns one output column of all W rows: acc_r = sum p v,
//     per block (int8: times the block's V scale), into fp32 partials
//     (m_r, l_r, acc_r[W][D]) that the wrapper allocates.
// The combine takes M = max m_r, out = sum_r e^(m_r - M) acc_r / max(sum_r
// e^(m_r - M) l_r, 1e-30), cast once. p is rounded against its range's
// max, not the running max of the whole walk: a difference of the order
// of one bf16 rounding of p (tests/test_torch_paged_verify_split.py
// emulates the kernel's ranges and holds them to the plain version). At
// W <= 9 the walk does ~5 FLOP a byte, far below the card's ridge: the
// FMA pipes suffice, and what counts is the bytes in flight. What holds
// it back: two launches, a fixed range length (short contexts leave SMs
// idle, and the partials add ~4 % to the bytes), and a ring that holds
// the whole range of one (slot, head) at D 128 (64 KB, three CTAs an SM).
//
// int8 variant (pool element P = int8_t): the pools hold int8 codes and
// `kv_scales` is this layer's [num_blocks, 2] f32 K/V grid; the rows
// arrive already quantized by the op layer's window quant-on-write. q
// stays in f32, codes are cast to f32, and the dequant follows
// `_dense_verify_q`'s order: logits (q.k) * scale * ks; probabilities not
// rounded; acc * alpha + (p.v) * vs per block.
//
// Shared memory of the first design: W <= 9 rows of at most 64 keys in
// three f32 planes plus per-row softmax state, ~7 KB, all static. Neither
// q (registers) nor the K/V tiles (read once each, straight from the
// cache) are staged there.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "attention_mma.cuh"

namespace {

constexpr int kMaxW = 9;
constexpr int kMaxBs = 64;
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

// ---------------------------------------------------------------------------
// The split walk: bf16 pools (B4), int8 pools (B5b)
// ---------------------------------------------------------------------------
constexpr int kRangeKeys = 128;  // keys a CTA walks (ops/paged_verify.py
                                 // RANGE_KEYS); a multiple of every bs
constexpr int kTileKeys = 64;    // keys a stage of the ring holds
constexpr int kStages = kRangeKeys / kTileKeys;
static_assert(kStages == 2, "the walk waits on two stages by name");

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

// grid (ranges, heads, slots), block D threads; dynamic shared memory:
// the ring, kStages x (K, V) tiles
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
  using Tl = Tile<P, D>;
  constexpr bool kQ = std::is_same<P, int8_t>::value;
  constexpr int kQPitch = D + 4;  // rows w, w + 1 four banks apart
  constexpr int kMaxBlocks = kRangeKeys / 8;
  extern __shared__ __align__(128) unsigned char ring[];
  __shared__ __align__(16) float s_q[kMaxW][kQPitch];
  __shared__ __align__(16) float s_p[kMaxW][kRangeKeys];  // logits, then p
  __shared__ float s_m[kMaxW], s_l[kMaxW];
  __shared__ int s_bid[kMaxBlocks];
  __shared__ float s_vs[kMaxBlocks], s_ks[kMaxBlocks];

  const int r = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pos = positions[s];
  const int last = pos + draft_lens[s];  // the walk's last key
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

  // logits: two threads a key (tid / 2), rows tid % 2, tid % 2 + 2, ...
  const int hf = tid & 1;
  for (int st = 0; st < kStages; ++st) {
    if (st == 0) {
      attn_mma::cp_async_wait<1>();
    } else {
      attn_mma::cp_async_wait<0>();
    }
    __syncthreads();  // stage st landed for every thread
    const unsigned char* kt = ring + st * 2 * Tl::kBytes;
    for (int kl = tid >> 1; kl < kTileKeys; kl += D / 2) {
      const int lk = st * kTileKeys + kl;
      if (lk >= nkeys) break;
      float dot[(kMaxW + 1) / 2];
#pragma unroll
      for (int j = 0; j < (kMaxW + 1) / 2; ++j) dot[j] = 0.f;
#pragma unroll 2
      for (int c = 0; c < Tl::kChunks; ++c) {
        float kf[Tl::kElems];
        unpack(*reinterpret_cast<const uint4*>(kt + Tl::offset(kl, c)), kf);
#pragma unroll
        for (int j = 0; j < (kMaxW + 1) / 2; ++j) {
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
      for (int j = 0; j < (kMaxW + 1) / 2; ++j) {
        const int w = hf + 2 * j;
        if (w < W) {
          float logit = dot[j] * scale;
          if constexpr (kQ) logit = logit * s_ks[lk / bs];  // dequant (K)
          s_p[w][lk] = logit;
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
  float acc[kMaxW];
#pragma unroll
  for (int w = 0; w < kMaxW; ++w) acc[w] = 0.f;
  for (int j = 0; j < nb; ++j) {
    float pv[kMaxW];
#pragma unroll
    for (int w = 0; w < kMaxW; ++w) pv[w] = 0.f;
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
      for (int w = 0; w < kMaxW; ++w) {
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
    for (int w = 0; w < kMaxW; ++w) {
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
  for (int w = 0; w < kMaxW; ++w)
    if (w < W) part_acc[(part * W + w) * D + tid] = acc[w];
  if (tid < W) {
    part_ml[(part * W + tid) * 2] = s_m[tid];
    part_ml[(part * W + tid) * 2 + 1] = s_l[tid];
  }
}

// grid (heads, slots), block D threads: each (slot, head, row)'s ranges
// combined in range order, cast once
template <typename T, int D>
__global__ void __launch_bounds__(D) paged_verify_combine_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int32_t* __restrict__ positions,
    const int32_t* __restrict__ draft_lens, T* __restrict__ out, int W,
    int heads, int nranges) {
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int nr =
      min((positions[s] + draft_lens[s]) / kRangeKeys + 1, nranges);
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
    constexpr int bytes = kStages * 2 * Tile<P, D>::kBytes;
    int err = static_cast<int>(cudaFuncSetAttribute(
        paged_verify_split_kernel<T, P, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
    if (err) return err;
    const int nranges =
        (max_blocks * block_size + kRangeKeys - 1) / kRangeKeys;
    paged_verify_split_kernel<T, P, D>
        <<<dim3(nranges, heads, slots), D, bytes, stream>>>(
            static_cast<const T*>(q), static_cast<const P*>(knew),
            static_cast<const P*>(vnew), static_cast<P*>(kpool),
            static_cast<P*>(vpool), static_cast<const float*>(kv_scales),
            static_cast<const int32_t*>(tables),
            static_cast<const int32_t*>(positions),
            static_cast<const int32_t*>(draft_lens),
            static_cast<float*>(part_acc), static_cast<float*>(part_ml), W,
            layer, num_blocks, block_size, heads, max_blocks, scale);
    err = static_cast<int>(cudaGetLastError());
    if (err) return err;
    paged_verify_combine_kernel<T, D><<<dim3(heads, slots), D, 0, stream>>>(
        static_cast<const float*>(part_acc),
        static_cast<const float*>(part_ml),
        static_cast<const int32_t*>(positions),
        static_cast<const int32_t*>(draft_lens), static_cast<T*>(out), W,
        heads, nranges);
    return static_cast<int>(cudaGetLastError());
  }
}

bool bad_args(int W, int block_size, int range_keys) {
  return W < 1 || W > kMaxW || block_size > kMaxBs ||
         kRangeKeys % block_size || range_keys != kRangeKeys;
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
