// Batched paged LoRA for Hopper (sm_90a): one site of one layer, every
// slot under its own adapter page.
//
// Replaces: no Pallas kernel. The JAX package computes the per-slot delta
// in XLA inside its compiled serving steps (paddle_tpu/ops/lora.py
// `lora_linear_delta`, `lora_qkv_delta`: a gather of each slot's A and B
// pages, two einsums with fp32 accumulation, a scale, a cast, and the add
// to the base projection), where XLA fuses them. Eager PyTorch would run
// each of those as its own launch, and gather a copy of every slot's
// factors out of the pool, four sites a layer a step. This kernel is the
// fused delta-and-add. Wrapper and plain version:
// paddle_tpu_torch/ops/lora.py (`batched_lora`, `batched_lora_plain`).
//
// base[row, o] = T(base[row, o] + T(s * sum_r xr[row, r] * B[p, l, r, o']))
// xr[row, r]   = sum_i x[row, i] * A[p, l, r, i]            (both fp32)
// with p = rows[slot] the slot's page, s = scaling[p], and o' = o for the
// linear sites, o' = (h * 3 + t) * D + d for the qkv site, whose base is
// 3-major (o = (t * heads + h) * D + d) while its B page is head-grouped
// [heads, 3, D]. The two roundings are the plain version's: the delta is
// cast to T, then added to the T base (for T = float both are exact
// no-ops of the cast). A page-0 slot (the null adapter, zero factors and
// scaling) adds exact zeros: its cluster returns at once and leaves the
// base as it is, the same bits up to the sign of a zero.
//
// Bound on this card: bytes, and the latency of the loads at serving's
// few rows. x and the base read once, the base written once, and each
// distinct page's A and B rows of this layer read once: at GPT-1.3B's fc1
// with 8 decode rows of 8 pages at rank 16, 8 * 16 * (2048 + 8192) * 2
// bytes = 2.6 MB, 0.8 us at 3.35 TB/s. The work is fp32 FMA, not the
// tensor cores: 2 * rows * R * (in + out) operations, 42 MFLOP for a
// 128-row fc1 chunk, well under a microsecond across the card.
//
// Design (second): one thread-block cluster of C CTAs a (slot, row tile);
// grid (C, row tiles, slots), 256 threads a CTA. The wrapper's plan
// (ops/lora.py `_plan`) gives C (1 to 8 from in_dim, a portable cluster),
// the tile's rows TM (all of a slot's rows up to 16: the decode and verify
// steps' 1 and 5 in one tile, a 128-row prefill chunk in eight) and the
// shrink's segments, from (in_dim, R, rows a slot) alone, never from
// out_dim or the dtype.
// - Loads: rank c of the cluster takes the inputs [c ks, (c + 1) ks), ks =
//   ceil(in_dim / C) rounded up to whole chunks of 8. Its share of the
//   page's R rows of A and of the tile's rows of x arrive in shared memory
//   by one 1-D `cp.async.bulk` a row onto an mbarrier (no tensor map, so
//   no host work a call), in stages of at most 64 KB; where in_dim is not
//   a multiple of 8 or a base is not 16-byte aligned, by plain loads with
//   zeros past in_dim. Before the shrink, `cp.async` (zero-filled past the
//   share) brings the rank's columns of B: rank c expands B's columns
//   [c cs, (c + 1) cs), cs = ceil(out_dim / C) rounded up to 8, so those
//   loads land while the shrink runs.
// - The shrink: a thread sums a 4-row x 4-rank tile of xr over one of the
//   `nseg` segments of the rank's chunks (chunk j to segment j % nseg, each
//   chunk's 8 inputs in order, the chunks in order), in fp32; the segments
//   join by a xor butterfly of shuffles (each lane the same bits). The
//   rank's partial xr [R, TM] then waits in its shared memory; after a
//   cluster barrier every rank sums all C partials in rank order through
//   distributed shared memory (`mapa`, `ld.shared::cluster`), so each
//   holds the same xr, computed once a row tile.
// - The expand: a thread takes 4 consecutive columns of B and 4 rows, sums
//   the R ranks in order from shared memory, scales, casts once and adds
//   to the base (its first item's base values loaded before the shrink,
//   4 columns a load where they are whole). A CTA leaves only after a
//   cluster barrier that follows its last read of another CTA's shared
//   memory.
// The sum order of xr[row, r] depends on (in_dim, R, rows a slot) alone:
// a tensor-parallel shard (the same x and A over out / mp columns of B)
// gives the whole launch's columns bit for bit, and the bf16 and f32
// instances sum in the same order, so a bf16 launch's fp32 delta is an f32
// launch's on the same values. No sum depends on another row's values or
// another slot, and no atomic is used: a rerun gives the same bits. The
// first design read a slot's whole A page on one SM for each 1,024
// columns and 8 rows, so one SM's load rate bounded it; the cluster
// spreads the page over C SMs and reads it once a row tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "hopper.cuh"

namespace {

using attn_mma::cp_async_16;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::smem_u32;

constexpr int kThreads = 256;
constexpr int kMaxRank = 64;
constexpr int kMaxTile = 16;      // rows of one slot a cluster
constexpr int kMaxSeg = 32;       // a warp's lanes
constexpr int kChunk = 8;         // inputs a shrink load brings
constexpr int kJoin = 8;          // remote loads in flight in the join
constexpr int kStageBytes = 64 * 1024;   // A and x rows of a stage
constexpr int kBStageBytes = 32 * 1024;  // B rows of an expand pass

// the layout of a launch: the plan's (TM, nseg) and what follows from it,
// the dtype and the shapes (stage widths, column share, smem offsets)
struct LoraPlan {
  int tm, tmp, rp;       // rows a tile; TM and R rounded up to 4
  int nseg;              // the shrink's segments
  int ks, stage, pitch;  // inputs a rank, a stage; a staged row's pitch
  int cs, nc;            // B columns a rank, an expand pass
  int off_stage, off_b, off_part, off_xr;
};

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// a bf16 pair's floats: exact, the halves shifted into place
__device__ __forceinline__ void widen(uint32_t u, float& lo, float& hi) {
  lo = __uint_as_float(u << 16);
  hi = __uint_as_float(u & 0xFFFF0000u);
}

// 16 bytes at p (aligned) as floats: 4 f32 or 8 bf16
__device__ __forceinline__ void load16(const float* p, float (&v)[4]) {
  const float4 r = *reinterpret_cast<const float4*>(p);
  v[0] = r.x;
  v[1] = r.y;
  v[2] = r.z;
  v[3] = r.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p,
                                       float (&v)[8]) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  widen(r.x, v[0], v[1]);
  widen(r.y, v[2], v[3]);
  widen(r.z, v[4], v[5]);
  widen(r.w, v[6], v[7]);
}

// 4 consecutive T at p (aligned to their size) as floats, and back
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  load16(p, v);
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p,
                                      float (&v)[4]) {
  const uint2 r = *reinterpret_cast<const uint2*>(p);
  widen(r.x, v[0], v[1]);
  widen(r.y, v[2], v[3]);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p,
                                       const __nv_bfloat16 (&v)[4]) {
  const uint32_t u[4] = {__bfloat16_as_ushort(v[0]),
                         __bfloat16_as_ushort(v[1]),
                         __bfloat16_as_ushort(v[2]),
                         __bfloat16_as_ushort(v[3])};
  *reinterpret_cast<uint2*>(p) =
      make_uint2(u[0] | (u[1] << 16), u[2] | (u[3] << 16));
}

// the base's column of B's column c: the same at the linear sites; at the
// qkv site B is head-grouped ((h * 3 + t) * D + d) and the base 3-major
__device__ __forceinline__ int base_col(int c, int heads, int head_dim) {
  if (heads == 0) return c;
  const int d = c % head_dim, th = c / head_dim;
  return ((th % 3) * heads + th / 3) * head_dim + d;
}

// the base under an expand item, 4 rows from 4 g and B's columns col ..
// col + 3, as floats: one load a row where the 4 base columns are whole and
// aligned (ovec), else one an element; zeros past the tile and c1
template <typename T>
__device__ __forceinline__ void load_prev(float (&prev)[4][4], const T* base,
                                          long long first, int out_dim,
                                          int col, int c1, int g, int nrows,
                                          int ovec, int heads, int head_dim) {
  if (col >= c1) return;
  const int o = base_col(col, heads, head_dim);
  const bool whole = ovec && col + 4 <= c1;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const T* row = base + (first + 4 * g + i) * out_dim;
    if (4 * g + i < nrows) {
      if (whole) {
        load4(row + o, prev[i]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          prev[i][k] = col + k < c1
              ? to_f(row[base_col(col + k, heads, head_dim)]) : 0.0f;
      }
    }
  }
}

// B's columns [cb, cb + nc) of ranks 0..R-1 of page row bp into bs [R,
// nc]: 16-byte cp.async (one group) when bvec, else plain loads; zeros
// from c1
template <typename T>
__device__ __forceinline__ void load_b(T* bs, const T* bp, int R,
                                       int out_dim, int cb, int c1, int nc,
                                       int bvec) {
  const int n = c1 - cb;
  if (bvec) {
    constexpr int per = 16 / sizeof(T);
    const int pieces = nc / per;
    for (int i = threadIdx.x; i < R * pieces; i += kThreads) {
      const int r = i / pieces, q = (i % pieces) * per;
      const bool in = q < n;
      cp_async_16(smem_u32(bs + r * nc + q),
                  in ? bp + static_cast<long long>(r) * out_dim + cb + q : bp,
                  in);
    }
    cp_async_commit();
  } else {
    for (int i = threadIdx.x; i < R * nc; i += kThreads) {
      const int r = i / nc, q = i % nc;
      bs[i] = q < n ? bp[static_cast<long long>(r) * out_dim + cb + q]
                    : from_f<T>(0.0f);
    }
  }
}

// grid (C, row tiles, slots), cluster (C, 1, 1)
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) lora_shrink_expand_kernel(
    const T* __restrict__ x, const T* __restrict__ a,
    const T* __restrict__ b, const int* __restrict__ rows,
    const float* __restrict__ scaling, T* __restrict__ base, int S,
    int in_dim, int out_dim, int R, int L, int layer, int heads,
    int head_dim, int vec, int bvec, int ovec, LoraPlan p) {
  constexpr int kPer = 16 / sizeof(T);     // inputs of a 16-byte load
  const int slot = blockIdx.z;
  const int page = rows[slot];
  // the null adapter adds zeros; the page is the cluster's, so the whole
  // cluster returns here, before any cluster barrier
  if (page == 0) return;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  T* stage = reinterpret_cast<T*>(smem + p.off_stage);
  T* bs = reinterpret_cast<T*>(smem + p.off_b);
  float* part = reinterpret_cast<float*>(smem + p.off_part);
  float* xr = reinterpret_cast<float*>(smem + p.off_xr);
  const int tid = threadIdx.x;
  const uint32_t rank = hopper::cluster_ctarank();
  const uint32_t ranks = hopper::cluster_nctarank();
  const int row0 = blockIdx.y * p.tm;
  const int nrows = min(p.tm, S - row0);
  const long long first = static_cast<long long>(slot) * S + row0;
  const T* xs = x + first * in_dim;
  const long long pl = static_cast<long long>(page) * L + layer;
  const T* ap = a + pl * R * in_dim;
  const T* bp = b + pl * R * out_dim;
  const float s = scaling[page];
  const int k0 = min(in_dim, static_cast<int>(rank) * p.ks);
  const int k1 = min(in_dim, k0 + p.ks);
  const int c0 = min(out_dim, static_cast<int>(rank) * p.cs);
  const int c1 = min(out_dim, c0 + p.cs);

  if (c0 < c1) load_b(bs, bp, R, out_dim, c0, c1, p.nc, bvec);
  // the base under this thread's first expand item, loaded before the
  // shrink: it does not depend on it
  const int nq = p.nc / 4;
  const int items = nq * (p.tmp / 4);
  float pre[4][4] = {};
  if (tid < items)
    load_prev(pre, base, first, out_dim, c0 + 4 * (tid % nq), c1, tid / nq,
              nrows, ovec, heads, head_dim);

  if (vec && tid == 0) {
    hopper::mbar_init(bar, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  // the shrink: thread (tile, seg) sums rows 4 tt .. 4 tt + 3 and ranks
  // 4 rt .. 4 rt + 3 of xr over chunks seg, seg + nseg, ... of the share
  const int rtiles = p.rp / 4;
  const int tile = tid / p.nseg, seg = tid % p.nseg;
  const bool active = tile < (p.tmp / 4) * rtiles;
  const int tt = tile / rtiles, rt = tile % rtiles;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
  int done = 0;                        // chunks of the share before a stage
  for (int kb = k0, st = 0; kb < k1; kb += p.stage, ++st) {
    const int len = min(p.stage, k1 - kb);
    if (st > 0) __syncthreads();       // the last stage is read
    if (vec) {
      // one bulk copy a row: the R rows of A, then the tile's rows of x
      const uint32_t bytes = len * sizeof(T);
      if (tid == 0) hopper::mbar_arrive_expect_tx(bar, bytes * (R + nrows));
      if (tid < 32) {
        __syncwarp();
        for (int i = tid; i < R + nrows; i += 32) {
          const T* src = i < R
              ? ap + static_cast<long long>(i) * in_dim + kb
              : xs + static_cast<long long>(i - R) * in_dim + kb;
          const int srow = i < R ? i : p.rp + i - R;
          hopper::bulk_load(stage + srow * p.pitch, src, bytes, bar);
        }
      }
      hopper::mbar_wait(bar, st & 1);
    } else {
      // plain loads, zeros from in_dim to the stage's last whole chunk
      const int width = (len + kChunk - 1) / kChunk * kChunk;
      for (int i = tid; i < (R + nrows) * width; i += kThreads) {
        const int row = i / width, e = i % width;
        const T* src = row < R
            ? ap + static_cast<long long>(row) * in_dim
            : xs + static_cast<long long>(row - R) * in_dim;
        const int srow = row < R ? row : p.rp + row - R;
        stage[srow * p.pitch + e] = e < len ? src[kb + e] : from_f<T>(0.0f);
      }
      __syncthreads();
    }
    const int nch = (len + kChunk - 1) / kChunk;
    if (active) {
      // the stage's first chunk of this segment
      const int j0 = ((seg - done) % p.nseg + p.nseg) % p.nseg;
      for (int j = j0; j < nch; j += p.nseg) {
        // the chunk's 8 inputs in order, a 16-byte load a row at a time
#pragma unroll
        for (int h = 0; h < kChunk; h += kPer) {
          float xv[4][kPer], av[4][kPer];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            load16(stage + (p.rp + 4 * tt + i) * p.pitch + j * kChunk + h,
                   xv[i]);
            load16(stage + (4 * rt + i) * p.pitch + j * kChunk + h, av[i]);
          }
#pragma unroll
          for (int e = 0; e < kPer; ++e)
#pragma unroll
            for (int i = 0; i < 4; ++i)
#pragma unroll
              for (int r = 0; r < 4; ++r)
                acc[i][r] = fmaf(xv[i][e], av[r][e], acc[i][r]);
        }
      }
    }
    done += nch;
  }
  // the segments of a tile are neighbouring lanes: join them
  for (int off = p.nseg / 2; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        acc[i][r] += __shfl_xor_sync(0xFFFFFFFFu, acc[i][r], off);
  // this rank's partial xr, [rank][row]
  if (active && seg == 0)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      *reinterpret_cast<float4*>(part + (4 * rt + r) * p.tmp + 4 * tt) =
          make_float4(acc[0][r], acc[1][r], acc[2][r], acc[3][r]);
  const float* xq = part;
  if (ranks > 1) {
    hopper::cluster_arrive();
    hopper::cluster_wait();
    // every rank sums the C partials in rank order, the loads of up to 8
    // ranks issued before their adds
    for (int i = tid * 4; i < p.rp * p.tmp; i += kThreads * 4) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int cg = 0; cg < static_cast<int>(ranks); cg += kJoin) {
        float4 w[kJoin];
#pragma unroll
        for (int c = 0; c < kJoin; ++c)
          if (cg + c < static_cast<int>(ranks))
            w[c] = hopper::ld_cluster_f32x4(
                hopper::map_rank(part + i, cg + c));
#pragma unroll
        for (int c = 0; c < kJoin; ++c)
          if (cg + c < static_cast<int>(ranks)) {
            if (cg + c == 0) {
              v = w[0];
            } else {
              v.x += w[c].x;
              v.y += w[c].y;
              v.z += w[c].z;
              v.w += w[c].w;
            }
          }
      }
      *reinterpret_cast<float4*>(xr + i) = v;
    }
    // this CTA reads no other CTA's shared memory after here
    hopper::cluster_arrive();
    xq = xr;
  }
  if (bvec) cp_async_wait<0>();
  __syncthreads();

  // the expand: 4 columns of B (in B's order) and 4 rows a thread
  for (int cb = c0, pass = 0; cb < c1; cb += p.nc, ++pass) {
    if (pass > 0) {
      __syncthreads();                 // the last pass's columns are read
      load_b(bs, bp, R, out_dim, cb, c1, p.nc, bvec);
      if (bvec) cp_async_wait<0>();
      __syncthreads();
    }
    for (int it = tid; it < items; it += kThreads) {
      const int q = it % nq, g = it / nq;
      const int col = cb + 4 * q;
      if (col >= c1 || 4 * g >= nrows) continue;
      float prev[4][4] = {};
      if (pass == 0 && it == tid) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) prev[i][k] = pre[i][k];
      } else {
        load_prev(prev, base, first, out_dim, col, c1, g, nrows, ovec,
                  heads, head_dim);
      }
      const int o = base_col(col, heads, head_dim);
      const bool whole = ovec && col + 4 <= c1;
      float d[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < 4; ++k) d[i][k] = 0.0f;
      for (int r = 0; r < R; ++r) {
        float bv[4];
        load4(bs + r * p.nc + 4 * q, bv);
        const float4 xv =
            *reinterpret_cast<const float4*>(xq + r * p.tmp + 4 * g);
        const float xs4[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int k = 0; k < 4; ++k) d[i][k] = fmaf(xs4[i], bv[k], d[i][k]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        T* row = base + (first + 4 * g + i) * out_dim;
        if (4 * g + i < nrows) {
          T y[4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const T delta = from_f<T>(__fmul_rn(d[i][k], s));
            y[k] = from_f<T>(__fadd_rn(prev[i][k], to_f(delta)));
          }
          if (whole) {
            store4(row + o, y);
          } else {
#pragma unroll
            for (int k = 0; k < 4; ++k)
              if (col + k < c1)
                row[base_col(col + k, heads, head_dim)] = y[k];
          }
        }
      }
    }
  }
  // no CTA leaves while another may still read its shared memory
  if (ranks > 1) hopper::cluster_wait();
}

constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

template <typename T>
int launch(const void* x, const void* a, const void* b, const void* rows,
           const void* scaling, void* base, int slots, int S, int in_dim,
           int out_dim, int R, int L, int layer, int heads, int head_dim,
           int vec, int bvec, int cluster, int tm, int nseg,
           cudaStream_t stream) {
  constexpr int esz = sizeof(T);
  LoraPlan p;
  p.tm = tm;
  p.tmp = round_up(tm, 4);
  p.rp = round_up(R, 4);
  p.nseg = nseg;
  p.ks = round_up((in_dim + cluster - 1) / cluster, kChunk);
  const int pad = 16 / esz;            // a 16-byte skew between rows
  const int fit = kStageBytes / ((p.rp + p.tmp) * esz) - pad;
  p.stage = std::max(kChunk, std::min(p.ks, fit / kChunk * kChunk));
  p.pitch = p.stage + pad;
  p.cs = round_up((out_dim + cluster - 1) / cluster, kChunk);
  p.nc = std::max(kChunk,
                  std::min(p.cs, kBStageBytes / (R * esz) / kChunk * kChunk));
  p.off_stage = 16;
  p.off_b = p.off_stage + round_up((p.rp + p.tmp) * p.pitch * esz, 16);
  p.off_part = p.off_b + round_up(R * p.nc * esz, 16);
  p.off_xr = p.off_part + p.rp * p.tmp * 4;
  const int smem = p.off_xr + p.rp * p.tmp * 4;
  // 4 consecutive base columns in one load and store
  const int ovec = reinterpret_cast<uintptr_t>(base) % (4 * esz) == 0 &&
                   out_dim % 4 == 0 && (heads == 0 || head_dim % 4 == 0);
  const dim3 grid(cluster, (S + tm - 1) / tm, slots);
  const cudaError_t e = hopper::launch_split(
      lora_shrink_expand_kernel<T>, grid, kThreads, smem, cluster, stream,
      static_cast<const T*>(x), static_cast<const T*>(a),
      static_cast<const T*>(b), static_cast<const int*>(rows),
      static_cast<const float*>(scaling), static_cast<T*>(base), S, in_dim,
      out_dim, R, L, layer, heads, head_dim, vec, bvec, ovec, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// base [slots * S, out_dim] += the delta of x [slots * S, in_dim] under
// pages rows[slots] (int32) of a [P, L, R, in_dim] and b [P, L, R,
// out_dim] (head-grouped [heads, 3, head_dim] when heads > 0), scaling [P]
// f32; dtype 0 = float, 1 = bfloat16; R <= 64. vec 1 when in_dim is a
// multiple of 8 and x and a have 16-byte bases (their rows then arrive by
// bulk copies); bvec 1 when out_dim rows of b are whole 16-byte units and
// b has a 16-byte base (B then arrives by 16-byte cp.async). The plan (the
// wrapper's `_plan`): `cluster` CTAs share in_dim (1 to 16), `tm` rows of a
// slot a tile (1 to 16), `nseg` segments of the shrink (a power of two up
// to 32, nseg times the 4 x 4 tiles of xr at most 256). Returns
// cudaGetLastError(), or cudaErrorInvalidValue for what it does not take.
int batched_lora(const void* x, const void* a, const void* b,
                 const void* rows, const void* scaling, void* base, int slots,
                 int S, int in_dim, int out_dim, int R, int L, int layer,
                 int heads, int head_dim, int dtype, int vec, int bvec,
                 int cluster, int tm, int nseg, void* stream) {
  const int tiles = (tm + 3) / 4 * ((R + 3) / 4);
  if (R < 1 || R > kMaxRank || cluster < 1 || cluster > hopper::kMaxCluster
      || tm < 1 || tm > kMaxTile || nseg < 1 || nseg > kMaxSeg
      || (nseg & (nseg - 1)) || nseg * tiles > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (slots == 0 || S == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, a, b, rows, scaling, base, slots, S,
                                 in_dim, out_dim, R, L, layer, heads,
                                 head_dim, vec, bvec, cluster, tm, nseg, st);
  return launch<float>(x, a, b, rows, scaling, base, slots, S, in_dim,
                       out_dim, R, L, layer, heads, head_dim, vec, bvec,
                       cluster, tm, nseg, st);
}

}  // extern "C"
