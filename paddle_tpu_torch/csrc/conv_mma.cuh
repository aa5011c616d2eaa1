// Tensor-core pieces of the conv kernels for Hopper (sm_90a): tiles of
// NHWC rows in shared memory and the `mma.sync` fragments read from them.
// The bf16 kernels of conv_bn_relu_bwd.cu (the 3x3 dWeight B11, the 1x1
// backward B10) and of conv_bn_relu.cu (the forwards B7 and B8 and the
// train forwards B9a and B9b) use them.
//
// A tile holds rows of 64 bf16 channels (128 bytes, eight 16-byte chunks):
// a pixel's channels [c0, c0 + 64) of an NHWC tensor, one row a pixel
// (a "slot"). Rows are read by `ldmatrix`, eight rows at one chunk, so the
// chunks of row r are stored XOR-swizzled by r % 8 (`tile_offset`), as
// attention_mma.cuh does for its [rows][D] tiles: eight consecutive slots
// spread over all 32 banks. A row is copied with `cp.async` 16 bytes a
// lane; a pixel outside the tensor or channels past its end are
// zero-filled (`copy_chunk`), so a ragged tile needs no other check.
//
// The product is attention_mma.cuh's `mma_bf16` (m16n8k16, fp32
// accumulate) over k = 16 pixels:
//   - `a_trans`: A = X^T for a [pixel][channel] tile X, rows 16 channels,
//     columns 16 pixels (a dWeight's x^T). Each lane names its own slot
//     (pixel k0 + (lane & 7) + 8 (lane >> 4)), so the 16 pixels may sit
//     anywhere in the tile: a 3x3 tap is the same read at shifted slots;
//   - `a_rows`: A = X itself for a [pixel][channel] tile X, rows 16
//     pixels, columns 16 channels (B10's dConv in dX, B8's x). Each lane
//     names the slot of pixel `lane & 15` (`a_row`), so a 3x3 tap is again
//     the same read at shifted slots;
//   - `b_trans`: B = X for a [row][channel] tile X whose rows k0 .. k0 +
//     15 are the 16 k values, columns channels n0 .. n0 + 15 as two
//     8-column blocks: b(block 0) = {r[0], r[1]}, b(block 1) = {r[2], r[3]}
//     (a dWeight's dConv over pixels; B10's wt [co][ci] and B8's w [ci][co]
//     over channels).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "attention_mma.cuh"

namespace conv_mma {

using bf16 = __nv_bfloat16;
using attn_mma::cp_async_16;
using attn_mma::cp_async_4;
using attn_mma::cp_async_commit;
using attn_mma::cp_async_wait;
using attn_mma::ldsm_x4;
using attn_mma::ldsm_x4_trans;
using attn_mma::mma_bf16;
using attn_mma::pack_bf16x2;
using attn_mma::smem_u32;

constexpr int kCh = 64;               // channels a tile row holds
constexpr int kRowBytes = kCh * 2;    // 128

// byte offset of chunk c (8 channels) of slot r in a swizzled tile
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return static_cast<uint32_t>(r) * kRowBytes +
         static_cast<uint32_t>((c ^ (r & 7)) << 4);
}

// chunk c of slot r <- 8 channels at src, zero-filled when !valid
__device__ __forceinline__ void copy_chunk(uint32_t tile, int r, int c,
                                           const bf16* src, bool valid) {
  cp_async_16(tile + tile_offset(r, c), src, valid);
}

// A fragment (16 channels from chunk 2 * cb, 16 pixels) of a
// [pixel][channel] tile; `slot` is this lane's pixel's row
__device__ __forceinline__ void a_trans(uint32_t (&a)[4], uint32_t tile,
                                        int slot, int cb, int lane) {
  ldsm_x4_trans(a, tile + tile_offset(slot, 2 * cb + ((lane >> 3) & 1)));
}

// the lane's pixel offset in a 16-pixel k-step for `a_trans`
__device__ __forceinline__ int a_pixel(int lane) {
  return (lane & 7) + ((lane >> 4) << 3);
}

// A fragment (16 pixels, 16 channels from chunk 2 * cb) of a
// [pixel][channel] tile read as it is; `slot` is this lane's pixel's row:
// lanes 0-15 name pixels 0-15 at channels 0-7, lanes 16-31 the same pixels
// at channels 8-15, so r[0..3] are a[0..3]
__device__ __forceinline__ void a_rows(uint32_t (&a)[4], uint32_t tile,
                                       int slot, int cb, int lane) {
  ldsm_x4(a, tile + tile_offset(slot, 2 * cb + (lane >> 4)));
}

// the lane's pixel in a 16-pixel m-tile for `a_rows`
__device__ __forceinline__ int a_row(int lane) { return lane & 15; }

// B fragments (16 k rows from row k0, channels from chunk 2 * cb) of a
// [row][channel] tile; k0 a multiple of 8
__device__ __forceinline__ void b_trans(uint32_t (&b)[4], uint32_t tile,
                                        int k0, int cb, int lane) {
  ldsm_x4_trans(b, tile + tile_offset(k0 + (lane & 15),
                                      2 * cb + (lane >> 4)));
}

}  // namespace conv_mma
