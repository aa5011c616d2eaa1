// Short-sequence (encoder) attention backward for Hopper (sm_90a), mask-free
// and key-masked.
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_shortseq_bwd_kernel`
// and `_shortseq_bwd_kernel_masked` (entry `_shortseq_call_bwd`, the
// backward of `_shortseq_attention`'s custom_vjp). Plain PyTorch version
// and wrapper: paddle_tpu_torch/ops/flash_attention.py
// (`shortseq_attention_bwd`).
//
// `_shortseq_bwd_core` computes the causal backward's arithmetic without
// the causal mask and with the forward's key mask added to s again, so the
// bodies are attention_bwd.cuh's with CAUSAL off and MASKED set when a mask
// is given; that header says what they compute, where they round and how
// the work is split into three launches with no atomics. The dK/dV CTA of
// a 64-key tile walks every q tile, the dQ CTA of a 64-row q tile every
// key tile. The kernels are named apart from the causal backward's
// (`shortseq_delta_mma_kernel`, `shortseq_dkdv_mma_kernel`,
// `shortseq_dq_mma_kernel` for bf16, `shortseq_*_fma_kernel` for f32), so
// a profile and the SASS tell them apart. The TPU kernel does a whole head
// in one program from VMEM; a Hopper block cannot hold q, k, v, O and dO
// of one head at S 512 (320 KB in bf16).
//
// Bound on this card at the bench shape (B64 H12 S512 D64 bf16):
// operations. 10 * BH * S^2 * D = 128.8 GFLOP takes 0.130 ms at
// 989 TFLOP/s (the three launches do 14 * BH * S^2 * D, 180 GFLOP);
// reading q, k, v, O, dO and the LSE and writing dq, dk, dv, 404.2 MB,
// takes 0.121 ms at 3.35 TB/s. The bf16 path runs the products on the
// tensor cores (`mma.sync`, operands from swizzled shared memory filled by
// `cp.async`); not yet `wgmma` or TMA.

#include "attention_bwd.cuh"

namespace {

using attn_bwd::bf16;

constexpr int kMaxS = 512;

template <int D>
__global__ void shortseq_delta_fma_kernel(const float* __restrict__ o,
                                          const float* __restrict__ dout,
                                          float* __restrict__ delta,
                                          int rows) {
  attn_bwd::delta_fma<D>(o, dout, delta, rows);
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(attn_bwd::kThreads)
shortseq_dkdv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dk,
    float* __restrict__ dv, int S, int heads_per_row, float scale) {
  attn_bwd::dkdv_fma<D, false, MASKED>(q, k, v, dout, lse, delta, mask, dk,
                                       dv, S, heads_per_row, scale);
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(attn_bwd::kThreads) shortseq_dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dq, int S,
    int heads_per_row, float scale) {
  attn_bwd::dq_fma<D, false, MASKED>(q, k, v, dout, lse, delta, mask, dq, S,
                                     heads_per_row, scale);
}

template <int D>
__global__ void shortseq_delta_mma_kernel(const bf16* __restrict__ o,
                                          const bf16* __restrict__ dout,
                                          float* __restrict__ delta,
                                          int rows) {
  attn_bwd::delta_mma<D>(o, dout, delta, rows);
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(attn_bwd::kMmaThreads)
shortseq_dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int heads_per_row, float scale) {
  attn_bwd::dkdv_mma<D, false, MASKED>(q, k, v, dout, lse, delta, mask, dk,
                                       dv, S, S, heads_per_row, scale);
}

template <int D, bool MASKED>
__global__ void __launch_bounds__(attn_bwd::kMmaThreads)
shortseq_dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, bf16* __restrict__ dq, int S,
    int heads_per_row, float scale) {
  attn_bwd::dq_mma<D, false, MASKED>(q, k, v, dout, lse, delta, mask, dq, S,
                                     S, heads_per_row, scale);
}

template <int D, bool MASKED>
int launch(const void* q, const void* k, const void* v, const void* mask,
           const void* o, const void* dout, const void* lse, void* delta,
           void* dq, void* dk, void* dv, int dtype, int bh, int S,
           int heads_per_row, float scale, cudaStream_t st) {
  if (dtype == 0)
    return attn_bwd::launch_fma<D, MASKED>(
        shortseq_delta_fma_kernel<D>, shortseq_dkdv_fma_kernel<D, MASKED>,
        shortseq_dq_fma_kernel<D, MASKED>, q, k, v, o, dout, lse, mask,
        delta, dq, dk, dv, bh, S, heads_per_row, scale, st);
  return attn_bwd::launch_mma<D, MASKED>(
      shortseq_delta_mma_kernel<D>, shortseq_dkdv_mma_kernel<D, MASKED>,
      shortseq_dq_mma_kernel<D, MASKED>, q, k, v, o, dout, lse, mask, delta,
      dq, dk, dv, bh, S, heads_per_row, scale, st);
}

template <int D>
int launch_masked_or_not(const void* q, const void* k, const void* v,
                         const void* mask, const void* o, const void* dout,
                         const void* lse, void* delta, void* dq, void* dk,
                         void* dv, int dtype, int bh, int S,
                         int heads_per_row, float scale, cudaStream_t st) {
  if (mask != nullptr)
    return launch<D, true>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv,
                           dtype, bh, S, heads_per_row, scale, st);
  return launch<D, false>(q, k, v, mask, o, dout, lse, delta, dq, dk, dv,
                          dtype, bh, S, heads_per_row, scale, st);
}

}  // namespace

// dtype: 0 = float32 (the fp32 FMA design), 1 = bfloat16 (mma.sync).
// q/k/v/o/dout/dq/dk/dv [bh, S, head_dim] contiguous and 16-byte aligned,
// lse [bh, S] fp32 (the forward's), delta [bh, S] fp32 scratch. mask: NULL
// (the mask-free kernels) or the forward's [bh / heads_per_row, S] fp32 key
// mask (the masked kernels). S % 128 == 0 and S <= 512; head_dim 64 or
// 128. Returns the first failing launch's cudaError_t (0 on success).
extern "C" int shortseq_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* mask,
                                      const void* o, const void* dout,
                                      const void* lse, void* delta, void* dq,
                                      void* dk, void* dv, int dtype, int bh,
                                      int S, int head_dim, int heads_per_row,
                                      float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || S % 128 != 0 || S > kMaxS || heads_per_row <= 0 ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64)
    return launch_masked_or_not<64>(q, k, v, mask, o, dout, lse, delta, dq,
                                    dk, dv, dtype, bh, S, heads_per_row,
                                    scale, st);
  if (head_dim == 128)
    return launch_masked_or_not<128>(q, k, v, mask, o, dout, lse, delta, dq,
                                     dk, dv, dtype, bh, S, heads_per_row,
                                     scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
