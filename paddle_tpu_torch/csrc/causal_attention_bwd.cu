// Causal self-attention backward for Hopper (sm_90a).
//
// Replaces: paddle_tpu/ops/pallas/flash_attention.py `_causal_bwd_kernel`
// (entry `_causal_call_bwd`, the backward of `_causal_attention`'s
// custom_vjp). Plain PyTorch version and wrapper:
// paddle_tpu_torch/ops/flash_attention.py (`causal_attention_bwd`).
//
// The bodies are attention_bwd.cuh's, with CAUSAL set and no key mask;
// that header says what they compute, where they round and how the work is
// split into three launches with no atomics. This file keeps the kernels'
// names (`delta_mma_kernel`, `dkdv_mma_kernel`, `dq_mma_kernel` for bf16,
// `*_fma_kernel` for f32) and the C entry point. The dK/dV CTA walks the q
// tiles from the diagonal to S, the dQ CTA the key tiles up to it; the
// CTAs with the longest walks are launched first.
//
// Bound on this card: operations. 5 * BH * D * S * (S + 1) causal FLOP
// over 989 TFLOP/s bf16: at B2 H16 S2048 D128 that is 85.9 GFLOP, about
// 87 us; the bytes (q, k, v, O, dO read, dq, dk, dv written, ~134 MB) take
// 40 us at 3.35 TB/s.

#include "attention_bwd.cuh"

namespace {

using attn_bwd::bf16;

template <int D>
__global__ void delta_fma_kernel(const float* __restrict__ o,
                                 const float* __restrict__ dout,
                                 float* __restrict__ delta, int rows) {
  attn_bwd::delta_fma<D>(o, dout, delta, rows);
}

template <int D>
__global__ void __launch_bounds__(attn_bwd::kThreads) dkdv_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dk,
    float* __restrict__ dv, int S, int heads_per_row, float scale) {
  attn_bwd::dkdv_fma<D, true, false>(q, k, v, dout, lse, delta, mask, dk, dv,
                                     S, heads_per_row, scale);
}

template <int D>
__global__ void __launch_bounds__(attn_bwd::kThreads) dq_fma_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, float* __restrict__ dq, int S,
    int heads_per_row, float scale) {
  attn_bwd::dq_fma<D, true, false>(q, k, v, dout, lse, delta, mask, dq, S,
                                   heads_per_row, scale);
}

template <int D>
__global__ void delta_mma_kernel(const bf16* __restrict__ o,
                                 const bf16* __restrict__ dout,
                                 float* __restrict__ delta, int rows) {
  attn_bwd::delta_mma<D>(o, dout, delta, rows);
}

template <int D>
__global__ void __launch_bounds__(attn_bwd::kMmaThreads) dkdv_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int S, int heads_per_row, float scale) {
  attn_bwd::dkdv_mma<D, true, false>(q, k, v, dout, lse, delta, mask, dk, dv,
                                     S, S, heads_per_row, scale);
}

template <int D>
__global__ void __launch_bounds__(attn_bwd::kMmaThreads) dq_mma_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const float* __restrict__ mask, bf16* __restrict__ dq, int S,
    int heads_per_row, float scale) {
  attn_bwd::dq_mma<D, true, false>(q, k, v, dout, lse, delta, mask, dq, S,
                                   S, heads_per_row, scale);
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const void* lse, void* delta, void* dq,
           void* dk, void* dv, int dtype, int bh, int S, float scale,
           cudaStream_t st) {
  if (dtype == 0)
    return attn_bwd::launch_fma<D, false>(
        delta_fma_kernel<D>, dkdv_fma_kernel<D>, dq_fma_kernel<D>, q, k, v,
        o, dout, lse, nullptr, delta, dq, dk, dv, bh, S, 1, scale, st);
  return attn_bwd::launch_mma<D, false>(
      delta_mma_kernel<D>, dkdv_mma_kernel<D>, dq_mma_kernel<D>, q, k, v, o,
      dout, lse, nullptr, delta, dq, dk, dv, bh, S, 1, scale, st);
}

}  // namespace

// dtype: 0 = float32 (the fp32 FMA design), 1 = bfloat16 (mma.sync).
// q/k/v/o/dout/dq/dk/dv [bh, S, head_dim] contiguous and 16-byte aligned,
// lse [bh, S] fp32 (the forward's), delta [bh, S] fp32 scratch. Returns
// the first failing launch's cudaError_t (0 on success).
extern "C" int causal_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* o,
                                    const void* dout, const void* lse,
                                    void* delta, void* dq, void* dk, void* dv,
                                    int dtype, int bh, int S, int head_dim,
                                    float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (head_dim == 64)
    return launch<64>(q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, bh, S,
                      scale, st);
  if (head_dim == 128)
    return launch<128>(q, k, v, o, dout, lse, delta, dq, dk, dv, dtype, bh, S,
                       scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
