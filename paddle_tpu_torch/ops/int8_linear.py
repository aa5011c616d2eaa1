"""A linear layer over int8 weights: the wrapper of `csrc/int8_linear.cu`
and its plain version.

`int8_linear(x, q, s, b)` is `x @ dequantize(q, s, x.dtype)^T + b` for int8
codes `q` `[N, K]` (torch's `[out, in]`) with per-output-channel scales `s`
`[N, 1]` in x's dtype, as the JAX package's int8 serving computes its
qkv, out, fc1 and fc2 projections (the dequantize inside the compiled
step, paddle_tpu/inference/engine.py `_materialize_state`). On a CPU
tensor it runs the plain version, `dequantize` then `torch.matmul` then
`+ b`; on a CUDA tensor it launches the kernel, which dequantizes in its
mainloop so the device reads int8 bytes (bf16 on the tensor cores, f32 in
fp32 FMA), or raises. It counts `.launches` and `.plain_calls`.

The bf16 kernel splits K over the CTAs of a thread-block cluster; `_plan`
is its launch plan, here so that the CPU tests can pin it. The split
depends on M and K alone, never on N: a tensor-parallel shard's launch
(N / mp rows of codes) then sums each column in the same order as the
whole launch, and its output is bitwise the whole launch's columns.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..quantization import dequantize
from ..utils import cpp_extension

__all__ = ["int8_linear", "int8_linear_plain"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_SMS = 132                  # the H100 SXM's streaming multiprocessors
_MAX_SPLIT = 8              # the portable thread-block cluster size


@functools.lru_cache(maxsize=None)
def _plan(M, N, K):
    """The bf16 kernel's launch plan `(split, bn, bm)` for x `[M, K]` and
    codes `[N, K]`: `split` CTAs of a cluster share K, from M and K alone
    (1 to 8: about 1024 of K a CTA where M <= 16 or M > 64, 2 at K 2048
    and 8 at K 8192; about 512 at 16 < M <= 64, the verify step, where a
    64-row tile's CTAs are few); `bm` rows of x a tile, 8 or 16 where
    M <= 16 (the weight-as-A kernel), else 64; `bn` output channels a CTA:
    64 at bm 64, else the widest of 64 and 32 that still gives two CTAs an
    SM, or 16."""
    bm = 8 if M <= 8 else 16 if M <= 16 else 64
    per_cta = 512 if 16 < M <= 64 else 1024
    split = max(1, min(_MAX_SPLIT, (K + per_cta // 2) // per_cta))
    if bm == 64:
        return split, 64, bm
    bn = next((b for b in (64, 32) if -(-N // b) * split >= 2 * _SMS), 16)
    return split, bn, bm


@functools.lru_cache(maxsize=None)
def _kernel():
    fn = cpp_extension.load("int8_linear").w8_linear
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, I, I, I, I, I, I, P]
    fn.restype = I
    return fn


def int8_linear_plain(x, q, s, b=None):
    """`torch.matmul(x, dequantize(q, s, x.dtype).T)`, then `+ b`."""
    int8_linear.plain_calls += 1
    y = torch.matmul(x, dequantize(q, s, x.dtype).t())
    return y if b is None else y + b


def _aligned(t):
    return t.data_ptr() % 16 == 0


def int8_linear(x, q, s, b=None):
    """`x [..., K] @ dequantize(q [N, K], s [N, 1], x.dtype)^T + b [N]`
    -> `[..., N]`: the plain version on a CPU tensor, one kernel launch on
    a CUDA one. The kernel takes bf16 or f32 x, K a multiple of 16,
    contiguous int8 codes and 16-byte aligned bases; anything else raises
    a ValueError."""
    if x.device.type == "cpu":
        return int8_linear_plain(x, q, s, b)
    N, K = q.shape
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"int8_linear: x dtype {x.dtype} has no kernel "
                         "(bfloat16 or float32)")
    if x.shape[-1] != K or K % 16:
        raise ValueError(f"int8_linear: x's last dim {x.shape[-1]} must be "
                         f"the codes' K = {K}, a multiple of 16")
    if q.dtype != torch.int8 or not q.is_contiguous():
        raise ValueError("int8_linear: codes must be contiguous int8 "
                         "[N, K]")
    if s.dtype != x.dtype or s.numel() != N:
        raise ValueError(f"int8_linear: scales must be [{N}, 1] in "
                         f"{x.dtype}")
    if b is not None and (b.dtype != x.dtype or b.numel() != N):
        raise ValueError(f"int8_linear: bias must be [{N}] in {x.dtype}")
    ts = [t for t in (q, s, b) if t is not None]
    if any(t.device != x.device for t in ts):
        raise ValueError("int8_linear: every operand on x's device")
    x2 = x.reshape(-1, K).contiguous()
    s = s.contiguous()
    b = None if b is None else b.contiguous()
    if not all(_aligned(t) for t in (x2, q)):
        raise ValueError("int8_linear: x and the codes need 16-byte "
                         "aligned bases")
    M = x2.shape[0]
    y = torch.empty((M, N), dtype=x.dtype, device=x.device)
    split, bn, bm = _plan(M, N, K)
    int8_linear.launches += 1
    err = _kernel()(x2.data_ptr(), q.data_ptr(), s.data_ptr(),
                    None if b is None else b.data_ptr(), y.data_ptr(), M, N,
                    K, _DTYPE_CODE[x.dtype], split, bn, bm,
                    torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f"int8_linear kernel launch failed: CUDA error "
                           f"{err}")
    return y.reshape(*x.shape[:-1], N)


int8_linear.launches = 0
int8_linear.plain_calls = 0
