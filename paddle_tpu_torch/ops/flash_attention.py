"""Causal attention: the CUDA kernels `csrc/causal_attention.cu` (forward)
and `csrc/causal_attention_bwd.cu` (backward), their plain PyTorch
versions, the autograd function that joins them, and the attention routing
of the port.

Counterpart of paddle_tpu/ops/pallas/flash_attention.py: the kernels
replace `_causal_fwd_kernel` and `_causal_bwd_kernel` (through
`_causal_call_fwd` / `_causal_call_bwd`, joined by `_causal_attention`'s
custom_vjp); `_CausalAttention` is that custom_vjp and
`chunked_causal_attention` goes through it. `flash_attention` ports the
routing.

`causal_attention_fwd` and `causal_attention_bwd` take the plain version
for CPU tensors and launch the kernel for CUDA tensors; they never fall
back. Each counts its kernel launches in `.launches` and every call of its
plain version, on any device, in `.plain_calls`.

Layouts: `[BH, S, D]` at the kernels, `[B, S, H, D]` (paddle layout) at
`chunked_causal_attention` and `flash_attention`. The LSE is `[BH, S]`
fp32; the TPU kernel's `[BH, 8, S]` was eight identical rows, padding for
the TPU's (8, 128) tiling.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils import cpp_extension

__all__ = ["causal_attention_fwd", "causal_attention_plain",
           "causal_attention_bwd", "causal_attention_bwd_plain",
           "chunked_causal_attention", "dense_attention", "flash_attention"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _causal_logits(q, k, scale):
    """fp32 causal logits `[BH, S, S]`, -1e30 above the diagonal."""
    S = q.shape[1]
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return torch.where(mask, logits, torch.full_like(logits, _NEG_INF))


def causal_attention_plain(q, k, v, scale):
    """Plain PyTorch version of the forward kernel: `[BH, S, D]` -> (O in
    q's dtype, LSE `[BH, S]` fp32). Exact per-row softmax as in
    `_causal_fwd_kernel`: fp32 logits, probabilities rounded to v's dtype
    before PV, fp32 PV, divide by the row sum, one cast."""
    causal_attention_fwd.plain_calls += 1
    logits = _causal_logits(q, k, scale)
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l))[..., 0]


def causal_attention_bwd_plain(q, k, v, o, do, lse, scale):
    """Plain PyTorch version of the backward kernel, written out from the
    formulas of `_causal_bwd_kernel`: p = exp(s - lse) in fp32 from the
    forward's LSE; dv = p_b^T do with p rounded to v's dtype; dp = do v^T
    and delta = rowsum(do * o) in fp32; ds = p * (dp - delta) * scale
    rounded to q's dtype; dq = ds k and dk = ds^T q in fp32, each cast
    once. Returns (dq, dk, dv) in q's dtype."""
    causal_attention_bwd.plain_calls += 1
    p = torch.exp(_causal_logits(q, k, scale) - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(1, 2), dof)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def _check_kernel_args(fn_name, named):
    q = named[0][1]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fn_name}: {name} is on {t.device}, the "
                             "kernel needs the card")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{fn_name}: {', '.join(n for n, _ in named)} "
                             "must share one shape and dtype")
    if q.dim() != 3:
        raise ValueError(f"{fn_name} takes [BH, S, D]")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn_name}: dtype {q.dtype} has no kernel "
                         "(float32 or bfloat16)")
    if q.shape[2] not in _HEAD_DIMS:
        raise ValueError(f"{fn_name}: head_dim {q.shape[2]} has no kernel "
                         f"(supported: {_HEAD_DIMS})")


@functools.lru_cache(maxsize=None)
def _bind(lib, name, n_pointers):
    """C function `name` of kernel library `lib`: `n_pointers` pointers,
    then dtype, bh, S, head_dim, the scale and the stream."""
    fn = getattr(cpp_extension.load(lib), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * n_pointers + [I] * 4 + [ctypes.c_float, P]
    fn.restype = I
    return fn


def causal_attention_fwd(q, k, v, scale=None):
    """Causal self-attention forward, `[BH, S, D]` -> (O `[BH, S, D]` in the
    input dtype, LSE `[BH, S]` fp32). CPU tensors take
    `causal_attention_plain`; CUDA tensors launch the kernel (any S,
    D in {64, 128}, float32 or bfloat16, contiguous) or raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, scale)
    _check_kernel_args("causal_attention_fwd", (("q", q), ("k", k),
                                                ("v", v)))
    BH, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    fn = _bind("causal_attention", "causal_attention_fwd", 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    causal_attention_fwd.launches += 1
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], BH, S, D, float(scale),
             stream)
    if err:
        raise RuntimeError(f"causal_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o, lse


causal_attention_fwd.launches = 0
causal_attention_fwd.plain_calls = 0


def causal_attention_bwd(q, k, v, o, do, lse, scale=None):
    """Causal self-attention backward, `[BH, S, D]` x5 and the forward's LSE
    `[BH, S]` fp32 -> (dq, dk, dv) in the input dtype. CPU tensors take
    `causal_attention_bwd_plain`; CUDA tensors launch the kernel (the
    forward's shapes and dtypes, all contiguous, the LSE fp32
    `[BH, S]`) or raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return causal_attention_bwd_plain(q, k, v, o, do, lse, scale)
    _check_kernel_args("causal_attention_bwd", (
        ("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    BH, S, D = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (BH, S) or not lse.is_contiguous()):
        raise ValueError("causal_attention_bwd: lse must be a contiguous "
                         f"float32 [{BH}, {S}] tensor on {q.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    fn = _bind("causal_attention_bwd", "causal_attention_bwd", 10)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    causal_attention_bwd.launches += 1
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], BH, S, D,
             float(scale), stream)
    if err:
        raise RuntimeError(f"causal_attention_bwd kernel launch failed: "
                           f"CUDA error {err}")
    return dq, dk, dv


causal_attention_bwd.launches = 0
causal_attention_bwd.plain_calls = 0


class _CausalAttention(torch.autograd.Function):
    """`[BH, S, D]` causal attention whose backward is
    `causal_attention_bwd` from the saved q, k, v, O and LSE: the port of
    `_causal_attention` / `_causal_vjp_fwd` / `_causal_vjp_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = causal_attention_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = causal_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                          ctx.scale)
        return dq, dk, dv, None


def chunked_causal_attention(q, k, v, scale=None):
    """Causal attention `[B, S, H, D]` -> `[B, S, H, D]` (the port of
    `chunked_causal_attention`), through `_CausalAttention`. When no
    gradient is needed (serving, `torch.no_grad()`), autograd saves
    nothing for a backward."""
    B, S, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)

    def to_bh(x):
        return x.transpose(1, 2).reshape(B * H, S, D).contiguous()

    o = _CausalAttention.apply(to_bh(q), to_bh(k), to_bh(v), scale)
    return o.reshape(B, H, S, D).transpose(1, 2)


def dense_attention(q, k, v, causal, scale=None, mask=None):
    """Plain PyTorch attention `[B, Sq, H, D]` x `[B, Skv, H, D]`, the JAX
    package's dense route (`_xla_attention`, and the dense branch of
    `scaled_dot_product_attention`): fp32 logits, a bottom-right-aligned
    causal mask for Sq != Skv, the additive `mask` (broadcastable to
    `[B, H, Sq, Skv]`), fp32 softmax, the probabilities cast to q's dtype
    before PV. Differentiable through autograd."""
    s = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    qh, kh, vh = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * s
    if causal:
        Sq, Skv = logits.shape[-2], logits.shape[-1]
        keep = torch.ones(Sq, Skv, dtype=torch.bool,
                          device=q.device).tril(Skv - Sq)
        logits = torch.where(keep, logits, torch.full_like(logits, _NEG_INF))
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.matmul(probs, vh).transpose(1, 2)


def flash_attention(q, k, v, causal=True, scale=None):
    """Mask-free attention `[B, Sq, H, D]` x `[B, Skv, H, D]` ->
    `[B, Sq, H, D]`, differentiable.

    Causal with Sq == Skv takes `chunked_causal_attention` (the kernels on
    the card, their plain versions on the CPU). Causal with Sq != Skv has
    no TPU kernel either: the JAX package computes it densely on every
    device, and so does the port (`dense_attention`, counted in
    `flash_attention.dense_calls`). Non-causal shapes go to kernels still
    to port and raise on every device."""
    Sq, Skv = q.shape[1], k.shape[1]
    if causal and Sq == Skv:
        return chunked_causal_attention(q, k, v, scale)
    if causal:
        flash_attention.dense_calls += 1
        return dense_attention(q, k, v, True, scale)
    raise NotImplementedError(
        f"flash_attention(causal=False) with Sq={Sq}, Skv={Skv} has no "
        "kernel in the port yet (the TPU package's _sdpa_fwd_kernel and "
        "shortseq kernels are still to port)")


flash_attention.dense_calls = 0
