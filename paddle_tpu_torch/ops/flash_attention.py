"""Attention kernels of the port, their plain PyTorch versions, the
autograd functions that join them, and the attention routing.

Counterpart of paddle_tpu/ops/pallas/flash_attention.py:
- causal (decoder) attention: `csrc/causal_attention.cu` and
  `csrc/causal_attention_bwd.cu` replace `_causal_fwd_kernel` and
  `_causal_bwd_kernel` (through `_causal_call_fwd` / `_causal_call_bwd`,
  joined by `_causal_attention`'s custom_vjp); `_CausalAttention` is that
  custom_vjp and `chunked_causal_attention` goes through it. Their
  bfloat16 path runs on the tensor cores (`mma.sync`, the fragment
  helpers of `csrc/attention_mma.cuh`), their float32 path in fp32 FMA;
- short-sequence (encoder) attention: `csrc/shortseq_attention.cu` and
  `csrc/shortseq_attention_bwd.cu` replace `_shortseq_fwd_kernel` /
  `_shortseq_fwd_kernel_masked` and `_shortseq_bwd_kernel` /
  `_shortseq_bwd_kernel_masked` (through `_shortseq_call_fwd` /
  `_shortseq_call_bwd`); `_ShortseqAttention` is `_shortseq_attention`'s
  custom_vjp and `shortseq_attention` goes through it. The forward's
  bfloat16 path runs on the tensor cores, its float32 path and the
  backward in fp32 FMA;
- the flash forward: `csrc/sdpa_forward.cu` replaces `_sdpa_fwd_kernel`
  (B6, through `pallas_sdpa_forward`), and also serves `flash_attention`'s
  library route, the shapes a TPU hands to jax's library flash kernel.
  Its bfloat16 path runs on the tensor cores, its float32 path in fp32
  FMA, head dims over 256 in a wide fp32 FMA design; its LSE variant
  feeds the library route's backward, `csrc/sdpa_backward.cu` (the
  backward of jax's library kernel, which has no Pallas counterpart),
  joined to it by `_LibraryAttention`;
- `flash_attention` ports the routing.

Each kernel wrapper takes the plain version for CPU tensors and launches
the kernel for CUDA tensors; it never falls back. It counts its kernel
launches in `.launches` and every call of its plain version, on any
device, in `.plain_calls`; the shortseq wrappers count launches of their
masked variant apart, in `.masked_launches`, and B6 its LSE variant in
`.lse_launches`.

Layouts: `[BH, S, D]` at the kernels, `[B, S, H, D]` (paddle layout) at
`chunked_causal_attention`, `shortseq_attention`, `pallas_sdpa_forward`
and `flash_attention`.
The LSE is `[BH, S]` fp32 and the shortseq key mask `[BH, S]` or `[B, S]`
fp32; the TPU kernels' `[BH, 8, S]` were eight identical rows, padding for
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
           "chunked_causal_attention", "shortseq_attention_fwd",
           "shortseq_attention_plain", "shortseq_attention_bwd",
           "shortseq_attention_bwd_plain", "shortseq_attention",
           "sdpa_forward", "sdpa_forward_plain", "sdpa_backward",
           "sdpa_backward_plain", "pallas_sdpa_forward",
           "dense_attention", "flash_attention"]

_NEG_INF = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _causal_logits(q, k, scale):
    """fp32 causal logits `[BH, S, S]`, -1e30 above the diagonal."""
    S = q.shape[1]
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    return torch.where(mask, logits, torch.full_like(logits, _NEG_INF))


def _softmax_pv(logits, v, dtype):
    """The forward kernels' arithmetic from fp32 logits `[BH, S, S]`: exact
    per-row softmax (row max, exp, sum), the probabilities rounded to v's
    dtype before an fp32 PV, divided by the row sum, one cast. Returns (O in
    `dtype`, LSE `[BH, S]` fp32)."""
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(dtype), (m + torch.log(l))[..., 0]


def _bwd_from_logits(logits, q, k, v, o, do, lse, scale):
    """The backward kernels' arithmetic from the forward's fp32 logits: p =
    exp(s - lse) in fp32; dv = p_b^T do with p rounded to v's dtype; dp =
    do v^T and delta = rowsum(do * o) in fp32; ds = p * (dp - delta) *
    scale rounded to q's dtype; dq = ds k and dk = ds^T q in fp32, each
    cast once. Returns (dq, dk, dv) in q's dtype."""
    p = torch.exp(logits - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.to(v.dtype).float().transpose(1, 2), dof)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    delta = (dof * o.float()).sum(-1, keepdim=True)
    ds = (p * (dp - delta) * scale).to(q.dtype).float()
    dq = torch.matmul(ds, k.float())
    dk = torch.matmul(ds.transpose(1, 2), q.float())
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def causal_attention_plain(q, k, v, scale):
    """Plain PyTorch version of the forward kernel: `[BH, S, D]` -> (O in
    q's dtype, LSE `[BH, S]` fp32), `_causal_fwd_kernel`'s arithmetic
    (`_softmax_pv`) over causal logits."""
    causal_attention_fwd.plain_calls += 1
    return _softmax_pv(_causal_logits(q, k, scale), v, q.dtype)


def causal_attention_bwd_plain(q, k, v, o, do, lse, scale):
    """Plain PyTorch version of the backward kernel, written out from the
    formulas of `_causal_bwd_kernel` (`_bwd_from_logits` over causal
    logits). Returns (dq, dk, dv) in q's dtype."""
    causal_attention_bwd.plain_calls += 1
    return _bwd_from_logits(_causal_logits(q, k, scale), q, k, v, o, do,
                            lse, scale)


def _check_kernel_args(fn_name, named, head_dims=_HEAD_DIMS):
    q = named[0][1]
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"{fn_name}: {name} is on {t.device}, the "
                             "kernel needs the card")
        if not t.is_contiguous():
            raise ValueError(f"{fn_name}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{fn_name}: {name} must be 16-byte aligned "
                             "(the kernels copy 16 bytes a lane)")
        if t.dtype != q.dtype or t.shape != q.shape:
            raise ValueError(f"{fn_name}: {', '.join(n for n, _ in named)} "
                             "must share one shape and dtype")
    if q.dim() != 3:
        raise ValueError(f"{fn_name} takes [BH, S, D]")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn_name}: dtype {q.dtype} has no kernel "
                         "(float32 or bfloat16)")
    if q.shape[2] not in head_dims:
        raise ValueError(f"{fn_name}: head_dim {q.shape[2]} has no kernel "
                         f"(supported: {head_dims})")


def _check_lse(fn_name, lse, q):
    BH, S, _ = q.shape
    if (lse.device != q.device or lse.dtype != torch.float32
            or lse.shape != (BH, S) or not lse.is_contiguous()):
        raise ValueError(f"{fn_name}: lse must be a contiguous float32 "
                         f"[{BH}, {S}] tensor on {q.device}")


@functools.lru_cache(maxsize=None)
def _bind(lib, name, n_pointers, n_ints=4):
    """C function `name` of kernel library `lib`: `n_pointers` pointers,
    then `n_ints` ints (dtype, bh, S, head_dim[, heads per mask row]), the
    scale and the stream."""
    fn = getattr(cpp_extension.load(lib), name)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P] * n_pointers + [I] * n_ints + [ctypes.c_float, P]
    fn.restype = I
    return fn


def causal_attention_fwd(q, k, v, scale=None):
    """Causal self-attention forward, `[BH, S, D]` -> (O `[BH, S, D]` in the
    input dtype, LSE `[BH, S]` fp32). CPU tensors take
    `causal_attention_plain`; CUDA tensors launch the kernel (any S,
    D in {64, 128}, float32 or bfloat16, contiguous and 16-byte aligned)
    or raise. bfloat16 runs on the tensor cores, float32 in fp32 FMA."""
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
    forward's shapes and dtypes, all contiguous and 16-byte aligned, the
    LSE fp32 `[BH, S]`) or raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return causal_attention_bwd_plain(q, k, v, o, do, lse, scale)
    _check_kernel_args("causal_attention_bwd", (
        ("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    BH, S, D = q.shape
    _check_lse("causal_attention_bwd", lse, q)
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


def _to_bh(x):
    """`[B, S, H, D]` -> contiguous `[B * H, S, D]`."""
    B, S, H, D = x.shape
    return x.transpose(1, 2).reshape(B * H, S, D).contiguous()


def _from_bh(o, B):
    """`[B * H, S, D]` -> `[B, S, H, D]` (a view)."""
    BH, S, D = o.shape
    return o.reshape(B, BH // B, S, D).transpose(1, 2)


def chunked_causal_attention(q, k, v, scale=None):
    """Causal attention `[B, S, H, D]` -> `[B, S, H, D]` (the port of
    `chunked_causal_attention`), through `_CausalAttention`. When no
    gradient is needed (serving, `torch.no_grad()`), autograd saves
    nothing for a backward."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    o = _CausalAttention.apply(_to_bh(q), _to_bh(k), _to_bh(v), scale)
    return _from_bh(o, q.shape[0])


# ---------------------------------------------------------------------------
# short-sequence (encoder) attention
# ---------------------------------------------------------------------------
_SHORTSEQ_MAX_S = 512


def _shapes_ok_for_shortseq(Sq, Skv, D):
    """The TPU shortseq kernels' shapes (`_shapes_ok_for_shortseq`):
    non-causal self-attention with S <= 512, S % 128 == 0, D in {64, 128}."""
    return (Sq == Skv and Sq <= _SHORTSEQ_MAX_S and Sq % 128 == 0
            and D in _HEAD_DIMS)


def _shapes_ok_for_causal(Sq, Skv, D):
    """The causal kernel's shapes: self-attention at head dim 64 or 128, as
    the TPU kernel's `_shapes_ok_for_causal` takes them. Its further terms
    (S a multiple of a 128-512 q block, a VMEM budget, an unroll bound)
    are TPU tiling limits the CUDA kernel does not have: it takes any
    length."""
    return Sq == Skv and D in _HEAD_DIMS


def _shapes_ok_for_lib(Sq, Skv, D):
    """The shapes the JAX package hands to jax's library flash kernel on a
    TPU (`_shapes_ok_for_lib`). The port gives their forward to B6
    (`sdpa_forward`, the port of `_sdpa_fwd_kernel`) and their backward to
    `sdpa_backward`, which take head dims up to 512."""
    return (Sq >= 128 and Sq % 128 == 0 and Skv >= 128 and Skv % 128 == 0
            and D % 64 == 0)


def _mask_rows(key_mask, BH):
    """fp32 key mask `[BH, S]` from `[BH, S]` or `[B, S]` (row b serves the
    heads b*H .. b*H + H - 1, as the TPU wrapper's `jnp.repeat`)."""
    km = key_mask.float()
    return km if km.shape[0] == BH else km.repeat_interleave(
        BH // km.shape[0], dim=0)


def _key_logits(q, k, scale, key_mask):
    """fp32 logits `[BH, S, S]` = q k^T * scale, plus the additive fp32 key
    mask over keys (whatever value it holds: -1e30, -inf or any other)."""
    logits = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    if key_mask is not None:
        logits = logits + _mask_rows(key_mask, q.shape[0])[:, None, :]
    return logits


def shortseq_attention_plain(q, k, v, scale, key_mask=None):
    """Plain PyTorch version of the shortseq forward kernel (both
    variants): `[BH, S, D]` -> (O in q's dtype, LSE `[BH, S]` fp32),
    `_shortseq_fwd_core`'s arithmetic (`_softmax_pv`) over non-causal
    logits plus the key mask. A row whose keys are all masked at -1e30
    gives the mean of v, as the TPU kernel does."""
    shortseq_attention_fwd.plain_calls += 1
    return _softmax_pv(_key_logits(q, k, scale, key_mask), v, q.dtype)


def shortseq_attention_bwd_plain(q, k, v, o, do, lse, scale, key_mask=None):
    """Plain PyTorch version of the shortseq backward kernel (both
    variants), `_shortseq_bwd_core`'s formulas (`_bwd_from_logits`) with
    the key mask added to s again. On a row whose keys are all masked at
    -1e30, s and the LSE both round to -1e30 and p = 1 for every key (not
    1/S): the TPU kernel's result, which this version and the kernel
    follow. Returns (dq, dk, dv) in q's dtype."""
    shortseq_attention_bwd.plain_calls += 1
    return _bwd_from_logits(_key_logits(q, k, scale, key_mask), q, k, v, o,
                            do, lse, scale)


def _check_shortseq_args(fn_name, q, key_mask):
    """The shortseq kernels' shapes, and the key mask as the kernel reads
    it. Returns (mask or None, heads per mask row)."""
    BH, S, D = q.shape
    if S % 128 or S > _SHORTSEQ_MAX_S:
        raise ValueError(f"{fn_name}: S={S} has no kernel (S % 128 == 0 "
                         f"and S <= {_SHORTSEQ_MAX_S})")
    if key_mask is None:
        return None, 1
    if (key_mask.device != q.device or key_mask.dtype != torch.float32
            or key_mask.dim() != 2 or key_mask.shape[1] != S
            or key_mask.shape[0] == 0 or BH % key_mask.shape[0]
            or not key_mask.is_contiguous()):
        raise ValueError(f"{fn_name}: key_mask must be a contiguous float32 "
                         f"[BH, {S}] or [B, {S}] tensor on {q.device} "
                         f"(BH={BH} a multiple of B)")
    return key_mask, BH // key_mask.shape[0]


def _count_launch(wrapper, key_mask):
    if key_mask is None:
        wrapper.launches += 1
    else:
        wrapper.masked_launches += 1


def shortseq_attention_fwd(q, k, v, scale=None, key_mask=None):
    """Non-causal whole-sequence attention forward, `[BH, S, D]` -> (O
    `[BH, S, D]` in the input dtype, LSE `[BH, S]` fp32), with an optional
    additive fp32 key mask `[BH, S]` or `[B, S]`. CPU tensors take
    `shortseq_attention_plain`; CUDA tensors launch the kernel (S % 128 ==
    0, S <= 512, D in {64, 128}, float32 or bfloat16, contiguous; the
    masked variant when a mask is given) or raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return shortseq_attention_plain(q, k, v, scale, key_mask)
    _check_kernel_args("shortseq_attention_fwd", (("q", q), ("k", k),
                                                  ("v", v)))
    km, hpm = _check_shortseq_args("shortseq_attention_fwd", q, key_mask)
    BH, S, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    fn = _bind("shortseq_attention", "shortseq_attention_fwd", 6, 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _count_launch(shortseq_attention_fwd, km)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if km is None else km.data_ptr(), o.data_ptr(),
             lse.data_ptr(), _DTYPE_CODE[q.dtype], BH, S, D, hpm,
             float(scale), stream)
    if err:
        raise RuntimeError(f"shortseq_attention kernel launch failed: CUDA "
                           f"error {err}")
    return o, lse


shortseq_attention_fwd.launches = 0
shortseq_attention_fwd.masked_launches = 0
shortseq_attention_fwd.plain_calls = 0


def shortseq_attention_bwd(q, k, v, o, do, lse, scale=None, key_mask=None):
    """Shortseq attention backward, `[BH, S, D]` x5, the forward's LSE
    `[BH, S]` fp32 and its key mask -> (dq, dk, dv) in the input dtype.
    CPU tensors take `shortseq_attention_bwd_plain`; CUDA tensors launch
    the kernel (the forward's shapes and dtypes, all contiguous) or
    raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return shortseq_attention_bwd_plain(q, k, v, o, do, lse, scale,
                                            key_mask)
    _check_kernel_args("shortseq_attention_bwd", (
        ("q", q), ("k", k), ("v", v), ("o", o), ("do", do)))
    km, hpm = _check_shortseq_args("shortseq_attention_bwd", q, key_mask)
    BH, S, D = q.shape
    _check_lse("shortseq_attention_bwd", lse, q)
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty((BH, S), dtype=torch.float32, device=q.device)
    fn = _bind("shortseq_attention_bwd", "shortseq_attention_bwd", 11, 5)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    _count_launch(shortseq_attention_bwd, km)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
             None if km is None else km.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], BH, S, D,
             hpm, float(scale), stream)
    if err:
        raise RuntimeError(f"shortseq_attention_bwd kernel launch failed: "
                           f"CUDA error {err}")
    return dq, dk, dv


shortseq_attention_bwd.launches = 0
shortseq_attention_bwd.masked_launches = 0
shortseq_attention_bwd.plain_calls = 0


class _ShortseqAttention(torch.autograd.Function):
    """`[BH, S, D]` non-causal attention with an optional key mask, whose
    backward is `shortseq_attention_bwd` from the saved q, k, v, mask, O
    and LSE: the port of `_shortseq_attention` / `_shortseq_vjp_fwd` /
    `_shortseq_vjp_bwd`. The mask is data and gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, key_mask, scale):
        o, lse = shortseq_attention_fwd(q, k, v, scale, key_mask)
        ctx.save_for_backward(q, k, v, key_mask, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, key_mask, o, lse = ctx.saved_tensors
        dq, dk, dv = shortseq_attention_bwd(q, k, v, o, do.contiguous(), lse,
                                            ctx.scale, key_mask)
        return dq, dk, dv, None, None


def shortseq_attention(q, k, v, scale=None, key_mask=None):
    """Non-causal self-attention `[B, S, H, D]` -> `[B, S, H, D]` (the port
    of `shortseq_attention`), through `_ShortseqAttention`. `key_mask` is an
    optional additive `[B, S]` mask over keys (0 for real tokens, -1e30 for
    padding, the encoder convention), cast to fp32 and broadcast over
    heads by the kernel."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[3])
    km = None if key_mask is None else key_mask.float().contiguous()
    o = _ShortseqAttention.apply(_to_bh(q), _to_bh(k), _to_bh(v), km, scale)
    return _from_bh(o, q.shape[0])


# ---------------------------------------------------------------------------
# the flash forward (B6) and the library route's backward
# ---------------------------------------------------------------------------
#: the largest head dim the kernels of the library route take
_SDPA_MAX_HEAD_DIM = 512
_SDPA_HEAD_DIMS = tuple(range(64, _SDPA_MAX_HEAD_DIM + 1, 64))


def _sdpa_logits(q, k, scale, causal):
    return (_causal_logits(q, k, scale) if causal
            else _key_logits(q, k, scale, None))


def sdpa_forward_plain(q, k, v, scale, causal=False, return_lse=False):
    """Plain PyTorch version of the flash forward kernel B6: q `[BH, Sq,
    D]` x k, v `[BH, Skv, D]` -> O `[BH, Sq, D]` in q's dtype, and with
    `return_lse` also the LSE `[BH, Sq]` fp32 (m + log(l): the row's max
    and its sum of exp(s - m)).

    `_sdpa_fwd_kernel`'s arithmetic: q, k and v cast to fp32; s = q k^T *
    scale; when causal (Sq == Skv), -1e30 where the key comes after the
    query; softmax; the probabilities stay fp32 for PV (unlike B1 and the
    dense route, which round them to v's dtype); O = acc / max(l, 1e-30)
    cast once. The kernel walks key blocks with an online softmax (a
    running max m, sum l and fp32 accumulator, each rescaled by exp(m_prev
    - m_new) at every block); this version takes the row's exact max over
    all keys at once, which is the same function: after the last block
    the kernel's m is that max, its l the row's sum of exp(s - m) and its
    acc the matching sum of p v, up to the order of fp32 sums."""
    sdpa_forward.plain_calls += 1
    s = _sdpa_logits(q, k, scale, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = (torch.matmul(p, v.float()) / l.clamp_min(1e-30)).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def _check_sdpa_args(fn_name, q_side, k_side):
    """B6's and the library backward's inputs: `q_side` the (name, tensor)
    pairs of q's shape `[BH, Sq, D]`, `k_side` those of k's `[BH, Skv,
    D]`; one BH, D and dtype, Sq and Skv > 0, D a multiple of 64 up to
    `_SDPA_MAX_HEAD_DIM` (512), which the error names."""
    q, k = q_side[0][1], k_side[0][1]
    D = q.shape[-1]
    _check_kernel_args(fn_name, q_side, _SDPA_HEAD_DIMS)
    _check_kernel_args(fn_name, k_side, _SDPA_HEAD_DIMS)
    if k.dtype != q.dtype or k.shape[0] != q.shape[0] or k.shape[2] != D \
            or q.shape[1] == 0 or k.shape[1] == 0:
        raise ValueError(f"{fn_name}: q [BH, Sq, D] and k, v [BH, Skv, D] "
                         "must share BH, D and dtype, with Sq, Skv > 0")


def sdpa_forward(q, k, v, scale=None, causal=False, return_lse=False):
    """Flash attention forward, q `[BH, Sq, D]` x k, v `[BH, Skv, D]` -> O
    `[BH, Sq, D]` in the input dtype, and with `return_lse` also the LSE
    `[BH, Sq]` fp32 (the kernel's LSE variant, which the library route's
    backward reads; its launches also count in `.lse_launches`). CPU
    tensors take `sdpa_forward_plain`; CUDA tensors launch B6 (any Sq and
    Skv, causal only at Sq == Skv; D a multiple of 64 up to 512: the
    tensor cores for bfloat16 and fp32 FMA for float32 up to 256, the wide
    FMA design for both above; contiguous) or raise. Causal with Sq != Skv
    raises on every device: the TPU kernel takes only Sq == Skv."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"sdpa_forward: causal needs Sq == Skv, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    if q.device.type == "cpu":
        return sdpa_forward_plain(q, k, v, scale, causal, return_lse)
    _check_sdpa_args("sdpa_forward", (("q", q),), (("k", k), ("v", v)))
    BH, Sq, D = q.shape
    o = torch.empty_like(q)
    lse = (torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    fn = _bind("sdpa_forward", "sdpa_forward", 5, 6)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sdpa_forward.launches += 1
    sdpa_forward.lse_launches += int(return_lse)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             None if lse is None else lse.data_ptr(), _DTYPE_CODE[q.dtype],
             BH, Sq, k.shape[1], D, int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"sdpa_forward kernel launch failed: CUDA error "
                           f"{err}")
    return (o, lse) if return_lse else o


sdpa_forward.launches = 0
sdpa_forward.lse_launches = 0
sdpa_forward.plain_calls = 0


def sdpa_backward_plain(q, k, v, o, do, lse, scale, causal=False):
    """Plain PyTorch version of the library route's backward kernel: the
    gradient of `sdpa_forward_plain` from its output O and LSE, in fp32,
    with the causal backward's rounding points (`_bwd_from_logits`): p =
    exp(s - lse); dv = p_b^T do with p rounded to v's dtype; dp = do v^T
    and delta = rowsum(do * o) in fp32; ds = p * (dp - delta) * scale
    rounded to q's dtype; dq = ds k, dk = ds^T q. For float32 inputs that
    is the exact gradient. Returns (dq, dk, dv) in q's dtype."""
    sdpa_backward.plain_calls += 1
    return _bwd_from_logits(_sdpa_logits(q, k, scale, causal), q, k, v, o,
                            do, lse, scale)


def sdpa_backward(q, k, v, o, do, lse, scale=None, causal=False):
    """The library route's attention backward: q, O, dO `[BH, Sq, D]`, k, v
    `[BH, Skv, D]` and B6's LSE `[BH, Sq]` fp32 -> (dq, dk, dv) in the
    input dtype. CPU tensors take `sdpa_backward_plain`; CUDA tensors
    launch the kernel (B6's shapes and dtypes: any Sq and Skv, causal only
    at Sq == Skv, D a multiple of 64 up to 512; the tensor cores for
    bfloat16 up to D 256, fp32 FMA otherwise; all contiguous and 16-byte
    aligned) or raise."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"sdpa_backward: causal needs Sq == Skv, got "
                         f"{q.shape[1]} and {k.shape[1]}")
    if q.device.type == "cpu":
        return sdpa_backward_plain(q, k, v, o, do, lse, scale, causal)
    _check_sdpa_args("sdpa_backward", (("q", q), ("o", o), ("do", do)),
                     (("k", k), ("v", v)))
    _check_lse("sdpa_backward", lse, q)
    BH, Sq, D = q.shape
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    fn = _bind("sdpa_backward", "sdpa_backward", 10, 6)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    sdpa_backward.launches += 1
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
             do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
             dk.data_ptr(), dv.data_ptr(), _DTYPE_CODE[q.dtype], BH, Sq,
             k.shape[1], D, int(causal), float(scale), stream)
    if err:
        raise RuntimeError(f"sdpa_backward kernel launch failed: CUDA error "
                           f"{err}")
    return dq, dk, dv


sdpa_backward.launches = 0
sdpa_backward.plain_calls = 0


class _LibraryAttention(torch.autograd.Function):
    """`[BH, S, D]` attention at the library route's shapes whose forward is
    B6 with its LSE and whose backward is `sdpa_backward` from the saved q,
    k, v, O and LSE: the port of jax's library flash kernel and its
    backward, which the JAX package takes there on a TPU."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        o, lse = sdpa_forward(q, k, v, scale, causal, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale, ctx.causal = scale, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = sdpa_backward(q, k, v, o, do.contiguous(), lse,
                                   ctx.scale, ctx.causal)
        return dq, dk, dv, None, None


def pallas_sdpa_forward(q, k, v, causal=True, scale=None, block_q=256,
                        block_k=256, interpret=False):
    """The port of the JAX entry point of B6: `[B, S, H, D]` (paddle
    layout) -> `[B, S, H, D]`, through `sdpa_forward`. As in JAX, each
    block is cut to S and S must be a multiple of both (an AssertionError
    otherwise). The blocks are checked and nothing more: the CUDA kernel
    tiles by its own 64-row tiles. `interpret` selects nothing either: the
    tensors' device does (the plain version on the CPU, the kernel on the
    card)."""
    B, S, H, D = q.shape
    block_q = min(block_q, S)
    block_k = min(block_k, S)
    if S % block_q or S % block_k:  # JAX's assert, kept under python -O
        raise AssertionError(f"pallas_sdpa_forward: S={S} must be a "
                             f"multiple of block_q={block_q} and "
                             f"block_k={block_k}")
    o = sdpa_forward(_to_bh(q), _to_bh(k), _to_bh(v), scale, causal)
    return _from_bh(o, B)


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
    `[B, Sq, H, D]`, differentiable. The JAX package's routing, in its
    order:
    - non-causal shortseq shapes (`_shapes_ok_for_shortseq`) take
      `shortseq_attention` (the kernels on the card, their plain versions
      on the CPU);
    - causal Sq == Skv at head dims 64 and 128 (`_shapes_ok_for_causal`)
      takes `chunked_causal_attention`;
    - shapes that a TPU hands to jax's library kernel
      (`_shapes_ok_for_lib`, non-causal or causal Sq == Skv): when no
      gradient is needed (grad mode off, or no input requires grad), B6
      (`sdpa_forward`); when one is, `_LibraryAttention` (B6 with its LSE,
      then `sdpa_backward`): the kernels on the card, their plain versions
      on the CPU;
    - every other shape (causal Sq != Skv, head dims or lengths no kernel
      takes, such as a causal head dim of 16) is dense on every device, as
      in JAX (`dense_attention`).
    Every dense computation counts in `flash_attention.dense_calls`."""
    Sq, Skv, D = q.shape[1], k.shape[1], q.shape[3]
    if not causal and _shapes_ok_for_shortseq(Sq, Skv, D):
        return shortseq_attention(q, k, v, scale)
    if causal and _shapes_ok_for_causal(Sq, Skv, D):
        return chunked_causal_attention(q, k, v, scale)
    if _shapes_ok_for_lib(Sq, Skv, D) and (not causal or Sq == Skv):
        qh, kh, vh = _to_bh(q), _to_bh(k), _to_bh(v)
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            s = scale if scale is not None else 1.0 / math.sqrt(D)
            o = _LibraryAttention.apply(qh, kh, vh, s, causal)
        else:
            o = sdpa_forward(qh, kh, vh, scale, causal)
        return _from_bh(o, q.shape[0])
    flash_attention.dense_calls += 1
    return dense_attention(q, k, v, causal, scale)


flash_attention.dense_calls = 0
