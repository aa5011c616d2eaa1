"""Structured neural-net ops of the paddle surface: counterpart of
paddle_tpu/ops/nn_ops.py (python/paddle/nn/functional), every function
with the JAX package's signature, through `ops.dispatch` under its
dispatch names (`conv2d` then `conv2d_bias`, `softmax_ce` and
`reduce_loss` inside `cross_entropy`, `flash_attention` and `sdpa` for
the two routes of `scaled_dot_product_attention`, ...).

JAX computes these outside its Pallas kernels (lax convolutions, reduce
windows, jnp), so the port computes them with torch ops; the attention
routes reach the port's attention kernels (`ops.flash_attention`).

- `linear` takes the weight `[in, out]` and rounds once: on the CPU a
  bf16 product and its bias are summed in fp32 and cast; on the card the
  bf16 GEMM accumulates in fp32 and the bias is added in its epilogue
  (`F.linear` over the weight's transposed view).
- `dropout` (and `dropout2d`, `dropout3d`, `alpha_dropout`, the output
  dropout of `scaled_dot_product_attention`,
  `fused_bias_dropout_residual_layer_norm`) draws its mask from the global
  key chain (`core.random.next_key`, jax's bits): after `paddle.seed(s)`
  the JAX package's mask bit for bit. The port's models draw theirs from
  their own torch generators through `dropout_with_generator` and
  `attention_with_generator`.
- `interpolate` is `jax.image.resize` / `scale_and_translate`: half-pixel
  centres, an antialiasing kernel when linear or cubic modes downsample,
  Keys cubic with a = -0.5, nearest as `floor((i + 0.5) * in / out)`;
  torch's `interpolate` differs in each.
- The NCHW ops take any memory format torch accepts. `data_format="NHWC"`
  is taken where JAX honours it (conv2d, batch_norm, pixel_unshuffle);
  where JAX ignores `data_format` or `ceil_mode` (the 2-D pools, the
  adaptive pools) the port raises NotImplementedError rather than pool
  the wrong axes. Adaptive pools whose sizes do not divide raise, as in
  JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch
from torch.nn import functional as F

from ..core import dtype as dtypes
from ..core.random import next_key
from . import threefry
from .conv import _pair, normalize_conv_padding
from .dispatch import apply, apply_nograd, as_tensor, const, unwrap
from .flash_attention import (_shapes_ok_for_shortseq, dense_attention,
                              flash_attention, shortseq_attention)
from .math import _scalar

__all__ = [
    "linear", "conv2d", "conv1d", "conv2d_transpose", "conv3d",
    "max_pool2d", "avg_pool2d", "adaptive_avg_pool2d", "adaptive_max_pool2d",
    "max_pool1d", "avg_pool1d", "global_avg_pool2d",
    "batch_norm", "layer_norm", "group_norm", "instance_norm", "rms_norm",
    "embedding", "dropout", "dropout2d",
    "softmax_with_cross_entropy", "cross_entropy", "mse_loss", "l1_loss",
    "nll_loss", "bce_loss", "bce_with_logits", "smooth_l1_loss",
    "kl_div", "cosine_similarity", "margin_ranking_loss",
    "hinge_embedding_loss",
    "scaled_dot_product_attention", "interpolate", "pixel_shuffle",
    "fused_bias_dropout_residual_layer_norm", "label_smooth",
    "temporal_shift", "unfold", "fold", "grid_sample", "affine_grid",
    "max_pool3d", "avg_pool3d", "normalize", "local_response_norm",
    "dropout3d", "alpha_dropout", "pixel_unshuffle", "sequence_mask",
    "square_error_cost", "log_loss", "sigmoid_focal_loss", "dice_loss",
    "npair_loss", "triplet_margin_loss", "cosine_embedding_loss",
    "margin_cross_entropy", "ctc_loss",
]

_LOW = (torch.bfloat16, torch.float16)


def _with_zero_grad(out, t):
    """`out` with `t` (broadcastable to it) on its autograd graph at zero
    gradient: JAX gives a label that only selects (`where(label == 1,
    ...)`) a zero gradient, not none."""
    return torch.where(torch.zeros((), dtype=torch.bool, device=t.device),
                       t.to(out.dtype), out)


def _opt(*ts):
    """The optional tensor operands that are given, as tensors."""
    return [as_tensor(t) for t in ts if t is not None]


# ---------------------------------------------------------------------------
# dense / conv
# ---------------------------------------------------------------------------

def linear(x, weight, bias=None):
    """y = x @ W + b, W `[in, out]` (paddle's layout): one rounding to the
    promoted dtype (fp32 accumulation, the bias added before the cast)."""
    x, weight = as_tensor(x), as_tensor(weight)

    def fn(a, w, *b):
        out_dtype = dtypes.promote_types(a.dtype, w.dtype)
        if out_dtype in _LOW and a.device.type == "cpu":
            out = torch.matmul(a.float(), w.float())
            if b:
                out = out + b[0].float()
            return out.to(out_dtype)
        if a.dtype != out_dtype:
            a = a.to(out_dtype)
        if w.dtype != out_dtype:
            w = w.to(out_dtype)
        if b and b[0].ndim == 1 and a.ndim >= 2:
            # one GEMM with the bias in its epilogue
            bb = b[0] if b[0].dtype == out_dtype else b[0].to(out_dtype)
            return F.linear(a, w.t(), bb)
        out = torch.matmul(a, w)
        if b:
            out = (out + b[0].to(out.dtype)).to(out_dtype)
        return out

    return apply("linear", fn, x, weight, *_opt(bias))


def _lax_pads(padding, window, stride, in_sizes):
    """A paddle padding spec over len(window) spatial dims as (lo, hi)
    pairs, lax's: an int, per-dim ints, 2 ints a dim, (lo, hi) pairs, or
    "SAME" (total (ceil(d/s) - 1) * s + k - d, lo = total // 2) / "VALID"."""
    n = len(window)
    if isinstance(padding, str):
        p = padding.upper()
        if p == "VALID":
            return [(0, 0)] * n
        if p != "SAME":
            raise ValueError(f"unsupported padding {padding!r}")
        out = []
        for d, k, s in zip(in_sizes, window, stride):
            total = max((-(-d // s) - 1) * s + k - d, 0)
            out.append((total // 2, total - total // 2))
        return out
    if isinstance(padding, (list, tuple)):
        if all(isinstance(p, (list, tuple)) for p in padding):
            return [(int(lo), int(hi)) for lo, hi in padding]
        if len(padding) == n:
            return [(int(p), int(p)) for p in padding]
        if len(padding) == 2 * n:
            return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                    for i in range(n)]
        raise ValueError(f"unsupported padding {padding!r}")
    return [(int(padding), int(padding))] * n


def _tuple(v, n):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v),) * n


def _conv_nd(a, w, stride, pads, dilation, groups):
    """lax.conv_general_dilated over NC... with (lo, hi) pads, cast to the
    input's dtype."""
    conv = {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[a.ndim]
    if all(lo == hi and lo >= 0 for lo, hi in pads):
        out = conv(a, w, None, stride, tuple(lo for lo, _ in pads), dilation,
                   groups)
    else:
        flat = [p for pair in pads[::-1] for p in pair]
        out = conv(F.pad(a, flat), w, None, stride, 0, dilation, groups)
    return out.to(a.dtype)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW"):
    """2-D convolution, weight OIHW, x NCHW or NHWC; then `bias` added
    after the conv's cast (dispatch `conv2d_bias`), as JAX adds it."""
    x, weight = as_tensor(x), as_tensor(weight)
    nhwc = data_format == "NHWC"
    stride, dilation = _pair(stride), _pair(dilation)
    window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    hw = x.shape[1:3] if nhwc else x.shape[2:]
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, window, stride,
                                                in_hw=hw)

    def fn(a, w):
        if nhwc:
            a = a.permute(0, 3, 1, 2)
        out = _conv_nd(a, w, stride, [(pt, pb), (pl, pr)], dilation, groups)
        return out.permute(0, 2, 3, 1) if nhwc else out

    out = apply("conv2d", fn, x, weight)
    if bias is not None:
        bshape = (1, 1, 1, -1) if nhwc else (1, -1, 1, 1)
        out = apply("conv2d_bias", lambda o, b: o + b.reshape(bshape), out,
                    as_tensor(bias))
    return out


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL"):
    x, weight = as_tensor(x), as_tensor(weight)
    stride, dilation = _tuple(stride, 1), _tuple(dilation, 1)
    window = [(weight.shape[2] - 1) * dilation[0] + 1]
    pads = _lax_pads(padding, window, stride, x.shape[2:])
    out = apply("conv1d", lambda a, w: _conv_nd(a, w, stride, pads,
                                                dilation, groups), x, weight)
    if bias is not None:
        out = apply("conv1d_bias", lambda o, b: o + b.reshape(1, -1, 1), out,
                    as_tensor(bias))
    return out


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW"):
    x, weight = as_tensor(x), as_tensor(weight)
    stride, dilation = _tuple(stride, 3), _tuple(dilation, 3)
    window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    pads = _lax_pads(padding, window, stride, x.shape[2:])
    out = apply("conv3d", lambda a, w: _conv_nd(a, w, stride, pads,
                                                dilation, groups), x, weight)
    if bias is not None:
        out = apply("conv3d_bias",
                    lambda o, b: o + b.reshape(1, -1, 1, 1, 1), out,
                    as_tensor(bias))
    return out


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, dilation=1, groups=1,
                     data_format="NCHW"):
    """Transposed conv, weight IOHW (`[in, out / groups, kh, kw]`), with
    JAX's padding: each side of the full transposed conv cut by its pad,
    `output_padding` added at the end."""
    x, weight = as_tensor(x), as_tensor(weight)
    stride, dilation = _pair(stride), _pair(dilation)
    opad = _pair(output_padding)
    if isinstance(padding, str):
        raise NotImplementedError("string padding for conv_transpose")
    pads = _lax_pads(padding, [1, 1], stride, x.shape[2:])

    def fn(a, w):
        full = F.conv_transpose2d(a, w, None, stride, 0, 0, groups,
                                  dilation)
        for ax, ((lo, hi), op) in enumerate(zip(pads, opad), 2):
            n = full.shape[ax] - lo - hi + op
            extra = max(0, lo + n - full.shape[ax])
            if extra:
                cfg = [0, 0] * (full.ndim - 1 - ax) + [0, extra]
                full = F.pad(full, cfg)
            full = full.narrow(ax, lo, n)
        return full.to(a.dtype)

    out = apply("conv2d_transpose", fn, x, weight)
    if bias is not None:
        out = apply("convt_bias", lambda o, b: o + b.reshape(1, -1, 1, 1),
                    out, as_tensor(bias))
    return out


# ---------------------------------------------------------------------------
# pooling
# ---------------------------------------------------------------------------

def _nchw_only(op, ceil_mode, data_format, first="NCHW"):
    if ceil_mode:
        raise NotImplementedError(
            f"{op}: ceil_mode=True (the JAX package ignores it; ROADMAP "
            "Queue C 29)")
    if data_format != first:
        raise NotImplementedError(
            f"{op}: data_format={data_format!r} (the JAX package pools the "
            f"{first} axes whatever the layout; ROADMAP Queue C 29)")


def _window_sum(a, ks, st, pads, value=0.0):
    """lax.reduce_window(add) with the pad value `value`."""
    flat = [p for pair in pads[::-1] for p in pair]
    pool = {3: F.avg_pool1d, 4: F.avg_pool2d, 5: F.avg_pool3d}[a.ndim]
    padded = F.pad(a, flat, value=value) if any(flat) else a
    if a.ndim == 3:
        return pool(padded, ks, st) * ks[0]
    return pool(padded, ks, st, divisor_override=1)


def _window_max(a, ks, st, pads):
    flat = [p for pair in pads[::-1] for p in pair]
    pool = {3: F.max_pool1d, 4: F.max_pool2d, 5: F.max_pool3d}[a.ndim]
    padded = F.pad(a, flat, value=-math.inf) if any(flat) else a
    return pool(padded, ks, st)


def _window_count(a, ks, st, pads):
    ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                      device=a.device)
    return _window_sum(ones, ks, st, pads)


def max_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               data_format="NCHW"):
    """Max pooling over NCHW, the window padded with -inf (JAX's
    `_pool2d`), the padding as `conv2d` takes it. `stride` defaults to the
    window."""
    _nchw_only("max_pool2d", ceil_mode, data_format)
    x = as_tensor(x)
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    pads = normalize_conv_padding(padding, ks, st, in_hw=x.shape[2:])
    return apply("max_pool2d", lambda a: _window_max(a, ks, st, pads), x)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               count_include_pad=True, data_format="NCHW"):
    _nchw_only("avg_pool2d", ceil_mode, data_format)
    x = as_tensor(x)
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    pads = normalize_conv_padding(padding, ks, st, in_hw=x.shape[2:])
    if count_include_pad:
        scale = 1.0 / (ks[0] * ks[1])
        return apply("avg_pool2d",
                     lambda a: _window_sum(a, ks, st, pads) * scale, x)
    return apply("avg_pool2d", lambda a: _window_sum(a, ks, st, pads)
                 / _window_count(a, ks, st, pads), x)


def _one(v):
    return int(v[0]) if isinstance(v, (list, tuple)) else int(v)


def max_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    x = as_tensor(x)
    ks = _one(kernel_size)
    st = ks if stride is None else _one(stride)
    pd = _one(padding)
    return apply("max_pool1d",
                 lambda a: _window_max(a, (ks,), (st,), [(pd, pd)]), x)


def avg_pool1d(x, kernel_size, stride=None, padding=0, ceil_mode=False):
    x = as_tensor(x)
    ks = _one(kernel_size)
    st = ks if stride is None else _one(stride)
    pd = _one(padding)
    return apply("avg_pool1d", lambda a: _window_sum(
        a, (ks,), (st,), [(pd, pd)]) / ks, x)


def _adaptive(op, x, output_size, data_format, reduce):
    _nchw_only(op, False, data_format)
    x = as_tensor(x)
    oh, ow = _pair(output_size)
    H, W = x.shape[2], x.shape[3]
    if H % oh or W % ow:
        raise NotImplementedError("adaptive pool with non-divisible sizes")
    kh, kw = H // oh, W // ow

    def fn(a):
        n, c = a.shape[0], a.shape[1]
        return reduce(a.reshape(n, c, oh, kh, ow, kw), (3, 5))

    return apply(op, fn, x)


def adaptive_avg_pool2d(x, output_size, data_format="NCHW"):
    """Adaptive average pooling over NCHW to `output_size`, for input sizes
    that are multiples of it (the mean over each H/oh x W/ow window);
    other sizes raise, as in JAX."""
    return _adaptive("adaptive_avg_pool2d", x, output_size, data_format,
                     lambda a, d: torch.mean(a, d))


def adaptive_max_pool2d(x, output_size, data_format="NCHW"):
    return _adaptive("adaptive_max_pool2d", x, output_size, data_format,
                     lambda a, d: torch.amax(a, d))


def global_avg_pool2d(x):
    return apply("global_avg_pool2d",
                 lambda a: a.mean((2, 3), keepdim=True), as_tensor(x))


def _pool3d_args(ceil_mode, data_format, return_mask=False):
    if ceil_mode:
        raise NotImplementedError("pool3d: ceil_mode=True not supported")
    if data_format != "NCDHW":
        raise NotImplementedError(
            f"pool3d: data_format={data_format!r}; NCDHW only")
    if return_mask:
        raise NotImplementedError("pool3d: return_mask not supported")


def max_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               return_mask=False, data_format="NCDHW"):
    """MaxPool3D over [B, C, D, H, W], the window padded with -inf."""
    _pool3d_args(ceil_mode, data_format, return_mask)
    ks = _tuple(kernel_size, 3)
    st = _tuple(stride if stride is not None else kernel_size, 3)
    pads = [(p, p) for p in _tuple(padding, 3)]
    return apply("max_pool3d", lambda a: _window_max(a, ks, st, pads),
                 as_tensor(x))


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW"):
    """AvgPool3D: the window sum over `divisor_override`, else over the
    count of unpadded elements (`exclusive`), else over the window."""
    _pool3d_args(ceil_mode, data_format)
    if divisor_override is not None and divisor_override <= 0:
        raise ValueError("divisor_override must be positive")
    ks = _tuple(kernel_size, 3)
    st = _tuple(stride if stride is not None else kernel_size, 3)
    pads = [(p, p) for p in _tuple(padding, 3)]

    def fn(a):
        out = _window_sum(a, ks, st, pads)
        if divisor_override is not None:
            return out / float(divisor_override)
        if exclusive:
            return out / _window_count(a, ks, st, pads)
        return out / float(np.prod(ks))

    return apply("avg_pool3d", fn, as_tensor(x))


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------

def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5,
               data_format="NCHW"):
    """BatchNorm over the channel axis (1, or the last for NHWC), both
    forms of JAX's `batch_norm`.

    Inference (`batch_norm_infer`): `(x - mean) * rsqrt(var + eps) *
    weight + bias` from the running statistics, op by op in the operands'
    dtype, as JAX's `infer_fn`.

    Training (`batch_norm`): single-pass fp32 batch statistics, mean32 and
    E[x^2] - mean32^2 clamped at 0 (var32); mean and var cast to x's
    dtype; `inv = rsqrt(var32 + eps)` cast to x's dtype; `(x - mean) *
    inv`, then `* weight`, then `+ bias`, each in x's dtype (or the
    promoted one). Gradients flow through the statistics. The running
    statistics update IN PLACE, outside autograd, as `momentum * running
    + (1 - momentum) * batch`, with the dtype-cast var times `n / max(n -
    1, 1)` (unbiased), each op in the buffers' dtype, as JAX's eager
    update rounds."""
    x = as_tensor(x)
    c_axis = 1 if data_format == "NCHW" else x.ndim - 1
    shape = [1] * x.ndim
    shape[c_axis] = x.shape[c_axis]
    red = [i for i in range(x.ndim) if i != c_axis]
    wb = _opt(weight, bias)

    def affine(out, rest):
        i = 0
        if weight is not None:
            out = out * rest[i].view(shape)
            i += 1
        if bias is not None:
            out = out + rest[i].view(shape)
        return out

    if training:
        def fn(a, *rest):
            af = a.float()
            mean32 = af.mean(dim=red)
            var32 = torch.clamp_min((af * af).mean(dim=red)
                                    - mean32 * mean32, 0.0)
            mean, var = mean32.to(a.dtype), var32.to(a.dtype)
            inv = torch.rsqrt(var32.view(shape) + epsilon).to(a.dtype)
            return affine((a - mean.view(shape)) * inv, rest), mean, var

        out, mean, var = apply("batch_norm", fn, x, *wb)
        if running_mean is not None:
            n = unwrap(x).numel() // x.shape[c_axis]
            update_running_stats(unwrap(running_mean), unwrap(running_var),
                                 mean, var, n, momentum)
        return out
    rm, rv = const(as_tensor(running_mean)), const(as_tensor(running_var))
    return apply("batch_norm_infer", lambda a, *rest: affine(
        (a - rm.view(shape)) * torch.rsqrt(rv.view(shape) + epsilon), rest),
        x, *wb)


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, n, momentum):
    """The running-stat side effect of BatchNorm's training form, IN PLACE:
    `momentum * running + (1 - momentum) * batch`, the batch var made
    unbiased as `var * (n / max(n - 1, 1))` from the dtype-cast `var`, each
    op rounding to the buffers' dtype (JAX's update, op for op)."""
    n = float(n)
    mean, var = unwrap(mean), unwrap(var)
    unbiased = var.detach() * (n / max(n - 1.0, 1.0))
    running_mean.copy_(momentum * running_mean
                       + (1 - momentum) * mean.detach())
    running_var.copy_(momentum * running_var + (1 - momentum) * unbiased)


def _affine_last(out, rest, weight, bias):
    i = 0
    if weight is not None:
        out = out * rest[i].to(out.dtype)
        i += 1
    if bias is not None:
        out = out + rest[i].to(out.dtype)
    return out


def layer_norm(x, normalized_shape, weight=None, bias=None, epsilon=1e-5):
    """LayerNorm over the trailing dims, in fp32 for bf16/f16 inputs, cast
    back once."""
    x = as_tensor(x)
    if isinstance(normalized_shape, int):
        normalized_shape = (normalized_shape,)
    dims = tuple(range(x.ndim - len(normalized_shape), x.ndim))

    def fn(a, *rest):
        af = a.float() if a.dtype in _LOW else a
        mean = af.mean(dims, keepdim=True)
        var = af.var(dims, correction=0, keepdim=True)
        out = (af - mean) * torch.rsqrt(var + epsilon)
        return _affine_last(out, rest, weight, bias).to(a.dtype)

    return apply("layer_norm", fn, x, *_opt(weight, bias))


def rms_norm(x, weight=None, epsilon=1e-6):
    """RMSNorm over the last dim, in fp32 for bf16/f16 inputs."""
    def fn(a, *w):
        af = a.float() if a.dtype in _LOW else a
        ms = torch.mean(torch.square(af), -1, keepdim=True)
        out = af * torch.rsqrt(ms + epsilon)
        if w:
            out = out * w[0].to(out.dtype)
        return out.to(a.dtype)

    return apply("rms_norm", fn, as_tensor(x), *_opt(weight))


def _channel_affine(out, rest, weight, bias, C):
    bshape = (1, C) + (1,) * (out.ndim - 2)
    i = 0
    if weight is not None:
        out = out * rest[i].reshape(bshape)
        i += 1
    if bias is not None:
        out = out + rest[i].reshape(bshape)
    return out


def group_norm(x, num_groups, weight=None, bias=None, epsilon=1e-5,
               data_format="NCHW"):
    x = as_tensor(x)
    C = x.shape[1]

    def fn(a, *rest):
        g = num_groups
        a2 = a.reshape(a.shape[0], g, C // g, *a.shape[2:])
        axes = tuple(range(2, a2.ndim))
        mean = a2.mean(axes, keepdim=True)
        var = a2.var(axes, correction=0, keepdim=True)
        out = ((a2 - mean) * torch.rsqrt(var + epsilon)).reshape(a.shape)
        return _channel_affine(out, rest, weight, bias, C)

    return apply("group_norm", fn, x, *_opt(weight, bias))


def instance_norm(x, weight=None, bias=None, epsilon=1e-5):
    x = as_tensor(x)
    axes = tuple(range(2, x.ndim))
    C = x.shape[1]

    def fn(a, *rest):
        mean = a.mean(axes, keepdim=True)
        var = a.var(axes, correction=0, keepdim=True)
        out = (a - mean) * torch.rsqrt(var + epsilon)
        return _channel_affine(out, rest, weight, bias, C)

    return apply("instance_norm", fn, x, *_opt(weight, bias))


# ---------------------------------------------------------------------------
# embedding / dropout
# ---------------------------------------------------------------------------

def embedding(ids, weight, padding_idx=None, sparse=False):
    """Rows of `weight` at `ids`; rows at `padding_idx` are zero. The
    gradient is the dense scatter-add into the weight."""
    idx = unwrap(as_tensor(ids)).long()
    weight = as_tensor(weight)

    def fn(w):
        out = w[idx.to(w.device)]
        if padding_idx is not None:
            keep = (idx != padding_idx).to(w.device)[..., None]
            out = torch.where(keep, out, torch.zeros((), dtype=out.dtype,
                                                     device=out.device))
        return out

    return apply("embedding", fn, weight)


def _keep_mask(key, keep, shape, device):
    """jax.random.bernoulli(key, keep, shape): uniform f32 < keep."""
    return threefry.uniform_shaped(key, tuple(shape), torch.float32,
                                   device=device) < keep


def dropout(x, p=0.5, training=True, mode="upscale_in_train", axis=None):
    """Dropout with the mask drawn from the global key chain (jax's bits:
    JAX's mask after the same `paddle.seed`). `axis` shares one draw over
    the other axes; `upscale_in_train` scales kept elements by 1/(1-p),
    `downscale_in_infer` keeps them as they are."""
    x = as_tensor(x)
    if not training or p == 0.0:
        return x
    key = next_key()
    keep = 1.0 - p
    axes = axis if isinstance(axis, (list, tuple)) else [axis]

    def fn(a):
        shape = a.shape if axis is None else tuple(
            a.shape[i] if i in axes else 1 for i in range(a.ndim))
        mask = _keep_mask(key, keep, shape, a.device)
        zero = torch.zeros((), dtype=a.dtype, device=a.device)
        if mode == "upscale_in_train":
            return torch.where(mask, a / _scalar(keep, a), zero)
        return torch.where(mask, a, zero)

    return apply("dropout", fn, x)


def dropout2d(x, p=0.5, training=True, data_format="NCHW"):
    axis = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, training, axis=axis)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    """Channel-wise dropout for 5-D inputs (whole [D,H,W] blocks)."""
    axis = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, training, axis=axis)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: dropped units take alpha' = -alpha * scale
    and the output is a * x + b with a = ((1-p)(1 + p alpha'^2))^-1/2,
    b = -a p alpha'."""
    x = as_tensor(x)
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    a_coef = ((1.0 - p) * (1.0 + p * alpha_p ** 2)) ** -0.5
    b_coef = -a_coef * p * alpha_p
    key = next_key()

    def fn(t):
        keep = _keep_mask(key, 1.0 - p, t.shape, t.device)
        kept = torch.where(keep, t, torch.full((), alpha_p, dtype=t.dtype,
                                               device=t.device))
        return (_scalar(a_coef, t) * kept + _scalar(b_coef, t)).to(t.dtype)

    return apply("alpha_dropout", fn, x)


def dropout_with_generator(x, p=0.5, training=True, generator=None):
    """The port's models' dropout, `upscale_in_train`: kept elements
    become x / (1 - p), the rest 0, in x's dtype. The keep mask is
    Bernoulli(1 - p) drawn from `generator` (a `torch.Generator` on x's
    device), which the model owns: the same generator state gives the same
    mask and each draw advances it."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout draws its mask from an explicit "
                         "torch.Generator; pass generator=")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

def _hard_labels(label, ndim, axis):
    if label.dim() == ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    return label


def _reduce_loss(loss, reduction):
    """`mean` or `sum` of `loss`; any other reduction leaves it as it is
    (the JAX package's `_reduce_loss`)."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def _softmax_ce_hard(lg, idx, axis, ignore_index):
    logp = torch.log_softmax(lg.float(), dim=axis)
    keep = idx != ignore_index
    ll = torch.gather(logp, axis, torch.where(keep, idx, 0))
    loss = torch.where(keep, -ll, torch.zeros((), device=ll.device))
    return loss.to(lg.dtype)


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """Softmax cross entropy per token, keeping `axis` with size 1, over
    an fp32 `log_softmax`. Hard labels (`softmax_ce`): -log p[label], 0
    where the label is `ignore_index`, cast back to the logits' dtype.
    Soft labels (`softmax_ce_soft`): -sum(label * log p), left in the
    promoted dtype, as the JAX package leaves it."""
    logits = as_tensor(logits)
    axis = axis % logits.ndim
    if soft_label:
        return apply("softmax_ce_soft", lambda lg, lb: -(
            lb * torch.log_softmax(lg.float(), dim=axis)).sum(
                axis, keepdim=True), logits, as_tensor(label))
    idx = _hard_labels(unwrap(as_tensor(label)), logits.ndim, axis)
    idx = idx.unsqueeze(axis).long().to(logits.device)
    return apply("softmax_ce", lambda lg: _softmax_ce_hard(
        lg, idx, axis, ignore_index), logits)


def _log_floor(p):
    """log(max(p, 1e-30)) in fp32: the probabilities' log of
    `use_softmax=False`."""
    return torch.log(torch.clamp_min(p.float(), 1e-30))


def _class_weights(weight, hard, ignore_index):
    """Each label's class weight, 0 where the label is ignored."""
    ignored = hard == ignore_index
    w = const(torch.as_tensor(weight, device=hard.device))
    return torch.where(ignored, torch.zeros((), dtype=w.dtype,
                                            device=w.device),
                       w[torch.where(ignored, 0, hard).long()])


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross entropy over `axis` with the JAX package's semantics and
    dispatches: hard or soft labels; `label_smoothing` turns hard labels
    into `onehot * (1 - eps) + eps / C` and then zeroes ignored rows
    (`ce_ignore_mask`); `use_softmax=False` takes `input` as probabilities
    (log of max(p, 1e-30), no softmax: `nll_hard` / `nll_soft`); `weight`
    scales each hard label's loss by its class weight (`ce_weight`). Then
    `squeeze_loss`, and `reduce_loss` unless `reduction` is none: mean is
    over the labels that are not ignored, or over the sum of the selected
    weights with `weight` (soft labels: the plain mean). A weight with soft
    labels raises, as in JAX."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none, sum or mean, got "
                         f"{reduction!r}")
    input = as_tensor(input)
    axis = axis % input.ndim
    hard = None if soft_label else _hard_labels(
        unwrap(as_tensor(label)), input.ndim, axis).to(input.device)
    smoothed = label_smoothing > 0.0 and not soft_label
    if smoothed:
        C = input.shape[axis]
        onehot = F.one_hot(torch.where(hard == ignore_index, 0, hard).long(),
                           C).float() * (hard != ignore_index).unsqueeze(-1)
        label = (onehot * (1 - label_smoothing) + label_smoothing / C) \
            .movedim(-1, axis)
        soft_label = True
    if use_softmax:
        loss = softmax_with_cross_entropy(input, label, soft_label, axis,
                                          ignore_index)
    elif soft_label:
        loss = apply("nll_soft", lambda p, lb: -(lb * _log_floor(p)).sum(
            axis, keepdim=True), input, as_tensor(label))
    else:
        idx = hard.unsqueeze(axis).long()
        keep = idx != ignore_index

        def nll(p):
            ll = torch.gather(_log_floor(p), axis, torch.where(keep, idx, 0))
            return torch.where(keep, -ll, torch.zeros(
                (), device=ll.device)).to(p.dtype)

        loss = apply("nll_hard", nll, input)
    if smoothed:
        # the soft path has no ignore_index: zero ignored rows so the
        # valid-count mean stays right
        valid = (hard != ignore_index).unsqueeze(axis)
        loss = apply("ce_ignore_mask", lambda l: torch.where(
            valid, l, torch.zeros((), dtype=l.dtype, device=l.device)),
            loss)
    wsel = None
    if weight is not None:
        if hard is None:
            raise ValueError(
                "weight with soft_label=True is not supported (pass hard "
                "labels, optionally with label_smoothing)")
        wsel = _class_weights(weight, hard, ignore_index)
        loss = apply("ce_weight", lambda l: l * wsel.unsqueeze(axis).to(
            l.dtype), loss)
    loss = apply("squeeze_loss", lambda l: l.squeeze(axis), loss)
    if reduction == "none":
        return loss
    if reduction == "sum" or hard is None:
        return apply("reduce_loss", lambda l: _reduce_loss(l, reduction),
                     loss)
    if wsel is not None:
        return apply("reduce_loss", lambda l: l.sum()
                     / wsel.sum().clamp_min(1e-12), loss)
    valid = (hard != ignore_index).float()
    return apply("reduce_loss", lambda l: l.sum()
                 / valid.sum().clamp_min(1.0), loss)


def mse_loss(input, label, reduction="mean"):
    """Squared error (input - label)^2 in the inputs' dtype, reduced by
    `reduction` (mean, sum, anything else: none), as the JAX package's
    `mse_loss` computes it."""
    return apply("mse_loss", lambda a, b: _reduce_loss(
        torch.square(a - b), reduction), as_tensor(input), as_tensor(label))


def l1_loss(input, label, reduction="mean"):
    return apply("l1_loss", lambda a, b: _reduce_loss(
        torch.abs(a - b), reduction), as_tensor(input), as_tensor(label))


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    def fn(a, b):
        d = torch.abs(a - b)
        return _reduce_loss(torch.where(d < delta, 0.5 * d * d / delta,
                                        d - 0.5 * delta), reduction)

    return apply("smooth_l1", fn, as_tensor(input), as_tensor(label))


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """NLL over log-probs, the class axis 1: input `[N, C]` or `[N, C, d1,
    ...]` with label `[N]` or `[N, d1, ...]`; mean over the labels not
    ignored, or over the selected weights with `weight`."""
    input = as_tensor(input)
    label = unwrap(as_tensor(label)).to(input.device)

    def fn(a):
        idx = label.unsqueeze(1).long()
        keep = idx != ignore_index
        ll = torch.gather(a, 1, torch.where(keep, idx, 0))
        loss = torch.where(keep, -ll, torch.zeros(
            (), dtype=a.dtype, device=a.device)).squeeze(1)
        if weight is not None:
            wsel = _class_weights(weight, label, ignore_index)
            loss = loss * wsel
            if reduction == "mean":
                return loss.sum() / wsel.sum().clamp_min(1e-12)
        elif reduction == "mean":
            return loss.sum() / keep.squeeze(1).to(loss.dtype).sum() \
                .clamp_min(1.0)
        return _reduce_loss(loss, reduction)

    return apply("nll_loss", fn, input)


def bce_loss(input, label, weight=None, reduction="mean"):
    w = const(weight)

    def fn(a, b):
        eps = 1e-12
        loss = -(b * torch.log(a + eps) + (1 - b) * torch.log(1 - a + eps))
        if w is not None:
            loss = loss * w
        return _reduce_loss(loss, reduction)

    return apply("bce_loss", fn, as_tensor(input), as_tensor(label))


def bce_with_logits(logit, label, weight=None, reduction="mean",
                    pos_weight=None):
    w = const(weight)
    pw = const(pos_weight)

    def fn(a, b):
        loss = torch.clamp_min(a, 0) - a * b \
            + torch.log1p(torch.exp(-torch.abs(a)))
        if pw is not None:
            loss = loss * (b * (pw - 1) + 1)
        if w is not None:
            loss = loss * w
        return _reduce_loss(loss, reduction)

    return apply("bce_logits", fn, as_tensor(logit), as_tensor(label))


def kl_div(input, label, reduction="mean"):
    return apply("kl_div", lambda a, b: _reduce_loss(
        b * (torch.log(torch.clamp_min(b, 1e-12)) - a), reduction),
        as_tensor(input), as_tensor(label))


def cosine_similarity(x1, x2, axis=1, eps=1e-8):
    def fn(a, b):
        num = torch.sum(a * b, axis)
        den = torch.linalg.vector_norm(a, dim=axis) * \
            torch.linalg.vector_norm(b, dim=axis)
        return num / torch.clamp_min(den, eps)

    return apply("cosine_similarity", fn, as_tensor(x1), as_tensor(x2))


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return apply("margin_ranking", lambda a, b, l: _reduce_loss(
        torch.clamp_min(-l * (a - b) + margin, 0.0), reduction),
        as_tensor(input), as_tensor(other), as_tensor(label))


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return apply("hinge_embedding", lambda a, l: _reduce_loss(
        _with_zero_grad(torch.where(l == 1.0, a, torch.clamp_min(
            margin - a, 0.0)), l), reduction),
        as_tensor(input), as_tensor(label))


def label_smooth(label, prior_dist=None, epsilon=0.1):
    label = as_tensor(label)
    k = label.shape[-1]
    prior = None if prior_dist is None else const(as_tensor(prior_dist))

    def fn(l):
        if prior is not None:
            return (1 - epsilon) * l + epsilon * prior.to(l.device)
        return (1 - epsilon) * l + epsilon / k

    return apply("label_smooth", fn, label)


def log_loss(input, label, epsilon=1e-4, name=None):
    return apply("log_loss", lambda p, y: -y * torch.log(p + epsilon)
                 - (1.0 - y) * torch.log(1.0 - p + epsilon),
                 as_tensor(input), as_tensor(label))


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """Focal loss on logits, divided by `normalizer` when given."""
    def fn(z, y, *rest):
        p = torch.sigmoid(z)
        ce = torch.clamp_min(z, 0) - z * y \
            + torch.log1p(torch.exp(-torch.abs(z)))
        p_t = p * y + (1 - p) * (1 - y)
        a_t = alpha * y + (1 - alpha) * (1 - y)
        loss = a_t * ((1 - p_t) ** gamma) * ce
        if rest:
            loss = loss / rest[0]
        return _reduce_loss(loss, reduction)

    return apply("sigmoid_focal_loss", fn, as_tensor(logit),
                 as_tensor(label), *_opt(normalizer))


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - the Dice coefficient over the trailing class dim: input `[N,
    ..., C]` probabilities, label `[N, ..., 1]` int."""
    def fn(a, l):
        oh = F.one_hot(l.squeeze(-1).long(), a.shape[-1]).to(a.dtype)
        red = tuple(range(1, a.dim()))
        inter = (a * oh).sum(red)
        union = a.sum(red) + oh.sum(red)
        return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()

    return apply("dice_loss", fn, as_tensor(input), as_tensor(label))


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Multi-class n-pair loss; the l2 term weighted by 0.25, as the
    reference weights it."""
    def fn(a, p, lab):
        sim = a @ p.T
        same = (lab[:, None] == lab[None, :]).to(a.dtype)
        same = same / same.sum(1, keepdim=True)
        xent = (-same * torch.log_softmax(sim, 1)).sum(1).mean()
        reg = l2_reg * ((a * a).sum(1).mean()
                        + (p * p).sum(1).mean()) * 0.25
        return xent + reg

    return apply("npair_loss", fn, as_tensor(anchor), as_tensor(positive),
                 as_tensor(labels))


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """max(d(a, pos) - d(a, neg) + margin, 0), d the p-norm distance with
    `epsilon` added once per distance, under the p-th root."""
    def dist(u, v):
        return ((torch.abs(u - v) ** p).sum(-1) + epsilon) ** (1 / p)

    def fn(a, pos, neg):
        dp, dn = dist(a, pos), dist(a, neg)
        if swap:
            dn = torch.minimum(dn, dist(pos, neg))
        return _reduce_loss(torch.clamp_min(dp - dn + margin, 0.0),
                            reduction)

    return apply("triplet_margin_loss", fn, as_tensor(input),
                 as_tensor(positive), as_tensor(negative))


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """label 1: 1 - cos; label -1: max(cos - margin, 0)."""
    def fn(a, b, lab):
        cos = (a * b).sum(-1) / torch.clamp_min(
            torch.linalg.vector_norm(a, dim=-1)
            * torch.linalg.vector_norm(b, dim=-1), 1e-12)
        loss = torch.where(lab > 0, 1.0 - cos,
                           torch.clamp_min(cos - margin, 0.0))
        return _reduce_loss(_with_zero_grad(loss, lab), reduction)

    return apply("cosine_embedding_loss", fn, as_tensor(input1),
                 as_tensor(input2), as_tensor(label))


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: `logits` are cosines, the target
    class's angle gets cos(m1 * theta + m2) - m3 before the scaled
    softmax cross entropy. `group` (model-parallel sharding) is not
    read, as in JAX."""
    def fn(lg, lab):
        oh = F.one_hot(lab.long(), lg.shape[-1]).to(lg.dtype)
        theta = torch.arccos(torch.clamp(lg, -1.0 + 1e-7, 1.0 - 1e-7))
        target = torch.cos(margin1 * theta + margin2) - margin3
        adj = lg * (1 - oh) + target * oh
        logp = torch.log_softmax(scale * adj, -1)
        loss = _reduce_loss(-(oh * logp).sum(-1), reduction)
        if return_softmax:
            return loss, torch.exp(logp)
        return loss

    return apply("margin_cross_entropy", fn, as_tensor(logits),
                 as_tensor(label))


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss by the log-domain forward algorithm, the JAX package's
    `lax.scan` over time as a loop: log_probs `[T, B, C]` (time-major; a
    log_softmax is applied, idempotent on log-probs), labels `[B, S]`.
    Returns the negative log-likelihood per sample, reduced; mean divides
    each sample by its label length first."""
    def fn(lp, labels, in_len, lab_len):
        lp = torch.log_softmax(lp, -1)
        T, B, _ = lp.shape
        S = labels.shape[1]
        L = 2 * S + 1
        NEG = -1e30
        dev = lp.device
        in_len, lab_len = in_len.to(dev), lab_len.to(dev)
        ext = torch.full((B, L), blank, dtype=torch.long, device=dev)
        ext[:, 1::2] = labels.long()
        ext_prev2 = F.pad(ext, (2, 0), value=blank)[:, :L]
        can_skip = (ext != blank) & (ext != ext_prev2)
        neg = torch.full((), NEG, dtype=lp.dtype, device=dev)
        alpha = torch.full((B, L), NEG, dtype=lp.dtype, device=dev)
        alpha = torch.cat([lp[0].gather(1, ext[:, :1]),
                           torch.where(lab_len[:, None] > 0,
                                       lp[0].gather(1, ext[:, 1:2]), neg),
                           alpha[:, 2:]], 1)
        for t in range(1, T):
            prev1 = F.pad(alpha, (1, 0), value=NEG)[:, :L]
            prev2 = F.pad(alpha, (2, 0), value=NEG)[:, :L]
            merged = torch.logaddexp(alpha, prev1)
            merged = torch.where(can_skip, torch.logaddexp(merged, prev2),
                                 merged)
            new = merged + lp[t].gather(1, ext)
            alpha = torch.where((t < in_len)[:, None], new, alpha)
        last = (2 * lab_len).long()
        a_n = alpha.gather(1, last[:, None])[:, 0]
        a_n1 = alpha.gather(1, torch.clamp_min(last - 1, 0)[:, None])[:, 0]
        nll = -torch.logaddexp(a_n, torch.where(lab_len > 0, a_n1, neg))
        if norm_by_times:
            nll = nll / in_len.to(nll.dtype)
        if reduction == "mean":
            return (nll / torch.clamp_min(lab_len, 1).to(nll.dtype)).mean()
        return _reduce_loss(nll, reduction)

    return apply("ctc_loss", fn, as_tensor(log_probs), as_tensor(labels),
                 as_tensor(input_lengths), as_tensor(label_lengths))


def square_error_cost(input, label):
    return apply("square_error_cost", lambda a, b: (a - b) ** 2,
                 as_tensor(input), as_tensor(label))


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _attention(q, k, v, attn_mask, dropout_p, is_causal, training, scale,
               drop):
    q, k, v = as_tensor(q), as_tensor(k), as_tensor(v)
    if attn_mask is None and dropout_p == 0.0:
        return apply("flash_attention", lambda qa, ka, va: flash_attention(
            qa, ka, va, causal=is_causal, scale=scale), q, k, v)
    mask = None if attn_mask is None else const(as_tensor(attn_mask))
    if (mask is not None and dropout_p == 0.0 and not is_causal
            and mask.dim() == 4 and mask.shape[1] == 1
            and mask.shape[2] == 1):
        B, Sq, _, D = q.shape
        Skv = k.shape[1]
        if (_shapes_ok_for_shortseq(Sq, Skv, D)
                and mask.shape[0] in (1, B) and mask.shape[3] == Skv):
            key_mask = mask[:, 0, 0, :].expand(B, Skv)
            return apply("flash_attention_keymask",
                         lambda qa, ka, va: shortseq_attention(
                             qa, ka, va, scale=scale, key_mask=key_mask),
                         q, k, v)
    out = apply("sdpa", lambda qa, ka, va: dense_attention(
        qa, ka, va, is_causal, scale, mask=mask), q, k, v)
    if dropout_p > 0.0 and training:
        out = drop(out, dropout_p)
    return out


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None):
    """Attention in paddle layout `[batch, seq, heads, head_dim]`, routed
    as the JAX package routes it:

    - no mask and `dropout_p == 0.0` (`flash_attention`): the port's
      `flash_attention`, which routes by shape (the shortseq and causal
      kernels, the library route, dense otherwise);
    - a key-only additive mask `[B or 1, 1, 1, Skv]`, `dropout_p == 0.0`,
      not causal, shortseq shapes (`flash_attention_keymask`): the
      shortseq kernels with that mask (the encoder padding mask);
    - everything else (`sdpa`): the dense branch: fp32 logits, the causal
      mask (bottom-right aligned) with `is_causal`, the additive
      `attn_mask` (broadcastable to `[B, H, Sq, Skv]`), fp32 softmax, the
      probabilities cast to q's dtype before PV.

    The routing reads `dropout_p` alone, not `training`: with
    `dropout_p > 0` and `training=False` the dense branch runs and drops
    nothing. With `dropout_p > 0` and `training`, the OUTPUT is dropped
    (`dropout`, the key chain), as the JAX package does."""
    return _attention(q, k, v, attn_mask, dropout_p, is_causal, training,
                      scale, lambda o, p: dropout(o, p, training=True))


def attention_with_generator(q, k, v, attn_mask=None, dropout_p=0.0,
                             is_causal=False, training=True, scale=None,
                             generator=None):
    """`scaled_dot_product_attention` for the port's models: the output
    dropout draws from `generator` (`dropout_with_generator`)."""
    return _attention(q, k, v, attn_mask, dropout_p, is_causal, training,
                      scale, lambda o, p: dropout_with_generator(
                          o, p, True, generator))


# ---------------------------------------------------------------------------
# resampling and vision
# ---------------------------------------------------------------------------

def _triangle(x):
    return torch.clamp_min(1 - torch.abs(x), 0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros((), device=x.device), out)


def _weight_mat(n_in, n_out, scale, translation, kernel, device):
    """jax.image's `compute_weight_mat` in fp32: the `[n_in, n_out]`
    weights of each output sample over the inputs, the kernel widened by
    1/scale when downsampling (antialiasing), each column normalized,
    zero where the sample lies outside the input."""
    f32 = dict(dtype=torch.float32, device=device)
    scale = torch.as_tensor(scale, **f32)
    translation = torch.as_tensor(translation, **f32)
    inv_scale = 1.0 / scale
    kernel_scale = torch.clamp_min(inv_scale, 1.0)
    sample_f = ((torch.arange(n_out, **f32) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
    x = torch.abs(sample_f[None, :] - torch.arange(n_in, **f32)[:, None]) \
        / kernel_scale
    w = kernel(x)
    total = torch.sum(w, 0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(torch.abs(total) > eps,
                    w / torch.where(total != 0, total, 1.0),
                    torch.zeros((), **f32))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros((), **f32))


def _resize_nearest(a, size):
    for d, n in zip((2, 3), size):
        m = a.shape[d]
        if m == n:
            continue
        off = (torch.arange(n, dtype=torch.float32, device=a.device) + 0.5) \
            * m / n
        a = torch.index_select(a, d, torch.floor(off).long())
    return a


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, data_format="NCHW"):
    """Resize NCHW images to `size` (or `scale_factor` times, truncated),
    as `jax.image.resize` does ("nearest", "bilinear" -> linear,
    "bicubic" -> Keys cubic, antialiased when downsampling); with
    `align_corners` and a linear or cubic mode, `scale_and_translate`
    with the scale (out - 1) / (in - 1) and the translation that maps
    corner to corner."""
    x = as_tensor(x)
    H, W = x.shape[2], x.shape[3]
    if size is None:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else (scale_factor,) * 2
        size = (int(H * sf[0]), int(W * sf[1]))
    size = tuple(int(s) for s in size)
    kernel = {"nearest": None, "bilinear": _triangle,
              "bicubic": _keys_cubic}[mode]

    def fn(a):
        if kernel is None:
            return _resize_nearest(a, size)
        dims = [(2, H, size[0]), (3, W, size[1])]
        if align_corners and size[0] > 1 and size[1] > 1:
            s = torch.tensor([(size[0] - 1) / (H - 1),
                              (size[1] - 1) / (W - 1)], dtype=torch.float32)
            plan = [(d, m, n, s[i], 0.5 * (1.0 - s[i]))
                    for i, (d, m, n) in enumerate(dims)]
        else:
            plan = [(d, m, n, n / m, 0.0) for d, m, n in dims if m != n]
        out = a
        for d, m, n, sc, tr in plan:
            w = _weight_mat(m, n, sc, tr, kernel, a.device).to(a.dtype)
            out = torch.movedim(torch.tensordot(
                torch.movedim(out, d, -1), w, dims=([out.ndim - 1], [0])),
                -1, d)
        return out

    return apply("interpolate", fn, x)


def pixel_shuffle(x, upscale_factor, data_format="NCHW"):
    r = int(upscale_factor)

    def fn(a):
        n, c, h, w = a.shape
        a = a.reshape(n, c // (r * r), r, r, h, w)
        return a.permute(0, 1, 4, 2, 5, 3).reshape(n, c // (r * r), h * r,
                                                    w * r)

    return apply("pixel_shuffle", fn, as_tensor(x))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    """Inverse of pixel_shuffle: [B,C,H,W] -> [B,C*r^2,H/r,W/r]."""
    r = int(downscale_factor)
    nhwc = data_format == "NHWC"

    def fn(a):
        if nhwc:
            a = a.permute(0, 3, 1, 2)
        B, C, H, W = a.shape
        a = a.reshape(B, C, H // r, r, W // r, r)
        out = a.permute(0, 1, 3, 5, 2, 4).reshape(B, C * r * r, H // r,
                                                  W // r)
        return out.permute(0, 2, 3, 1) if nhwc else out

    return apply("pixel_unshuffle", fn, as_tensor(x))


def temporal_shift(x, seg_num, shift_ratio=0.25, data_format="NCHW"):
    def fn(a):
        nt, c, h, w = a.shape
        n = nt // seg_num
        a = a.reshape(n, seg_num, c, h, w)
        fold = int(c * shift_ratio)
        left = torch.cat([a[:, 1:, :fold],
                          torch.zeros_like(a[:, :1, :fold])], 1)
        right = torch.cat([torch.zeros_like(a[:, :1, fold:2 * fold]),
                           a[:, :-1, fold:2 * fold]], 1)
        out = torch.cat([left, right, a[:, :, 2 * fold:]], 2)
        return out.reshape(nt, c, h, w)

    return apply("temporal_shift", fn, as_tensor(x))


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col: [B, C, H, W] -> [B, C*kh*kw, L], channel-major blocks."""
    ks, st = _pair(kernel_sizes), _pair(strides)
    pd, dl = _pair(paddings), _pair(dilations)
    return apply("unfold", lambda a: F.unfold(a, ks, dl, pd, st),
                 as_tensor(x))


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im: [B, C*kh*kw, L] -> [B, C, H, W], overlaps summed (the
    transpose of `unfold`)."""
    osz, ks = _pair(output_sizes), _pair(kernel_sizes)
    st, pd, dl = _pair(strides), _pair(paddings), _pair(dilations)
    return apply("fold", lambda a: F.fold(a, osz, ks, dl, pd, st),
                 as_tensor(x))


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True):
    """Bilinear sampling of NCHW `x` at `grid` `[N, Ho, Wo, 2]` in [-1, 1]
    with zeros outside, JAX's formula (which reads neither `mode` nor
    `padding_mode`)."""
    def fn(a, g):
        n, c, h, w = a.shape
        if align_corners:
            gx = (g[..., 0] + 1) * (w - 1) / 2
            gy = (g[..., 1] + 1) * (h - 1) / 2
        else:
            gx = ((g[..., 0] + 1) * w - 1) / 2
            gy = ((g[..., 1] + 1) * h - 1) / 2
        x0, y0 = torch.floor(gx), torch.floor(gy)
        x1, y1 = x0 + 1, y0 + 1
        rows = torch.arange(n, device=a.device)[:, None, None]

        def sample(yy, xx):
            ok = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
            yc = torch.clamp(yy, 0, h - 1).long()
            xc = torch.clamp(xx, 0, w - 1).long()
            v = a.permute(0, 2, 3, 1)[rows, yc, xc]          # [n, H, W, c]
            return torch.where(ok[..., None], v, torch.zeros(
                (), dtype=v.dtype, device=v.device))

        wa = (x1 - gx) * (y1 - gy)
        wb = (gx - x0) * (y1 - gy)
        wc = (x1 - gx) * (gy - y0)
        wd = (gx - x0) * (gy - y0)
        out = (sample(y0, x0) * wa[..., None] + sample(y0, x1) * wb[..., None]
               + sample(y1, x0) * wc[..., None]
               + sample(y1, x1) * wd[..., None])
        return out.permute(0, 3, 1, 2)

    return apply("grid_sample", fn, as_tensor(x), as_tensor(grid))


def affine_grid(theta, out_shape, align_corners=True):
    n, c, h, w = [int(s) for s in out_shape]

    def fn(th):
        f32 = dict(dtype=th.dtype, device=th.device)
        if align_corners:
            ys, xs = torch.linspace(-1, 1, h, **f32), \
                torch.linspace(-1, 1, w, **f32)
        else:
            ys = (torch.arange(h, **f32) + 0.5) / h * 2 - 1
            xs = (torch.arange(w, **f32) + 0.5) / w * 2 - 1
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        base = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # [h, w, 3]
        return torch.einsum("nij,hwj->nhwi", th, base)

    return apply("affine_grid", fn, as_tensor(theta))


def fused_bias_dropout_residual_layer_norm(x, residual, bias=None,
                                           ln_scale=None, ln_bias=None,
                                           dropout_rate=0.0, epsilon=1e-5,
                                           training=True):
    """LayerNorm(dropout(x + bias) + residual) * ln_scale + ln_bias, one
    dispatch (`fused_bias_dropout_residual_ln`), the dropout mask from the
    key chain."""
    key = next_key() if (dropout_rate > 0.0 and training) else None

    def fn(a, r, *rest):
        i = 0
        if bias is not None:
            a = a + rest[i]
            i += 1
        if key is not None:
            keep = 1.0 - dropout_rate
            mask = _keep_mask(key, keep, a.shape, a.device)
            a = torch.where(mask, a / _scalar(keep, a),
                            torch.zeros((), dtype=a.dtype, device=a.device))
        out = a + r
        mean = out.mean(-1, keepdim=True)
        var = out.var(-1, correction=0, keepdim=True)
        y = (out - mean) * torch.rsqrt(var + epsilon)
        if ln_scale is not None:
            y = y * rest[i]
            i += 1
        if ln_bias is not None:
            y = y + rest[i]
        return y

    return apply("fused_bias_dropout_residual_ln", fn, as_tensor(x),
                 as_tensor(residual), *_opt(bias, ln_scale, ln_bias))


def normalize(x, p=2, axis=1, epsilon=1e-12, name=None):
    """L_p normalize along `axis`."""
    def fn(a):
        n = torch.sum(torch.abs(a) ** p, axis, keepdim=True) ** (1.0 / p)
        return a / torch.clamp_min(n, epsilon)

    return apply("normalize", fn, as_tensor(x))


def local_response_norm(x, size, alpha=1e-4, beta=0.75, k=1.0,
                        data_format="NCHW", name=None):
    """x / (k + alpha * window_sum(x^2) / size)^beta over a window of
    `size` channels (paddle's average-pool formulation)."""
    if data_format != "NCHW":
        raise NotImplementedError(
            f"local_response_norm: data_format={data_format!r}; NCHW only")

    def fn(a):
        half = size // 2
        sq = F.pad(torch.square(a), (0, 0, 0, 0, half, size - 1 - half))
        summed = sum(sq[:, i:i + a.shape[1]] for i in range(size))
        return a / torch.pow(k + alpha * summed / size, beta)

    return apply("local_response_norm", fn, as_tensor(x))


def sequence_mask(lengths, maxlen=None, dtype="bool", name=None):
    """mask[i, t] = t < lengths[i]."""
    lengths = as_tensor(lengths)
    ml = int(maxlen) if maxlen is not None else int(unwrap(lengths).max())
    td = dtypes.to_torch(dtype)
    return apply_nograd("sequence_mask", lambda l: (torch.arange(
        ml, device=l.device)[None, :] < l[..., None]).to(td), lengths)
