"""Attention entry point, dropout, the cross-entropy and squared-error
losses and the ops a ResNet needs: counterparts of `scaled_dot_product_attention`,
`dropout`, `softmax_with_cross_entropy`, `cross_entropy`, `mse_loss`,
`conv2d`, `batch_norm` (both forms), `max_pool2d` and `adaptive_avg_pool2d` in
paddle_tpu/ops/nn_ops.py. The conv, BatchNorm and pooling ops take
NCHW, as the paddle API does, in any memory format torch accepts,
`channels_last` included; NHWC `data_format` is not ported.
"""
from __future__ import annotations

import math

import torch
from torch.nn import functional as F

from .conv import _pair, normalize_conv_padding
from .flash_attention import (_shapes_ok_for_shortseq, dense_attention,
                              flash_attention, shortseq_attention)

__all__ = ["scaled_dot_product_attention", "dropout",
           "softmax_with_cross_entropy", "cross_entropy", "mse_loss",
           "conv2d", "batch_norm", "update_running_stats", "max_pool2d",
           "adaptive_avg_pool2d"]


def scaled_dot_product_attention(q, k, v, attn_mask=None, dropout_p=0.0,
                                 is_causal=False, training=True, scale=None,
                                 generator=None):
    """Attention in paddle layout `[batch, seq, heads, head_dim]`, routed
    as the JAX package routes it (paddle_tpu/ops/nn_ops.py):

    - no mask and `dropout_p == 0.0`: `flash_attention`, which routes by
      shape (shortseq and causal kernels, dense otherwise);
    - a key-only additive mask `[B or 1, 1, 1, Skv]`, `dropout_p == 0.0`,
      not causal, shortseq shapes: `shortseq_attention` with that mask
      (the encoder padding mask; the masked kernels on the card);
    - everything else: the dense branch (`dense_attention`): fp32 logits,
      the causal mask (bottom-right aligned) with `is_causal`, the
      additive `attn_mask` (broadcastable to `[B, H, Sq, Skv]`), fp32
      softmax, the probabilities cast to q's dtype before PV.

    The routing reads `dropout_p` alone, not `training`: with
    `dropout_p > 0` and `training=False` the dense branch runs and drops
    nothing. With `dropout_p > 0` and `training`, the OUTPUT is dropped
    (as the JAX package does), the mask drawn from `generator`."""
    if attn_mask is None and dropout_p == 0.0:
        return flash_attention(q, k, v, causal=is_causal, scale=scale)
    if (attn_mask is not None and dropout_p == 0.0 and not is_causal
            and attn_mask.dim() == 4 and attn_mask.shape[1] == 1
            and attn_mask.shape[2] == 1):
        B, Sq, _, D = q.shape
        Skv = k.shape[1]
        if (_shapes_ok_for_shortseq(Sq, Skv, D)
                and attn_mask.shape[0] in (1, B)
                and attn_mask.shape[3] == Skv):
            key_mask = attn_mask[:, 0, 0, :].expand(B, Skv)
            return shortseq_attention(q, k, v, scale=scale,
                                      key_mask=key_mask)
    out = dense_attention(q, k, v, is_causal, scale, mask=attn_mask)
    if dropout_p > 0.0 and training:
        out = dropout(out, dropout_p, training=True, generator=generator)
    return out


def dropout(x, p=0.5, training=True, generator=None):
    """Dropout, `upscale_in_train`: kept elements become x / (1 - p), the
    rest 0, in x's dtype. The keep mask is Bernoulli(1 - p) drawn from
    `generator` (a `torch.Generator` on x's device), which the caller
    owns: there is no global RNG state, so the same generator state gives
    the same mask and each draw advances it."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout draws its mask from an explicit "
                         "torch.Generator; pass generator=")
    keep = 1.0 - p
    mask = torch.rand(x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype,
                                                   device=x.device))


def _hard_labels(label, ndim, axis):
    if label.dim() == ndim and label.shape[axis] == 1:
        label = label.squeeze(axis)
    return label


def softmax_with_cross_entropy(logits, label, soft_label=False, axis=-1,
                               ignore_index=-100):
    """Hard-label softmax cross entropy, per token, keeping `axis` with size
    1: fp32 `log_softmax`, -log p[label], 0 where the label is
    `ignore_index`, cast back to the logits' dtype. Soft labels are not
    ported and raise."""
    if soft_label:
        raise NotImplementedError("soft_label=True is not ported yet")
    axis = axis % logits.dim()
    idx = _hard_labels(label, logits.dim(), axis).unsqueeze(axis).long()
    logp = torch.log_softmax(logits.float(), dim=axis)
    keep = idx != ignore_index
    ll = torch.gather(logp, axis, torch.where(keep, idx, 0))
    loss = torch.where(keep, -ll, torch.zeros((), device=ll.device))
    return loss.to(logits.dtype)


def _reduce_loss(loss, reduction):
    """`mean` or `sum` of `loss`; any other reduction leaves it as it is
    (the JAX package's `_reduce_loss`)."""
    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(input, label, reduction="mean"):
    """Squared error (input - label)^2 in the inputs' dtype, reduced by
    `reduction` (mean, sum, anything else: none), as the JAX package's
    `mse_loss` computes it."""
    return _reduce_loss(torch.square(input - label), reduction)


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Hard-label cross entropy over `axis` with `ignore_index` and
    `reduction` in none / sum / mean; mean is over the labels that are not
    ignored (paddle semantics). `weight`, soft labels, `label_smoothing`
    and `use_softmax=False` are not ported and raise."""
    if weight is not None or soft_label or label_smoothing > 0.0 \
            or not use_softmax:
        raise NotImplementedError(
            "cross_entropy: weight, soft_label, label_smoothing and "
            "use_softmax=False are not ported yet")
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none, sum or mean, got "
                         f"{reduction!r}")
    axis = axis % input.dim()
    loss = softmax_with_cross_entropy(input, label, axis=axis,
                                      ignore_index=ignore_index).squeeze(axis)
    if reduction == "none":
        return loss
    if reduction == "sum":
        return loss.sum()
    valid = (_hard_labels(label, input.dim(), axis) != ignore_index).float()
    return loss.sum() / valid.sum().clamp_min(1.0)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1):
    """2-D convolution, x NCHW, weight OIHW (paddle), the result in x's
    dtype with `bias` added after it (as the JAX package adds it, after the
    conv's cast). Padding as `normalize_conv_padding` takes it: an int,
    per-dim ints, 4 ints (top, bottom, left, right), (lo, hi) pairs, or
    "SAME"/"VALID" (lax's asymmetric SAME at stride > 1, over the dilated
    window). The conv is `F.conv2d`'s: XLA computes this conv outside any
    Pallas kernel too."""
    stride, dilation = _pair(stride), _pair(dilation)
    window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, window, stride,
                                                in_hw=x.shape[2:])
    if pt == pb >= 0 and pl == pr >= 0:
        out = F.conv2d(x, weight, None, stride, (pt, pl), dilation, groups)
    else:
        out = F.conv2d(F.pad(x, (pl, pr, pt, pb)), weight, None, stride, 0,
                       dilation, groups)
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out


def batch_norm(x, running_mean, running_var, weight=None, bias=None,
               training=False, momentum=0.9, epsilon=1e-5):
    """BatchNorm over the channel axis 1, both forms of JAX's `batch_norm`.

    Inference (`training=False`): `(x - mean) * rsqrt(var + eps) * weight +
    bias` from the running statistics, op by op in the operands' dtype, as
    JAX's `infer_fn`.

    Training: single-pass fp32 batch statistics, mean32 and E[x^2] -
    mean32^2 clamped at 0 (var32); mean and var cast to x's dtype; `inv =
    rsqrt(var32 + eps)` cast to x's dtype; `(x - mean) * inv`, then
    `* weight`, then `+ bias`, each in x's dtype (or the promoted one).
    Gradients flow through the statistics. The running statistics update
    IN PLACE, outside autograd, as `momentum * running + (1 - momentum) *
    batch`, with the dtype-cast var times `n / max(n - 1, 1)` (unbiased),
    each op in the buffers' dtype, as JAX's eager update rounds."""
    shape = [1] * x.dim()
    shape[1] = x.shape[1]
    if training:
        red = [i for i in range(x.dim()) if i != 1]
        af = x.float()
        mean32 = af.mean(dim=red)
        var32 = torch.clamp_min((af * af).mean(dim=red) - mean32 * mean32,
                                0.0)
        mean = mean32.to(x.dtype)
        var = var32.to(x.dtype)
        inv = torch.rsqrt(var32.view(shape) + epsilon).to(x.dtype)
        out = (x - mean.view(shape)) * inv
        if running_mean is not None:
            update_running_stats(running_mean, running_var, mean, var,
                                 x.numel() // x.shape[1], momentum)
    else:
        out = (x - running_mean.view(shape)) \
            * torch.rsqrt(running_var.view(shape) + epsilon)
    if weight is not None:
        out = out * weight.view(shape)
    if bias is not None:
        out = out + bias.view(shape)
    return out


@torch.no_grad()
def update_running_stats(running_mean, running_var, mean, var, n, momentum):
    """The running-stat side effect of BatchNorm's training form, IN PLACE:
    `momentum * running + (1 - momentum) * batch`, the batch var made
    unbiased as `var * (n / max(n - 1, 1))` from the dtype-cast `var`, each
    op rounding to the buffers' dtype (JAX's update, op for op)."""
    n = float(n)
    unbiased = var.detach() * (n / max(n - 1.0, 1.0))
    running_mean.copy_(momentum * running_mean
                       + (1 - momentum) * mean.detach())
    running_var.copy_(momentum * running_var + (1 - momentum) * unbiased)


def max_pool2d(x, kernel_size, stride=None, padding=0):
    """Max pooling over NCHW, the window padded with -inf (JAX's
    `_pool2d`), the padding as `conv2d` takes it. `stride` defaults to the
    window."""
    ks = _pair(kernel_size)
    st = _pair(stride if stride is not None else kernel_size)
    (pt, pb), (pl, pr) = normalize_conv_padding(padding, ks, st,
                                                in_hw=x.shape[2:])
    if pt == pb and pl == pr and 0 <= pt <= ks[0] // 2 \
            and 0 <= pl <= ks[1] // 2:
        return F.max_pool2d(x, ks, st, (pt, pl))
    return F.max_pool2d(F.pad(x, (pl, pr, pt, pb), value=-math.inf), ks, st)


def adaptive_avg_pool2d(x, output_size):
    """Adaptive average pooling over NCHW to `output_size`, for input sizes
    that are multiples of it (the mean over each H/oh x W/ow window);
    other sizes raise, as in JAX."""
    oh, ow = _pair(output_size)
    H, W = x.shape[2], x.shape[3]
    if H % oh or W % ow:
        raise NotImplementedError("adaptive pool with non-divisible sizes")
    return F.avg_pool2d(x, (H // oh, W // ow))
