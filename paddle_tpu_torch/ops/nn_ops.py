"""Attention entry point, dropout, the losses and the ops a ResNet needs:
counterparts of `scaled_dot_product_attention`, `dropout`, the losses
(`softmax_with_cross_entropy`, `cross_entropy` with every option, `mse_loss`,
`l1_loss` through `hinge_embedding_loss`, `log_loss` through `ctc_loss`),
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
           "l1_loss", "smooth_l1_loss", "nll_loss", "bce_loss",
           "bce_with_logits", "kl_div", "margin_ranking_loss",
           "hinge_embedding_loss", "log_loss", "sigmoid_focal_loss",
           "dice_loss", "npair_loss", "triplet_margin_loss",
           "cosine_embedding_loss", "margin_cross_entropy", "ctc_loss",
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
    """Softmax cross entropy per token, keeping `axis` with size 1, over
    an fp32 `log_softmax`. Hard labels: -log p[label], 0 where the label
    is `ignore_index`, cast back to the logits' dtype. Soft labels
    (`label` a distribution over `axis`): -sum(label * log p), left in
    the promoted dtype, as the JAX package leaves it."""
    axis = axis % logits.dim()
    logp = torch.log_softmax(logits.float(), dim=axis)
    if soft_label:
        return -(label * logp).sum(axis, keepdim=True)
    idx = _hard_labels(label, logits.dim(), axis).unsqueeze(axis).long()
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


def _log_floor(p):
    """log(max(p, 1e-30)) in fp32: the probabilities' log of
    `use_softmax=False`."""
    return torch.log(torch.clamp_min(p.float(), 1e-30))


def _class_weights(weight, hard, ignore_index):
    """Each label's class weight, 0 where the label is ignored."""
    ignored = hard == ignore_index
    w = torch.as_tensor(weight, device=hard.device)
    return torch.where(ignored, torch.zeros((), dtype=w.dtype,
                                            device=w.device),
                       w[torch.where(ignored, 0, hard).long()])


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0):
    """Cross entropy over `axis` with the JAX package's semantics
    (paddle's): hard or soft labels; `label_smoothing` turns hard labels
    into `onehot * (1 - eps) + eps / C` and then zeroes ignored rows;
    `use_softmax=False` takes `input` as probabilities (log of max(p,
    1e-30), no softmax); `weight` scales each hard label's loss by its
    class weight. `reduction` is none, sum or mean; mean is over the
    labels that are not ignored, or over the sum of the selected weights
    with `weight` (soft labels: the plain mean). A weight with soft labels
    raises, as in JAX."""
    if reduction not in ("none", "sum", "mean"):
        raise ValueError(f"reduction must be none, sum or mean, got "
                         f"{reduction!r}")
    axis = axis % input.dim()
    hard = None if soft_label else _hard_labels(label, input.dim(), axis)
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
        loss = -(label * _log_floor(input)).sum(axis, keepdim=True)
    else:
        idx = hard.unsqueeze(axis).long()
        keep = idx != ignore_index
        ll = torch.gather(_log_floor(input), axis, torch.where(keep, idx, 0))
        loss = torch.where(keep, -ll, torch.zeros((), device=ll.device)) \
            .to(input.dtype)
    if smoothed:
        # the soft path has no ignore_index: zero ignored rows so the
        # valid-count mean stays right
        loss = torch.where((hard != ignore_index).unsqueeze(axis), loss,
                           torch.zeros((), dtype=loss.dtype,
                                       device=loss.device))
    wsel = None
    if weight is not None:
        if hard is None:
            raise ValueError(
                "weight with soft_label=True is not supported (pass hard "
                "labels, optionally with label_smoothing)")
        wsel = _class_weights(weight, hard, ignore_index)
        loss = loss * wsel.unsqueeze(axis).to(loss.dtype)
    loss = loss.squeeze(axis)
    if reduction == "none":
        return loss
    if reduction == "sum" or hard is None:
        return _reduce_loss(loss, reduction)
    if wsel is not None:
        return loss.sum() / wsel.sum().clamp_min(1e-12)
    valid = (hard != ignore_index).float()
    return loss.sum() / valid.sum().clamp_min(1.0)


def l1_loss(input, label, reduction="mean"):
    return _reduce_loss(torch.abs(input - label), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0):
    d = torch.abs(input - label)
    return _reduce_loss(torch.where(d < delta, 0.5 * d * d / delta,
                                    d - 0.5 * delta), reduction)


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean"):
    """NLL over log-probs, the class axis 1: input `[N, C]` or `[N, C, d1,
    ...]` with label `[N]` or `[N, d1, ...]`; mean over the labels not
    ignored, or over the selected weights with `weight`."""
    idx = label.unsqueeze(1).long()
    keep = idx != ignore_index
    ll = torch.gather(input, 1, torch.where(keep, idx, 0))
    loss = torch.where(keep, -ll, torch.zeros((), dtype=input.dtype,
                                              device=input.device)) \
        .squeeze(1)
    if weight is not None:
        wsel = _class_weights(weight, label, ignore_index)
        loss = loss * wsel
        if reduction == "mean":
            return loss.sum() / wsel.sum().clamp_min(1e-12)
    elif reduction == "mean":
        return loss.sum() / keep.squeeze(1).to(loss.dtype).sum() \
            .clamp_min(1.0)
    return _reduce_loss(loss, reduction)


def bce_loss(input, label, weight=None, reduction="mean"):
    eps = 1e-12
    loss = -(label * torch.log(input + eps)
             + (1 - label) * torch.log(1 - input + eps))
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def bce_with_logits(logit, label, weight=None, reduction="mean",
                    pos_weight=None):
    loss = torch.clamp_min(logit, 0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    if pos_weight is not None:
        loss = loss * (label * (pos_weight - 1) + 1)
    if weight is not None:
        loss = loss * weight
    return _reduce_loss(loss, reduction)


def kl_div(input, label, reduction="mean"):
    return _reduce_loss(
        label * (torch.log(torch.clamp_min(label, 1e-12)) - input),
        reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean"):
    return _reduce_loss(torch.clamp_min(-label * (input - other) + margin,
                                        0.0), reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean"):
    return _reduce_loss(torch.where(label == 1.0, input,
                                    torch.clamp_min(margin - input, 0.0)),
                        reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return -label * torch.log(input + epsilon) \
        - (1.0 - label) * torch.log(1.0 - input + epsilon)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    """Focal loss on logits, divided by `normalizer` when given."""
    p = torch.sigmoid(logit)
    ce = torch.clamp_min(logit, 0) - logit * label \
        + torch.log1p(torch.exp(-torch.abs(logit)))
    p_t = p * label + (1 - p) * (1 - label)
    a_t = alpha * label + (1 - alpha) * (1 - label)
    loss = a_t * ((1 - p_t) ** gamma) * ce
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce_loss(loss, reduction)


def dice_loss(input, label, epsilon=1e-5, name=None):
    """1 - the Dice coefficient over the trailing class dim: input `[N,
    ..., C]` probabilities, label `[N, ..., 1]` int."""
    oh = F.one_hot(label.squeeze(-1).long(), input.shape[-1]) \
        .to(input.dtype)
    red = tuple(range(1, input.dim()))
    inter = (input * oh).sum(red)
    union = input.sum(red) + oh.sum(red)
    return (1.0 - (2.0 * inter + epsilon) / (union + epsilon)).mean()


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    """Multi-class n-pair loss; the l2 term weighted by 0.25, as the
    reference weights it."""
    sim = anchor @ positive.T
    same = (labels[:, None] == labels[None, :]).to(anchor.dtype)
    same = same / same.sum(1, keepdim=True)
    xent = (-same * torch.log_softmax(sim, 1)).sum(1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return xent + reg


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    """max(d(a, pos) - d(a, neg) + margin, 0), d the p-norm distance with
    `epsilon` added once per distance, under the p-th root."""
    def dist(u, v):
        return ((torch.abs(u - v) ** p).sum(-1) + epsilon) ** (1 / p)

    dp, dn = dist(input, positive), dist(input, negative)
    if swap:
        dn = torch.minimum(dn, dist(positive, negative))
    return _reduce_loss(torch.clamp_min(dp - dn + margin, 0.0), reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0,
                          reduction="mean", name=None):
    """label 1: 1 - cos; label -1: max(cos - margin, 0)."""
    cos = (input1 * input2).sum(-1) / torch.clamp_min(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), 1e-12)
    return _reduce_loss(torch.where(label > 0, 1.0 - cos,
                                    torch.clamp_min(cos - margin, 0.0)),
                        reduction)


def margin_cross_entropy(logits, label, margin1=1.0, margin2=0.5,
                         margin3=0.0, scale=64.0, group=None,
                         return_softmax=False, reduction="mean"):
    """ArcFace-family margin softmax: `logits` are cosines, the target
    class's angle gets cos(m1 * theta + m2) - m3 before the scaled
    softmax cross entropy. `group` (model-parallel sharding) is not
    read, as in JAX."""
    oh = F.one_hot(label.long(), logits.shape[-1]).to(logits.dtype)
    theta = torch.arccos(torch.clamp(logits, -1.0 + 1e-7, 1.0 - 1e-7))
    target = torch.cos(margin1 * theta + margin2) - margin3
    adj = logits * (1 - oh) + target * oh
    logp = torch.log_softmax(scale * adj, -1)
    loss = _reduce_loss(-(oh * logp).sum(-1), reduction)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC loss by the log-domain forward algorithm, the JAX package's
    `lax.scan` over time as a loop: log_probs `[T, B, C]` (time-major; a
    log_softmax is applied, idempotent on log-probs), labels `[B, S]`.
    Returns the negative log-likelihood per sample, reduced; mean divides
    each sample by its label length first."""
    lp = torch.log_softmax(log_probs, -1)
    T, B, _ = lp.shape
    S = labels.shape[1]
    L = 2 * S + 1
    NEG = -1e30
    dev = lp.device
    in_len = torch.as_tensor(input_lengths, device=dev)
    lab_len = torch.as_tensor(label_lengths, device=dev)
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
