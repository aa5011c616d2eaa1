"""Attention entry point, dropout and the cross-entropy losses of the port:
counterparts of `scaled_dot_product_attention`, `dropout`,
`softmax_with_cross_entropy` and `cross_entropy` in
paddle_tpu/ops/nn_ops.py.
"""
from __future__ import annotations

import torch

from .flash_attention import (_shapes_ok_for_shortseq, dense_attention,
                              flash_attention, shortseq_attention)

__all__ = ["scaled_dot_product_attention", "dropout",
           "softmax_with_cross_entropy", "cross_entropy"]


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
