"""The port's losses (`paddle_tpu_torch.ops.nn_ops`) and loss layers
(`paddle_tpu_torch.nn`) against the JAX package's, on the CPU.

Same seeded numpy inputs to both packages, fp32. Each case holds the
forward within 1e-6 (absolute plus relative) and the gradients of the
differentiated inputs within 1e-5, taken through a seeded cotangent over
the output (`jax.grad` against torch's autograd): every reduction,
`ignore_index`, class weights, soft labels, `label_smoothing` and
`use_softmax=False` for the cross entropy, and each other loss at its
options.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.ops import nn_ops

FWD_TOL = 1e-6
GRAD_TOL = 1e-5
REDUCTIONS = ["none", "sum", "mean"]


def _d(a):
    """A differentiated input."""
    return ("d", np.asarray(a, np.float32))


def _j(v):
    return Tensor._wrap(jnp.asarray(v)) if isinstance(v, np.ndarray) else v


def _t(v):
    return torch.from_numpy(v.copy()) if isinstance(v, np.ndarray) else v


def _outputs(out):
    return out if isinstance(out, tuple) else (out,)


def _both(jf, tf, args, kw=None, seed=7):
    """Run `jf` (JAX) and `tf` (the port) on `args` (each `("d", float32
    array)` to differentiate, or a constant) and `kw` (constants); hold
    the outputs to FWD_TOL and the gradients of a seeded cotangent over
    the first output to GRAD_TOL."""
    kw = kw or {}
    is_d = [isinstance(a, tuple) and a[0] == "d" for a in args]
    args = [a[1] if d else a for a, d in zip(args, is_d)]
    diff = [a for a, d in zip(args, is_d) if d]

    def call_j(*darrs):
        it = iter(darrs)
        a = [Tensor._wrap(next(it)) if d else _j(v)
             for d, v in zip(is_d, args)]
        return tuple(o._array for o in _outputs(
            jf(*a, **{k: _j(v) for k, v in kw.items()})))

    jout = call_j(*[jnp.asarray(v) for v in diff])
    cot = np.asarray(np.random.RandomState(seed).randn(*np.shape(jout[0])),
                     np.float32)
    jgrads = jax.grad(lambda *d: jnp.sum(call_j(*d)[0] * cot),
                      argnums=tuple(range(len(diff))))(
        *[jnp.asarray(v) for v in diff])

    tdiff = [torch.from_numpy(v.copy()).requires_grad_(True) for v in diff]
    it = iter(tdiff)
    a = [next(it) if d else _t(v) for d, v in zip(is_d, args)]
    tout = _outputs(tf(*a, **{k: _t(v) for k, v in kw.items()}))
    assert len(tout) == len(jout)
    for g, w in zip(tout, jout):
        assert tuple(g.shape) == tuple(np.shape(w))
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   atol=FWD_TOL, rtol=FWD_TOL)
    tgrads = torch.autograd.grad((tout[0] * torch.from_numpy(cot)).sum(),
                                 tdiff)
    for g, w in zip(tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL,
                                   rtol=GRAD_TOL)


def _fn(name):
    return getattr(JF, name), getattr(nn_ops, name)


def _rng(seed=0):
    return np.random.RandomState(seed)


def _ce_case(variant, seed=0):
    """(logits, labels, kwargs) of one cross-entropy variant: `[4, 6, 9]`
    logits over the last axis (axis 1 for `axis1`), two labels ignored
    where the variant has hard labels."""
    rng = _rng(seed)
    logits = 2 * rng.randn(4, 6, 9)
    labels = rng.randint(0, 9, (4, 6)).astype(np.int64)
    labels[0, 1] = labels[3, 4] = -100
    kw = {}
    if variant == "keepdim":
        labels = labels[..., None]
    elif variant == "weight":
        kw["weight"] = rng.uniform(0.2, 2.0, 9).astype(np.float32)
    elif variant == "soft":
        p = np.exp(rng.randn(4, 6, 9))
        labels = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        kw["soft_label"] = True
    elif variant == "smoothing":
        kw["label_smoothing"] = 0.1
    elif variant == "smoothing_weight":
        kw.update(label_smoothing=0.2,
                  weight=rng.uniform(0.2, 2.0, 9).astype(np.float32))
    elif variant == "probs":
        e = np.exp(logits)
        logits = e / e.sum(-1, keepdims=True)
        kw["use_softmax"] = False
    elif variant == "probs_soft":
        e = np.exp(logits)
        logits = e / e.sum(-1, keepdims=True)
        p = np.exp(rng.randn(4, 6, 9))
        labels = (p / p.sum(-1, keepdims=True)).astype(np.float32)
        kw.update(use_softmax=False, soft_label=True)
    elif variant == "axis1":
        logits = np.ascontiguousarray(logits.transpose(0, 2, 1))
        kw.update(axis=1, weight=rng.uniform(0.2, 2.0, 9)
                  .astype(np.float32))
    elif variant == "ignore_7":
        labels[(labels == 5) | (labels == -100)] = 7
        kw["ignore_index"] = 7
    return logits.astype(np.float32), labels, kw


CE_VARIANTS = ["hard", "keepdim", "weight", "soft", "smoothing",
               "smoothing_weight", "probs", "probs_soft", "axis1",
               "ignore_7"]


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("variant", CE_VARIANTS)
def test_cross_entropy_every_option_matches_jax(variant, reduction):
    logits, labels, kw = _ce_case(variant)
    _both(*_fn("cross_entropy"), [_d(logits), labels],
          dict(kw, reduction=reduction))


def test_cross_entropy_weight_with_soft_labels_raises_as_jax():
    logits, labels, kw = _ce_case("soft")
    w = np.ones(9, np.float32)
    with pytest.raises(ValueError, match="soft_label"):
        JF.cross_entropy(_j(logits), _j(labels), weight=w, **kw)
    with pytest.raises(ValueError, match="soft_label"):
        nn_ops.cross_entropy(_t(logits), _t(labels), weight=_t(w), **kw)


@pytest.mark.parametrize("soft", [False, True])
def test_softmax_with_cross_entropy_matches_jax(soft):
    logits, labels, _ = _ce_case("soft" if soft else "hard", seed=3)
    _both(*_fn("softmax_with_cross_entropy"), [_d(logits), labels],
          dict(soft_label=soft))


def _pair(seed, shape=(5, 7)):
    rng = _rng(seed)
    return rng.randn(*shape).astype(np.float32), \
        rng.randn(*shape).astype(np.float32)


def _probs(rng, shape):
    return rng.uniform(0.05, 0.95, shape).astype(np.float32)


def _elementwise_case(name, seed):
    """(args, kwargs) of the elementwise losses with a `reduction`."""
    rng = _rng(seed)
    a, b = _pair(seed)
    sign = np.where(rng.rand(5, 7) < 0.5, -1.0, 1.0).astype(np.float32)
    if name == "l1_loss":
        return [_d(a), b], {}
    if name == "smooth_l1_loss":
        return [_d(a), b], {"delta": 0.7}
    if name == "bce_loss":
        return [_d(_probs(rng, (5, 7))), rng.randint(0, 2, (5, 7))
                .astype(np.float32)], \
            {"weight": rng.uniform(0.5, 2, (5, 7)).astype(np.float32)}
    if name == "bce_with_logits":
        return [_d(2 * a), rng.randint(0, 2, (5, 7)).astype(np.float32)], \
            {"weight": rng.uniform(0.5, 2, 7).astype(np.float32),
             "pos_weight": rng.uniform(0.5, 3, 7).astype(np.float32)}
    if name == "kl_div":
        p = _probs(rng, (5, 7))
        return [_d(np.log(_probs(rng, (5, 7)))),
                p / p.sum(-1, keepdims=True)], {}
    if name == "margin_ranking_loss":
        return [_d(a), _d(b), sign], {"margin": 0.3}
    if name == "hinge_embedding_loss":
        return [_d(a), sign], {"margin": 0.8}
    raise KeyError(name)


ELEMENTWISE = ["l1_loss", "smooth_l1_loss", "bce_loss", "bce_with_logits",
               "kl_div", "margin_ranking_loss", "hinge_embedding_loss"]


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise_losses_match_jax(name, reduction):
    args, kw = _elementwise_case(name, ELEMENTWISE.index(name))
    _both(*_fn(name), args, dict(kw, reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("variant", ["plain", "weight", "spatial",
                                     "spatial_weight"])
def test_nll_loss_matches_jax(variant, reduction):
    rng = _rng(5)
    shape = (4, 6, 3, 2) if variant.startswith("spatial") else (8, 6)
    x = rng.randn(*shape)
    logp = (x - np.log(np.exp(x).sum(1, keepdims=True))).astype(np.float32)
    lab_shape = (shape[0],) + shape[2:]
    labels = rng.randint(0, 6, lab_shape).astype(np.int64)
    labels.reshape(-1)[[1, 5]] = -100
    kw = dict(reduction=reduction)
    if variant.endswith("weight"):
        kw["weight"] = rng.uniform(0.2, 2.0, 6).astype(np.float32)
    _both(*_fn("nll_loss"), [_d(logp), labels], kw)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("normalizer", [False, True])
def test_sigmoid_focal_loss_matches_jax(normalizer, reduction):
    rng = _rng(11)
    kw = dict(reduction=reduction, alpha=0.3, gamma=1.5)
    if normalizer:
        kw["normalizer"] = np.asarray(3.5, np.float32)
    _both(*_fn("sigmoid_focal_loss"),
          [_d(2 * rng.randn(6, 5)), rng.randint(0, 2, (6, 5))
           .astype(np.float32)], kw)


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("swap,p", [(False, 2.0), (True, 2.0),
                                    (False, 1.0), (True, 3.0)])
def test_triplet_margin_loss_matches_jax(swap, p, reduction):
    rng = _rng(12)
    a, pos, neg = (rng.randn(6, 8).astype(np.float32) for _ in range(3))
    _both(*_fn("triplet_margin_loss"), [_d(a), _d(pos), _d(neg)],
          dict(margin=0.5, p=p, swap=swap, reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
def test_cosine_embedding_loss_matches_jax(reduction):
    rng = _rng(13)
    a, b = _pair(13, (6, 8))
    y = np.where(rng.rand(6) < 0.5, -1.0, 1.0).astype(np.float32)
    _both(*_fn("cosine_embedding_loss"), [_d(a), _d(b), y],
          dict(margin=0.1, reduction=reduction))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("return_softmax", [False, True])
def test_margin_cross_entropy_matches_jax(return_softmax, reduction):
    rng = _rng(14)
    cos = rng.uniform(-0.95, 0.95, (5, 10)).astype(np.float32)
    y = rng.randint(0, 10, 5).astype(np.int64)
    _both(*_fn("margin_cross_entropy"), [_d(cos), y],
          dict(margin1=1.0, margin2=0.3, margin3=0.1, scale=16.0,
               return_softmax=return_softmax, reduction=reduction))


def test_log_dice_npair_losses_match_jax():
    rng = _rng(15)
    _both(*_fn("log_loss"), [_d(_probs(rng, (6, 1))),
                             rng.randint(0, 2, (6, 1)).astype(np.float32)],
          dict(epsilon=1e-3))
    p = np.exp(rng.randn(3, 4, 5))
    _both(*_fn("dice_loss"),
          [_d(p / p.sum(-1, keepdims=True)),
           rng.randint(0, 5, (3, 4, 1)).astype(np.int64)])
    _both(*_fn("npair_loss"), [_d(rng.randn(6, 8)), _d(rng.randn(6, 8)),
                               np.array([0, 1, 2, 0, 1, 3], np.int64)],
          dict(l2_reg=0.01))


@pytest.mark.parametrize("reduction", REDUCTIONS)
@pytest.mark.parametrize("norm_by_times", [False, True])
def test_ctc_loss_matches_jax(norm_by_times, reduction):
    """T 12, batch 4, 6 classes, labels up to 4 long with repeats (the
    skip rule), a sample of label length 0 and inputs shorter than T."""
    rng = _rng(16)
    T, B, C, S = 12, 4, 6, 4
    lp = rng.randn(T, B, C).astype(np.float32)
    labels = rng.randint(1, C, (B, S)).astype(np.int64)
    labels[1, 1] = labels[1, 0]                  # a repeat: no skip
    in_len = np.array([12, 9, 12, 7], np.int64)
    lab_len = np.array([4, 3, 0, 2], np.int64)
    _both(*_fn("ctc_loss"), [_d(lp), labels, in_len, lab_len],
          dict(blank=0, reduction=reduction, norm_by_times=norm_by_times))


def _layer_case(name):
    """(JAX layer, port layer, args) of each loss layer."""
    rng = _rng(20)
    a, b = _pair(21)
    sign = np.where(rng.rand(5, 7) < 0.5, -1.0, 1.0).astype(np.float32)
    w = rng.uniform(0.2, 2.0, 9).astype(np.float32)
    if name == "CrossEntropyLoss":
        logits, labels, _ = _ce_case("hard", seed=22)
        kw = dict(label_smoothing=0.1, reduction="mean")
        return (jnn.CrossEntropyLoss(weight=w, **kw),
                tnn.CrossEntropyLoss(weight=torch.from_numpy(w), **kw),
                [_d(logits), labels])
    if name == "NLLLoss":
        logp = np.log(_probs(rng, (6, 9)))
        labels = rng.randint(0, 9, 6).astype(np.int64)
        labels[2] = -100
        return (jnn.NLLLoss(weight=w), tnn.NLLLoss(weight=torch.from_numpy(w)),
                [_d(logp), labels])
    if name == "BCELoss":
        return (jnn.BCELoss(reduction="sum"), tnn.BCELoss(reduction="sum"),
                [_d(_probs(rng, (5, 7))), rng.randint(0, 2, (5, 7))
                 .astype(np.float32)])
    if name == "BCEWithLogitsLoss":
        pw = rng.uniform(0.5, 3, 7).astype(np.float32)
        return (jnn.BCEWithLogitsLoss(pos_weight=pw),
                tnn.BCEWithLogitsLoss(pos_weight=torch.from_numpy(pw)),
                [_d(a), rng.randint(0, 2, (5, 7)).astype(np.float32)])
    if name == "KLDivLoss":
        p = _probs(rng, (5, 7))
        return (jnn.KLDivLoss(), tnn.KLDivLoss(),
                [_d(np.log(_probs(rng, (5, 7)))), p])
    if name == "MarginRankingLoss":
        return (jnn.MarginRankingLoss(0.2), tnn.MarginRankingLoss(0.2),
                [_d(a), _d(b), sign])
    if name == "HingeEmbeddingLoss":
        return (jnn.HingeEmbeddingLoss(0.5), tnn.HingeEmbeddingLoss(0.5),
                [_d(a), sign])
    if name == "SmoothL1Loss":
        return (jnn.SmoothL1Loss("sum", 0.5), tnn.SmoothL1Loss("sum", 0.5),
                [_d(a), b])
    return (getattr(jnn, name)(), getattr(tnn, name)(), [_d(a), b])


LAYERS = ["CrossEntropyLoss", "MSELoss", "L1Loss", "SmoothL1Loss", "NLLLoss",
          "BCELoss", "BCEWithLogitsLoss", "KLDivLoss", "MarginRankingLoss",
          "HingeEmbeddingLoss"]


@pytest.mark.parametrize("name", LAYERS)
def test_loss_layers_match_jax(name):
    jl, tl, args = _layer_case(name)
    assert isinstance(tl, torch.nn.Module)
    _both(jl, tl, args)
