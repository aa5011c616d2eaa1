"""The port's `nn.functional` against the JAX package's
(`paddle_tpu/ops/nn_ops.py`, `paddle_tpu/nn/functional`), on the CPU,
beyond the one case a function of `tests/test_torch_ops_api.py`:

- the namespace: every name of JAX's `nn.functional` (the aliases too);
- `interpolate` as `jax.image.resize` / `scale_and_translate`: nearest,
  bilinear and bicubic, downsampling (antialiased) and upsampling,
  `align_corners`, `scale_factor`; forward and gradient within 1e-5;
- the dropouts after `paddle.seed`: `dropout` (both modes, `axis`),
  `dropout2d`, `dropout3d`, `alpha_dropout`, the output dropout of
  `scaled_dot_product_attention` and `fused_bias_dropout_residual_
  layer_norm`: JAX's mask bit for bit (the zeros), values within 1e-6;
- `data_format="NHWC"` for `conv2d` and `batch_norm` (both forms, the
  running statistics too), padding forms of the convs and pools,
  `conv2d_transpose` with asymmetric padding and groups, within 1e-5;
- where JAX ignores `ceil_mode` or the layout (`max_pool2d`,
  `avg_pool2d`, the adaptive pools) the port raises; adaptive pools that
  do not divide raise in both;
- bf16: `linear` rounds once, bitwise JAX's; `layer_norm` and `rms_norm`
  compute in fp32 and round once, within one bf16 ulp of JAX's.
"""
import numpy as np
import pytest

import paddle_tpu as jp
import paddle_tpu_torch as tp

from _paddle_state import paddle_state  # noqa: F401

JF, TF = jp.nn.functional, tp.nn.functional
RNG = np.random.RandomState(7)


def _np(t):
    return np.asarray(t.numpy())


def _close(t, j, tol=1e-5):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=tol,
                               atol=tol * max(np.abs(j).max(), 1e-30))


def _both(fn, *arrays, grad=True, seed=None):
    """fn(F, pkg, *tensors) in both packages; the outputs and the
    gradients of sum(out * cot) with a seeded cotangent."""
    res = []
    for pkg, F in ((tp, TF), (jp, JF)):
        if seed is not None:
            pkg.seed(seed)
        ts = [pkg.to_tensor(a, stop_gradient=not grad) for a in arrays]
        out = fn(F, pkg, *ts)
        gs = []
        if grad:
            cot = np.random.RandomState(1).randn(*out.shape).astype(
                np.float32)
            pkg.sum(pkg.multiply(out, pkg.to_tensor(cot))).backward()
            gs = [t.grad for t in ts]
        res.append((out, gs))
    return res


def test_functional_namespace_matches_jax():
    names = [n for n in dir(JF) if not n.startswith("_")
             and callable(getattr(JF, n))]
    missing = [n for n in names if not hasattr(TF, n)]
    assert not missing
    assert TF.upsample is TF.interpolate
    assert TF.binary_cross_entropy is TF.bce_loss
    assert TF.binary_cross_entropy_with_logits is TF.bce_with_logits


X8 = RNG.randn(2, 3, 8, 8).astype(np.float32)


@pytest.mark.parametrize("mode,size,align", [
    ("nearest", (5, 3), False), ("nearest", (13, 11), False),
    ("bilinear", (5, 3), False), ("bilinear", (13, 11), False),
    ("bilinear", (5, 12), True),
    ("bicubic", (5, 3), False), ("bicubic", (13, 11), False),
    ("bicubic", (16, 4), True)])
def test_interpolate_matches_jax_resize(mode, size, align):
    (t, tg), (j, jg) = _both(lambda F, p, x: F.interpolate(
        x, size=list(size), mode=mode, align_corners=align), X8)
    _close(t, j)
    _close(tg[0], jg[0])


def test_interpolate_scale_factor_matches_jax():
    for sf in (0.5, 1.5, (2, 0.75)):
        (t, _), (j, _) = _both(lambda F, p, x: F.interpolate(
            x, scale_factor=sf, mode="bilinear"), X8, grad=False)
        _close(t, j)


def _zeros_equal(t, j):
    np.testing.assert_array_equal(_np(t) == 0, _np(j) == 0)


@pytest.mark.parametrize("kw", [
    dict(p=0.3), dict(p=0.6, mode="downscale_in_infer"),
    dict(p=0.5, axis=1), dict(p=0.4, axis=[0, 2]), dict(p=0.5,
                                                        training=False)],
    ids=["up", "down", "axis1", "axis02", "eval"])
def test_dropout_masks_match_jax(kw):
    x = RNG.randn(4, 5, 6).astype(np.float32)
    (t, tg), (j, jg) = _both(lambda F, p, a: F.dropout(a, **kw), x, seed=11)
    _zeros_equal(t, j)
    _close(t, j, 1e-6)
    _close(tg[0], jg[0], 1e-6)


@pytest.mark.parametrize("fn", ["dropout2d", "dropout3d", "alpha_dropout"])
def test_channel_and_alpha_dropout_match_jax(fn):
    shape = {"dropout2d": (3, 4, 5, 5), "dropout3d": (2, 3, 2, 3, 3),
             "alpha_dropout": (4, 16)}[fn]
    x = RNG.randn(*shape).astype(np.float32)
    (t, tg), (j, jg) = _both(lambda F, p, a: getattr(F, fn)(a, 0.4), x,
                             seed=5)
    if fn != "alpha_dropout":
        _zeros_equal(t, j)
    _close(t, j, 1e-6)
    _close(tg[0], jg[0], 1e-6)


def test_sdpa_output_dropout_and_fused_ln_dropout_match_jax():
    q = RNG.randn(2, 6, 2, 8).astype(np.float32)
    mask = np.where(RNG.rand(2, 1, 6, 6) < 0.2, -1e9, 0).astype(np.float32)
    (t, _), (j, _) = _both(lambda F, p, a, m: F.scaled_dot_product_attention(
        a, a, a, attn_mask=m, dropout_p=0.3), q, mask, grad=False, seed=3)
    _zeros_equal(t, j)
    _close(t, j)
    x, r = RNG.randn(2, 3, 8).astype(np.float32), RNG.randn(2, 3, 8).astype(
        np.float32)
    (t, tg), (j, jg) = _both(
        lambda F, p, a, b: F.fused_bias_dropout_residual_layer_norm(
            a, b, dropout_rate=0.5), x, r, seed=9)
    _close(t, j)
    _close(tg[0], jg[0])


@pytest.mark.parametrize("padding", [1, "SAME", "VALID", [1, 2, 0, 1]])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_conv2d_layouts_and_padding_match_jax(padding, fmt):
    x = RNG.randn(2, 3, 7, 6).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    w = RNG.randn(4, 3, 3, 3).astype(np.float32)
    b = RNG.randn(4).astype(np.float32)
    (t, tg), (j, jg) = _both(lambda F, p, a, k, c: F.conv2d(
        a, k, c, stride=2, padding=padding, data_format=fmt), x, w, b)
    _close(t, j)
    for a, c in zip(tg, jg):
        _close(a, c)


@pytest.mark.parametrize("training", [False, True])
@pytest.mark.parametrize("fmt", ["NCHW", "NHWC"])
def test_batch_norm_layouts_match_jax(training, fmt):
    x = RNG.randn(3, 4, 5, 5).astype(np.float32)
    if fmt == "NHWC":
        x = x.transpose(0, 2, 3, 1).copy()
    stats = [RNG.randn(4).astype(np.float32),
             (RNG.rand(4) + 0.5).astype(np.float32)]
    wb = [RNG.randn(4).astype(np.float32) for _ in range(2)]
    cot = RNG.randn(*x.shape).astype(np.float32)
    res = []
    for pkg, F in ((tp, TF), (jp, JF)):
        rm, rv = (pkg.to_tensor(s.copy()) for s in stats)
        a = pkg.to_tensor(x, stop_gradient=False)
        w, c = (pkg.to_tensor(v, stop_gradient=False) for v in wb)
        out = F.batch_norm(a, rm, rv, w, c, training=training,
                           momentum=0.8, data_format=fmt)
        pkg.sum(pkg.multiply(out, pkg.to_tensor(cot))).backward()
        res.append((out, a.grad, w.grad, c.grad, rm, rv))
    for t, j in zip(*res):
        _close(t, j)


def test_conv1d_conv3d_transpose_forms_match_jax():
    cases = [
        (lambda F, p, a, k: F.conv1d(a, k, padding="SAME", dilation=2),
         (2, 3, 9), (4, 3, 3)),
        (lambda F, p, a, k: F.conv1d(a, k, stride=2, padding=[1, 2],
                                     groups=3), (2, 3, 9), (6, 1, 3)),
        (lambda F, p, a, k: F.conv3d(a, k, stride=[1, 2, 1], padding=[
            1, 0, 1]), (1, 2, 4, 5, 4), (3, 2, 3, 2, 3)),
        (lambda F, p, a, k: F.conv2d_transpose(a, k, stride=2, padding=[
            1, 0, 2, 1], output_padding=1), (2, 3, 4, 5), (3, 2, 3, 3)),
        (lambda F, p, a, k: F.conv2d_transpose(a, k, stride=[2, 1],
                                               padding=1, groups=2,
                                               dilation=2),
         (1, 4, 5, 4), (4, 3, 3, 2))]
    for fn, xs, ws in cases:
        (t, tg), (j, jg) = _both(fn, RNG.randn(*xs).astype(np.float32),
                                 RNG.randn(*ws).astype(np.float32))
        _close(t, j)
        for a, c in zip(tg, jg):
            _close(a, c)


def test_pool_forms_match_jax():
    x = RNG.randn(2, 3, 7, 8).astype(np.float32)
    for fn in (lambda F, p, a: F.max_pool2d(a, 3, 2, "SAME"),
               lambda F, p, a: F.avg_pool2d(a, [3, 2], 2, [1, 0]),
               lambda F, p, a: F.avg_pool2d(a, 3, 1, 1,
                                            count_include_pad=False),
               lambda F, p, a: F.max_pool1d(p.reshape(a, [2, 3, 56]), 4, 3,
                                            2),
               lambda F, p, a: F.avg_pool3d(p.reshape(a, [2, 3, 7, 2, 4]),
                                            2, 1, 1, exclusive=False),
               lambda F, p, a: F.avg_pool3d(p.reshape(a, [2, 3, 7, 2, 4]),
                                            2, 1, 1, divisor_override=3)):
        (t, tg), (j, jg) = _both(fn, x)
        _close(t, j)
        _close(tg[0], jg[0])


def test_ignored_layouts_raise_and_adaptive_pools_need_divisors():
    x = tp.to_tensor(RNG.randn(1, 2, 6, 6).astype(np.float32))
    for call in (lambda: TF.max_pool2d(x, 2, ceil_mode=True),
                 lambda: TF.max_pool2d(x, 2, data_format="NHWC"),
                 lambda: TF.avg_pool2d(x, 2, ceil_mode=True),
                 lambda: TF.adaptive_avg_pool2d(x, 3, data_format="NHWC"),
                 lambda: TF.adaptive_max_pool2d(x, 3, data_format="NHWC")):
        with pytest.raises(NotImplementedError):
            call()
    jx = jp.to_tensor(RNG.randn(1, 2, 6, 6).astype(np.float32))
    for F, a in ((TF, x), (JF, jx)):
        with pytest.raises(NotImplementedError, match="non-divisible"):
            F.adaptive_avg_pool2d(a, 4)
        with pytest.raises(NotImplementedError, match="non-divisible"):
            F.adaptive_max_pool2d(a, 5)


def _bf16(pkg, a):
    return pkg.cast(pkg.to_tensor(a), "bfloat16")


def _f32(pkg, t):
    return np.asarray(pkg.cast(t, "float32").numpy())


def test_bf16_linear_rounds_once_as_jax():
    x = RNG.randn(4, 6, 32).astype(np.float32)
    w = (RNG.randn(32, 16) * 0.3).astype(np.float32)
    b = RNG.randn(16).astype(np.float32)
    outs = [_f32(pkg, F.linear(_bf16(pkg, x), _bf16(pkg, w), _bf16(pkg, b)))
            for pkg, F in ((tp, TF), (jp, JF))]
    np.testing.assert_array_equal(outs[0], outs[1])


def test_bf16_norms_compute_in_fp32_as_jax():
    x = RNG.randn(4, 64).astype(np.float32) * 3 + 1
    g, c = RNG.randn(64).astype(np.float32), RNG.randn(64).astype(np.float32)
    for fn in (lambda F, p: F.layer_norm(_bf16(p, x), 64, _bf16(p, g),
                                         _bf16(p, c)),
               lambda F, p: F.rms_norm(_bf16(p, x), _bf16(p, g))):
        t, j = (_f32(pkg, fn(F, pkg)) for pkg, F in ((tp, TF), (jp, JF)))
        assert str(fn(TF, tp).dtype) == "torch.bfloat16"
        np.testing.assert_allclose(t, j, rtol=2 ** -8, atol=0)


def test_embedding_padding_idx_and_sequence_mask_match_jax():
    ids = np.array([[0, 2, 5], [2, 2, 1]], np.int32)
    w = RNG.randn(6, 4).astype(np.float32)
    res = []
    for pkg, F in ((tp, TF), (jp, JF)):
        wt = pkg.to_tensor(w, stop_gradient=False)
        out = F.embedding(pkg.to_tensor(ids), wt, padding_idx=2)
        pkg.sum(pkg.multiply(out, out)).backward()
        m = F.sequence_mask(pkg.to_tensor(np.array([1, 3, 0], np.int32)),
                            maxlen=4, dtype="float32")
        res.append((out, wt.grad, m))
    for t, j in zip(*res):
        _close(t, j)
