"""The conv ops and blocks of the PyTorch port against the JAX package, on
the CPU.

- The backend seam's helpers (`normalize_conv_padding`,
  `conv_shapes_supported`, `resolve_conv_backend`) return what JAX's do
  over a grid of kernels, strides, channels, dilations, groups and
  paddings; the port's `auto` takes the kernels wherever JAX's static gate
  does (JAX's `auto` does so on its accelerator; on the CPU it is dense).
- `conv_bn_relu_plain` (what the kernels' wrappers run on a CPU tensor)
  against `conv_bn_relu_reference` (paddle_tpu/ops/pallas/conv.py:293) at
  bench_ops.py's nine ResNet-50 sweep shapes at batch 1, and a stride x
  ReLU x padding x dtype matrix. The JAX Pallas conv kernels cannot run
  here (jax 0.9.0 has no `pltpu.TPUCompilerParams`), so the reference is
  their dense foil.
- `conv2d`, `batch_norm` (inference), `max_pool2d`, `adaptive_avg_pool2d`
  against JAX's `nn_ops`.
- `ConvBNReLU` in eval, kernel route and dense route, against JAX's
  `ConvBNReLU(backend="dense")` with seeded BatchNorm statistics.

Tolerances, max |port - JAX| relative to max |JAX|: f32 1e-5 (fp32 sums
in another order: the JAX suite's FP32_REL_TOL, tests/test_pallas_conv.py);
bf16 one bf16 ulp at max |JAX| (both sum exact products in fp32, so only
the final rounding may differ: one ulp of the value).
"""
import math

import bench_ops
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu.ops.pallas import conv as jconv
from paddle_tpu_torch.nn import BatchNorm2D, ConvBNReLU
from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import nn_ops as tops

SWEEP = list(bench_ops.CONV_SWEEP_SHAPES)
F32_TOL = 1e-5


def _rel_err(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-6)


def _bf16_ulp(ref):
    """One bf16 ulp at max |ref|, relative to max |ref|."""
    top = float(np.max(np.abs(np.asarray(ref, np.float32))))
    return 2.0 ** (math.floor(math.log2(top)) - 7) / top


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _j(a, dtype):
    return jnp.asarray(np.asarray(a, np.float32)).astype(dtype)


# ---------------------------------------------------------------------------
# the backend seam's helpers
# ---------------------------------------------------------------------------
PADDINGS = [0, 1, 2, "SAME", "VALID", "same", (1, 0), [1, 1],
            ((0, 1), (1, 0)), [0, 1, 1, 0], (0, 0, 0, 0)]


@pytest.mark.parametrize("kernel", [1, 3, 7, (3, 1)])
@pytest.mark.parametrize("stride", [1, 2, 3, (1, 2)])
def test_conv_helpers_match_jax(kernel, stride, monkeypatch):
    monkeypatch.delenv("PADDLE_CONV_BACKEND", raising=False)
    for padding in PADDINGS:
        for hw in ((8, 8), (7, 9), (56, 56)):
            assert tconv.normalize_conv_padding(padding, kernel, stride, hw) \
                == jconv.normalize_conv_padding(padding, kernel, stride, hw)
        for cin, cout in ((8, 16), (12, 16), (64, 8), (16, 20)):
            for dilation, groups in ((1, 1), (2, 1), (1, 2)):
                args = (kernel, stride, cin, cout, dilation, groups, padding)
                ok = jconv.conv_shapes_supported(*args)
                assert tconv.conv_shapes_supported(*args) == ok
                kw = dict(kernel=kernel, stride=stride, in_channels=cin,
                          out_channels=cout, dilation=dilation,
                          groups=groups, padding=padding)
                for backend in ("dense", "pallas"):
                    assert tconv.resolve_conv_backend(backend, **kw) \
                        == jconv.resolve_conv_backend(backend, **kw)
                assert tconv.resolve_conv_backend(None, **kw) \
                    == ("pallas" if ok else "dense")
    with pytest.raises(ValueError, match="SAME"):
        tconv.normalize_conv_padding("SAME", kernel, stride)
    with pytest.raises(ValueError, match="backend"):
        tconv.resolve_conv_backend("cudnn", kernel=kernel, stride=stride)


# ---------------------------------------------------------------------------
# the plain version against conv_bn_relu_reference
# ---------------------------------------------------------------------------
def _conv_inputs(n, hw, cin, cout, k, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) * 0.1).astype(np.float32)
    scale = (rng.rand(cout) + 0.5).astype(np.float32)
    shift = rng.randn(cout).astype(np.float32)
    return x, w, scale, shift


def _check_plain(n, hw, cin, cout, k, s, dtype, padding, relu, seed=0):
    x, w, scale, shift = _conv_inputs(n, hw, cin, cout, k, seed)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    ref = jconv.conv_bn_relu_reference(
        _j(x, jd), _j(w, jd), jnp.asarray(scale), jnp.asarray(shift),
        stride=s, padding=padding, relu=relu)
    before = (tconv.conv1x1_bn_relu if k == 1
              else tconv.conv3x3_bn_relu).plain_calls
    got = tconv.fused_conv_bn_relu(_t(x, td), _t(w, td),
                                   torch.from_numpy(scale),
                                   torch.from_numpy(shift), s, padding, relu)
    assert (tconv.conv1x1_bn_relu if k == 1
            else tconv.conv3x3_bn_relu).plain_calls == before + 1
    assert got.dtype == td and tuple(got.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    tol = F32_TOL if dtype == "float32" else _bf16_ulp(ref)
    assert _rel_err(got.float().numpy(), ref) <= tol
    return got, ref


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,hw,cin,cout,k,s", SWEEP,
                         ids=[r[0] for r in SWEEP])
def test_plain_matches_reference_at_sweep_shapes(name, hw, cin, cout, k, s,
                                                 dtype):
    """The nine sweep shapes at batch 1, SAME and ReLU as bench_ops runs
    them (SAME pads asymmetrically at stride 2: the halo edge case)."""
    _check_plain(1, hw, cin, cout, k, s, dtype, "SAME", True)


@pytest.mark.parametrize("k,cin,cout", [(1, 32, 64), (3, 32, 32)])
@pytest.mark.parametrize("s", [1, 2])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("padding", ["int", "SAME"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_reference_matrix(k, cin, cout, s, relu, padding,
                                        dtype):
    """Both filter sizes x stride x ReLU x padding (ResNet's int padding:
    0 for 1x1, 1 for 3x3) x dtype, at an odd width (15)."""
    pad = "SAME" if padding == "SAME" else (0 if k == 1 else 1)
    got, _ = _check_plain(2, 15, cin, cout, k, s, dtype, pad, relu, seed=1)
    if not relu:
        assert bool((got < 0).any())


def test_fused_op_refuses_what_the_kernels_do_not_take():
    """The shapes `conv_shapes_supported` rejects raise, as JAX's
    `fused_conv_bn_relu` does, on the CPU too: a 7x7 filter, channels not
    a multiple of 8, a padded 1x1, a 3x3 handed to the 1x1 wrapper."""
    x, w, scale, shift = (torch.from_numpy(a) for a in
                          _conv_inputs(1, 8, 16, 16, 3))
    sc, sh = scale, shift
    x7, w7, _, _ = (torch.from_numpy(a) for a in _conv_inputs(1, 8, 16, 16, 7))
    for args in ((x7, w7, sc, sh, 1, 3), (x[..., :12], w[:, :, :12], sc, sh),
                 (x, w[:1, :1], sc, sh, 1, 1)):
        with pytest.raises(ValueError, match="do not cover"):
            tconv.fused_conv_bn_relu(*args)
        with pytest.raises(ValueError):
            jconv.fused_conv_bn_relu(*(jnp.asarray(a.numpy())
                                       if torch.is_tensor(a) else a
                                       for a in args))
    with pytest.raises(ValueError, match="takes a 1x1"):
        tconv.conv1x1_bn_relu(x, w, sc, sh, 1, 1)


# ---------------------------------------------------------------------------
# functional ops
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("padding,stride,dilation,groups", [
    (3, 2, 1, 1), ("SAME", 2, 1, 1), ("VALID", 1, 1, 1), ([1, 2], 1, 1, 2),
    ([0, 1, 1, 0], 2, 1, 1), ("SAME", 1, 2, 1), (1, (1, 2), 1, 4)])
def test_conv2d_matches_jax(padding, stride, dilation, groups):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 8, 11, 10).astype(np.float32)
    k = 7 if padding == 3 else 3
    w = (rng.randn(16, 8 // groups, k, k) * 0.2).astype(np.float32)
    b = rng.randn(16).astype(np.float32)
    ref = jops.conv2d(paddle.to_tensor(x), paddle.to_tensor(w),
                      paddle.to_tensor(b), stride, padding, dilation,
                      groups).numpy()
    got = tops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                      torch.from_numpy(b), stride, padding, dilation, groups)
    assert got.shape == ref.shape
    assert _rel_err(got.numpy(), ref) <= F32_TOL
    # channels_last input, no bias: the same values, channels_last out
    got = tops.conv2d(torch.from_numpy(x).contiguous(
        memory_format=torch.channels_last), torch.from_numpy(w), None,
        stride, padding, dilation, groups)
    ref = jops.conv2d(paddle.to_tensor(x), paddle.to_tensor(w), None,
                      stride, padding, dilation, groups).numpy()
    assert _rel_err(got.numpy(), ref) <= F32_TOL


def test_batch_norm_and_pooling_match_jax():
    rng = np.random.RandomState(4)
    x = rng.randn(2, 6, 9, 8).astype(np.float32)
    stats = [rng.uniform(lo, hi, 6).astype(np.float32) for lo, hi in
             ((-0.5, 0.5), (0.5, 2.0), (0.5, 1.5), (-0.5, 0.5))]
    ref = jops.batch_norm(paddle.to_tensor(x),
                          *(paddle.to_tensor(a) for a in stats),
                          training=False).numpy()
    got = tops.batch_norm(torch.from_numpy(x),
                          *(torch.from_numpy(a) for a in stats))
    assert _rel_err(got.numpy(), ref) <= F32_TOL
    # the training form: batch statistics, the running stats updated in
    # place (tests/test_torch_conv_train.py holds it in full)
    jstats = [paddle.to_tensor(a) for a in stats]
    tstats = [torch.from_numpy(a.copy()) for a in stats]
    ref = jops.batch_norm(paddle.to_tensor(x), *jstats,
                          training=True).numpy()
    got = tops.batch_norm(torch.from_numpy(x), *tstats, training=True)
    assert _rel_err(got.numpy(), ref) <= F32_TOL
    for t, j in zip(tstats[:2], jstats[:2]):
        assert _rel_err(t.numpy(), j.numpy()) <= F32_TOL
    for k, s, p in ((3, 2, 1), (3, 2, "SAME"), (2, None, 0), (3, 1, 2),
                    (3, 2, [0, 1, 1, 0])):
        ref = jops.max_pool2d(paddle.to_tensor(x), k, s, p).numpy()
        got = tops.max_pool2d(torch.from_numpy(x), k, s, p)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=str((k, s,
                                                                     p)))
    for size in ((1, 1), (3, 4), (9, 2)):
        ref = jops.adaptive_avg_pool2d(paddle.to_tensor(x), size).numpy()
        got = tops.adaptive_avg_pool2d(torch.from_numpy(x), size)
        assert _rel_err(got.numpy(), ref) <= F32_TOL
    with pytest.raises(NotImplementedError, match="non-divisible"):
        tops.adaptive_avg_pool2d(torch.from_numpy(x), (2, 5))


# ---------------------------------------------------------------------------
# the ConvBNReLU block
# ---------------------------------------------------------------------------
def _seeded_bn_arrays(rng, c):
    return {"bn.weight": rng.uniform(0.5, 1.5, c), "bn.bias":
            rng.uniform(-0.5, 0.5, c), "bn._mean": rng.uniform(-0.5, 0.5, c),
            "bn._variance": rng.uniform(0.5, 2.0, c)}


@pytest.mark.parametrize("cin,cout,k,s,padding,act", [
    (16, 32, 3, 1, 1, "relu"), (16, 16, 3, 2, 1, None),
    (32, 64, 1, 1, 0, "relu"), (32, 64, 1, 2, 0, None),
    (16, 16, 3, 2, "SAME", "relu")])
def test_convbnrelu_eval_matches_jax_dense(cin, cout, k, s, padding, act):
    """The block on the kernel route (`auto`: the plain version here) and
    on the dense route, from the same weights and seeded BatchNorm
    statistics, against JAX's dense block. The kernel route is one call of
    the kernel wrapper and carries no gradient (forward only, as JAX's
    fused path); the dense route counts in `dense_calls`."""
    paddle.seed(0)
    jb = jnn.ConvBNReLU(cin, cout, k, stride=s, padding=padding, act=act,
                        backend="dense")
    jb.eval()
    rng = np.random.RandomState(5)
    arrays = {"conv.weight": np.asarray(jb.conv.weight._array),
              **_seeded_bn_arrays(rng, cout)}
    arrays = {n: np.asarray(a, np.float32) for n, a in arrays.items()}
    jb.set_state_dict(arrays)
    x = rng.randn(2, cin, 13, 13).astype(np.float32)
    ref = jb(paddle.to_tensor(x)).numpy()
    wrapper = tconv.conv1x1_bn_relu if k == 1 else tconv.conv3x3_bn_relu
    for backend in (None, "dense"):
        tb = ConvBNReLU(cin, cout, k, stride=s, padding=padding, act=act,
                        backend=backend, device="cpu")
        tb.load_state_dict({n: torch.tensor(a) for n, a in arrays.items()})
        tb.eval()
        assert tb.backend == ("dense" if backend else "pallas")
        plain, dense = wrapper.plain_calls, \
            tconv.fused_conv_bn_relu.dense_calls
        xt = torch.from_numpy(x).requires_grad_()
        got = tb(xt)
        assert (wrapper.plain_calls - plain,
                tconv.fused_conv_bn_relu.dense_calls - dense) == \
            ((0, 1) if backend else (1, 0))
        assert got.requires_grad == bool(backend)
        assert got.shape == ref.shape
        assert _rel_err(got.detach().numpy(), ref) <= F32_TOL, backend
        if act is None:
            assert float(got.detach().min()) < 0


def test_convbnrelu_resolves_like_jax(monkeypatch):
    """Shapes the kernels do not take resolve dense whatever was asked
    (the 7x7/s2 stem, channels not a multiple of 8), as in JAX, and the
    port's `auto` resolves as JAX's explicit `pallas`; a custom norm layer
    resolves dense; a bad activation or backend raises."""
    monkeypatch.delenv("PADDLE_CONV_BACKEND", raising=False)
    cases = [((3, 64, 7), dict(stride=2, padding=3)), ((12, 16, 3), {}),
             ((16, 16, 3), dict(padding=1)), ((16, 16, 1), dict(stride=2))]
    for args, kw in cases:
        for backend in (None, "dense", "pallas"):
            tb = ConvBNReLU(*args, backend=backend, device="cpu", **kw)
            jb = jnn.ConvBNReLU(*args, backend=backend or "pallas", **kw)
            assert tb.backend == jb.backend, (args, backend)

    class Norm(torch.nn.Module):
        def __init__(self, c):
            super().__init__()
            self.scale = torch.nn.Parameter(torch.ones(c))

        def forward(self, x):
            return x * self.scale.view(1, -1, 1, 1)

    tb = ConvBNReLU(16, 16, 3, padding=1, backend="pallas",
                    norm_layer=Norm, device="cpu")
    assert tb.backend == "dense" and not isinstance(tb.bn, BatchNorm2D)
    tb.eval()
    assert tb(torch.zeros(1, 16, 4, 4)).shape == (1, 16, 4, 4)
    with pytest.raises(ValueError, match="act"):
        ConvBNReLU(8, 8, 3, act="gelu", device="cpu")
    with pytest.raises(ValueError, match="backend"):
        ConvBNReLU(8, 8, 3, backend="cudnn", device="cpu")
