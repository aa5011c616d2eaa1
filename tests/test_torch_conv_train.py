"""The conv training ops of the PyTorch port against the JAX package, on the
CPU.

- `batch_norm(training=True)`: the output, the gradients of x, weight and
  bias, and the running statistics against JAX's `nn_ops.batch_norm` at
  f32 and bf16, NCHW.
- `Momentum` against JAX's `_single_update` over three steps, with and
  without nesterov and weight decay, f32 and bf16 parameters.
- The plain versions of the conv train kernels, at bench_ops.py's nine
  ResNet-50 sweep geometries (batch 1, channels cut by 8) and the 1x1 and
  3x3 stride-2 cases: the train forward's conv and `[2, Cout]` sums
  (B9) against JAX's conv; the 1x1 backward's dx and dw (B10) and the 3x3
  dWeight (B11), fed the port's pass-1 results, against `jax.vjp` of
  `conv_bn_relu_train_reference` (paddle_tpu/ops/pallas/conv.py:853).
  The JAX Pallas train kernels cannot run here (jax 0.9.0 has no
  `pltpu.TPUCompilerParams`), so the reference is their dense foil.
- `fused_conv_bn_relu_train` (the autograd Function, over the plain
  versions on the CPU): (y, mean, var) and the four gradients against
  `jax.vjp` of the reference.
- `ConvBNReLU` in train mode on the kernel route against JAX's dense block,
  with the running-stat update; `use_global_stats` and the dense backend
  take the composition; a geometry JAX's per-call gate sends dense (3x3 at
  34 x 34) takes the kernels here (ROADMAP Queue C 7).

Tolerances. f32: max |port - JAX| within 1e-5 of max |JAX| (fp32 sums in
another order; the JAX suite's FP32_GRAD_TOL, tests/test_pallas_conv_bwd.py).
bf16 forward: one bf16 ulp at max |JAX| (both sum exact products in fp32;
only the final rounding may differ). bf16 gradients: relative L2 within
`CONV_FUSED_REL_TOL` = 0.03 (bench_ops.py), the JAX suite's BF16_GRAD_TOL:
bf16 roundings of dConv and of the dense backward's own intermediates feed
sign-cancelling sums, so Linf deviations run ~10x the aggregate error for
the dense backward too.
"""
import math

import bench_ops
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.ops import nn_ops as jops
from paddle_tpu.ops.pallas import conv as jconv
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu_torch import Momentum
from paddle_tpu_torch.nn import BatchNorm2D, ConvBNReLU
from paddle_tpu_torch.ops import conv as tconv
from paddle_tpu_torch.ops import nn_ops as tops

F32_TOL = 1e-5
BF16_GRAD_TOL = bench_ops.CONV_FUSED_REL_TOL
# the sweep at batch 1 with channels cut by 8 (at least 8)
SWEEP = [(n, hw, max(cin // 8, 8), max(cout // 8, 8), k, s)
         for n, hw, cin, cout, k, s in bench_ops.CONV_SWEEP_SHAPES]
STRIDE2 = [("1x1_s2", 14, 16, 32, 1, 2), ("3x3_s2_odd", 15, 16, 16, 3, 2)]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _rel_err(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.max(np.abs(g - r)) / max(np.max(np.abs(r)), 1e-6)


def _rel_l2(got, ref):
    g = np.asarray(got, np.float32)
    r = np.asarray(ref, np.float32)
    return np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-6)


def _bf16_ulp(ref):
    top = float(np.max(np.abs(np.asarray(ref, np.float32))))
    return 2.0 ** (math.floor(math.log2(top)) - 7) / top


def _np(t):
    return t.detach().float().numpy()


# ---------------------------------------------------------------------------
# BatchNorm's training form and Momentum
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_batch_norm_training_matches_jax(dtype):
    """Output, gradients and running statistics after two training calls
    (the second from the first's running stats). f32: each within 1e-5 of
    its largest value. bf16: the output and gradients as the bf16 forward
    and gradient bars; the running stats within two bf16 ulps at their
    largest value (the update rounds to bf16 three times, and a batch
    mean summed in another order may round the other way)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(11)
    C = 6
    stats = [rng.uniform(lo, hi, C).astype(np.float32) for lo, hi in
             ((-0.5, 0.5), (0.5, 2.0), (0.5, 1.5), (-0.5, 0.5))]
    jrm, jrv, jw, jb = (paddle.to_tensor(jnp.asarray(a).astype(jdt),
                                         stop_gradient=i < 2)
                        for i, a in enumerate(stats))
    trm, trv = (torch.from_numpy(a).to(tdt) for a in stats[:2])
    tw, tb = (torch.from_numpy(a).to(tdt).requires_grad_()
              for a in stats[2:])
    for call in range(2):
        x = (rng.randn(3, C, 7, 5) * 2 + 0.5).astype(np.float32)
        dy = rng.randn(3, C, 7, 5).astype(np.float32)
        jx = paddle.to_tensor(jnp.asarray(x).astype(jdt),
                              stop_gradient=False)
        jout = jops.batch_norm(jx, jrm, jrv, jw, jb, training=True,
                               momentum=0.9)
        (jout * paddle.to_tensor(jnp.asarray(dy).astype(jdt))).sum() \
            .backward()
        tx = torch.from_numpy(x).to(tdt).requires_grad_()
        tout = tops.batch_norm(tx, trm, trv, tw, tb, training=True,
                               momentum=0.9)
        tout.backward(torch.from_numpy(dy).to(tdt))
        assert tout.dtype == tdt and trm.dtype == tdt
        got = [_np(tout), _np(tx.grad), _np(tw.grad), _np(tb.grad)]
        want = [np.asarray(t._array.astype(jnp.float32)) for t in
                (jout, jx.grad, jw.grad, jb.grad)]
        if dtype == "float32":
            for name, g, r in zip(("out", "dx", "dw", "db"), got, want):
                assert _rel_err(g, r) <= F32_TOL, name
        else:
            assert _rel_err(got[0], want[0]) <= _bf16_ulp(want[0])
            for name, g, r in zip(("dx", "dw", "db"), got[1:], want[1:]):
                assert _rel_l2(g, r) <= BF16_GRAD_TOL, name
        for t, j in ((trm, jrm), (trv, jrv)):
            want = np.asarray(j._array.astype(jnp.float32))
            if dtype == "float32":
                assert _rel_err(_np(t), want) <= F32_TOL
            else:
                assert _rel_err(_np(t), want) <= 2 * _bf16_ulp(want)
        tw.grad = tb.grad = None
        jw.clear_grad()
        jb.clear_grad()


def test_batch_norm_use_global_stats_keeps_the_inference_form():
    """A training-mode BatchNorm2D with use_global_stats normalizes by its
    running statistics and leaves them alone; without it, the batch
    statistics and the running update with the layer's momentum."""
    x = torch.from_numpy(np.random.RandomState(2).randn(2, 4, 3, 3)
                         .astype(np.float32))
    bn = BatchNorm2D(4, momentum=0.8, use_global_stats=True, device="cpu")
    with torch.no_grad():
        bn._mean.uniform_(-0.5, 0.5)
    before = bn._mean.clone()
    out = bn.train()(x)
    torch.testing.assert_close(out, tops.batch_norm(
        x, bn._mean, bn._variance, bn.weight, bn.bias), rtol=0, atol=0)
    torch.testing.assert_close(bn._mean, before, rtol=0, atol=0)
    bn._use_global_stats = None
    bn(x)
    mean = x.mean(dim=(0, 2, 3))
    torch.testing.assert_close(bn._mean, 0.8 * before + 0.2 * mean)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("nesterov", [False, True])
@pytest.mark.parametrize("wd", [None, 0.05])
def test_momentum_matches_jax_single_update(dtype, nesterov, wd):
    """Three steps: the fp32 velocity and the parameter, rounded back to
    its own dtype every step (bf16 within one bf16 ulp of the value: fp32
    sums in another order may round a half-ulp value the other way)."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.RandomState(5)
    shapes = {"w": (6, 5), "b": (5,)}
    params = {n: np.array(jnp.asarray(0.05 * rng.randn(*s), jdt)
                            .astype(jnp.float32)) for n, s in shapes.items()}
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a).to(tdt))
               for n, a in params.items()}
    jopt = JMomentum(learning_rate=0.1, momentum=0.9, parameters=[],
                     use_nesterov=nesterov, weight_decay=wd)
    topt = Momentum(learning_rate=0.1, momentum=0.9,
                    parameters=list(tparams.values()),
                    use_nesterov=nesterov, weight_decay=wd)
    jp = {n: jnp.asarray(a, jdt) for n, a in params.items()}
    jacc = {n: {"velocity": jnp.zeros(a.shape, jnp.float32)}
            for n, a in params.items()}
    for step in range(3):
        for i, (n, s) in enumerate(shapes.items()):
            g = np.array(jnp.asarray(rng.randn(*s), jdt)
                           .astype(jnp.float32))
            jp[n], jacc[n] = jopt._single_update(
                jp[n], jnp.asarray(g, jdt), jacc[n],
                jnp.asarray(0.1, jnp.float32), jnp.asarray(step, jnp.int32))
            tparams[n].grad = torch.from_numpy(g).to(tdt)
        topt.step()
        for i, n in enumerate(shapes):
            got = tparams[n].detach()
            assert got.dtype == tdt
            want = np.asarray(jp[n].astype(jnp.float32))
            np.testing.assert_allclose(
                _np(got), want, atol=1e-8 if dtype == "float32" else 0,
                rtol=1e-6 if dtype == "float32" else 2 ** -7)
            vel = topt._accumulators["velocity"][i]
            assert vel.dtype == torch.float32
            np.testing.assert_allclose(vel.numpy(),
                                       np.asarray(jacc[n]["velocity"]),
                                       rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the kernels' plain versions and the training op
# ---------------------------------------------------------------------------
def _case(hw, cin, cout, k, s, dtype, n=1, seed=0):
    """NHWC x, HWIO w, f32 gamma and beta, the cotangent dy, as numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, hw, hw, cin).astype(np.float32)
    w = (rng.randn(k, k, cin, cout) / math.sqrt(k * k * cin)) \
        .astype(np.float32)
    gamma = (rng.rand(cout) + 0.5).astype(np.float32)
    beta = rng.randn(cout).astype(np.float32)
    jdt = DTYPES[dtype][1]
    x, w = (np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
            for a in (x, w))
    ho = (hw - 1) // s + 1
    dy = rng.randn(n, ho, ho, cout).astype(np.float32)
    return x, w, gamma, beta, dy


def _jax_vjp(x, w, gamma, beta, dy, s, padding, relu, dtype):
    """(y, mean, var, dx, dw, dgamma, dbeta) of jax.vjp of the reference,
    the mean and var cotangents zero, as in a train step."""
    jdt = DTYPES[dtype][1]
    fn = jax.vjp(lambda *a: jconv.conv_bn_relu_train_reference(
        *a, stride=s, padding=padding, relu=relu),
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(gamma),
        jnp.asarray(beta))
    (y, mean, var), vjp = fn
    grads = vjp((jnp.asarray(dy).astype(y.dtype), jnp.zeros_like(mean),
                 jnp.zeros_like(var)))
    return [np.asarray(a.astype(jnp.float32)) for a in (y, mean, var)
            + tuple(grads)]


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(DTYPES[dtype][0])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,hw,cin,cout,k,s", SWEEP + STRIDE2,
                         ids=[r[0] for r in SWEEP + STRIDE2])
def test_train_kernel_plain_versions_match_jax(name, hw, cin, cout, k, s,
                                               dtype):
    """B9: the conv against JAX's (lax.conv_general_dilated, "SAME") cast
    to the dtype, and its `[2, Cout]` sums against the sums of JAX's conv.
    B10 (1x1) and B11 (3x3): fed the port's forward conv and the pass-1
    bundle, dx and dw against jax.vjp of the reference."""
    pad = "SAME"
    x, w, gamma, beta, dy = _case(hw, cin, cout, k, s, dtype, seed=hw + k)
    jdt = DTYPES[dtype][1]
    pads = jconv.normalize_conv_padding(pad, k, s, in_hw=(hw, hw))
    jconv_out = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (s, s), list(pads),
        dimension_numbers=("NHWC", "HWIO", "NHWC")).astype(jdt)
    ref_conv = np.asarray(jconv_out.astype(jnp.float32))
    p = ref_conv.reshape(-1, cout).astype(np.float64)
    ref_sums = np.stack([p.sum(0), (p * p).sum(0)])
    tx, tw = _t(x, dtype), _t(w, dtype)
    wrapper = tconv.conv1x1_train if k == 1 else tconv.conv3x3_train
    plain = wrapper.plain_calls
    conv, sums = (wrapper(tx, tw, s) if k == 1 else wrapper(tx, tw, s, pad))
    assert wrapper.plain_calls == plain + 1
    assert conv.dtype == tx.dtype and sums.dtype == torch.float32
    assert conv.is_contiguous() and tuple(sums.shape) == (2, cout)
    tol = F32_TOL if dtype == "float32" else _bf16_ulp(ref_conv)
    assert _rel_err(_np(conv), ref_conv) <= tol
    # sums over M cast values: f32 1e-5 of the largest; bf16 values that
    # round the other way move a sum by an ulp of a value, at most
    assert _rel_err(sums.numpy(), ref_sums) <= (
        F32_TOL if dtype == "float32" else 2 ** -8)

    ref = _jax_vjp(x, w, gamma, beta, dy, s, pad, True, dtype)
    g32 = torch.from_numpy(gamma)
    b32 = torch.from_numpy(beta)
    y, conv, mean32, var32 = tconv._train_forward(
        tx, tw, g32, b32, s, tuple(pads), True, 1e-5)
    # pass 1 and pass 2 of the backward, the kernels' plain versions
    dx, dw, _, _ = tconv._train_backward(
        tx, tw, g32, b32, conv, mean32, var32,
        torch.from_numpy(dy).to(y.dtype), s, tuple(pads), True, 1e-5)
    metric, tol = ((_rel_err, F32_TOL) if dtype == "float32"
                   else (_rel_l2, BF16_GRAD_TOL))
    assert metric(_np(dx), ref[3]) <= tol
    assert metric(_np(dw), ref[4]) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("k,s,relu,padding", [
    (1, 1, True, 0), (1, 2, True, 0), (1, 1, False, 0), (1, 2, False, 0),
    (3, 1, True, 1), (3, 2, True, 1), (3, 1, False, 1), (3, 2, False,
                                                          "SAME"),
    (3, 2, True, "VALID")])
def test_fused_train_op_matches_jax_vjp(k, s, relu, padding, dtype):
    """`fused_conv_bn_relu_train` through its autograd Function (the plain
    versions on the CPU, each counted once a call): y, mean and var (bf16:
    one ulp), and dx, dw, dgamma and dbeta against jax.vjp of the
    reference (bf16: relative L2 within 0.03)."""
    hw, cin, cout = 10, 16, 24
    x, w, gamma, beta, dy = _case(hw, cin, cout, k, s, dtype, n=2, seed=k)
    hw_out = (hw + sum(jconv.normalize_conv_padding(
        padding, k, s, in_hw=(hw, hw))[0]) - k) // s + 1
    dy = dy[:, :hw_out, :hw_out] if dy.shape[1] >= hw_out else \
        np.random.RandomState(3).randn(2, hw_out, hw_out, cout) \
        .astype(np.float32)
    ref = _jax_vjp(x, w, gamma, beta, dy, s, padding, relu, dtype)
    leaves = [_t(x, dtype), _t(w, dtype), torch.from_numpy(gamma),
              torch.from_numpy(beta)]
    leaves = [t.requires_grad_() for t in leaves]
    wrappers = ((tconv.conv1x1_train, tconv.conv1x1_bwd) if k == 1 else
                (tconv.conv3x3_train, tconv.conv3x3_dw,
                 tconv.conv3x3_bn_relu))
    before = [w_.plain_calls for w_ in wrappers]
    calls = tconv.fused_conv_bn_relu_train.calls
    y, mean, var = tconv.fused_conv_bn_relu_train(
        *leaves, stride=s, padding=padding, relu=relu)
    assert not mean.requires_grad and not var.requires_grad
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy).to(y.dtype))
    assert tconv.fused_conv_bn_relu_train.calls == calls + 1
    assert [w_.plain_calls - b for w_, b in zip(wrappers, before)] == \
        [1] * len(wrappers)
    got = [_np(t) for t in (y, mean, var) + grads]
    for i, (name, g, r) in enumerate(zip(
            ("y", "mean", "var", "dx", "dw", "dgamma", "dbeta"), got, ref)):
        assert g.shape == r.shape, name
        if dtype == "float32":
            assert _rel_err(g, r) <= F32_TOL, name
        elif i < 3:
            assert _rel_err(g, r) <= _bf16_ulp(r), name
        else:
            assert _rel_l2(g, r) <= BF16_GRAD_TOL, name
    assert grads[1].dtype == leaves[1].dtype


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Shapes the static gate rejects raise before any kernel; a dWeight
    g of the wrong shape raises."""
    x = torch.zeros(1, 8, 8, 12)
    with pytest.raises(ValueError, match="do not cover"):
        tconv.fused_conv_bn_relu_train(x, torch.zeros(3, 3, 12, 16),
                                       torch.ones(16), torch.zeros(16))
    with pytest.raises(ValueError, match="do not cover"):
        tconv.conv1x1_train(torch.zeros(1, 8, 8, 16),
                            torch.zeros(1, 1, 16, 16), stride=3)
    with pytest.raises(ValueError, match="must be"):
        tconv.conv3x3_dw(torch.zeros(1, 8, 8, 16),
                         torch.zeros(1, 4, 4, 16), 1, 1)


# ---------------------------------------------------------------------------
# the ConvBNReLU block in train mode
# ---------------------------------------------------------------------------
def _seeded_block_arrays(jb, rng, cout):
    arrays = {"conv.weight": np.asarray(jb.conv.weight._array),
              "bn.weight": rng.uniform(0.5, 1.5, cout),
              "bn.bias": rng.uniform(-0.5, 0.5, cout),
              "bn._mean": rng.uniform(-0.5, 0.5, cout),
              "bn._variance": rng.uniform(0.5, 2.0, cout)}
    return {n: np.asarray(a, np.float32) for n, a in arrays.items()}


@pytest.mark.parametrize("cin,cout,k,s,padding,act", [
    (16, 32, 3, 1, 1, "relu"), (16, 16, 3, 2, 1, None),
    (32, 64, 1, 1, 0, "relu"), (32, 64, 1, 2, 0, None)])
def test_convbnrelu_train_matches_jax_dense(cin, cout, k, s, padding, act):
    """The block in train mode on the kernel route (`auto`: the train op
    over the plain versions here) and on the dense route, from the same
    weights and seeded BatchNorm statistics, against JAX's dense block:
    the output, the gradients of x and of every parameter, and the
    running statistics after the step."""
    paddle.seed(0)
    jb = jnn.ConvBNReLU(cin, cout, k, stride=s, padding=padding, act=act,
                        backend="dense")
    rng = np.random.RandomState(6)
    arrays = _seeded_block_arrays(jb, rng, cout)
    jb.set_state_dict(arrays)
    jb.train()
    x = rng.randn(2, cin, 11, 11).astype(np.float32)
    hw = (11 + 2 * (padding if isinstance(padding, int) else 0) - k) // s + 1
    dy = rng.randn(2, cout, hw, hw).astype(np.float32)
    jx = paddle.to_tensor(x, stop_gradient=False)
    (jb(jx) * paddle.to_tensor(dy)).sum().backward()
    jout = np.asarray(jb(paddle.to_tensor(x)).numpy())   # the second step
    want = {n: np.asarray(p.grad._array) for n, p in jb.named_parameters()}
    want["x"] = np.asarray(jx.grad._array)
    jstate = {n: np.asarray(v._array) for n, v in jb.state_dict().items()}
    for backend in (None, "dense"):
        tb = ConvBNReLU(cin, cout, k, stride=s, padding=padding, act=act,
                        backend=backend, device="cpu")
        tb.load_state_dict({n: torch.tensor(a) for n, a in arrays.items()})
        tb.train()
        calls = (tconv.fused_conv_bn_relu_train.calls,
                 tconv.fused_conv_bn_relu.dense_train_calls)
        tx = torch.from_numpy(x).requires_grad_()
        tb(tx).backward(torch.from_numpy(dy))
        tout = tb(torch.from_numpy(x))
        assert (tconv.fused_conv_bn_relu_train.calls - calls[0],
                tconv.fused_conv_bn_relu.dense_train_calls - calls[1]) == \
            ((0, 2) if backend else (2, 0))
        assert _rel_err(_np(tout), jout) <= F32_TOL, backend
        got = {n: p.grad.numpy() for n, p in tb.named_parameters()}
        got["x"] = tx.grad.numpy()
        assert set(got) == set(want)
        for n in want:
            assert _rel_err(got[n], want[n]) <= F32_TOL, (backend, n)
        for n, v in tb.state_dict().items():
            np.testing.assert_allclose(v.numpy(), jstate[n], rtol=1e-6,
                                       atol=1e-7, err_msg=(backend, n))


def test_convbnrelu_train_routes_without_a_geometry_gate():
    """No per-call geometry gate (ROADMAP Queue C 7): a 3x3 at 34 x 34,
    which JAX's `conv_train_geometry_tileable` sends dense, takes the train
    op on the kernel route; a BatchNorm with use_global_stats takes the
    composition, counted as a dense training call."""
    assert not jconv.conv_train_geometry_tileable(3, 1, 1, in_hw=(34, 34),
                                                  in_channels=16,
                                                  out_channels=16)
    tb = ConvBNReLU(16, 16, 3, padding=1, device="cpu").train()
    assert tb.backend == "pallas"
    calls = tconv.fused_conv_bn_relu_train.calls
    out = tb(torch.randn(1, 16, 34, 34))
    assert tconv.fused_conv_bn_relu_train.calls == calls + 1
    assert out.requires_grad and out.shape == (1, 16, 34, 34)
    tb.bn._use_global_stats = True
    dense = tconv.fused_conv_bn_relu.dense_train_calls
    tb(torch.randn(1, 16, 34, 34))
    assert tconv.fused_conv_bn_relu.dense_train_calls == dense + 1
    assert tconv.fused_conv_bn_relu_train.calls == calls + 1
