"""Gradient merge, loss scaling and the rest of `TrainStep`'s surface: the
port against the JAX package, on the CPU.

Each case of tests/test_trainstep_features.py runs in both packages from
the same weights (a tiny MLP, SGD at lr 0.1, seeded numpy batches): merge
equals the large batch, merge trains, the scaler skips on overflow, the
scaler trains when finite, scaler x merge equals the scaled large batch,
and an overflow skips the whole window. The port is held to JAX's
`jit.TrainStep` within 1e-6 (parameters, losses), and to its own large
batch at the JAX test's bars (rtol 1e-5, atol 1e-6). Beside them: a
BatchNorm model whose running statistics survive a skipped step (and, in a
merge window, keep the finite micro-step's update and not the overflowed
one's), a parameter the loss does not reach inside a merge window,
`with_outputs`, `loss_fn=None` with the trailing label dropped, the
refusals, the plain versions' counts, and the eager `GradScaler` (`scale`,
`unscale_` at f32 and bf16 bit for bit, `step`, `update`'s growth and
backoff, the `state_dict` round trip).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.amp import GradScaler as JScaler
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import SGD, AdamW, TrainStep
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.nn.norm import BatchNorm2D
from paddle_tpu_torch.observability import MetricsRegistry, TrainingTelemetry
from paddle_tpu_torch.ops import grad_merge as gm
from paddle_tpu_torch.ops.nn_ops import mse_loss


def _t(a):
    return paddle.to_tensor(np.asarray(a))


def _bridge(jnet, tnet):
    """tnet's parameters and buffers set to jnet's (Linear weights
    transposed: paddle keeps them [in, out])."""
    with torch.no_grad():
        target = tnet.state_dict()
        for name, v in jnet.state_dict().items():
            a = np.asarray(v._array)
            target[name].copy_(torch.from_numpy(
                a.T.copy() if a.ndim == 2 else a))


def _assert_same(jnet, tnet, atol=1e-6, rtol=0.0):
    target = tnet.state_dict()
    for name, v in jnet.state_dict().items():
        a = np.asarray(v._array)
        got = target[name].detach().numpy()
        np.testing.assert_allclose(got.T if a.ndim == 2 else got, a,
                                   atol=atol, rtol=rtol, err_msg=name)


def _mlp_pair(seed, opt="sgd"):
    """The JAX test's MLP in both packages, same weights, each with its
    optimizer."""
    paddle.seed(seed)
    jnet = jnn.Sequential(jnn.Linear(8, 16), jnn.Tanh(), jnn.Linear(16, 4))
    tnet = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.Tanh(),
                               torch.nn.Linear(16, 4))
    _bridge(jnet, tnet)
    if opt == "sgd":
        return (jnet, JSGD(0.1, parameters=jnet.parameters()), tnet,
                SGD(0.1, parameters=tnet.parameters()))
    return (jnet, JAdamW(0.1, parameters=jnet.parameters()), tnet,
            AdamW(0.1, parameters=tnet.parameters()))


def _micro(seed, n=4, rows=8):
    rs = np.random.RandomState(seed)
    return [(rs.randn(rows, 8).astype(np.float32),
             rs.randn(rows, 4).astype(np.float32)) for _ in range(n)]


def _call(jstep, tstep, x, y):
    """One call in each package: (JAX loss, port loss)."""
    jl = float(jstep(_t(x), _t(y))._array)
    tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y)))
    return jl, tl


# ---------------------------------------------------------------------------
# gradient merge
# ---------------------------------------------------------------------------
def test_grad_accumulation_matches_large_batch():
    micro = _micro(0)
    big_x = np.concatenate([m[0] for m in micro])
    big_y = np.concatenate([m[1] for m in micro])
    _, _, tnet_a, topt_a = _mlp_pair(7)
    TrainStep(tnet_a, topt_a, mse_loss)(torch.from_numpy(big_x),
                                        torch.from_numpy(big_y))
    jnet, jopt, tnet, topt = _mlp_pair(7)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, accumulate_steps=4)
    tstep = TrainStep(tnet, topt, mse_loss, accumulate_steps=4)
    w0 = tnet[0].weight.detach().clone()
    for i, (x, y) in enumerate(micro):
        jl, tl = _call(jstep, tstep, x, y)
        assert abs(jl - tl) <= 1e-6
        if i < 3:
            assert torch.equal(tnet[0].weight, w0)
    assert topt._step_count == jopt._step_count == 1
    _assert_same(jnet, tnet)
    for a, b in zip(tnet_a.parameters(), tnet.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_grad_accumulation_trains():
    rs = np.random.RandomState(1)
    x = rs.randn(8, 8).astype(np.float32)
    y = rs.randn(8, 4).astype(np.float32)
    jnet, jopt, tnet, topt = _mlp_pair(3)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, accumulate_steps=2)
    tstep = TrainStep(tnet, topt, mse_loss, accumulate_steps=2)
    losses = [_call(jstep, tstep, x, y) for _ in range(8)]   # 4 updates
    np.testing.assert_allclose([t for _, t in losses],
                               [j for j, _ in losses], atol=1e-6, rtol=0)
    assert losses[-1][1] < losses[0][1]
    assert topt._step_count == 4
    _assert_same(jnet, tnet)


def test_grad_merge_updates_a_parameter_the_loss_does_not_reach():
    """A Linear off the loss's path inside a two-step merge window with
    AdamW: its zero grads enter the merge buffers and its decay moves it,
    as in JAX."""
    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.used = jnn.Linear(8, 4)
            self.unused = jnn.Linear(8, 4)

        def forward(self, x):
            return self.used(x)

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.used = torch.nn.Linear(8, 4)
            self.unused = torch.nn.Linear(8, 4)

        def forward(self, x):
            return self.used(x)

    paddle.seed(4)
    jnet, tnet = JNet(), TNet()
    _bridge(jnet, tnet)
    jstep = jjit.TrainStep(jnet, JAdamW(0.1, parameters=jnet.parameters()),
                           JF.mse_loss, accumulate_steps=2)
    tstep = TrainStep(tnet, AdamW(0.1, parameters=tnet.parameters()),
                      mse_loss, accumulate_steps=2)
    before = tnet.unused.weight.detach().clone()
    for x, y in _micro(5):
        _call(jstep, tstep, x, y)
    assert len(tstep._grad_bufs) == 4
    assert (tnet.unused.weight - before).abs().max() > 1e-4
    _assert_same(jnet, tnet)


# ---------------------------------------------------------------------------
# loss scaling
# ---------------------------------------------------------------------------
def test_scaler_skips_update_on_overflow():
    jnet, jopt, tnet, topt = _mlp_pair(5)
    kw = dict(init_loss_scaling=1e38, incr_ratio=2.0, decr_ratio=0.5,
              decr_every_n_nan_or_inf=1)
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, scaler=jsc)
    tstep = TrainStep(tnet, topt, mse_loss, scaler=tsc)
    x = np.ones((4, 8), np.float32)
    y = np.full((4, 4), 1e3, np.float32)
    w0 = tnet[0].weight.detach().clone()
    jl, tl = _call(jstep, tstep, x, y)
    assert np.isfinite(tl) and abs(jl - tl) <= 1e-6 * abs(jl)
    assert torch.equal(tnet[0].weight, w0)
    assert tsc.get_scale() == jsc.get_scale() == pytest.approx(0.5e38)
    assert topt._step_count == jopt._step_count == 0
    _assert_same(jnet, tnet, atol=0)


def test_scaler_trains_when_finite():
    rs = np.random.RandomState(2)
    x = rs.randn(8, 8).astype(np.float32)
    y = rs.randn(8, 4).astype(np.float32)
    jnet, jopt, tnet, topt = _mlp_pair(6)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss,
                           scaler=JScaler(init_loss_scaling=1024.0))
    tsc = GradScaler(init_loss_scaling=1024.0)
    tstep = TrainStep(tnet, topt, mse_loss, scaler=tsc)
    losses = [_call(jstep, tstep, x, y) for _ in range(6)]
    got = [t for _, t in losses]
    np.testing.assert_allclose(got, [j for j, _ in losses], atol=1e-6,
                               rtol=0)
    assert got[-1] < got[0]
    assert tsc.get_scale() == 1024.0 and topt._step_count == 6
    _assert_same(jnet, tnet)
    # parity with an unscaled step: same weights, same data
    _, _, net2, opt2 = _mlp_pair(6)
    step2 = TrainStep(net2, opt2, mse_loss)
    plain = [float(step2(torch.from_numpy(x), torch.from_numpy(y)))
             for _ in range(6)]
    np.testing.assert_allclose(got, plain, rtol=1e-4, atol=1e-6)


def test_scaler_with_grad_accumulation_parity():
    """K scaled micro-steps equal one scaled step on the combined batch."""
    micro = _micro(3)
    big_x = np.concatenate([m[0] for m in micro])
    big_y = np.concatenate([m[1] for m in micro])
    _, _, tnet_a, topt_a = _mlp_pair(11)
    TrainStep(tnet_a, topt_a, mse_loss,
              scaler=GradScaler(init_loss_scaling=1024.0))(
        torch.from_numpy(big_x), torch.from_numpy(big_y))
    jnet, jopt, tnet, topt = _mlp_pair(11)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, accumulate_steps=4,
                           scaler=JScaler(init_loss_scaling=1024.0))
    tsc = GradScaler(init_loss_scaling=1024.0)
    tstep = TrainStep(tnet, topt, mse_loss, accumulate_steps=4, scaler=tsc)
    w0 = tnet[0].weight.detach().clone()
    for i, (x, y) in enumerate(micro):
        _call(jstep, tstep, x, y)
        if i < 3:
            assert torch.equal(tnet[0].weight, w0)
    assert topt._step_count == 1 and tsc.get_scale() == 1024.0
    _assert_same(jnet, tnet)
    for a, b in zip(tnet_a.parameters(), tnet.parameters()):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_scaler_accumulation_overflow_skips_whole_window():
    """One overflowing micro-step poisons the window: no update, scale
    halved, the flag reset for the next window, which trains."""
    jnet, jopt, tnet, topt = _mlp_pair(12)
    kw = dict(init_loss_scaling=1e38, decr_every_n_nan_or_inf=1)
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, accumulate_steps=2,
                           scaler=jsc)
    tstep = TrainStep(tnet, topt, mse_loss, accumulate_steps=2, scaler=tsc)
    w0 = tnet[0].weight.detach().clone()
    x = np.ones((4, 8), np.float32)
    y = np.full((4, 4), 1e3, np.float32)
    _call(jstep, tstep, x, y)
    _call(jstep, tstep, x, y)                 # the window closes here
    assert torch.equal(tnet[0].weight, w0)
    assert topt._step_count == 0
    assert tsc.get_scale() == pytest.approx(0.5e38)
    rs = np.random.RandomState(4)
    x2 = rs.randn(4, 8).astype(np.float32)
    y2 = rs.randn(4, 4).astype(np.float32)
    jsc._scale = tsc._scale = 1024.0          # a sane scale for the next
    _call(jstep, tstep, x2, y2)
    _call(jstep, tstep, x2, y2)
    assert topt._step_count == 1
    assert not torch.allclose(tnet[0].weight, w0)
    _assert_same(jnet, tnet)


def _bn_pair(seed):
    """Linear -> BatchNorm2D over a [N, 4, 2, 2] view -> Linear, in both
    packages, with running statistics drawn from the seed (at init they
    are the identity, which would hide a wrong restore)."""
    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc1 = jnn.Linear(8, 16)
            self.bn = jnn.BatchNorm2D(4)
            self.fc2 = jnn.Linear(16, 4)

        def forward(self, x):
            h = paddle.reshape(self.fc1(x), [-1, 4, 2, 2])
            return self.fc2(paddle.reshape(self.bn(h), [-1, 16]))

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc1 = torch.nn.Linear(8, 16)
            self.bn = BatchNorm2D(4)
            self.fc2 = torch.nn.Linear(16, 4)

        def forward(self, x):
            h = self.fc1(x).reshape(-1, 4, 2, 2)
            return self.fc2(self.bn(h).reshape(-1, 16))

    paddle.seed(seed)
    jnet, tnet = JNet(), TNet()
    rs = np.random.RandomState(seed)
    jnet.bn._mean.set_value(rs.randn(4).astype(np.float32))
    jnet.bn._variance.set_value(rs.uniform(0.5, 2, 4).astype(np.float32))
    _bridge(jnet, tnet)
    return jnet, tnet


def test_skipped_step_keeps_batchnorm_running_statistics():
    """K = 1: an overflowed step leaves the running statistics bitwise as
    they were; a finite step then moves them as JAX's does."""
    jnet, tnet = _bn_pair(8)
    kw = dict(init_loss_scaling=1e38, decr_every_n_nan_or_inf=1)
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jstep = jjit.TrainStep(jnet, JSGD(0.1, parameters=jnet.parameters()),
                           JF.mse_loss, scaler=jsc)
    tstep = TrainStep(tnet, SGD(0.1, parameters=tnet.parameters()),
                      mse_loss, scaler=tsc)
    stats = [b.clone() for b in tnet.buffers()]
    rs = np.random.RandomState(9)
    x = rs.randn(6, 8).astype(np.float32)
    _call(jstep, tstep, x, np.full((6, 4), 1e3, np.float32))
    assert all(torch.equal(a, b) for a, b in zip(stats, tnet.buffers()))
    _assert_same(jnet, tnet, atol=0)
    jsc._scale = tsc._scale = 1024.0
    _call(jstep, tstep, x, rs.randn(6, 4).astype(np.float32))
    assert not torch.equal(stats[0], tnet.bn._mean)
    _assert_same(jnet, tnet)


def test_overflowed_micro_step_keeps_batchnorm_statistics_in_a_window():
    """K = 2 at scale 1e30: the first micro-step is finite and moves the
    running statistics, the second overflows and does not; the window is
    skipped, as in JAX."""
    jnet, tnet = _bn_pair(10)
    kw = dict(init_loss_scaling=1e30, decr_every_n_nan_or_inf=1)
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jstep = jjit.TrainStep(jnet, JSGD(0.1, parameters=jnet.parameters()),
                           JF.mse_loss, accumulate_steps=2, scaler=jsc)
    topt = SGD(0.1, parameters=tnet.parameters())
    tstep = TrainStep(tnet, topt, mse_loss, accumulate_steps=2, scaler=tsc)
    rs = np.random.RandomState(11)
    x1, x2 = (rs.randn(6, 8).astype(np.float32) for _ in range(2))
    w0 = tnet.fc1.weight.detach().clone()
    _call(jstep, tstep, x1, rs.randn(6, 4).astype(np.float32))
    after_first = [b.clone() for b in tnet.buffers()]
    _call(jstep, tstep, x2, np.full((6, 4), 1e20, np.float32))
    assert all(torch.equal(a, b) for a, b in zip(after_first,
                                                 tnet.buffers()))
    assert torch.equal(tnet.fc1.weight, w0) and topt._step_count == 0
    assert tsc.get_scale() == jsc.get_scale() == pytest.approx(0.5e30)
    _assert_same(jnet, tnet)


# ---------------------------------------------------------------------------
# the rest of the surface
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("scaled", [False, True])
def test_with_outputs_returns_the_loss_and_the_outputs(scaled):
    jnet, jopt, tnet, topt = _mlp_pair(13)
    jkw = {"scaler": JScaler(init_loss_scaling=64.0)} if scaled else {}
    tkw = {"scaler": GradScaler(init_loss_scaling=64.0)} if scaled else {}
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss, with_outputs=True, **jkw)
    tstep = TrainStep(tnet, topt, mse_loss, with_outputs=True, **tkw)
    x, y = _micro(14, n=1)[0]
    jl, jout = jstep(_t(x), _t(y))
    tl, tout = tstep(torch.from_numpy(x), torch.from_numpy(y))
    assert not tout.requires_grad and tout.shape == (8, 4)
    np.testing.assert_allclose(float(tl), float(jl._array), atol=1e-6)
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout._array),
                               atol=1e-6)
    _assert_same(jnet, tnet)


def test_model_loss_without_loss_fn_drops_the_trailing_label():
    """loss_fn=None: the model's output is the loss. A trailing positional
    is still split off as the label and never reaches the model, in both
    packages; a model that takes its own labels gets them by passing a
    placeholder last (or `label=`)."""
    seen = {"jax": [], "torch": []}

    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = jnn.Linear(8, 4)

        def forward(self, *args):
            seen["jax"].append(len(args))
            return JF.mse_loss(self.fc(args[0]), args[1])

    class TNet(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.fc = torch.nn.Linear(8, 4)

        def forward(self, *args):
            seen["torch"].append(len(args))
            return mse_loss(self.fc(args[0]), args[1])

    paddle.seed(15)
    jnet, tnet = JNet(), TNet()
    _bridge(jnet, tnet)
    jstep = jjit.TrainStep(jnet, JSGD(0.1, parameters=jnet.parameters()))
    tstep = TrainStep(tnet, SGD(0.1, parameters=tnet.parameters()))
    x, y = _micro(16, n=1)[0]
    placeholder = np.zeros(1, np.float32)
    for _ in range(2):
        jl = float(jstep(_t(x), _t(y), _t(placeholder))._array)
        tl = float(tstep(torch.from_numpy(x), torch.from_numpy(y),
                         torch.from_numpy(placeholder)))
        assert abs(jl - tl) <= 1e-6
    tl3 = float(tstep(torch.from_numpy(x), torch.from_numpy(y),
                      label=torch.from_numpy(placeholder)))
    # JAX runs the forward once, when it traces the step
    assert seen["torch"] == [2, 2, 2] and seen["jax"] == [2]
    assert tl3 < tl
    with pytest.raises(IndexError):
        tstep(torch.from_numpy(x), torch.from_numpy(y))   # y dropped


@pytest.mark.parametrize("kw,call", [
    ({"telemetry": "telemetry"}, None),
    ({"with_outputs": True, "accumulate_steps": 2}, None),
    ({"scaler": "scaler"}, "run_scan"),
    ({"scaler": "scaler"}, "run_repeat"),
    ({"accumulate_steps": 3}, "run_scan"),
    ({"accumulate_steps": 3}, "run_repeat")])
def test_refusals(kw, call):
    _, _, tnet, topt = _mlp_pair(17)
    kw = {k: GradScaler() if v == "scaler" else v for k, v in kw.items()}
    x = torch.zeros(2, 8, 8)
    if "telemetry" in kw:
        # ported (ROADMAP Queue A 11): the step observes instead of
        # refusing, one observation a call, its loss on the gauge
        tel = TrainingTelemetry(registry=MetricsRegistry())
        step = TrainStep(tnet, topt, mse_loss, telemetry=tel)
        loss = step(x[0], torch.ones(8, 4))
        snap = tel.registry.snapshot()
        assert snap["train_steps_total"]["series"][0]["value"] == 1
        assert snap["train_loss"]["series"][0]["value"] == float(loss)
        return
    if call is None:
        with pytest.raises(NotImplementedError):
            TrainStep(tnet, topt, mse_loss, **kw)
        return
    step = TrainStep(tnet, topt, mse_loss, **kw)
    with pytest.raises(NotImplementedError, match=call):
        if call == "run_scan":
            step.run_scan(x, torch.zeros(2, 8, 4))
        else:
            step.run_repeat(x[0], torch.zeros(8, 4), 2)


def test_plain_versions_run_on_the_cpu_and_are_counted():
    """On CPU tensors the merge, finish and unscale wrappers take their
    plain versions, one call a group, and launch nothing."""
    _, _, tnet, topt = _mlp_pair(18)
    wrappers = (gm.grad_merge, gm.grad_finish, gm.grad_unscale)
    before = [(w.launches, w.plain_calls) for w in wrappers]
    merge = TrainStep(tnet, topt, mse_loss, accumulate_steps=2,
                      scaler=GradScaler(8.0))
    for x, y in _micro(19, n=2):
        merge(torch.from_numpy(x), torch.from_numpy(y))
    one = TrainStep(tnet, topt, mse_loss, scaler=GradScaler(8.0))
    one(*map(torch.from_numpy, _micro(20, n=1)[0]))
    assert [(w.launches - a, w.plain_calls - b)
            for w, (a, b) in zip(wrappers, before)] == [(0, 2), (0, 1),
                                                        (0, 1)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("first", [True, False])
def test_grad_merge_plain_versions_match_the_jax_ops(dtype, first):
    """K1 and K2's plain versions against the JAX programs' ops, jitted:
    the merge `b + g.astype(f32)` (from a zero buffer at a window's first
    micro-step), the flag, `(b / scale / K)` (XLA folds the divide by K
    into a multiply by its reciprocal; K = 3 shows it) and the unscale
    `(g.astype(f32) / scale)`: the same bits, -0 included. (No subnormal
    input: XLA on the CPU flushes them to zero, the card does not.)"""
    import jax

    rs = np.random.RandomState(21)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    g = rs.randn(257).astype(np.float32)
    g[:3] = [-0.0, 3e38, -1e-30]
    b = rs.randn(257).astype(np.float32)
    jg = jnp.asarray(g, jdt)
    jb = jnp.zeros(257, jnp.float32) if first else jnp.asarray(b)
    tg = torch.from_numpy(np.array(jg.astype(jnp.float32))).to(dtype)
    tb = torch.from_numpy(np.asarray(jb).copy())
    flag = torch.zeros(1, dtype=torch.int32)
    gm.grad_merge_plain([tg], [tb], first, [flag])
    want = jax.jit(lambda b, g: b + g.astype(jnp.float32))(jb, jg)
    assert torch.equal(tb.view(torch.int32),
                       torch.from_numpy(np.asarray(want).view(np.int32)))
    assert int(flag) == 0
    scale = np.float32(3.0e4)
    out = torch.empty_like(tg)
    gm.grad_finish_plain([out], [tb], float(scale), 3)
    want = jax.jit(lambda b, s: (b / s / 3).astype(jdt))(want, scale)
    np.testing.assert_array_equal(out.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    gm.grad_unscale_plain([tg], float(scale), flag)
    want = jax.jit(lambda g, s: (g.astype(jnp.float32) / s).astype(jdt))(
        jg, scale)
    np.testing.assert_array_equal(tg.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))
    assert int(flag) == 0
    gm.grad_unscale_plain([torch.tensor([1.0, float("inf")]).to(dtype)],
                          1.0, flag)
    assert int(flag) == 1


# ---------------------------------------------------------------------------
# the eager GradScaler
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_eager_scale_and_unscale_match_jax_bit_for_bit(dtype):
    """scale() multiplies by the scale and unscale_ by 1 / scale, both
    Python floats that JAX weakly types: against a bf16 tensor they round
    to bf16 first (scale 3.0: 1/3 is not a bf16 value). The port's bits
    equal JAX's, and the finiteness test follows the multiply."""
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    rs = np.random.RandomState(22)
    g = np.asarray(jnp.asarray(rs.randn(64, 3) * 50, jdt).astype(
        jnp.float32))
    jp = paddle.to_tensor(g).astype(jdt)
    jp.grad = paddle.to_tensor(g).astype(jdt)
    tp = torch.nn.Parameter(torch.from_numpy(g).to(dtype))
    tp.grad = torch.from_numpy(g).to(dtype)
    jsc, tsc = JScaler(init_loss_scaling=3.0), GradScaler(
        init_loss_scaling=3.0)
    jopt, topt = JSGD(0.1, parameters=[jp]), SGD(0.1, parameters=[tp])
    jsc.unscale_(jopt)
    tsc.unscale_(topt)
    np.testing.assert_array_equal(
        tp.grad.float().numpy(),
        np.asarray(jp.grad._array.astype(jnp.float32)))
    assert tp.grad.dtype == dtype and not tsc._found_inf
    loss = np.asarray(jnp.asarray([1.7], jdt).astype(jnp.float32))
    jl = jsc.scale(paddle.to_tensor(loss).astype(jdt))
    tl = tsc.scale(torch.from_numpy(loss).to(dtype))
    np.testing.assert_array_equal(tl.float().numpy(),
                                  np.asarray(jl._array.astype(jnp.float32)))
    # once per step: a second unscale_ before update() does nothing
    before = tp.grad.clone()
    tsc.unscale_(topt)
    assert torch.equal(tp.grad, before)


def test_eager_step_skips_on_overflow_and_updates_the_scale_like_jax():
    """step(): unscale, skip the update when a grad is not finite, then
    update(); growth every incr_every_n_steps good steps and backoff every
    decr_every_n_nan_or_inf bad ones (not below 1.0), over a sequence of
    steps, state for state with JAX's scaler."""
    kw = dict(init_loss_scaling=16.0, incr_ratio=2.0, decr_ratio=0.25,
              incr_every_n_steps=2, decr_every_n_nan_or_inf=2)
    jsc, tsc = JScaler(**kw), GradScaler(**kw)
    jp = paddle.to_tensor(np.ones(3, np.float32))
    tp = torch.nn.Parameter(torch.ones(3))
    jopt, topt = JSGD(0.5, parameters=[jp]), SGD(0.5, parameters=[tp])
    pattern = [0, 0, 1, 0, 1, 1, 1, 1, 1, 1, 0, 0, 0]
    for bad in pattern:
        g = np.array([np.inf if bad else 2.0, 1.0, -1.0], np.float32)
        jp.grad = paddle.to_tensor(g)
        tp.grad = torch.from_numpy(g.copy())
        jsc.step(jopt)
        tsc.step(topt)
        assert tsc.state_dict() == jsc.state_dict()
        jopt.clear_grad()
        topt.clear_grad()
    assert topt._step_count == jopt._step_count == pattern.count(0)
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp._array),
                               rtol=1e-6)
    assert tsc.get_scale() == 1.0 * 2.0        # floored at 1, then grown


def test_eager_scaler_surface():
    """minimize is step; state_dict round trip; a disabled scaler passes
    the loss through and steps without unscaling."""
    tsc = GradScaler(init_loss_scaling=8.0)
    tp = torch.nn.Parameter(torch.ones(2))
    topt = SGD(1.0, parameters=[tp])
    tp.grad = torch.full((2,), 8.0)
    loss = torch.tensor(2.0)
    assert torch.equal(tsc.scale(loss), torch.tensor(16.0))
    tsc.minimize(topt, loss)
    assert torch.equal(tp.detach(), torch.zeros(2))
    state = tsc.state_dict()
    assert state == {"scale": 8.0, "good_steps": 1, "bad_steps": 0}
    twin = GradScaler()
    twin.load_state_dict(state)
    assert twin.state_dict() == state and twin.is_enable()
    off = GradScaler(enable=False)
    assert off.scale(loss) is loss and not off.is_enable()
    tp.grad = torch.full((2,), 8.0)
    off.step(topt)
    assert torch.equal(tp.detach(), torch.full((2,), -8.0))
