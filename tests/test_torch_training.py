"""The training slice of the PyTorch port against the JAX package, on the CPU.

Same seeded numpy inputs to both packages, fp32 unless stated:
- the losses (`cross_entropy`, `softmax_with_cross_entropy`) within 1e-6;
- one and two Adam / AdamW updates against JAX's `_single_update` (fp32
  within 1e-6 relative; bf16 parameters within one bf16 ulp, since the two
  may round a value that lies on a half-ulp differently after fp32 sums in
  another order);
- every LR scheduler over 20 steps (identical Python, so exactly equal);
- the three gradient clips within 1e-6 relative (bf16 grads within one
  bf16 ulp);
- dropout statistically (it draws from a torch.Generator, JAX from its own
  keys, so the masks cannot be compared);
- the slice as a whole: a tiny GPT through the weight bridge, whose
  per-parameter gradients after one backward match JAX's within 1e-5, and
  whose losses over five `TrainStep` calls with AdamW and a global-norm
  clip match JAX's compiled `jit.TrainStep` within 1e-5.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import GPTConfig as JConfig
from paddle_tpu.models import GPTForCausalLM as JGPT
from paddle_tpu.nn import clip as jclip
from paddle_tpu.optimizer import Adam as JAdam
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import lr as jlr
from paddle_tpu_torch import (Adam, AdamW, ClipGradByGlobalNorm, Momentum,
                              ClipGradByNorm, ClipGradByValue, GPTConfig,
                              GPTForCausalLM, TrainStep,
                              load_paddle_tpu_state)
from paddle_tpu_torch.amp import GradScaler
from paddle_tpu_torch.observability import MetricsRegistry, TrainingTelemetry
from paddle_tpu_torch.models.convert import _linear_weights
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.nn_ops import (cross_entropy, dropout, mse_loss,
                                         softmax_with_cross_entropy)
from paddle_tpu_torch.optimizer import lr as tlr

VOCAB = 61


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("reduction", ["none", "sum", "mean"])
def test_cross_entropy_matches_jax(reduction):
    rng = np.random.RandomState(0)
    logits = (3 * rng.randn(2, 7, 11)).astype(np.float32)
    labels = rng.randint(0, 11, (2, 7, 1)).astype(np.int64)
    labels[0, 2, 0] = labels[1, 5, 0] = -100
    want = JF.cross_entropy(Tensor._wrap(jnp.asarray(logits)),
                            Tensor._wrap(jnp.asarray(labels)),
                            reduction=reduction)
    got = cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                        reduction=reduction)
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                               atol=1e-6, rtol=0)
    # the mean is over the 12 labels that are not ignored
    if reduction == "mean":
        per = cross_entropy(torch.from_numpy(logits),
                            torch.from_numpy(labels), reduction="none")
        assert float(per[0, 2]) == 0.0
        assert math.isclose(float(got), float(per.sum()) / 12, rel_tol=1e-6)


def test_softmax_with_cross_entropy_matches_jax_and_refuses_the_rest():
    rng = np.random.RandomState(1)
    logits = rng.randn(5, 9).astype(np.float32)
    labels = np.array([3, -100, 0, 8, 7])
    want = JF.softmax_with_cross_entropy(Tensor._wrap(jnp.asarray(logits)),
                                         labels)
    got = softmax_with_cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels))
    assert tuple(got.shape) == (5, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                               atol=1e-6, rtol=0)
    x, y = torch.from_numpy(logits), torch.from_numpy(labels)
    soft = np.full((5, 9), 1 / 9, np.float32)
    for kw, lab in (({"soft_label": True}, soft),
                    ({"weight": np.ones(9, np.float32)}, labels),
                    ({"label_smoothing": 0.1}, labels),
                    ({"use_softmax": False}, labels)):
        want = JF.cross_entropy(Tensor._wrap(jnp.asarray(logits)), lab,
                                **kw)
        got = cross_entropy(x, torch.from_numpy(lab), **{
            k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
            for k, v in kw.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                                   atol=1e-6, rtol=1e-6)
    got = softmax_with_cross_entropy(x, torch.from_numpy(soft),
                                     soft_label=True)
    want = JF.softmax_with_cross_entropy(Tensor._wrap(jnp.asarray(logits)),
                                         Tensor._wrap(jnp.asarray(soft)),
                                         soft_label=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                               atol=1e-6, rtol=0)
    with pytest.raises(ValueError, match="soft_label"):
        cross_entropy(x, torch.from_numpy(soft), soft_label=True,
                      weight=torch.ones(9))
    with pytest.raises(ValueError, match="reduction"):
        cross_entropy(x, y, reduction="max")


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------
def _opt_case(dtype, seed):
    """Two parameters (a weight and a bias) and two steps of grads."""
    rng = np.random.RandomState(seed)
    shapes = {"fc.weight": (6, 5), "fc.bias": (5,)}
    params = {n: (0.05 * rng.randn(*s)).astype(np.float32)
              for n, s in shapes.items()}
    grads = [{n: rng.randn(*s).astype(np.float32) for n, s in shapes.items()}
             for _ in range(2)]
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    # round the inputs to the working dtype once, on the numpy side
    params = {n: np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
              for n, a in params.items()}
    grads = [{n: np.asarray(jnp.asarray(a, jdt).astype(jnp.float32))
              for n, a in g.items()} for g in grads]
    return params, grads, jdt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_adam_and_adamw_updates_match_jax_single_update(dtype, kind):
    """Two steps (bias correction at t = 1 and 2); AdamW with a decay mask
    that spares the bias, Adam with an L2 weight decay. Moments stay fp32
    and the parameter is rounded back to its own dtype every step."""
    params, grads, jdt = _opt_case(dtype, seed=3 if kind == "adam" else 4)
    lr_, wd = 1e-2, 0.05
    names = list(params)
    tparams = {n: torch.nn.Parameter(torch.from_numpy(a).to(dtype))
               for n, a in params.items()}
    if kind == "adam":
        jopt = JAdam(learning_rate=lr_, parameters=[], weight_decay=wd)
        topt = Adam(learning_rate=lr_, parameters=list(tparams.values()),
                    weight_decay=wd)
        extras = {n: None for n in names}
    else:
        jopt = JAdamW(learning_rate=lr_, parameters=[], weight_decay=wd)
        topt = AdamW(learning_rate=lr_, parameters=list(tparams.items()),
                     weight_decay=wd,
                     apply_decay_param_fun=lambda n: not n.endswith("bias"))
        extras = {n: {"decay": jnp.asarray(0.0 if n.endswith("bias")
                                           else wd, jnp.float32)}
                  for n in names}
    jp = {n: jnp.asarray(a, jdt) for n, a in params.items()}
    jacc = {n: {"moment1": jnp.zeros(a.shape, jnp.float32),
                "moment2": jnp.zeros(a.shape, jnp.float32)}
            for n, a in params.items()}
    for step, g in enumerate(grads):
        for n in names:
            jp[n], jacc[n] = jopt._single_update(
                jp[n], jnp.asarray(g[n], jdt), jacc[n],
                jnp.asarray(lr_, jnp.float32), jnp.asarray(step, jnp.int32),
                extras=extras[n])
            tparams[n].grad = torch.from_numpy(g[n]).to(dtype)
        topt.step()
        assert topt._step_count == step + 1
        for i, n in enumerate(names):
            got = tparams[n].detach()
            assert got.dtype == dtype
            want = np.asarray(jp[n].astype(jnp.float32))
            if dtype == torch.float32:
                np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                           atol=1e-8)
            else:
                np.testing.assert_allclose(got.float().numpy(), want,
                                           rtol=2 ** -7, atol=0)
            for k in ("moment1", "moment2"):
                acc = topt._accumulators[k][i]
                assert acc.dtype == torch.float32
                np.testing.assert_allclose(acc.numpy(),
                                           np.asarray(jacc[n][k]),
                                           rtol=1e-6, atol=1e-9)


def test_optimizer_surface():
    """get_lr/set_lr, a scheduler is called and never stepped, clear_grad,
    a parameter without a grad is left alone, state_dict round trip."""
    p = torch.nn.Parameter(torch.ones(3))
    q = torch.nn.Parameter(torch.ones(2))
    sched = tlr.StepDecay(0.1, step_size=2)
    opt = AdamW(learning_rate=sched, parameters=[p, q])
    assert opt.get_lr() == 0.1
    with pytest.raises(RuntimeError):
        opt.set_lr(0.5)
    p.grad = torch.full((3,), 0.5)
    opt.step()
    assert sched.last_epoch == 0 and opt._step_count == 1
    assert torch.equal(q.detach(), torch.ones(2))
    assert not torch.equal(p.detach(), torch.ones(3))
    opt.clear_grad()
    assert p.grad is None
    state = {k: (v.clone() if torch.is_tensor(v) else v)
             for k, v in opt.state_dict().items()}
    fresh = AdamW(learning_rate=tlr.StepDecay(0.1, step_size=2),
                  parameters=[p, q])
    fresh.set_state_dict(state)
    assert fresh._step_count == 1
    assert torch.equal(fresh._accumulators["moment1"][0],
                       opt._accumulators["moment1"][0])
    plain = Adam(learning_rate=0.1, parameters=[p])
    plain.set_lr(0.2)
    assert plain.get_lr() == 0.2
    with pytest.raises(ValueError, match="parameters"):
        Adam()


@pytest.mark.parametrize("make", [
    lambda ps: AdamW(1e-2, parameters=ps, weight_decay=0.05),
    lambda ps: Momentum(0.1, 0.9, parameters=ps, use_nesterov=True,
                        weight_decay=0.01)], ids=["adamw", "momentum"])
def test_optimizer_accumulators_follow_the_parameter_layout(make):
    """A channels_last weight and a transposed matrix get accumulators in
    their own layout, and two steps leave the same values as on the same
    parameters laid out contiguously."""
    rng = np.random.default_rng(6)
    w, t = (rng.standard_normal(s).astype(np.float32)
            for s in ((4, 3, 3, 3), (5, 6)))
    laid = [torch.from_numpy(w).to(memory_format=torch.channels_last),
            torch.from_numpy(t).t()]
    flat = [torch.from_numpy(w), torch.from_numpy(t.T.copy())]
    opts = [make(ps) for ps in (laid, flat)]
    for step in range(2):
        for ps in (laid, flat):
            for p, s in zip(ps, (w, t.T)):
                p.grad = torch.from_numpy(
                    np.ascontiguousarray(s) * (step + 1.5))
        for opt in opts:
            opt.step()
    for a, b in zip(laid, flat):
        assert torch.equal(a, b)
    for name, lst in opts[0]._accumulators.items():
        for a, p, b in zip(lst, laid, opts[1]._accumulators[name]):
            assert a.stride() == p.stride() and torch.equal(a, b), name


# ---------------------------------------------------------------------------
# LR schedulers
# ---------------------------------------------------------------------------
SCHEDULERS = {
    "NoamDecay": lambda m: m.NoamDecay(64, 5, learning_rate=2.0),
    "PiecewiseDecay": lambda m: m.PiecewiseDecay([3, 8], [0.3, 0.2, 0.1]),
    "NaturalExpDecay": lambda m: m.NaturalExpDecay(0.5, 0.1),
    "ExponentialDecay": lambda m: m.ExponentialDecay(0.5, 0.9),
    "InverseTimeDecay": lambda m: m.InverseTimeDecay(0.5, 0.2),
    "PolynomialDecay": lambda m: m.PolynomialDecay(0.5, 7, cycle=True),
    "LinearWarmup": lambda m: m.LinearWarmup(m.CosineAnnealingDecay(0.4, 9),
                                             4, 0.0, 0.4),
    "CosineAnnealingDecay": lambda m: m.CosineAnnealingDecay(0.5, 6, 0.01),
    "StepDecay": lambda m: m.StepDecay(0.5, 3),
    "MultiStepDecay": lambda m: m.MultiStepDecay(0.5, [2, 5, 11]),
    "LambdaDecay": lambda m: m.LambdaDecay(0.5, lambda e: 0.95 ** e),
    "OneCycleLR": lambda m: m.OneCycleLR(0.3, 20),
}


@pytest.mark.parametrize("name", sorted(SCHEDULERS))
def test_lr_scheduler_matches_jax_over_20_steps(name):
    j, t = SCHEDULERS[name](jlr), SCHEDULERS[name](tlr)
    want, got = [], []
    for _ in range(20):
        want.append(j())
        got.append(t())
        j.step()
        t.step()
    assert got == want
    assert t.state_dict() == j.state_dict()


def test_reduce_on_plateau_matches_jax():
    metrics = [5.0, 4.0, 4.0, 4.1, 4.0, 3.9999, 4.2, 4.3, 1.0, 1.0, 1.0,
               1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
    j = jlr.ReduceOnPlateau(0.5, patience=2, cooldown=1)
    t = tlr.ReduceOnPlateau(0.5, patience=2, cooldown=1)
    for m in metrics:
        j.step(m)
        t.step(m)
        assert t() == j()
    assert t() < 0.5


# ---------------------------------------------------------------------------
# gradient clipping
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["value", "norm", "global_norm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grad_clips_match_jax(kind, dtype):
    rng = np.random.RandomState(5)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    grads = [rng.randn(4, 3).astype(np.float32), None,
             (0.01 * rng.randn(7)).astype(np.float32),
             (3 * rng.randn(2, 2)).astype(np.float32)]
    jg = [None if g is None else jnp.asarray(g, jdt) for g in grads]
    tg = [None if g is None else torch.from_numpy(g).to(dtype)
          for g in grads]
    jmake, tmake, args = {
        "value": (jclip.ClipGradByValue, ClipGradByValue, (0.8, -0.5)),
        "norm": (jclip.ClipGradByNorm, ClipGradByNorm, (1.5,)),
        "global_norm": (jclip.ClipGradByGlobalNorm, ClipGradByGlobalNorm,
                        (2.0,))}[kind]
    want = jmake(*args)._clip_arrays(jg)
    params = [torch.zeros(1) for _ in tg]
    got = tmake(*args)(list(zip(params, tg)))
    assert [p for p, _ in got] == params
    tol = 1e-6 if dtype == torch.float32 else 2 ** -7
    for (_, g), w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert g.dtype == dtype
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(w.astype(jnp.float32)),
                                   rtol=tol, atol=0)


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropout_keeps_a_binomial_share_and_scales_exactly(dtype):
    n, p = 200_000, 0.3
    x = torch.full((n,), 3.0, dtype=dtype)
    g = torch.Generator().manual_seed(11)
    state = g.get_state()
    a = dropout(x, p, training=True, generator=g)
    assert a.dtype == dtype
    kept = a != 0
    # keep share within 5 standard deviations of Binomial(n, 0.7)
    sd = math.sqrt(n * p * (1 - p))
    assert abs(int(kept.sum()) - n * (1 - p)) < 5 * sd
    assert torch.equal(a[kept], (x / (1 - p))[kept])
    g2 = torch.Generator().manual_seed(11)
    assert torch.equal(dropout(x, p, generator=g2), a)   # same seed
    b = dropout(x, p, generator=g)                       # next draw
    assert not torch.equal(b != 0, kept)
    g.set_state(state)
    assert torch.equal(dropout(x, p, generator=g), a)
    assert dropout(x, p, training=False) is x
    assert dropout(x, 0.0, generator=g) is x
    with pytest.raises(ValueError, match="generator"):
        dropout(x, p)


def test_gpt_dropout_draws_from_the_model_generator():
    """Training mode with dropout: the same generator state gives the same
    loss, the next draw another; eval mode is deterministic and equals the
    dropout-free model."""
    cfg = GPTConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=2, seq=64)
    cfg.dropout = 0.2
    model = GPTForCausalLM(cfg, device="cpu").train()
    ids = torch.from_numpy(np.random.RandomState(0).randint(
        0, VOCAB, (2, 9)))
    gen = model.gpt.dropout_generator
    state = gen.get_state()
    a = model(ids, labels=ids)
    b = model(ids, labels=ids)
    gen.set_state(state)
    assert float(model(ids, labels=ids)) == float(a)
    assert float(a) != float(b)
    model.eval()
    with torch.no_grad():
        e = model(ids, labels=ids)
        cfg0 = GPTConfig.tiny(vocab=VOCAB, hidden=32, layers=2, heads=2,
                              seq=64)
        ref = GPTForCausalLM(cfg0, device="cpu").eval()
        assert float(ref(ids, labels=ids)) == float(e)


# ---------------------------------------------------------------------------
# the slice as a whole
# ---------------------------------------------------------------------------
def _pair(seed=0, hidden=32):
    paddle.seed(seed)
    kw = dict(vocab=VOCAB, hidden=hidden, layers=2, heads=2, seq=64)
    jm = JGPT(JConfig.tiny(**kw))
    arrays = {k: np.asarray(v._array) for k, v in jm.state_dict().items()}
    tm = GPTForCausalLM(GPTConfig.tiny(**kw), device="cpu")
    load_paddle_tpu_state(tm, arrays)
    return jm, tm


def test_tiny_gpt_gradients_match_jax():
    """One forward with labels and one backward: the loss within 1e-6 and
    every parameter's gradient within 1e-5 (Linear grads transposed:
    paddle keeps Linear weights [in, out], torch [out, in]); the backward
    went through the causal backward's wrapper once per layer (hidden 128
    and 2 heads: head dim 64, a causal kernel shape; narrower heads are
    dense, as in JAX)."""
    jm, tm = _pair(hidden=128)
    ids = np.random.RandomState(3).randint(0, VOCAB, (2, 16)).astype(
        np.int32)
    jloss = jm(Tensor._wrap(ids), labels=Tensor._wrap(ids))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._array) for n, p in jm.named_parameters()}
    bwd = tfa.causal_attention_bwd.plain_calls
    tloss = tm(torch.from_numpy(ids).long(), labels=torch.from_numpy(ids))
    tloss.backward()
    assert tfa.causal_attention_bwd.plain_calls == bwd + 2
    np.testing.assert_allclose(float(tloss), float(jloss._array), atol=1e-6,
                               rtol=0)
    linear = _linear_weights(tm)
    tparams = dict(tm.named_parameters())
    assert set(tparams) == set(jgrads)
    for name, p in tparams.items():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if name in linear else g,
                                   jgrads[name], atol=1e-5, rtol=0,
                                   err_msg=name)


def test_tiny_gpt_trainstep_losses_match_jax_trainstep():
    """Five steps of AdamW (decay 0.01, global-norm clip 1.0) on distinct
    batches through the port's TrainStep and JAX's compiled jit.TrainStep,
    labels unshifted as bench.py feeds them: the per-step losses within
    1e-5, falling."""
    jm, tm = _pair(seed=1)
    rng = np.random.RandomState(7)
    batches = rng.randint(0, VOCAB, (5, 2, 16)).astype(np.int32)
    jopt = JAdamW(learning_rate=1e-2, parameters=jm.parameters(),
                  grad_clip=jclip.ClipGradByGlobalNorm(1.0))
    jstep = jjit.TrainStep(jm, jopt, jm.loss_fn)
    want = [float(jstep(Tensor._wrap(b), Tensor._wrap(b))._array)
            for b in batches]
    topt = AdamW(learning_rate=1e-2, parameters=tm.parameters(),
                 grad_clip=ClipGradByGlobalNorm(1.0))
    tstep = TrainStep(tm, topt, tm.loss_fn)
    got = [float(tstep(torch.from_numpy(b).long(),
                       label=torch.from_numpy(b).long()))
           for b in batches]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert got[-1] < got[0]
    assert topt._step_count == 5
    assert all(p.grad is None for p in tm.parameters())


def test_trainstep_loops_and_refusals():
    """run_scan and run_repeat are loops over the step (a run_scan over two
    batches equals two calls on a twin model); a telemetry step observes
    each call without moving the update (its losses and parameters are
    bitwise the twin's) and the loops record nothing, as JAX's compiled
    loops do; as in the JAX package, with_outputs with gradient merge and
    the loops with a scaler or gradient merge raise."""
    _, a = _pair(seed=2)
    _, b = _pair(seed=2)
    xs = torch.from_numpy(np.random.RandomState(8).randint(
        0, VOCAB, (2, 2, 12)))
    sa = TrainStep(a, AdamW(1e-2, parameters=a.parameters()), a.loss_fn)
    sb = TrainStep(b, AdamW(1e-2, parameters=b.parameters()), b.loss_fn)
    scan = sa.run_scan(xs, xs)
    assert scan.shape == (2,)
    torch.testing.assert_close(scan, torch.stack([sb(xs[0], xs[0]),
                                                  sb(xs[1], xs[1])]),
                               rtol=0, atol=0)
    rep = sa.run_repeat(xs[0], xs[0], 3)
    assert rep.shape == (3,) and float(rep[-1]) < float(rep[0])
    tel = TrainingTelemetry(registry=MetricsRegistry())
    _, c = _pair(seed=2)
    sc = TrainStep(c, AdamW(1e-2, parameters=c.parameters()), c.loss_fn,
                   telemetry=tel)
    _, b2 = _pair(seed=2)
    sd = TrainStep(b2, AdamW(1e-2, parameters=b2.parameters()), b2.loss_fn)
    for x in xs:
        assert torch.equal(sc(x, x), sd(x, x))
    for p, q in zip(c.parameters(), b2.parameters()):
        assert torch.equal(p, q)
    sc.run_repeat(xs[0], xs[0], 2)
    assert tel.registry.snapshot()["train_steps_total"]["series"][0][
        "value"] == 2
    with pytest.raises(NotImplementedError):
        TrainStep(a, sa.optimizer, a.loss_fn, with_outputs=True,
                  accumulate_steps=2)
    for kw in ({"scaler": GradScaler()}, {"accumulate_steps": 2}):
        step = TrainStep(a, sa.optimizer, a.loss_fn, **kw)
        with pytest.raises(NotImplementedError, match="run_scan"):
            step.run_scan(xs, xs)
        with pytest.raises(NotImplementedError, match="run_repeat"):
            step.run_repeat(xs[0], xs[0], 2)


class _JTwoHeads(paddle.nn.Layer):
    """Two Linears; the loss reaches only the first."""

    def __init__(self):
        super().__init__()
        self.used = paddle.nn.Linear(6, 3)
        self.unused = paddle.nn.Linear(6, 3)

    def forward(self, x):
        return self.used(x)


class _TwoHeads(torch.nn.Module):
    def __init__(self, jm):
        super().__init__()
        self.used = torch.nn.Linear(6, 3)
        self.unused = torch.nn.Linear(6, 3)
        with torch.no_grad():
            for name, p in self.named_parameters():
                a = np.asarray(dict(jm.named_parameters())[name]._array)
                p.copy_(torch.from_numpy(a.T.copy() if a.ndim == 2 else a))

    def forward(self, x):
        return self.used(x)


@pytest.mark.parametrize("kind", ["adamw", "adam_l2", "momentum_l2"])
def test_trainstep_updates_a_parameter_the_loss_does_not_reach(kind):
    """JAX's compiled step traces every trainable parameter the optimizer
    holds and gives one the loss does not reach a zero grad, so decay and
    momentum still move it; the port's TrainStep does the same. Three
    steps at lr 0.1: every parameter, reached or not, within 1e-6 of JAX's
    jit.TrainStep, and the unreached weight moved. The eager step() still
    skips a parameter without a grad (test_optimizer_surface)."""
    from paddle_tpu.optimizer import Momentum as JMomentum

    paddle.seed(21)
    jm = _JTwoHeads()
    tm = _TwoHeads(jm)
    rng = np.random.RandomState(9)
    xs = rng.randn(3, 4, 6).astype(np.float32)
    ys = rng.randn(3, 4, 3).astype(np.float32)
    make = {"adamw": lambda m, ps: m.AdamW(0.1, parameters=ps),
            "adam_l2": lambda m, ps: m.Adam(0.1, parameters=ps,
                                            weight_decay=0.01),
            "momentum_l2": lambda m, ps: m.Momentum(
                0.1, 0.9, parameters=ps, weight_decay=0.01)}[kind]

    class J:
        AdamW, Adam, Momentum = JAdamW, JAdam, JMomentum

    class T:
        AdamW, Adam, Momentum = AdamW, Adam, Momentum

    jstep = jjit.TrainStep(jm, make(J, jm.parameters()), JF.mse_loss)
    tstep = TrainStep(tm, make(T, tm.parameters()), mse_loss)
    before = tm.unused.weight.detach().clone()
    for x, y in zip(xs, ys):
        jstep(Tensor._wrap(jnp.asarray(x)), Tensor._wrap(jnp.asarray(y)))
        tstep(torch.from_numpy(x), torch.from_numpy(y))
    assert tstep.optimizer._step_count == 3
    moved = (tm.unused.weight.detach() - before).abs().max().item()
    assert moved > 1e-4
    for name, p in jm.named_parameters():
        a = np.asarray(p._array)
        got = dict(tm.named_parameters())[name].detach().numpy()
        np.testing.assert_allclose(got.T if a.ndim == 2 else got, a,
                                   atol=1e-6, rtol=0, err_msg=name)


def test_num_params_and_flops_per_token_match_jax():
    jm, tm = _pair()
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(16) == jm.flops_per_token(16)
    assert tm.flops_per_token() == jm.flops_per_token()
