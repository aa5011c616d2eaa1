"""The paddle Tensor methods of the port against the JAX package's
(`paddle_tpu/ops/__init__.py`), and the rules that keep paddle's
meanings out of torch's code and the port's own, on the CPU.

- The dunders on tensors and Python scalars, both sides, and every method
  of the op schema's `tensor_method: true` set called as a method on its
  op case's first argument: values within 1e-6 of the largest of JAX's
  (1e-5 for the cases `tools/paddle_op_cases.py` marks loose), dtypes
  and shapes equal.
- The names torch means otherwise (`transpose`, `split`, `gather`,
  `where`, `numel`, `max`, ...) take paddle's meaning on a `Tensor`, and
  torch's own functions given a `Tensor` keep torch's (they get plain
  views); `Parameter`s stay hashable, so modules list them once.
- `setitem` records the overwrite as JAX does: gradients on a leaf that
  does not require grad and on a non-leaf within 1e-6 of JAX's; a leaf
  that requires grad raises JAX's RuntimeError.
- Given paddle `Parameter`s and `Tensor` inputs, the port's AdamW and
  Momentum (with `ClipGradByGlobalNorm`), `GradScaler`, `TrainStep` over
  `GPTConfig.tiny()`, and the GPT, BERT, ResNet and Transformer forwards
  give the plain tensors' results bit for bit.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu_torch.core.tensor import Parameter, Tensor
from paddle_tpu_torch.ops import registry

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
from paddle_op_cases import PADDLE_OP_CASES, paddle_op_args  # noqa: E402
from _paddle_state import paddle_state  # noqa: E402,F401


def _np(t):
    if isinstance(t, (bool, int, float, np.ndarray)):
        return np.asarray(t)
    return np.asarray(t.numpy())


def _close(t, j, tol=1e-6):
    t, j = _np(t), _np(j)
    assert t.shape == j.shape
    if j.dtype.kind in "biu":
        np.testing.assert_array_equal(t, j)
        return
    scale = float(np.nanmax(np.abs(j))) if j.size and np.isfinite(
        j).any() else 1.0
    np.testing.assert_allclose(t, j, rtol=tol, atol=tol * max(scale, 1e-30),
                               equal_nan=True)


def _pair(pkg):
    rng = np.random.RandomState(5)
    return (pkg.to_tensor(rng.randn(3, 4).astype(np.float32)),
            pkg.to_tensor((rng.rand(3, 4) + 0.5).astype(np.float32)))


DUNDERS = [lambda a, b: a + b, lambda a, b: a - b, lambda a, b: a * b,
           lambda a, b: a / b, lambda a, b: a // b, lambda a, b: a % b,
           lambda a, b: b ** a, lambda a, b: a @ b.T, lambda a, b: -a,
           lambda a, b: abs(a), lambda a, b: ~(a > b), lambda a, b: a == b,
           lambda a, b: a != b, lambda a, b: a < b, lambda a, b: a <= b,
           lambda a, b: a > b, lambda a, b: a >= b,
           lambda a, b: (a > 0) & (b > 1), lambda a, b: (a > 0) | (b > 1),
           lambda a, b: (a > 0) ^ (b > 1), lambda a, b: 2.0 + a,
           lambda a, b: 2.0 - a, lambda a, b: 3.0 * a, lambda a, b: 1.0 / b,
           lambda a, b: 2.0 ** a, lambda a, b: a[1:, ::2],
           lambda a, b: a[1], lambda a, b: a.T]


@pytest.mark.parametrize("k", range(len(DUNDERS)))
def test_dunders_match_jax(k):
    fn = DUNDERS[k]
    t, j = fn(*_pair(tp)), fn(*_pair(jp))
    assert isinstance(t, Tensor)
    _close(t, j)


METHOD_OPS = sorted(e["op"] for e in registry.all_ops()
                    if e["tensor_method"] and e["op"] in PADDLE_OP_CASES
                    and PADDLE_OP_CASES[e["op"]].args
                    and isinstance(PADDLE_OP_CASES[e["op"]].args[0], tuple)
                    and PADDLE_OP_CASES[e["op"]].args[0][0] != "L"
                    and not PADDLE_OP_CASES[e["op"]].rand
                    and PADDLE_OP_CASES[e["op"]].check is None)


def _method_out(pkg, name):
    args = [pkg.to_tensor(np.array(v)) if kind == "t" else v
            for kind, v in paddle_op_args(name)]
    out = getattr(args[0], name)(*args[1:], **PADDLE_OP_CASES[name].kw)
    return out if isinstance(out, (list, tuple)) else [out]


def test_methods_match_jax():
    assert len(METHOD_OPS) > 100
    for name in METHOD_OPS:
        tol = max(PADDLE_OP_CASES[name].tol, 1e-6)
        touts, jouts = _method_out(tp, name), _method_out(jp, name)
        assert len(touts) == len(jouts), name
        for t, j in zip(touts, jouts):
            if isinstance(j, jp.Tensor):
                assert isinstance(t, Tensor), name
            _close(t, j, tol)


def test_colliding_names_take_paddle_meaning_and_torch_keeps_its_own():
    x = tp.to_tensor(np.arange(24, dtype=np.float32).reshape(2, 3, 4))
    assert list(x.transpose([2, 0, 1]).shape) == [4, 2, 3]
    assert [list(s.shape) for s in x.split(2, axis=2)] == [[2, 3, 2]] * 2
    assert list(x.gather(tp.to_tensor([0, 2]), axis=1).shape) == [2, 2, 4]
    assert isinstance(x.numel(), Tensor) and int(x.numel()) == 24
    assert list(x.max(axis=1).shape) == [2, 4]
    assert list(x.sort(axis=0).shape) == [2, 3, 4]
    assert list(x.expand([3, 2, 3, 4]).shape) == [3, 2, 3, 4]
    c = x > 5
    assert np.array_equal(c.where(x, -x).numpy(),
                          np.where(c.numpy(), x.numpy(), -x.numpy()))
    assert isinstance(x.equal(x), Tensor) and bool(x.equal(x).all())
    # torch's own functions get plain views: torch's meanings
    assert [s.shape[2] for s in torch.split(x, 3, dim=2)] == [3, 1]
    assert torch.transpose(x, 0, 1).shape == (3, 2, 4)
    assert torch.max(x, 1).values.shape == (2, 4)
    assert isinstance(torch.relu(x), Tensor)
    assert repr(x).startswith("Tensor(")
    y = torch.nn.functional.multi_head_attention_forward(
        *[x[0].reshape([3, 1, 4])] * 3,
        4, 1, torch.ones(12, 4), torch.zeros(12), None, None, False, 0.0,
        torch.eye(4), torch.zeros(4), training=False)[0]
    assert y.shape == (3, 1, 4)
    p, q = Parameter(np.ones(3, np.float32)), Parameter(np.ones(3,
                                                                np.float32))
    assert len({p, q, p}) == 2
    m = torch.nn.Module()
    m.a, m.b = p, q
    assert [n for n, _ in m.named_parameters()] == ["a", "b"]


def _setitem_grads(pkg, leaf):
    rng = np.random.RandomState(2)
    x = pkg.to_tensor(rng.randn(3, 4).astype(np.float32),
                      stop_gradient=leaf)
    v = pkg.to_tensor(rng.randn(4).astype(np.float32), stop_gradient=False)
    cot = pkg.to_tensor(rng.randn(3, 4).astype(np.float32))
    y = x if leaf else x * 2.0
    y[1] = v * 3.0
    pkg.sum(y * cot).backward()
    return (None if leaf else _np(x.grad)), _np(v.grad), _np(y)


@pytest.mark.parametrize("leaf", [True, False], ids=["leaf", "non_leaf"])
def test_setitem_gradients_match_jax(leaf):
    for t, j in zip(_setitem_grads(tp, leaf), _setitem_grads(jp, leaf)):
        if j is None:
            assert t is None
        else:
            _close(t, j)


def test_setitem_on_a_leaf_that_requires_grad_raises_as_jax():
    msgs = []
    for pkg in (jp, tp):
        x = pkg.to_tensor(np.ones(3, np.float32), stop_gradient=False)
        with pytest.raises(RuntimeError) as e:
            x[0] = 2.0
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    x = tp.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    with tp.no_grad():
        x[0] = 2.0
    assert x.numpy()[0] == 2.0


def _paddle_params(module):
    """A deep copy of `module` whose parameters are paddle `Parameter`s
    (the same values)."""
    m = copy.deepcopy(module)
    for sub in m.modules():
        for n, p in list(sub._parameters.items()):
            if p is not None:
                sub._parameters[n] = Parameter(p.detach().clone(),
                                               trainable=p.requires_grad)
    return m


def _models():
    from paddle_tpu_torch import (BertConfig, BertForSequenceClassification,
                                  GPTConfig, GPTForCausalLM, Transformer)

    torch.manual_seed(0)
    ids = torch.randint(0, 64, (2, 8))
    return [
        (GPTForCausalLM(GPTConfig.tiny(), device="cpu").eval(), (ids,)),
        (BertForSequenceClassification(BertConfig.tiny(),
                                       device="cpu").eval(), (ids,)),
        (tp.resnet18(num_classes=4, device="cpu").eval(),
         (torch.randn(1, 3, 32, 32),)),
        (Transformer(d_model=16, nhead=2, num_encoder_layers=1,
                     num_decoder_layers=1, dim_feedforward=32,
                     device="cpu").eval(),
         (torch.randn(2, 5, 16), torch.randn(2, 3, 16)))]


def test_models_given_paddle_params_and_inputs_are_bitwise():
    for model, inputs in _models():
        pm = _paddle_params(model)
        assert any(isinstance(p, Parameter) for p in pm.parameters())
        with torch.no_grad():
            want = model(*inputs)
            got = pm(*[tp.to_tensor(x) for x in inputs])
        assert isinstance(got, Tensor), type(model).__name__
        assert torch.equal(got.as_subclass(torch.Tensor), want)
        assert all(isinstance(p, Parameter) for p in pm.parameters())


def _opt_run(make, paddle_side, scaler=False):
    torch.manual_seed(1)
    params = [torch.randn(4, 3), torch.randn(3)]
    grads = [torch.randn(4, 3), torch.randn(3)]
    ps = [Parameter(p.clone()) if paddle_side else
          torch.nn.Parameter(p.clone()) for p in params]
    opt = make(ps)
    sc = tp.amp.GradScaler(init_loss_scaling=4.0) if scaler else None
    for _ in range(3):
        for p, g in zip(ps, grads):
            p.grad = (g * 4.0 if scaler else g).clone()
        if sc is not None:
            sc.step(opt)
        else:
            opt.step()
        opt.clear_grad()
    return [p.detach().as_subclass(torch.Tensor).clone() for p in ps]


@pytest.mark.parametrize("name", ["adamw", "momentum_clip", "scaler"])
def test_optimizers_clip_scaler_given_paddle_params_are_bitwise(name):
    make = {
        "adamw": lambda ps: tp.AdamW(learning_rate=0.1, parameters=ps,
                                     weight_decay=0.01),
        "momentum_clip": lambda ps: tp.Momentum(
            learning_rate=0.1, parameters=ps,
            grad_clip=tp.ClipGradByGlobalNorm(0.5)),
        "scaler": lambda ps: tp.SGD(learning_rate=0.1, parameters=ps)}[name]
    scaler = name == "scaler"
    for a, b in zip(_opt_run(make, True, scaler),
                    _opt_run(make, False, scaler)):
        assert torch.equal(a, b)


def test_trainstep_given_paddle_params_and_inputs_is_bitwise():
    from paddle_tpu_torch import GPTConfig, GPTForCausalLM

    torch.manual_seed(0)
    base = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    ids = torch.randint(0, 128, (2, 16))
    labels = torch.randint(0, 128, (2, 16))
    runs = []
    for paddle_side in (False, True):
        m = _paddle_params(base) if paddle_side else copy.deepcopy(base)
        opt = tp.AdamW(learning_rate=1e-3, parameters=m.parameters())
        step = tp.TrainStep(m, opt, lambda out, lab: tp.nn.functional
                            .cross_entropy(out.reshape([-1, 128]),
                                           lab.reshape([-1])))
        feed = (tp.to_tensor(ids), tp.to_tensor(labels)) if paddle_side \
            else (ids, labels)
        losses = [step(*feed).as_subclass(torch.Tensor).clone()
                  for _ in range(2)]
        runs.append((losses, [p.detach().as_subclass(torch.Tensor).clone()
                              for p in m.parameters()]))
    (l0, p0), (l1, p1) = runs
    assert all(torch.equal(a, b) for a, b in zip(l0, l1))
    assert all(torch.equal(a, b) for a, b in zip(p0, p1))
