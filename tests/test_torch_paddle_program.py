"""A GPT written in the paddle API (`tools/paddle_gpt_program.py`) run by
both packages on the CPU at `GPTConfig.tiny()` on the same numpy weights.

- f32: the loss and every parameter's gradient within 1e-5 of JAX's (of
  the largest magnitude of JAX's gradient).
- Under `auto_cast(dtype="bfloat16")` O1: `OpStats.counts` equal JAX's
  and the program's pinned counts (`expected_counts`, which phase
  `paddle_program` of `chip_smoke.py` scales to 24 layers on the card);
  every dispatch's output dtypes equal JAX's in order (`linear` bf16,
  `layer_norm` and the cross entropy fp32); the loss within 2e-3 of
  JAX's (bf16 GEMMs with fp32 accumulation in both; the bar is 16 bf16
  ulps of a loss near 4.9 at this size) and within 2e-2 of the f32 loss.
- The port's own modules (the GPT, the BERT models, ResNet and
  `ConvBNReLU`, the `nn.Transformer` layers, `TrainStep`) raise
  NotImplementedError under an enabled `auto_cast`.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu as jp
import paddle_tpu_torch as tp
from paddle_tpu.ops import dispatch as jdispatch
from paddle_tpu_torch.core import dtype as tdtypes
from paddle_tpu_torch.ops import dispatch as tdispatch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))
import paddle_gpt_program as prog  # noqa: E402

V, H, L, SEQ, FFN, HEADS = 128, 64, 2, 64, 256, 4
B, S = 2, 16

from _paddle_state import paddle_state  # noqa: E402,F401


def _batch():
    rng = np.random.RandomState(3)
    return (rng.randint(0, V, (B, S)).astype(np.int32),
            rng.randint(0, V, (B, S)).astype(np.int32))


@functools.lru_cache(maxsize=None)
def _run(pkg, o1=False):
    """(loss, {name: grad}, dispatch counts, the loss tensor) of the
    program in `pkg` (once a package and mode: the tests share them)."""
    state = prog.random_state(V, H, L, SEQ, FFN, seed=1)
    params = {k: pkg.to_tensor(v, stop_gradient=False)
              for k, v in state.items()}
    ids, labels = (pkg.to_tensor(a) for a in _batch())
    stats = jdispatch.OpStats if pkg is jp else tdispatch.OpStats
    stats.enabled, stats.counts = True, {}
    try:
        if o1:
            with pkg.amp.auto_cast(dtype="bfloat16"):
                loss = prog.gpt_loss(pkg, params, ids, labels, HEADS)
        else:
            loss = prog.gpt_loss(pkg, params, ids, labels, HEADS)
    finally:
        stats.enabled = False
    counts = dict(stats.counts)
    loss.backward()
    grads = {k: np.asarray(p.grad.numpy(), np.float32)
             for k, p in params.items()}
    return float(loss.numpy()), grads, counts, loss


def test_f32_loss_and_grads_match_jax():
    jl, jg, jc, _ = _run(jp)
    tl, tg, tc, _ = _run(tp)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    assert set(tg) == set(jg)
    for k in jg:
        scale = max(np.abs(jg[k]).max(), 1e-30)
        assert np.abs(tg[k] - jg[k]).max() <= 1e-5 * scale, k
    assert tc == jc == prog.expected_counts(L)


def _record_dtypes(monkeypatch):
    """Patch both packages' dispatch to log (name, output dtypes)."""
    logs = {"jax": [], "port": []}
    jwrap = jdispatch._wrap_outputs

    def jrec(out, node, needs_grad, op_name=None):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        logs["jax"].append((op_name or node.name,
                            [str(o.dtype) for o in outs]))
        return jwrap(out, node, needs_grad, op_name)

    tfinish = tdispatch._finish

    def trec(name, out, inputs, paddle):
        outs = out if isinstance(out, (tuple, list)) else (out,)
        logs["port"].append((name, [tdtypes.canonical_name(o.dtype)
                                    for o in outs]))
        return tfinish(name, out, inputs, paddle)

    monkeypatch.setattr(jdispatch, "_wrap_outputs", jrec)
    monkeypatch.setattr(tdispatch, "_finish", trec)
    return logs


def test_o1_bf16_counts_dtypes_and_loss_match_jax(monkeypatch):
    logs = _record_dtypes(monkeypatch)
    jl, jg, jc, jloss = _run(jp, o1=True)
    tl, tg, tc, tloss = _run(tp, o1=True)
    assert tc == jc == prog.expected_counts(L, o1=True)
    assert logs["port"] == logs["jax"]
    by_name = {}
    for name, dts in logs["port"]:
        by_name.setdefault(name, set()).update(dts)
    assert by_name["linear"] == {"bfloat16"}
    assert by_name["layer_norm"] == {"float32"}
    assert by_name["softmax_ce"] == {"float32"}
    assert tdtypes.canonical_name(tloss.dtype) == jloss.dtype == "float32"
    assert abs(tl - jl) <= 2e-3
    f32, _, _, _ = _run(tp)
    assert abs(tl - f32) <= 2e-2
    for k in jg:
        assert np.isfinite(tg[k]).all(), k


def _models():
    from paddle_tpu_torch import (BertConfig, BertForSequenceClassification,
                                  GPTConfig, GPTForCausalLM, Transformer)
    from paddle_tpu_torch.nn import ConvBNReLU

    ids = torch.zeros((1, 8), dtype=torch.long)
    gpt = GPTForCausalLM(GPTConfig.tiny(), device="cpu")
    bert = BertForSequenceClassification(BertConfig.tiny(), device="cpu")
    net = tp.resnet18(num_classes=4, device="cpu")
    cbr = ConvBNReLU(3, 4, 3, device="cpu")
    tr = Transformer(d_model=16, nhead=2, num_encoder_layers=1,
                     num_decoder_layers=1, dim_feedforward=32,
                     device="cpu")
    img = torch.zeros((1, 3, 32, 32))
    seq = torch.zeros((1, 4, 16))
    return [("GPTForCausalLM", lambda: gpt(ids)),
            ("BertForSequenceClassification", lambda: bert(ids)),
            ("ResNet", lambda: net(img)),
            ("ConvBNReLU", lambda: cbr(img)),
            ("Transformer", lambda: tr(seq, seq)),
            ("TrainStep", lambda: tp.TrainStep(
                gpt, tp.SGD(0.1, parameters=gpt.parameters()),
                lambda out, label: out.mean())(ids, ids))]


def test_port_modules_raise_under_auto_cast():
    for what, call in _models():
        call()                                      # runs without amp
        with tp.amp.auto_cast():
            with pytest.raises(NotImplementedError, match=what):
                call()
        with tp.amp.auto_cast(enable=False):
            call()
