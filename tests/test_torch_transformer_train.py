"""Training the encoder-decoder Transformer of the PyTorch port against the
JAX package, on the CPU.

A 2 + 2 layer `Transformer` (d_model 128, 2 heads: head dim 64, FFN 256,
dropout 0) is built in JAX from a seed and carried into the port through
the weight bridge (`models/convert.py`). A small wrapper module passes the
causal `tgt_mask`, since `TrainStep` takes positional inputs only, in both
packages. The source is 640 long, so the encoder's self-attention and the
cross-attention (128 x 640) take the library route: in the port
`_LibraryAttention` (B6 with its LSE, then the library backward; their
plain versions here), in JAX the dense computation it uses off a TPU. The
decoder's masked self-attention is dense in both. The loss is `mse_loss`
against a target drawn from the seed. Held, fp32, batch 2:
- `mse_loss` at every reduction within 1e-6 (the sum also 1e-6
  relative: fp32 sums in another order);
- the first step's gradient of every parameter within 1e-5 (the tiny
  GPT's bars, `tests/test_torch_training.py`), Linear weights transposed;
- three `TrainStep` losses with AdamW and with Momentum against JAX's
  compiled `jit.TrainStep`, within 1e-5.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu_torch import (AdamW, Momentum, Transformer, TrainStep,
                              load_paddle_tpu_state)
from paddle_tpu_torch.models.convert import _linear_weights
from paddle_tpu_torch.ops import flash_attention as tfa
from paddle_tpu_torch.ops.nn_ops import mse_loss

D_MODEL, HEADS, FFN, SRC, TGT, BATCH = 128, 2, 256, 640, 128, 2


class _JSeq2Seq(jnn.Layer):
    """The JAX model with its causal target mask."""

    def __init__(self, model, mask):
        super().__init__()
        self.model = model
        self.mask = mask

    def forward(self, src, tgt):
        return self.model(src, tgt, tgt_mask=self.mask)


class _Seq2Seq(torch.nn.Module):
    """The port's model with its causal target mask."""

    def __init__(self, model, mask):
        super().__init__()
        self.model = model
        self.mask = mask

    def forward(self, src, tgt):
        return self.model(src, tgt, tgt_mask=self.mask)


def _pair(seed):
    paddle.seed(seed)
    args = (D_MODEL, HEADS, 2, 2, FFN, 0.0)
    jm = jnn.Transformer(*args)
    tm = Transformer(*args, device="cpu")
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    jnet = _JSeq2Seq(jm, jnn.Transformer.generate_square_subsequent_mask(TGT))
    tnet = _Seq2Seq(tm, Transformer.generate_square_subsequent_mask(
        TGT, device="cpu"))
    return jnet.train(), tnet.train()


def _batch(seed):
    rng = np.random.RandomState(seed)
    return tuple(rng.uniform(-1, 1, (BATCH, n, D_MODEL)).astype(np.float32)
                 for n in (SRC, TGT, TGT))


def _counts():
    return (tfa.sdpa_forward.plain_calls, tfa.sdpa_backward.plain_calls,
            tfa.flash_attention.dense_calls)


@pytest.mark.parametrize("reduction", ["mean", "sum", "none"])
def test_mse_loss_matches_jax(reduction):
    rng = np.random.RandomState(0)
    a, b = (rng.randn(3, 5, 7).astype(np.float32) for _ in range(2))
    want = JF.mse_loss(Tensor._wrap(a), Tensor._wrap(b), reduction=reduction)
    got = mse_loss(torch.from_numpy(a), torch.from_numpy(b),
                   reduction=reduction)
    assert tuple(got.shape) == tuple(want.shape)
    # the sum of 105 terms near 175 rounds in another order: relative
    np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                               atol=1e-6, rtol=1e-6)


def test_transformer_gradients_match_jax():
    """One forward and backward of mse_loss: the loss within 1e-6 and every
    parameter's gradient within 1e-5; the port's step took
    `_LibraryAttention` on its four library attentions (plain versions
    here) and nothing dense through `flash_attention`."""
    jnet, tnet = _pair(0)
    src, tgt, label = _batch(1)
    jloss = JF.mse_loss(jnet(Tensor._wrap(src), Tensor._wrap(tgt)),
                        Tensor._wrap(label))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._array)
              for n, p in jnet.model.named_parameters()}
    before = _counts()
    tloss = mse_loss(tnet(torch.from_numpy(src), torch.from_numpy(tgt)),
                     torch.from_numpy(label))
    tloss.backward()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (4, 4, 0)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss._array),
                               atol=1e-6,
                               rtol=0)
    linear = _linear_weights(tnet.model)
    tparams = dict(tnet.model.named_parameters())
    assert set(tparams) == set(jgrads)
    for name, p in tparams.items():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if name in linear else g,
                                   jgrads[name], atol=1e-5, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("opt", ["adamw", "momentum"])
def test_transformer_trainstep_losses_match_jax_trainstep(opt):
    """Three steps on distinct batches through the port's TrainStep and
    JAX's compiled jit.TrainStep (AdamW(1e-3), or Momentum(0.01, 0.9)):
    the per-step losses within 1e-5; the port's steps took the library
    route's plain versions four times each a step."""
    jnet, tnet = _pair(1)
    if opt == "adamw":
        jopt = JAdamW(learning_rate=1e-3, parameters=jnet.parameters())
        topt = AdamW(learning_rate=1e-3, parameters=tnet.parameters())
    else:
        jopt = JMomentum(learning_rate=0.01, momentum=0.9,
                         parameters=jnet.parameters())
        topt = Momentum(learning_rate=0.01, momentum=0.9,
                        parameters=tnet.parameters())
    jstep = jjit.TrainStep(jnet, jopt, JF.mse_loss)
    tstep = TrainStep(tnet, topt, mse_loss)
    batches = [_batch(10 + i) for i in range(3)]
    want = [float(jstep(*(Tensor._wrap(x) for x in b))._array)
            for b in batches]
    before = _counts()
    got = [float(tstep(*(torch.from_numpy(x) for x in b))) for b in batches]
    assert tuple(a - b for a, b in zip(_counts(), before)) == (12, 12, 0)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert topt._step_count == 3
