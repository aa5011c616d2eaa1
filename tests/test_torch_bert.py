"""The encoder slice of the PyTorch port (BERT/ERNIE) against the JAX
package, on the CPU.

A small BERT at the kernels' widths (hidden 128, 2 heads: head dim 64;
2 layers; seq 128; f32), so that attention takes the shortseq route (its
plain versions here), through the weight bridge from the JAX model:
- the bridge's round trip for both heads, the pretraining decoder tied to
  the word embeddings, and its error for a missing or an extra name;
- `BertModel`'s hidden and pooled outputs, with and without
  `token_type_ids` and a partial `attention_mask` (no all-padding row: on
  the CPU JAX computes attention densely, and an all-padding row is where
  its TPU kernel's backward and the dense one part, see
  tests/test_torch_shortseq_attention.py), within 1e-5;
- the classifier's loss within 1e-6 and its gradients against JAX's
  within 1e-5; four `TrainStep` AdamW losses against JAX's compiled
  `jit.TrainStep` within 1e-5; the pretraining loss with -100 labels;
- `num_params`, `flops_per_token` and the config presets equal to JAX's;
- `BertModel` built on its own draws the JAX package's init scheme (the
  spread of every tensor within 5 % of the JAX model's), as the heads do;
- dropout from the model's generator, and the card by default for every
  model class.
"""
import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.jit as jjit
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.models import BertConfig as JConfig
from paddle_tpu.models import BertForPretraining as JPretrain
from paddle_tpu.models import BertForSequenceClassification as JCls
from paddle_tpu.models import BertModel as JBert
from paddle_tpu.optimizer import AdamW as JAdamW
from paddle_tpu_torch import (AdamW, BertConfig, BertForPretraining,
                              BertForSequenceClassification, BertModel,
                              ErnieModel, TrainStep, load_paddle_tpu_state,
                              paddle_tpu_state)
from paddle_tpu_torch.models.convert import _linear_weights
from paddle_tpu_torch.ops import flash_attention as tfa

VOCAB, S = 97, 128
KW = dict(vocab=VOCAB, hidden=128, layers=2, heads=2, seq=S)


def _configs(dropout=0.0):
    jc, tc = JConfig.tiny(**KW), BertConfig.tiny(**KW)
    for c in (jc, tc):
        c.hidden_dropout = c.attention_dropout = dropout
    return jc, tc


def _pair(kind="cls", seed=0, dropout=0.0):
    """A JAX model and the port's, the port's weights from the JAX one's
    `state_dict()` through the bridge."""
    paddle.seed(seed)
    jc, tc = _configs(dropout)
    jm = (JCls if kind == "cls" else JPretrain)(jc)
    arrays = {k: np.asarray(v._array) for k, v in jm.state_dict().items()}
    tm = (BertForSequenceClassification if kind == "cls"
          else BertForPretraining)(tc, device="cpu")
    load_paddle_tpu_state(tm, arrays)
    return jm, tm, arrays


def _batch(seed, B=2):
    """ids, token types and a partial attention mask (row 1 keeps 100 of
    128 tokens; no row is all padding)."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, VOCAB, (B, S)).astype(np.int32)
    tt = rng.randint(0, 2, (B, S)).astype(np.int32)
    am = np.ones((B, S), np.float32)
    am[1, 100:] = 0.0
    return ids, tt, am


def _j(x):
    return None if x is None else Tensor._wrap(x)


def _t(x):
    if x is None:
        return None
    t = torch.from_numpy(x)
    return t.long() if x.dtype == np.int32 else t


@pytest.mark.parametrize("kind", ["cls", "pretrain"])
def test_weight_bridge_round_trip_and_errors(kind):
    """JAX state_dict -> port -> JAX layout is the identity; a second port
    model loaded from the first's export is identical; the pretraining
    decoder is the word embedding itself, under no name of its own (the
    JAX state_dict has none); a missing or an extra name raises."""
    _, tm, arrays = _pair(kind)
    back = paddle_tpu_state(tm)
    assert set(back) == set(arrays)
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    if kind == "pretrain":
        assert tm.heads.decoder_weight is \
            tm.bert.embeddings.word_embeddings.weight
        assert not any("decoder_weight" in n for n in tm.state_dict())
        assert "heads.decoder_bias" in dict(tm.named_parameters())
    _, tc = _configs()
    twin = (BertForSequenceClassification if kind == "cls"
            else BertForPretraining)(tc, device="cpu")
    load_paddle_tpu_state(twin, back)
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              twin.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)
    missing = dict(arrays)
    missing.pop("bert.layers.1.fc2.bias")
    with pytest.raises(KeyError, match="missing"):
        load_paddle_tpu_state(twin, missing)
    extra = dict(arrays, **{"heads.decoder_weight":
                            arrays["bert.embeddings.word_embeddings.weight"]})
    with pytest.raises(KeyError, match="unused"):
        load_paddle_tpu_state(twin, extra)


@pytest.mark.parametrize("token_types,mask", [(False, False), (True, False),
                                              (False, True), (True, True)])
def test_bert_model_outputs_match_jax(token_types, mask):
    """hidden `[B, S, H]` and pooled `[B, H]` within 1e-5; every layer's
    attention took the shortseq route (mask-free, or the key-mask route
    with the padding mask), none the dense one."""
    jm, tm, _ = _pair()
    ids, tt, am = _batch(1)
    tt = tt if token_types else None
    am = am if mask else None
    jh, jp = jm.bert(_j(ids), _j(tt), _j(am))
    plain = tfa.shortseq_attention_fwd.plain_calls
    dense = tfa.flash_attention.dense_calls
    with torch.no_grad():
        th, tp = tm.bert(_t(ids), _t(tt), _t(am))
    assert tfa.shortseq_attention_fwd.plain_calls == plain + 2
    assert tfa.flash_attention.dense_calls == dense
    np.testing.assert_allclose(th.numpy(), np.asarray(jh._array), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp._array), atol=1e-5,
                               rtol=0)


def test_eval_with_attention_dropout_is_dense_like_jax():
    """The default dropouts (0.1) in eval mode: JAX routes attention with
    `dropout_p` 0.1 to its dense branch even outside training, and so does
    the port (no shortseq call); the logits match and nothing is
    dropped."""
    jm, tm, _ = _pair(dropout=0.1)
    jm.eval()
    tm.eval()
    ids, tt, am = _batch(2)
    want = jm(_j(ids), _j(tt), _j(am))
    plain = tfa.shortseq_attention_fwd.plain_calls
    with torch.no_grad():
        got = tm(_t(ids), _t(tt), _t(am))
    assert tfa.shortseq_attention_fwd.plain_calls == plain
    np.testing.assert_allclose(got.numpy(), np.asarray(want._array),
                               atol=1e-5, rtol=0)


def test_classifier_loss_and_gradients_match_jax():
    """One forward with labels and a padding mask, one backward: the loss
    within 1e-6, every parameter's gradient within 1e-5 (Linear grads
    transposed); the backward went through the shortseq backward's wrapper
    once per layer."""
    jm, tm, _ = _pair(seed=3)
    ids, tt, am = _batch(4)
    labels = np.array([0, 1], np.int64)
    jloss = jm(_j(ids), _j(tt), _j(am), labels=_j(labels))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._array) for n, p in jm.named_parameters()}
    bwd = tfa.shortseq_attention_bwd.plain_calls
    tloss = tm(_t(ids), _t(tt), _t(am), labels=_t(labels))
    tloss.backward()
    assert tfa.shortseq_attention_bwd.plain_calls == bwd + 2
    np.testing.assert_allclose(tloss.item(), float(jloss._array), atol=1e-6,
                               rtol=0)
    linear = _linear_weights(tm)
    tparams = dict(tm.named_parameters())
    assert set(tparams) == set(jgrads)
    for name, p in tparams.items():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if name in linear else g,
                                   jgrads[name], atol=1e-5, rtol=0,
                                   err_msg=name)


def test_trainstep_losses_match_jax_trainstep():
    """Four AdamW steps (lr 1e-3) on distinct batches through the port's
    TrainStep and JAX's compiled jit.TrainStep, as bench.py's fine-tune
    feeds them (ids and labels): the per-step losses within 1e-5."""
    jm, tm, _ = _pair(seed=5)
    rng = np.random.RandomState(8)
    ids = rng.randint(0, VOCAB, (4, 2, S)).astype(np.int32)
    labels = rng.randint(0, 2, (4, 2)).astype(np.int64)
    jstep = jjit.TrainStep(jm, JAdamW(learning_rate=1e-3,
                                      parameters=jm.parameters()),
                           jm.loss_fn)
    want = [float(jstep(_j(x), _j(y))._array) for x, y in zip(ids, labels)]
    topt = AdamW(learning_rate=1e-3, parameters=tm.parameters())
    tstep = TrainStep(tm, topt, tm.loss_fn)
    got = [float(v) for v in tstep.run_scan(_t(ids), _t(labels))]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert topt._step_count == 4


def test_pretraining_loss_with_ignored_labels_matches_jax():
    """MLM cross entropy over the labels that are not -100 plus NSP,
    within 1e-6, and the gradients within 1e-5: the tied word embedding
    gathers both its lookup's and the decoder's."""
    jm, tm, _ = _pair("pretrain", seed=6)
    ids, tt, am = _batch(7)
    rng = np.random.RandomState(9)
    mlm = np.where(rng.rand(2, S) < 0.15, rng.randint(0, VOCAB, (2, S)),
                   -100).astype(np.int64)
    nsp = np.array([1, 0], np.int64)
    jloss = jm(_j(ids), _j(tt), _j(am), mlm_labels=_j(mlm),
               nsp_labels=_j(nsp))
    jloss.backward()
    jgrads = {n: np.asarray(p.grad._array) for n, p in jm.named_parameters()}
    tloss = tm(_t(ids), _t(tt), _t(am), mlm_labels=_t(mlm),
               nsp_labels=_t(nsp))
    tloss.backward()
    np.testing.assert_allclose(tloss.item(), float(jloss._array), atol=1e-6,
                               rtol=0)
    linear = _linear_weights(tm)
    for name, p in tm.named_parameters():
        g = p.grad.numpy()
        np.testing.assert_allclose(g.T if name in linear else g,
                                   jgrads[name], atol=1e-5, rtol=0,
                                   err_msg=name)
    with torch.no_grad():
        mlm_logits, nsp_logits = tm(_t(ids), _t(tt), _t(am))
    assert mlm_logits.shape == (2, S, VOCAB) and nsp_logits.shape == (2, 2)


def test_num_params_flops_and_presets_match_jax():
    jm, tm, _ = _pair()
    assert tm.num_params() == jm.num_params()
    assert tm.flops_per_token(S) == jm.flops_per_token(S)
    for name in ("bert_base", "bert_large", "ernie_base", "ernie_3_base",
                 "tiny"):
        assert dataclasses.asdict(getattr(BertConfig, name)()) == \
            dataclasses.asdict(getattr(JConfig, name)()), name


def test_dropout_draws_from_the_model_generator():
    """Training mode with dropout: the same generator state gives the same
    loss, the next draw another; eval mode with the same weights and no
    dropout configured gives one value."""
    _, tm, arrays = _pair(dropout=0.2)
    tm.train()
    ids, tt, am = _batch(10)
    labels = torch.tensor([1, 0])
    gen = tm.bert.dropout_generator
    state = gen.get_state()
    a = float(tm(_t(ids), _t(tt), _t(am), labels=labels))
    b = float(tm(_t(ids), _t(tt), _t(am), labels=labels))
    gen.set_state(state)
    assert float(tm(_t(ids), _t(tt), _t(am), labels=labels)) == a
    assert a != b


def test_bert_model_alone_draws_the_jax_init_scheme():
    """A `BertModel` built without a head has the JAX `BertModel`'s names
    and shapes (Linear weights transposed), and its weights follow the JAX
    init: constant tensors (zero biases, unit LayerNorm weights) equal,
    every other tensor's standard deviation within 5 % of the JAX one's
    (N(0, initializer_range) for embeddings and Linear weights; torch's
    own init would be N(0, 1) and kaiming uniform). From the same
    generator it is the encoder the classification head builds."""
    paddle.seed(0)
    jc, tc = _configs()
    want = {k: np.asarray(v._array) for k, v in JBert(jc).state_dict().items()}
    tm = BertModel(tc, device="cpu")
    got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        assert sorted(g.shape) == sorted(w.shape), name
        if w.std() == 0:
            np.testing.assert_array_equal(g, np.full_like(g, w.flat[0]),
                                          err_msg=name)
        else:
            assert abs(g.std() / w.std() - 1) < 0.05, (name, g.std(),
                                                       w.std())
    head = BertForSequenceClassification(tc, device="cpu")
    for (n, a), (_, b) in zip(tm.named_parameters(),
                              head.bert.named_parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=n)


def test_models_want_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = _configs()
    for cls in (BertModel, ErnieModel, BertForSequenceClassification,
                BertForPretraining):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls(tc)
        m = cls(tc, device="cpu")
        assert m.device.type == "cpu"
        assert {p.device.type for p in m.parameters()} == {"cpu"}
        assert getattr(m, "bert", m).dropout_generator.device.type == "cpu"
