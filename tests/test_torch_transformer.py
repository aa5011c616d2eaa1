"""The encoder-decoder Transformer of the PyTorch port against the JAX
package, on the CPU.

Each module is built in JAX from a seed and carried into the port through
the weight bridge; the same seeded numpy inputs go through both, fp32,
eval mode, dropout 0. Outputs are held within 1e-5 (fp32 sums in another
order). On the CPU JAX computes every attention densely; the port takes
its routes: at d_model 128 and 2 heads (head dim 64), the encoder's
self-attention over a source of 640 and the cross-attention take B6's
plain version, a source of 256 the shortseq one, and the decoder's
masked self-attention the dense branch. Covered:
- `MultiHeadAttention` alone, across `kdim`/`vdim`, with and without a
  cache;
- the encoder layer with `normalize_before` both ways and `relu`/`gelu`
  (exact), the decoder layer with a causal `tgt_mask`;
- `nn.Transformer` at two length pairs, with its routes counted;
- the mask builder, the 84-name bridge both ways, the init scheme and the
  shared starting weights of a stack, dropout from the model's generator,
  `dropout=0.1` in eval taking the dense branch as JAX does, and the card
  by default.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch import (MultiHeadAttention, Transformer,
                              TransformerDecoder, TransformerDecoderLayer,
                              TransformerEncoder, TransformerEncoderLayer,
                              load_paddle_tpu_state, paddle_tpu_state)
from paddle_tpu_torch.ops import flash_attention as tfa

D_MODEL, HEADS, FFN = 128, 2, 256
ATOL = 1e-5


def _bridge(jm, tm):
    """The JAX module's weights into the port's, both in eval mode."""
    jm.eval()
    load_paddle_tpu_state(tm, {k: np.asarray(v._array)
                               for k, v in jm.state_dict().items()})
    return tm.eval()


def _x(seed, *shape):
    return np.random.RandomState(seed).uniform(-1, 1, shape).astype(
        np.float32)


def _j(x):
    return None if x is None else Tensor._wrap(x)


def _t(x):
    return None if x is None else torch.from_numpy(x)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(),
                               np.asarray(want._array), atol=ATOL, rtol=0)


def _counts():
    return (tfa.sdpa_forward.plain_calls,
            tfa.shortseq_attention_fwd.plain_calls,
            tfa.flash_attention.dense_calls)


@pytest.mark.parametrize("case", ["self", "cross_kdim", "empty_cache",
                                  "cache"])
def test_multihead_attention_matches_jax(case):
    """Self-attention at S 128 (shortseq); cross-attention over a 256-long
    key/value input of widths 96/80 (`kdim`, `vdim`; B6); an empty cache
    from `gen_cache`; a cache of 128 earlier keys (B6 over 256 keys).
    With a cache, the returned k and v match JAX's too."""
    kdim, vdim = (96, 80) if case == "cross_kdim" else (None, None)
    paddle.seed(1)
    jm = jnn.MultiHeadAttention(D_MODEL, HEADS, kdim=kdim, vdim=vdim)
    tm = _bridge(jm, MultiHeadAttention(D_MODEL, HEADS, kdim=kdim,
                                        vdim=vdim, device="cpu"))
    q = _x(2, 2, 128, D_MODEL)
    k = v = None
    if case == "cross_kdim":
        k, v = _x(3, 2, 256, kdim), _x(4, 2, 256, vdim)
    if case == "self":
        want, got = jm(_j(q)), tm(_t(q))
        _close(got, want)
        return
    if case == "cross_kdim":
        before = _counts()
        with torch.no_grad():
            got = tm(_t(q), _t(k), _t(v))
        assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
        _close(got, jm(_j(q), _j(k), _j(v)))
        return
    if case == "empty_cache":
        jc, tc = jm.gen_cache(_j(q)), tm.gen_cache(_t(q))
        assert tc[0].shape == (2, 0, HEADS, D_MODEL // HEADS)
        assert tc[0].dtype == torch.float32
    else:
        c = [_x(5 + i, 2, 128, HEADS, D_MODEL // HEADS) for i in range(2)]
        jc, tc = tuple(_j(x) for x in c), tuple(_t(x) for x in c)
    want, (jk, jv) = jm(_j(q), cache=jc)
    with torch.no_grad():
        got, (tk, tv) = tm(_t(q), cache=tc)
    for g, w in ((got, want), (tk, jk), (tv, jv)):
        _close(g, w)


@pytest.mark.parametrize("normalize_before", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu"])
def test_encoder_layer_matches_jax(normalize_before, activation):
    """One encoder layer over a source of 640 (B6 on its self-attention)."""
    paddle.seed(2)
    args = (D_MODEL, HEADS, FFN, 0.0, activation)
    jm = jnn.TransformerEncoderLayer(*args,
                                     normalize_before=normalize_before)
    tm = _bridge(jm, TransformerEncoderLayer(
        *args, normalize_before=normalize_before, device="cpu"))
    src = _x(3, 2, 640, D_MODEL)
    before = _counts()
    with torch.no_grad():
        got = tm(_t(src))
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    _close(got, jm(_j(src)))


@pytest.mark.parametrize("normalize_before", [False, True])
def test_decoder_layer_matches_jax(normalize_before):
    """One decoder layer, a target of 128 under the causal `tgt_mask`
    (dense branch) over a memory of 384 (B6 on the cross-attention)."""
    paddle.seed(3)
    args = (D_MODEL, HEADS, FFN, 0.0)
    jm = jnn.TransformerDecoderLayer(*args,
                                     normalize_before=normalize_before)
    tm = _bridge(jm, TransformerDecoderLayer(
        *args, normalize_before=normalize_before, device="cpu"))
    tgt, mem = _x(4, 2, 128, D_MODEL), _x(5, 2, 384, D_MODEL)
    jmask = jnn.Transformer.generate_square_subsequent_mask(128)
    tmask = Transformer.generate_square_subsequent_mask(128, device="cpu")
    before = _counts()
    with torch.no_grad():
        got = tm(_t(tgt), _t(mem), tgt_mask=tmask)
    assert tuple(a - b for a, b in zip(_counts(), before)) == (1, 0, 0)
    _close(got, jm(_j(tgt), _j(mem), tgt_mask=jmask))


@pytest.mark.parametrize("S,moved", [(640, (4, 0, 0)), (256, (2, 2, 0))])
def test_transformer_matches_jax(S, moved):
    """`nn.Transformer(d_model=128, nhead=2, 2, 2, 256, dropout=0.0)`,
    batch 2, target 128 under the causal mask: source 640 takes B6 on both
    encoder self-attentions and both cross-attentions; source 256 takes
    the shortseq route in the encoder and B6 on the cross-attentions. No
    attention is dense through `flash_attention`."""
    paddle.seed(0)
    args = (D_MODEL, HEADS, 2, 2, FFN, 0.0)
    jm = jnn.Transformer(*args)
    tm = _bridge(jm, Transformer(*args, device="cpu"))
    src, tgt = _x(6, 2, S, D_MODEL), _x(7, 2, 128, D_MODEL)
    jmask = jnn.Transformer.generate_square_subsequent_mask(128)
    tmask = Transformer.generate_square_subsequent_mask(128, device="cpu")
    want = jm(_j(src), _j(tgt), tgt_mask=jmask)
    before = _counts()
    with torch.no_grad():
        got = tm(_t(src), _t(tgt), tgt_mask=tmask)
    assert tuple(a - b for a, b in zip(_counts(), before)) == moved
    assert got.shape == (2, 128, D_MODEL)
    _close(got, want)


def test_square_subsequent_mask_matches_jax():
    want = np.asarray(
        jnn.Transformer.generate_square_subsequent_mask(5)._array)
    got = Transformer.generate_square_subsequent_mask(5, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (5, 5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 1] == -np.inf and got[1, 0] == 0.0


def test_bridge_maps_the_84_names_both_ways():
    """A 2 + 2 layer Transformer: the port's entries and JAX's `state_dict`
    names are the same 84; JAX -> port -> JAX gives JAX's arrays back
    (Linear weights transposed on the way in and out)."""
    paddle.seed(4)
    jm = jnn.Transformer(D_MODEL, HEADS, 2, 2, FFN, 0.0)
    arrays = {k: np.asarray(v._array) for k, v in jm.state_dict().items()}
    tm = Transformer(D_MODEL, HEADS, 2, 2, FFN, 0.0, device="cpu")
    assert len(arrays) == 84
    assert sorted(paddle_tpu_state(tm)) == sorted(arrays)
    back = paddle_tpu_state(load_paddle_tpu_state(tm, arrays))
    for name, a in arrays.items():
        np.testing.assert_array_equal(back[name], a, err_msg=name)
    w = tm.encoder.layers[0].self_attn.q_proj.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        arrays["encoder.layers.0.self_attn.q_proj.weight"].T)
    with pytest.raises(KeyError):
        load_paddle_tpu_state(tm, {k: a for k, a in arrays.items()
                                   if "norm3" not in k})


def test_init_scheme_and_stacks_start_from_one_layer():
    """JAX's defaults, drawn from the generator: Xavier-normal Linear
    weights (spread within 5 % of sqrt(2 / (fan_in + fan_out))), zero
    biases, LayerNorm at ones and zeros; every layer of a stack starts
    equal to the first, as JAX's deep copies do; the same seed draws the
    same weights, and `bias_attr=False` builds no bias."""
    g = torch.Generator().manual_seed(7)
    tm = Transformer(256, 4, 2, 2, 512, 0.0, device="cpu", generator=g)
    for name, mod in tm.named_modules():
        if isinstance(mod, torch.nn.Linear):
            std = np.sqrt(2.0 / (mod.in_features + mod.out_features))
            assert abs(mod.weight.std().item() / std - 1) < 0.05, name
            assert not mod.bias.any(), name
        elif isinstance(mod, torch.nn.LayerNorm):
            assert mod.eps == 1e-5
            assert bool((mod.weight == 1).all() and not mod.bias.any())
    for stack in (tm.encoder, tm.decoder):
        first = stack.layers[0].state_dict()
        for layer in stack.layers[1:]:
            assert all(torch.equal(first[k], v)
                       for k, v in layer.state_dict().items())
    again = Transformer(256, 4, 2, 2, 512, 0.0, device="cpu",
                        generator=torch.Generator().manual_seed(7))
    assert all(torch.equal(a, b) for a, b in zip(tm.parameters(),
                                                 again.parameters()))
    nobias = MultiHeadAttention(64, 2, bias_attr=False, device="cpu")
    assert nobias.q_proj.bias is None
    paddle.seed(5)
    jnob = jnn.MultiHeadAttention(64, 2, bias_attr=False)
    assert sorted(jnob.state_dict()) == sorted(paddle_tpu_state(nobias))


def test_dropout_draws_from_the_models_generator():
    """In train mode with dropout, every layer draws from the one
    `dropout_generator` the model gives them all: reseeding it gives the
    same output, drawing on gives another."""
    tm = Transformer(64, 2, 2, 2, 128, 0.1, device="cpu").train()
    gens = {id(m.dropout_generator) for m in tm.modules()
            if hasattr(m, "dropout_generator")}
    assert gens == {id(tm.dropout_generator)}
    src, tgt = torch.from_numpy(_x(8, 2, 16, 64)), torch.from_numpy(
        _x(9, 2, 8, 64))
    tm.dropout_generator.manual_seed(3)
    a = tm(src, tgt)
    b = tm(src, tgt)
    tm.dropout_generator.manual_seed(3)
    c = tm(src, tgt)
    assert torch.equal(a, c) and not torch.equal(a, b)


def test_eval_with_dropout_is_dense_like_jax():
    """`dropout=0.1` in eval: `scaled_dot_product_attention` reads
    `dropout_p`, not the mode, so every attention takes the dense branch
    and drops nothing (ROADMAP Queue C 4), no kernel route, as in JAX."""
    paddle.seed(6)
    args = (D_MODEL, HEADS, 1, 1, FFN, 0.1)
    jm = jnn.Transformer(*args)
    tm = _bridge(jm, Transformer(*args, device="cpu"))
    src, tgt = _x(10, 2, 640, D_MODEL), _x(11, 2, 128, D_MODEL)
    before = _counts()
    with torch.no_grad():
        got = tm(_t(src), _t(tgt))
    assert _counts() == before
    _close(got, jm(_j(src), _j(tgt)))


def test_models_want_the_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (lambda **kw: Transformer(64, 2, 1, 1, 128, **kw),
                  lambda **kw: MultiHeadAttention(64, 2, **kw),
                  lambda **kw: TransformerEncoderLayer(64, 2, 128, **kw),
                  lambda **kw: TransformerDecoderLayer(64, 2, 128, **kw)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
        m = build(device="cpu")
        assert {p.device.type for p in m.parameters()} == {"cpu"}
        assert m.dropout_generator.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer.generate_square_subsequent_mask(4)
    layer = TransformerEncoderLayer(64, 2, 128, device="cpu")
    assert TransformerEncoder(layer, 2).layers[1].norm1.weight.device.type \
        == "cpu"
    dec = TransformerDecoderLayer(64, 2, 128, device="cpu")
    assert len(TransformerDecoder(dec, 3).layers) == 3
