"""Transformer layers: counterpart of paddle_tpu/nn/transformer.py.

`MultiHeadAttention`, the encoder and decoder layers and stacks, and the
encoder-decoder `Transformer`, whose defaults (d_model 512, 8 heads, 6 + 6
layers, FFN 2048, ReLU, post-norm) are the base model of Vaswani et al.
2017. Layouts follow paddle: `[batch, seq, d_model]`, per head `[batch,
seq, heads, head_dim]`. Parameter names match the JAX layers'
`state_dict()` one to one (`models/convert.py` bridges the weights).

Attention goes through `ops.nn_ops.scaled_dot_product_attention`, as in
JAX: without a mask and without attention dropout, `flash_attention`
routes by shape. The encoder's self-attention over sources longer than 512
and the decoder's cross-attention (query length != memory length) take
the library route, B6 (`sdpa_forward`) when no gradient is needed; a
masked attention (the decoder's causal `tgt_mask`) takes the dense branch.

Weights follow the JAX package's defaults for layers built without
initializers: Xavier-normal Linear weights (std sqrt(2 / (fan_in +
fan_out))), zero biases, LayerNorm at ones and zeros (eps 1e-5), drawn
from an explicit `generator` (seed 0 when None). A stack is its layer
followed by deep copies of it, so every layer starts from the same
weights, as JAX builds it. Dropout masks are drawn from
`dropout_generator`, a `torch.Generator` on the module's device seeded
with 0; a stack, and the `Transformer`, give all their layers one
generator, drawn in order through a forward.
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn
from torch.nn import functional as F

from ..device import resolve_device
from ..ops.nn_ops import dropout, scaled_dot_product_attention

__all__ = ["MultiHeadAttention", "TransformerEncoderLayer",
           "TransformerEncoder", "TransformerDecoderLayer",
           "TransformerDecoder", "Transformer"]

_LN_EPS = 1e-5
# the activations a layer takes by name; gelu is exact (erf), as the JAX
# package's `act.gelu` defaults to approximate=False
_ACTIVATIONS = {"relu": F.relu, "gelu": F.gelu}


def _activation(name):
    if name not in _ACTIVATIONS:
        raise NotImplementedError(f"activation {name!r} is not ported yet "
                                  f"(ported: {sorted(_ACTIVATIONS)})")
    return _ACTIVATIONS[name]


def _has_bias(weight_attr, bias_attr):
    """`bias_attr=False` builds no bias, None the default one. Parameter
    attributes and initializers are not ported yet."""
    if weight_attr is not None or bias_attr not in (None, False):
        raise NotImplementedError("weight_attr and bias_attr other than "
                                  "None (or bias_attr=False) are not ported "
                                  "yet")
    return bias_attr is None


@torch.no_grad()
def _linear(in_features, out_features, bias, generator, kw):
    """nn.Linear with JAX's default init: Xavier-normal weight drawn from
    `generator`, zero bias."""
    lin = nn.Linear(in_features, out_features, bias=bias, **kw)
    std = math.sqrt(2.0 / (in_features + out_features))
    lin.weight.normal_(0.0, std, generator=generator)
    if bias:
        lin.bias.zero_()
    return lin


def _setup(module, device, dtype, generator):
    """Resolve `device` (None means the card), give `module` its
    `dropout_generator`, and return (the weight generator, the
    factory kwargs)."""
    module.device = resolve_device(device)
    module.dropout_generator = torch.Generator(module.device).manual_seed(0)
    if generator is None:
        generator = torch.Generator(module.device).manual_seed(0)
    return generator, dict(device=module.device, dtype=dtype)


def _share_dropout_generator(module, generator):
    """Every submodule of `module` that drops draws from `generator`."""
    module.dropout_generator = generator
    for m in module.modules():
        if hasattr(m, "dropout_generator"):
            m.dropout_generator = generator


class MultiHeadAttention(nn.Module):
    """Multi-head attention with q/k/v/out projections (`kdim`, `vdim` for
    the key and value inputs). `need_weights` is accepted and ignored, as
    in JAX. `bias_attr=False` builds the projections without bias."""

    def __init__(self, embed_dim, num_heads, dropout=0.0, kdim=None,
                 vdim=None, need_weights=False, weight_attr=None,
                 bias_attr=None, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        g, kw = _setup(self, device, dtype, generator)
        bias = _has_bias(weight_attr, bias_attr)
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.dropout = dropout
        self.need_weights = need_weights
        kdim = kdim or embed_dim
        vdim = vdim or embed_dim
        self.q_proj = _linear(embed_dim, embed_dim, bias, g, kw)
        self.k_proj = _linear(kdim, embed_dim, bias, g, kw)
        self.v_proj = _linear(vdim, embed_dim, bias, g, kw)
        self.out_proj = _linear(embed_dim, embed_dim, bias, g, kw)

    def forward(self, query, key=None, value=None, attn_mask=None,
                cache=None):
        """`[B, S, embed_dim]` -> `[B, S, embed_dim]`; key and value default
        to the query. With `cache` = (k, v) `[B, T, H, D]`, the new keys and
        values are appended on axis 1 and `(out, (k, v))` is returned."""
        key = query if key is None else key
        value = query if value is None else value
        B, S = query.shape[0], query.shape[1]
        H, D = self.num_heads, self.head_dim
        q = self.q_proj(query).reshape(B, S, H, D)
        k = self.k_proj(key).reshape(B, key.shape[1], H, D)
        v = self.v_proj(value).reshape(B, value.shape[1], H, D)
        if cache is not None:
            k = torch.cat([cache[0], k], dim=1)
            v = torch.cat([cache[1], v], dim=1)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout,
            training=self.training, generator=self.dropout_generator)
        out = self.out_proj(out.reshape(B, S, H * D))
        if cache is not None:
            return out, (k, v)
        return out

    def gen_cache(self, key, value=None, type=None):
        """An empty cache: fp32 zeros `[B, 0, heads, head_dim]` for k and
        v, as JAX makes it."""
        shape = (key.shape[0], 0, self.num_heads, self.head_dim)
        return (torch.zeros(shape, device=key.device),
                torch.zeros(shape, device=key.device))


class TransformerEncoderLayer(nn.Module):
    """Self-attention and a feed-forward block, each with a residual and
    LayerNorm: after it (post-norm, the default) or before it
    (`normalize_before`)."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g, kw = _setup(self, device, dtype, generator)
        bias = _has_bias(weight_attr, bias_attr)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.act_dropout = dropout if act_dropout is None else act_dropout
        self.dropout_p = dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            weight_attr=weight_attr,
                                            bias_attr=bias_attr,
                                            generator=g, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, bias, g, kw)
        self.linear2 = _linear(dim_feedforward, d_model, bias, g, kw)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.activation = _activation(activation)
        _share_dropout_generator(self, self.dropout_generator)

    def _drop(self, x, p):
        return dropout(x, p, self.training, self.dropout_generator)

    def forward(self, src, src_mask=None, cache=None):
        """`[B, S, d_model]` -> `[B, S, d_model]`; `cache` is accepted and
        ignored, as in JAX."""
        residual = src
        if self.normalize_before:
            src = self.norm1(src)
        src = self.self_attn(src, src, src, attn_mask=src_mask)
        src = residual + self._drop(src, self.dropout_p)
        if not self.normalize_before:
            src = self.norm1(src)
        residual = src
        if self.normalize_before:
            src = self.norm2(src)
        src = self.linear2(self._drop(self.activation(self.linear1(src)),
                                      self.act_dropout))
        src = residual + self._drop(src, self.dropout_p)
        if not self.normalize_before:
            src = self.norm2(src)
        return src


class TransformerEncoder(nn.Module):
    """`encoder_layer` followed by `num_layers - 1` deep copies of it (the
    same starting weights, as JAX builds the stack), then the optional
    `norm`. The stack lives where its layer lives and draws nothing at
    build time, so it takes no device, dtype or generator."""

    def __init__(self, encoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [encoder_layer] + [copy.deepcopy(encoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm
        _share_dropout_generator(self, encoder_layer.dropout_generator)

    def forward(self, src, src_mask=None):
        out = src
        for layer in self.layers:
            out = layer(out, src_mask=src_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class TransformerDecoderLayer(nn.Module):
    """Masked self-attention, cross-attention over the encoder's memory and
    a feed-forward block, each with a residual and LayerNorm. As in JAX,
    `weight_attr` and `bias_attr` are taken and passed nowhere: the
    attentions and the feed-forward block are built with the defaults."""

    def __init__(self, d_model, nhead, dim_feedforward, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, weight_attr=None, bias_attr=None,
                 device=None, dtype=torch.float32, generator=None):
        super().__init__()
        g, kw = _setup(self, device, dtype, generator)
        attn_dropout = dropout if attn_dropout is None else attn_dropout
        self.act_dropout = dropout if act_dropout is None else act_dropout
        self.dropout_p = dropout
        self.normalize_before = normalize_before
        self.self_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                            generator=g, **kw)
        self.cross_attn = MultiHeadAttention(d_model, nhead, attn_dropout,
                                             generator=g, **kw)
        self.linear1 = _linear(d_model, dim_feedforward, True, g, kw)
        self.linear2 = _linear(dim_feedforward, d_model, True, g, kw)
        self.norm1 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.norm2 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.norm3 = nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
        self.activation = _activation(activation)
        _share_dropout_generator(self, self.dropout_generator)

    def _drop(self, x, p):
        return dropout(x, p, self.training, self.dropout_generator)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None,
                cache=None):
        """`[B, T, d_model]` over memory `[B, S, d_model]` -> `[B, T,
        d_model]`; `cache` is accepted and ignored, as in JAX."""
        residual = tgt
        if self.normalize_before:
            tgt = self.norm1(tgt)
        tgt = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask)
        tgt = residual + self._drop(tgt, self.dropout_p)
        if not self.normalize_before:
            tgt = self.norm1(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm2(tgt)
        tgt = self.cross_attn(tgt, memory, memory, attn_mask=memory_mask)
        tgt = residual + self._drop(tgt, self.dropout_p)
        if not self.normalize_before:
            tgt = self.norm2(tgt)
        residual = tgt
        if self.normalize_before:
            tgt = self.norm3(tgt)
        tgt = self.linear2(self._drop(self.activation(self.linear1(tgt)),
                                      self.act_dropout))
        tgt = residual + self._drop(tgt, self.dropout_p)
        if not self.normalize_before:
            tgt = self.norm3(tgt)
        return tgt


class TransformerDecoder(nn.Module):
    """`decoder_layer` followed by `num_layers - 1` deep copies of it, then
    the optional `norm` (as `TransformerEncoder`)."""

    def __init__(self, decoder_layer, num_layers, norm=None):
        super().__init__()
        self.layers = nn.ModuleList(
            [decoder_layer] + [copy.deepcopy(decoder_layer)
                               for _ in range(num_layers - 1)])
        self.num_layers = num_layers
        self.norm = norm
        _share_dropout_generator(self, decoder_layer.dropout_generator)

    def forward(self, tgt, memory, tgt_mask=None, memory_mask=None):
        out = tgt
        for layer in self.layers:
            out = layer(out, memory, tgt_mask=tgt_mask,
                        memory_mask=memory_mask)
        if self.norm is not None:
            out = self.norm(out)
        return out


class Transformer(nn.Module):
    """The encoder-decoder Transformer: `forward(src, tgt, ...)` runs the
    encoder over `src` `[B, S, d_model]` and the decoder over `tgt` `[B, T,
    d_model]` against its memory. With `normalize_before`, each stack ends
    in a LayerNorm. `device=None` means the CUDA card and raises without
    one; pass `device="cpu"` for the plain PyTorch path. The encoder layer
    draws its weights from `generator` first, then the decoder layer."""

    def __init__(self, d_model=512, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 activation="relu", attn_dropout=None, act_dropout=None,
                 normalize_before=False, custom_encoder=None,
                 custom_decoder=None, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        g, kw = _setup(self, device, dtype, generator)
        args = (d_model, nhead, dim_feedforward, dropout, activation,
                attn_dropout, act_dropout, normalize_before)
        if custom_encoder is not None:
            self.encoder = custom_encoder
        else:
            enc_norm = (nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
                        if normalize_before else None)
            self.encoder = TransformerEncoder(
                TransformerEncoderLayer(*args, generator=g, **kw),
                num_encoder_layers, enc_norm)
        if custom_decoder is not None:
            self.decoder = custom_decoder
        else:
            dec_norm = (nn.LayerNorm(d_model, eps=_LN_EPS, **kw)
                        if normalize_before else None)
            self.decoder = TransformerDecoder(
                TransformerDecoderLayer(*args, generator=g, **kw),
                num_decoder_layers, dec_norm)
        self.d_model = d_model
        self.nhead = nhead
        _share_dropout_generator(self, self.dropout_generator)

    def forward(self, src, tgt, src_mask=None, tgt_mask=None,
                memory_mask=None):
        memory = self.encoder(src, src_mask=src_mask)
        return self.decoder(tgt, memory, tgt_mask=tgt_mask,
                            memory_mask=memory_mask)

    @staticmethod
    def generate_square_subsequent_mask(length, device=None):
        """The decoder's causal mask: fp32 `[length, length]`, 0 on and
        below the diagonal and -inf above, as JAX builds it. `device=None`
        means the card, as for the models."""
        dev = resolve_device(device)
        keep = torch.ones(length, length, dtype=torch.bool, device=dev).tril()
        return torch.zeros(length, length, device=dev).masked_fill(
            ~keep, -math.inf)
