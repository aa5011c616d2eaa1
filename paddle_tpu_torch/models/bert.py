"""BERT / ERNIE, the encoder family: counterpart of paddle_tpu/models/bert.py.

Post-LN transformer encoder blocks with a fused qkv projection reshaped
3-major (`[B, S, 3, heads, D]`), tanh GELU, LayerNorm with the config's
epsilon (1e-12), a tanh pooler over position 0, the sequence-classification
head (bench.py's fine-tune row) and the pretraining heads (MLM with a
decoder tied to the word embeddings, plus NSP). Parameter names match the
JAX model's `state_dict()` (`models/convert.py` bridges the weights).

Attention goes through `scaled_dot_product_attention`, non-causal: without
a padding mask and without attention dropout the shortseq kernels take
encoder shapes (S <= 512, S % 128 == 0, head dim 64 or 128); the padding
mask becomes an additive key mask and takes their masked variants.
Dropout draws from `dropout_generator`, a `torch.Generator` the model
owns.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from ..core.tensor import plain_entry
from ..device import resolve_device
from ..ops.nn_ops import attention_with_generator as \
    scaled_dot_product_attention
from ..ops.nn_ops import cross_entropy
from ..ops.nn_ops import dropout_with_generator as dropout

__all__ = ["BertConfig", "BertEmbeddings", "BertSelfAttention", "BertLayer",
           "BertPooler", "BertModel", "ErnieModel",
           "BertForSequenceClassification", "BertPretrainingHeads",
           "BertForPretraining"]

_MASK_VALUE = -1e30


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    layer_norm_epsilon: float = 1e-12
    initializer_range: float = 0.02
    num_labels: int = 2

    @staticmethod
    def bert_base():
        return BertConfig()

    @staticmethod
    def bert_large():
        return BertConfig(hidden_size=1024, num_layers=24, num_heads=16,
                          intermediate_size=4096)

    @staticmethod
    def ernie_base():
        # ERNIE-1.0 base: same encoder, 18000-token Chinese vocab
        return BertConfig(vocab_size=18000)

    @staticmethod
    def ernie_3_base():
        # ERNIE-3.0-base-zh: L12 H768 A12, 40000 vocab, seq 512
        return BertConfig(vocab_size=40000)

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, seq=64):
        return BertConfig(vocab_size=vocab, hidden_size=hidden,
                          num_layers=layers, num_heads=heads,
                          intermediate_size=4 * hidden,
                          max_position_embeddings=seq)


def _layer_norm(config, kw):
    return nn.LayerNorm(config.hidden_size, eps=config.layer_norm_epsilon,
                        **kw)


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size, **kw)
        self.position_embeddings = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, **kw)
        self.token_type_embeddings = nn.Embedding(config.type_vocab_size,
                                                  config.hidden_size, **kw)
        self.layer_norm = _layer_norm(config, kw)
        self.dropout = config.hidden_dropout

    def forward(self, input_ids, token_type_ids=None, position_ids=None,
                generator=None):
        """Word + position + token-type embeddings, LayerNorm, dropout.
        `position_ids` default to arange(S); without `token_type_ids`
        every token is type 0, whose row still adds (and trains)."""
        S = input_ids.shape[1]
        if position_ids is None:
            position_ids = torch.arange(S, device=input_ids.device)
        h = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        if token_type_ids is None:
            h = h + self.token_type_embeddings.weight[0]
        else:
            h = h + self.token_type_embeddings(token_type_ids)
        return dropout(self.layer_norm(h), self.dropout, self.training,
                       generator)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        H = config.hidden_size
        kw = dict(device=device, dtype=dtype)
        self.qkv_proj = nn.Linear(H, 3 * H, **kw)   # fused qkv
        self.out_proj = nn.Linear(H, H, **kw)
        self.dropout_p = config.attention_dropout

    def forward(self, x, attn_mask=None, generator=None):
        """Bidirectional self-attention; `attn_mask` is the additive
        `[B, 1, 1, S]` key mask or None."""
        B, S, H = x.shape
        qkv = self.qkv_proj(x).view(B, S, 3, self.num_heads, self.head_dim)
        q, k, v = qkv.unbind(2)
        out = scaled_dot_product_attention(
            q, k, v, attn_mask=attn_mask, dropout_p=self.dropout_p,
            is_causal=False, training=self.training, generator=generator)
        return self.out_proj(out.reshape(B, S, H))


class BertLayer(nn.Module):
    """Post-LN encoder block (the original BERT residual order)."""

    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.attention = BertSelfAttention(config, **kw)
        self.ln1 = _layer_norm(config, kw)
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **kw)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **kw)
        self.ln2 = _layer_norm(config, kw)
        self.dropout = config.hidden_dropout

    def forward(self, x, attn_mask=None, generator=None):
        a = self.attention(x, attn_mask, generator)
        x = self.ln1(x + dropout(a, self.dropout, self.training, generator))
        h = self.fc2(F.gelu(self.fc1(x), approximate="tanh"))
        return self.ln2(x + dropout(h, self.dropout, self.training,
                                    generator))


class BertPooler(nn.Module):
    def __init__(self, config: BertConfig, *, device=None, dtype=None):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=device, dtype=dtype)

    def forward(self, hidden):
        """`[B, S, H]` -> `[B, H]`: tanh of the dense layer at position 0
        (the [CLS] token)."""
        return torch.tanh(self.dense(hidden[:, 0]))


class BertModel(nn.Module):
    """Embeddings, encoder layers and (with `with_pooler`) the pooler.

    `device=None` means the CUDA card and raises without one; pass
    `device="cpu"` for the plain PyTorch path. Weights are drawn from
    `generator` (a `torch.Generator` on `device`; seed 0 when None) with
    the JAX package's init scheme. It owns `dropout_generator`, a
    `torch.Generator` on its device seeded with 0, from which every
    dropout mask of `forward` is drawn in order; a caller may reseed it or
    put another generator in its place."""

    def __init__(self, config: BertConfig, with_pooler=True, *, device=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.dropout_generator = torch.Generator(self.device).manual_seed(0)
        kw = dict(device=self.device, dtype=dtype)
        self.embeddings = BertEmbeddings(config, **kw)
        self.layers = nn.ModuleList([BertLayer(config, **kw)
                                     for _ in range(config.num_layers)])
        self.pooler = BertPooler(config, **kw) if with_pooler else None
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator):
        """N(0, initializer_range) for the embeddings and for every Linear
        weight (qkv, out, fc1, fc2, pooler), zero biases, unit LayerNorm
        weights."""
        std = self.config.initializer_range
        emb = self.embeddings
        for e in (emb.word_embeddings, emb.position_embeddings,
                  emb.token_type_embeddings):
            e.weight.normal_(0.0, std, generator=generator)
        lins = [x for layer in self.layers
                for x in (layer.attention.qkv_proj, layer.attention.out_proj,
                          layer.fc1, layer.fc2)]
        if self.pooler is not None:
            lins.append(self.pooler.dense)
        for lin in lins:
            _init_linear(lin, std, generator)
        for mod in self.modules():
            if isinstance(mod, nn.LayerNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()

    @plain_entry('BertModel')
    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                position_ids=None):
        """(hidden `[B, S, H]`, pooled `[B, H]`), or hidden alone without a
        pooler. `attention_mask` `[B, S]` holds 1 for real tokens and 0 for
        padding (the paddle/HF convention); it becomes the additive fp32
        key mask `(1 - m) * -1e30`, `[B, 1, 1, S]`."""
        attn_mask = None
        if attention_mask is not None:
            m = (1.0 - attention_mask.float()) * _MASK_VALUE
            attn_mask = m.reshape(m.shape[0], 1, 1, m.shape[1])
        g = self.dropout_generator
        h = self.embeddings(input_ids, token_type_ids, position_ids, g)
        for layer in self.layers:
            h = layer(h, attn_mask, g)
        if self.pooler is not None:
            return h, self.pooler(h)
        return h

    def num_params(self):
        return sum(p.numel() for p in self.parameters())


class ErnieModel(BertModel):
    """ERNIE shares the BERT encoder graph; its pretraining differences
    (knowledge masking, task embeddings) live in the data pipeline."""


@torch.no_grad()
def _init_linear(lin, std, generator):
    """N(0, std) weight, or with std None the JAX package's default for a
    Linear created without an initializer: Xavier normal, std sqrt(2 /
    (fan_in + fan_out)). Zero bias."""
    if std is None:
        std = math.sqrt(2.0 / (lin.in_features + lin.out_features))
    lin.weight.normal_(0.0, std, generator=generator)
    lin.bias.zero_()


class BertForSequenceClassification(nn.Module):
    """The fine-tune benchmark head (bench.py's BERT row): the pooled
    output through dropout and a Linear to `num_labels` logits.

    `device=None` means the CUDA card and raises without one; pass
    `device="cpu"` for the plain PyTorch path. Weights are drawn from
    `generator` (a `torch.Generator` on `device`; seed 0 when None) with
    the JAX package's init scheme."""

    def __init__(self, config: BertConfig, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        kw = dict(device=self.device, dtype=dtype)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.bert = BertModel(config, generator=generator, **kw)
        self.dropout = config.hidden_dropout
        self.classifier = nn.Linear(config.hidden_size, config.num_labels,
                                    **kw)
        self._init_head(generator)

    @torch.no_grad()
    def init_weights(self, generator):
        self.bert.init_weights(generator)
        self._init_head(generator)

    @torch.no_grad()
    def _init_head(self, generator):
        _init_linear(self.classifier, None, generator)

    @plain_entry('BertForSequenceClassification')
    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                labels=None):
        """Logits `[B, num_labels]`, or with `labels` `[B]` their mean
        cross entropy."""
        _, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        pooled = dropout(pooled, self.dropout, self.training,
                         self.bert.dropout_generator)
        logits = self.classifier(pooled)
        if labels is not None:
            return self.loss_fn(logits, labels)
        return logits

    def loss_fn(self, logits, labels):
        return cross_entropy(logits, labels)

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len):
        """Training FLOPs/token: 6N over the matmul parameters only (the
        embedding tables are gathers, and no tied vocab projection reuses
        them as a matmul), plus the attention score and value matmuls
        (12 * L * H * S, bidirectional)."""
        c = self.config
        emb = self.bert.embeddings
        n_embed = sum(e.weight.numel() for e in (
            emb.word_embeddings, emb.position_embeddings,
            emb.token_type_embeddings))
        n_matmul = self.num_params() - n_embed
        return 6 * n_matmul + 12 * c.num_layers * c.hidden_size * seq_len


class BertPretrainingHeads(nn.Module):
    """MLM head (transform, GELU, LayerNorm, a decoder TIED to the word
    embedding weight `[V, H]` it is given, its own bias) and the NSP head,
    as JAX's `BertPretrainingHeads(config, embedding_weight)`. The tied
    weight is no parameter of this module: a model's `state_dict()` holds
    it once, under its owner's name, as the JAX model's does."""

    def __init__(self, config: BertConfig, embedding_weight, *, device=None,
                 dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.transform = nn.Linear(config.hidden_size, config.hidden_size,
                                   **kw)
        self.layer_norm = _layer_norm(config, kw)
        # a tuple keeps nn.Module from registering the weight here; the
        # parameter object is kept, so `.to()` and loads (which write it in
        # place) reach it
        self._tied = (embedding_weight,)
        self.decoder_bias = nn.Parameter(torch.zeros(config.vocab_size,
                                                     **kw))
        self.seq_relationship = nn.Linear(config.hidden_size, 2, **kw)

    @property
    def decoder_weight(self):
        return self._tied[0]                         # [V, H]

    def forward(self, hidden, pooled):
        h = self.layer_norm(F.gelu(self.transform(hidden),
                                   approximate="tanh"))
        mlm_logits = torch.matmul(h, self.decoder_weight.t()) \
            + self.decoder_bias
        return mlm_logits, self.seq_relationship(pooled)


class BertForPretraining(nn.Module):
    """BERT with the MLM and NSP heads. `forward` with `mlm_labels` returns
    the MLM cross entropy over the labels that are not -100, plus the NSP
    cross entropy with `nsp_labels`. Device, dtype and generator as
    `BertForSequenceClassification`."""

    def __init__(self, config: BertConfig, *, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        kw = dict(device=self.device, dtype=dtype)
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        self.bert = BertModel(config, generator=generator, **kw)
        self.heads = BertPretrainingHeads(
            config, self.bert.embeddings.word_embeddings.weight, **kw)
        self._init_head(generator)

    @torch.no_grad()
    def init_weights(self, generator):
        self.bert.init_weights(generator)
        self._init_head(generator)

    @torch.no_grad()
    def _init_head(self, generator):
        h = self.heads
        _init_linear(h.transform, self.config.initializer_range, generator)
        _init_linear(h.seq_relationship, None, generator)
        h.decoder_bias.zero_()
        h.layer_norm.weight.fill_(1.0)
        h.layer_norm.bias.zero_()

    @plain_entry('BertForPretraining')
    def forward(self, input_ids, token_type_ids=None, attention_mask=None,
                mlm_labels=None, nsp_labels=None):
        hidden, pooled = self.bert(input_ids, token_type_ids, attention_mask)
        mlm_logits, nsp_logits = self.heads(hidden, pooled)
        if mlm_labels is None:
            return mlm_logits, nsp_logits
        V = self.config.vocab_size
        loss = cross_entropy(mlm_logits.reshape(-1, V),
                             mlm_labels.reshape(-1), ignore_index=-100)
        if nsp_labels is not None:
            loss = loss + cross_entropy(nsp_logits, nsp_labels)
        return loss
