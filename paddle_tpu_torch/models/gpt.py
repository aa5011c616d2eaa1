"""GPT, the flagship decoder-only LM: counterpart of paddle_tpu/models/gpt.py.

Pre-norm blocks with a fused qkv projection reshaped 3-major
(`[B, S, 3, heads, D]`), tanh GELU, LayerNorm with the config's epsilon,
and the LM head tied to `wte`. Parameter names match the JAX model's
`state_dict()` (`models/convert.py` bridges the weights).

Ported: what serving runs (`forward`, the prefill and decode paths of
`generate` and of the paged engine, the speculative verify step, the int8
KV scales those paths thread) and what training runs (`forward` with
labels and `loss_fn`, dropout where the JAX model applies it, backward
through the causal attention kernels, `num_params`, `flops_per_token`).
The paged paths update the pools
(and, with `kv_scales`, the `[layers, num_blocks, 2]` scale array) IN PLACE
and return only the hidden states. The serving forwards (`forward_prefill`
and the paged paths) also take `qweights`, the serving engine's int8 weight
snapshot (one dict a layer: `qkv_proj`, `out_proj`, `fc1` and `fc2` to
their int8 codes and scales), through which those four projections run
`ops.int8_linear` instead of the live weights (every other parameter, and
every other path, reads the live ones), and `lora`, an `ops.lora.LoraState`
(multi-tenant adapter serving), whose per-slot low-rank delta each of those
four projections adds to its output (`ops.lora.batched_lora`); a slot on
the null adapter's page adds exact zeros.

Tensor-parallel serving (the serving forwards' `tp`, a `TensorParallel`
built by the engine: the counterpart of JAX's `mp_axis` and the engine's
`_tp_arrays`): Megatron column parallelism, never a sum of partial
products. Each shard holds the qkv weight head-grouped (its heads' q, k
and v rows together), out_proj, fc1 and fc2 by output columns and wte by
vocab rows; its dots stay full length over the gathered activation, and
`_mp_all_gather` puts the columns back together, four times a layer; the
embedding is vocab-parallel (`_vocab_parallel_embed`) and the logits are
gathered once. Norms, residuals and wpe are replicated, computed once per
distinct device of the mesh. Sharded activations are lists of per-shard
tensors in mesh order, and so are the replicated ones (shards on one
device share one tensor). Without `tp` the forwards are the single-device
ones, unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch
from torch import nn
from torch.nn import functional as F

from ..device import on_device, resolve_device
from ..ops.int8_linear import int8_linear
from ..ops.nn_ops import cross_entropy, dropout, scaled_dot_product_attention
from ..ops.paged_attention import (paged_attention_step,
                                   paged_attention_step_shards,
                                   paged_prefill_chunk,
                                   paged_prefill_chunk_shards,
                                   paged_verify_window,
                                   paged_verify_window_shards)

__all__ = ["GPTConfig", "GPTForCausalLM", "GPTModel", "GPTBlock",
           "GPTAttention", "GPTMLP", "TensorParallel"]


@dataclass
class GPTConfig:
    vocab_size: int = 50304
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_seq_len: int = 1024
    intermediate_size: int = None
    dropout: float = 0.0
    layer_norm_epsilon: float = 1e-5
    initializer_range: float = 0.02
    use_bias: bool = True

    def __post_init__(self):
        if self.intermediate_size is None:
            self.intermediate_size = 4 * self.hidden_size

    @staticmethod
    def gpt_small():
        return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def gpt_medium():
        return GPTConfig(hidden_size=1024, num_layers=24, num_heads=16)

    @staticmethod
    def gpt_1p3b():
        # the BASELINE GPT-3 1.3B config
        return GPTConfig(hidden_size=2048, num_layers=24, num_heads=16,
                         max_seq_len=2048)

    @staticmethod
    def tiny(vocab=128, hidden=64, layers=2, heads=4, seq=64):
        return GPTConfig(vocab_size=vocab, hidden_size=hidden,
                         num_layers=layers, num_heads=heads, max_seq_len=seq)


# the adapter site of each projection
_LORA_SITE = {"qkv_proj": "qkv", "out_proj": "out", "fc1": "fc1",
              "fc2": "fc2"}


def _linear(lin, x, qw, name, lora=None, layer=None):
    """`lin(x)`, or with the layer's int8 snapshot `qw` the same projection
    over its codes and scales (`ops.int8_linear`); with `lora` the slots'
    adapter delta of x at `layer` added to it."""
    if qw is None:
        y = lin(x)
    else:
        q, s = qw[name]
        y = int8_linear(x, q, s, lin.bias)
    if lora is not None:
        y = lora.add(_LORA_SITE[name], y, x, layer)
    return y


# -- tensor parallel (the serving forwards' `tp`) ----------------------------

def _mp_gather_to(parts, device):
    return torch.cat([p.to(device) for p in parts], dim=-1)


def _mp_all_gather(parts, mesh):
    """Concatenate a column-parallel activation's shards (a list in mesh
    order) along the LAST axis and place the result on every shard's
    device, computed once per distinct device: the tiled all-gather of
    JAX's `_mp_all_gather`. Mesh order is the engine's head and column
    order, and gathering is pure data movement, so the result is the
    unsharded activation bit for bit."""
    on = {dev: _mp_gather_to(parts, dev) for dev in mesh.distinct}
    return [on[d] for d in mesh.devices]


def _vocab_parallel_embed(weights, token_ids, mesh):
    """Embedding lookup over a vocab-sharded table (JAX's
    `_vocab_parallel_embed`): `weights` each shard's `[V/mp, H]` rows,
    `token_ids` each shard's copy of the ids. Each shard gathers the rows
    it owns and zeroes the rows of ids it does not own; the shards' rows
    are then summed in mesh order on every distinct device. Every id hits
    exactly one shard, so the sum adds exact zeros: the unsharded gather,
    bit for bit."""
    rows = []
    for r, (w, ids) in enumerate(zip(weights, token_ids)):
        vl = w.shape[0]
        loc = ids.long() - r * vl
        inb = (loc >= 0) & (loc < vl)
        got = F.embedding(torch.clamp(loc, 0, vl - 1), w)
        rows.append(torch.where(inb[..., None], got,
                                torch.zeros((), dtype=w.dtype,
                                            device=w.device)))
    out = {}
    for dev in mesh.distinct:
        total = rows[0].to(dev)
        for x in rows[1:]:
            total = total + x.to(dev)
        out[dev] = total
    return [out[d] for d in mesh.devices]


class TensorParallel:
    """The tensor-parallel context of the serving forwards: `mesh` (a
    `distributed.ServingMesh`), `shards` (one dict a shard, in mesh order:
    `"wte"` its `[V/mp, H]` vocab rows, `"layers"` one dict a layer of
    `qkv_proj`, `out_proj`, `fc1` and `fc2` to `(weight, bias)` or, int8,
    `(codes, scale, bias)`, torch's `[out, in]` layout over the shard's
    output columns, qkv head-grouped) and `replicas` (one dict a distinct
    device: `"wpe"`, `"ln1"` and `"ln2"` a `(weight, bias)` a layer,
    `"ln_f"`, `"eps"`). The serving engine builds it (`_build_tp_state`)
    on each shard's device."""

    def __init__(self, mesh, shards, replicas):
        self.mesh = mesh
        self.shards = shards
        self.replicas = replicas

    def put(self, t, non_blocking=False):
        """A host tensor (or numpy array) copied to every shard's device,
        once per distinct device: a per-shard list. `non_blocking` copies
        from pinned staging without a wait (the engine's async core)."""
        if not torch.is_tensor(t):
            t = torch.from_numpy(t)
        if non_blocking:
            t = t.pin_memory()
        on = {dev: t.to(dev, non_blocking=non_blocking)
              for dev in self.mesh.distinct}
        return [on[d] for d in self.mesh.devices]

    def rep(self, fn, *xs):
        """Replicated work: `fn(replica, *args)` once per distinct device,
        on the first shard of that device's arguments of the per-shard
        lists `xs`; returns a per-shard list."""
        out = {}
        for r, dev in enumerate(self.mesh.devices):
            if dev not in out:
                out[dev] = fn(self.replicas[dev], *(x[r] for x in xs))
        return [out[d] for d in self.mesh.devices]

    def layer_norm(self, h, name, layer=None):
        def ln(rep, x):
            w, b = rep[name] if layer is None else rep[name][layer]
            return F.layer_norm(x, (x.shape[-1],), w, b, rep["eps"])
        return self.rep(ln, h)

    def add(self, a, b):
        return self.rep(lambda _, x, y: x + y, a, b)

    def linear(self, r, layer, name, x, lora=None):
        """Shard r's columns of projection `name` at `layer` over the
        full-length input x, its adapter delta added when `lora` (the
        per-shard `LoraState` list) is given."""
        w = self.shards[r]["layers"][layer][name]
        with on_device(x):
            y = F.linear(x, w[0], w[1]) if len(w) == 2 \
                else int8_linear(x, *w)
            if lora is not None:
                y = lora[r].add(_LORA_SITE[name], y, x, layer)
        return y


class GPTAttention(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.num_heads = config.num_heads
        self.head_dim = config.hidden_size // config.num_heads
        H = config.hidden_size
        kw = dict(bias=config.use_bias, device=device, dtype=dtype)
        self.qkv_proj = nn.Linear(H, 3 * H, **kw)   # fused qkv
        self.out_proj = nn.Linear(H, H, **kw)
        self.dropout = config.dropout

    def _qkv_heads(self, x, qw=None, lora=None, layer=None, tp=None):
        """Per-head q/k/v `[B, S, heads, D]` from the fused projection
        (3-major reshape), the adapter delta added before the unbind.
        Under `tp`: x the per-shard list of the replicated input; each
        shard's qkv weight is head-grouped (`[heads/mp * 3 * D, H]`, JAX's
        `[H, heads/mp, 3, D]`), so the same full-length dots give just its
        heads, as per-shard lists of `[B, S, heads/mp, D]`; its adapter B
        pages are head-sharded alike."""
        if tp is not None:
            B, S, _ = x[0].shape
            qkv = [tp.linear(r, layer, "qkv_proj", xr, lora).view(
                B, S, -1, 3, self.head_dim).unbind(3)
                for r, xr in enumerate(x)]
            return tuple(list(t) for t in zip(*qkv))
        B, S, _ = x.shape
        qkv = _linear(self.qkv_proj, x, qw, "qkv_proj", lora, layer).view(
            B, S, 3, self.num_heads, self.head_dim)
        return qkv.unbind(2)

    def _attn_out(self, out, B, S, qw=None, lora=None, layer=None,
                  tp=None):
        """Merge heads and apply the output projection. Under `tp` the
        shards' heads are all-gathered to the full `[B, S, H]` input
        first, each shard projects its output columns (its adapter delta
        added), and a second gather assembles them."""
        if tp is not None:
            full = _mp_all_gather([o.reshape(B, S, -1) for o in out],
                                  tp.mesh)
            return _mp_all_gather(
                [tp.linear(r, layer, "out_proj", xr, lora)
                 for r, xr in enumerate(full)], tp.mesh)
        return _linear(self.out_proj, out.reshape(B, S, -1), qw, "out_proj",
                       lora, layer)

    def forward(self, x, generator=None):
        """Causal self-attention; in training mode with dropout > 0 the
        attention output is dropped (the dense SDPA branch, as in the JAX
        model), its mask drawn from `generator`."""
        B, S, _ = x.shape
        q, k, v = self._qkv_heads(x)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True, dropout_p=self.dropout,
            training=self.training, generator=generator)
        return self._attn_out(out, B, S)

    def forward_prefill(self, x, qw=None, lora=None, layer=None):
        """Causal forward that also returns this layer's k/v."""
        B, S, _ = x.shape
        q, k, v = self._qkv_heads(x, qw, lora, layer)
        out = scaled_dot_product_attention(q, k, v, is_causal=True)
        return self._attn_out(out, B, S, qw, lora, layer), k, v

    def forward_prefill_chunk(self, x, kpool, vpool, layer_idx, block_row,
                              start, plen, kv_scales=None, qw=None,
                              lora=None):
        """Chunked prefill for ONE slot against the paged pools (updated
        in place). x `[1, C, H]`; start/plen host ints."""
        B, C, _ = x.shape
        q, k, v = self._qkv_heads(x, qw, lora, layer_idx)
        out = paged_prefill_chunk(q, k, v, kpool, vpool, layer_idx,
                                  block_row, start, plen, scales=kv_scales)
        return self._attn_out(out, B, C, qw, lora, layer_idx)

    def forward_decode(self, x, kcache, vcache, pos):
        """One-token decode against a FIXED-size cache: x `[B, 1, H]`,
        kcache/vcache `[B, L, heads, D]` written IN PLACE at host int
        `pos`; attends over positions `<= pos` through an additive mask."""
        B, _, H = x.shape
        L = kcache.shape[1]
        q, k, v = self._qkv_heads(x)
        kcache[:, pos] = k[:, 0]
        vcache[:, pos] = v[:, 0]
        allowed = torch.arange(L, device=x.device) <= pos
        attn_mask = torch.where(
            allowed, torch.zeros((), device=x.device),
            torch.full((), -1e30, device=x.device)).reshape(1, 1, 1, L)
        out = scaled_dot_product_attention(q, kcache, vcache,
                                           attn_mask=attn_mask)
        return self.out_proj(out.reshape(B, 1, H))

    def forward_decode_paged(self, x, kpool, vpool, layer_idx,
                             block_tables, positions, kv_scales=None,
                             backend="pallas", qw=None, lora=None):
        """Batched one-token decode against the global paged pools
        (updated in place): x `[slots, 1, H]`; `backend` the paged
        attention's (`dense` or `pallas`)."""
        B = x.shape[0]
        q, k, v = self._qkv_heads(x, qw, lora, layer_idx)
        out = paged_attention_step(q, k, v, kpool, vpool, layer_idx,
                                   block_tables, positions,
                                   scales=kv_scales, backend=backend)
        return self._attn_out(out, B, 1, qw, lora, layer_idx)

    def forward_verify_paged(self, x, kpool, vpool, layer_idx,
                             block_tables, positions, draft_lens,
                             kv_scales=None, backend="pallas", qw=None,
                             lora=None):
        """Speculative verify of a `[slots, W]` window against the global
        paged pools (updated in place): x `[slots, W, H]`; every live
        row's k/v lands through the table and each row attends causally
        up to its own position; each slot's adapter page serves its W
        rows."""
        B, W, _ = x.shape
        q, k, v = self._qkv_heads(x, qw, lora, layer_idx)
        out = paged_verify_window(q, k, v, kpool, vpool, layer_idx,
                                  block_tables, positions, draft_lens,
                                  scales=kv_scales, backend=backend)
        return self._attn_out(out, B, W, qw, lora, layer_idx)


class GPTMLP(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(bias=config.use_bias, device=device, dtype=dtype)
        self.fc1 = nn.Linear(config.hidden_size, config.intermediate_size,
                             **kw)
        self.fc2 = nn.Linear(config.intermediate_size, config.hidden_size,
                             **kw)
        self.dropout = config.dropout

    def forward(self, x, generator=None, qw=None, lora=None, layer=None,
                tp=None):
        """fc1, tanh GELU, fc2; `lora` adds the fc1 delta before the
        activation and the fc2 delta after fc2. Under `tp` (serving, no
        dropout) each shard computes its fc1 columns and their GELU, a
        gather assembles the hidden activation, each shard computes its
        fc2 columns over it and a second gather assembles them."""
        if tp is not None:
            h = _mp_all_gather(
                [F.gelu(tp.linear(r, layer, "fc1", xr, lora),
                        approximate="tanh") for r, xr in enumerate(x)],
                tp.mesh)
            return _mp_all_gather([tp.linear(r, layer, "fc2", hr, lora)
                                   for r, hr in enumerate(h)], tp.mesh)
        h = F.gelu(_linear(self.fc1, x, qw, "fc1", lora, layer),
                   approximate="tanh")
        out = _linear(self.fc2, h, qw, "fc2", lora, layer)
        return dropout(out, self.dropout, self.training, generator)


class GPTBlock(nn.Module):
    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        kw = dict(eps=config.layer_norm_epsilon, device=device, dtype=dtype)
        self.ln1 = nn.LayerNorm(config.hidden_size, **kw)
        self.attn = GPTAttention(config, device=device, dtype=dtype)
        self.ln2 = nn.LayerNorm(config.hidden_size, **kw)
        self.mlp = GPTMLP(config, device=device, dtype=dtype)

    def forward(self, x, generator=None):
        x = x + self.attn(self.ln1(x), generator)
        return x + self.mlp(self.ln2(x), generator)

    def _forward_tp(self, h, layer, attend, lora, tp):
        """One layer under tensor parallel: h the per-shard list of the
        replicated residual stream; `attend(layer, q, k, v)` the paged (or
        causal) attention over the per-shard heads."""
        B, S = h[0].shape[:2]
        x = tp.layer_norm(h, "ln1", layer)
        q, k, v = self.attn._qkv_heads(x, lora=lora, layer=layer, tp=tp)
        h = tp.add(h, self.attn._attn_out(attend(layer, q, k, v), B, S,
                                          lora=lora, layer=layer, tp=tp))
        x = tp.layer_norm(h, "ln2", layer)
        return tp.add(h, self.mlp(x, lora=lora, layer=layer, tp=tp))

    def forward_prefill(self, x, qw=None, lora=None, layer=None):
        a, k, v = self.attn.forward_prefill(self.ln1(x), qw, lora, layer)
        x = x + a
        return x + self.mlp(self.ln2(x), qw=qw, lora=lora, layer=layer), k, v

    def forward_prefill_chunk(self, x, kpool, vpool, layer_idx, block_row,
                              start, plen, kv_scales=None, qw=None,
                              lora=None):
        x = x + self.attn.forward_prefill_chunk(
            self.ln1(x), kpool, vpool, layer_idx, block_row, start, plen,
            kv_scales, qw, lora)
        return x + self.mlp(self.ln2(x), qw=qw, lora=lora, layer=layer_idx)

    def forward_decode(self, x, kcache, vcache, pos):
        x = x + self.attn.forward_decode(self.ln1(x), kcache, vcache, pos)
        return x + self.mlp(self.ln2(x))

    def forward_decode_paged(self, x, kpool, vpool, layer_idx, block_tables,
                             positions, kv_scales=None, backend="pallas",
                             qw=None, lora=None):
        x = x + self.attn.forward_decode_paged(
            self.ln1(x), kpool, vpool, layer_idx, block_tables, positions,
            kv_scales, backend, qw, lora)
        return x + self.mlp(self.ln2(x), qw=qw, lora=lora, layer=layer_idx)

    def forward_verify_paged(self, x, kpool, vpool, layer_idx, block_tables,
                             positions, draft_lens, kv_scales=None,
                             backend="pallas", qw=None, lora=None):
        x = x + self.attn.forward_verify_paged(
            self.ln1(x), kpool, vpool, layer_idx, block_tables, positions,
            draft_lens, kv_scales, backend, qw, lora)
        return x + self.mlp(self.ln2(x), qw=qw, lora=lora, layer=layer_idx)


def _layer(qweights, i):
    return None if qweights is None else qweights[i]


class GPTModel(nn.Module):
    """Embeddings, blocks and the final LayerNorm. It owns
    `dropout_generator`, a `torch.Generator` on its device seeded with 0,
    from which every dropout mask of `forward` is drawn in order; a caller
    may reseed it or put another generator in its place."""

    def __init__(self, config: GPTConfig, device=None, dtype=None):
        super().__init__()
        self.config = config
        self.dropout_generator = torch.Generator(
            device=device if device is not None else "cpu").manual_seed(0)
        kw = dict(device=device, dtype=dtype)
        self.wte = nn.Embedding(config.vocab_size, config.hidden_size, **kw)
        self.wpe = nn.Embedding(config.max_seq_len, config.hidden_size, **kw)
        self.blocks = nn.ModuleList([GPTBlock(config, **kw)
                                     for _ in range(config.num_layers)])
        self.ln_f = nn.LayerNorm(config.hidden_size,
                                 eps=config.layer_norm_epsilon, **kw)

    def forward(self, input_ids, position_ids=None):
        """Hidden states `[B, S, H]`; dropout after the embedding and in
        every block in training mode."""
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1],
                                        device=input_ids.device)
        g = self.dropout_generator
        h = self.wte(input_ids) + self.wpe(position_ids)
        h = dropout(h, self.config.dropout, self.training, g)
        for blk in self.blocks:
            h = blk(h, g)
        return self.ln_f(h)

    def _embed(self, token_ids, tp=None):
        """Token embedding; under `tp` the vocab-parallel lookup over the
        shards' wte rows (token_ids per-shard copies)."""
        if tp is None:
            return self.wte(token_ids)
        return _vocab_parallel_embed([s["wte"] for s in tp.shards],
                                     token_ids, tp.mesh)

    def _embed_tp(self, token_ids, pos_of, tp):
        """`_embed` plus wpe under `tp`: `pos_of(device)` the positions
        on a device, looked up once per distinct device."""
        return tp.rep(lambda rep, e: e + F.embedding(pos_of(e.device),
                                                     rep["wpe"]),
                      self._embed(token_ids, tp))

    def _forward_tp(self, h, attend, lora, tp):
        for i, blk in enumerate(self.blocks):
            h = blk._forward_tp(h, i, attend, lora, tp)
        return tp.layer_norm(h, "ln_f")

    def forward_prefill(self, input_ids, qweights=None, lora=None, tp=None):
        """Causal forward over the prompt collecting every layer's k/v,
        stacked `[layers, B, S, heads, D]`; `qweights` the serving engine's
        int8 weight snapshot or None, `lora` the slots' adapter pages
        (`ops.lora.LoraState`) or None. Positions past the position table
        (a bucket wider than it, whose padded tail the engine ignores)
        clamp into it. Under `tp` (input_ids, lora per-shard lists) the
        stacks are per-shard lists of each shard's heads."""
        if tp is not None:
            S = input_ids[0].shape[1]
            ks, vs = [[] for _ in tp.shards], [[] for _ in tp.shards]

            def attend(layer, q, k, v):
                for r in range(len(q)):
                    ks[r].append(k[r])
                    vs[r].append(v[r])
                out = []
                for a, b, c in zip(q, k, v):
                    with on_device(a):
                        out.append(scaled_dot_product_attention(
                            a, b, c, is_causal=True))
                return out

            h = self._embed_tp(input_ids, lambda dev: torch.clamp(
                torch.arange(S, device=dev), 0, self.config.max_seq_len - 1),
                tp)
            h = self._forward_tp(h, attend, lora, tp)
            return (h, [torch.stack(k) for k in ks],
                    [torch.stack(v) for v in vs])
        S = input_ids.shape[1]
        pos = torch.clamp(torch.arange(S, device=input_ids.device), 0,
                          self.config.max_seq_len - 1)
        h = self.wte(input_ids) + self.wpe(pos)
        ks, vs = [], []
        for i, blk in enumerate(self.blocks):
            h, k, v = blk.forward_prefill(h, _layer(qweights, i), lora, i)
            ks.append(k)
            vs.append(v)
        return self.ln_f(h), torch.stack(ks), torch.stack(vs)

    def forward_prefill_chunk(self, token_ids, start, kpool, vpool,
                              block_row, plen, kv_scales=None, qweights=None,
                              lora=None, tp=None):
        """Chunked paged prefill: token_ids `[1, C]`, chunk
        `[start, start + C)` of one slot's prompt padded past `plen`
        (host ints); writes each layer's k/v through `block_row` into the
        pools IN PLACE (int8 pools: quantized, `kv_scales` updated in
        place); `qweights` the int8 weight snapshot or None, `lora` the
        slot's adapter page or None. Returns hidden `[1, C, H]`. Under
        `tp` every tensor argument is a per-shard list (the pools each
        shard's planes, `kv_scales` the replicas) and so is the result."""
        if tp is not None:
            C = token_ids[0].shape[1]

            def attend(layer, q, k, v):
                return paged_prefill_chunk_shards(
                    q, k, v, kpool, vpool, layer, block_row, start, plen,
                    scales=kv_scales)

            h = self._embed_tp(token_ids, lambda dev: torch.clamp(
                start + torch.arange(C, device=dev), 0,
                self.config.max_seq_len - 1).unsqueeze(0), tp)
            return self._forward_tp(h, attend, lora, tp)
        C = token_ids.shape[1]
        # padded-tail positions clamp into the wpe table: their rows are
        # garbage the engine ignores, but the gather must stay in bounds
        pos = torch.clamp(start + torch.arange(C, device=token_ids.device),
                          0, self.config.max_seq_len - 1)
        h = self.wte(token_ids) + self.wpe(pos).unsqueeze(0)
        for i, blk in enumerate(self.blocks):
            h = blk.forward_prefill_chunk(h, kpool, vpool, i, block_row,
                                          start, plen, kv_scales,
                                          _layer(qweights, i), lora)
        return self.ln_f(h)

    def forward_decode(self, token_ids, pos, kstack, vstack):
        """One decode step: token_ids `[B, 1]`, host int `pos`,
        kstack/vstack `[layers, B, L, heads, D]` written IN PLACE. Returns
        hidden `[B, 1, H]`."""
        pemb = self.wpe(torch.tensor([pos], device=token_ids.device))
        h = self.wte(token_ids) + pemb
        for i, blk in enumerate(self.blocks):
            h = blk.forward_decode(h, kstack[i], vstack[i], pos)
        return self.ln_f(h)

    def forward_decode_paged(self, token_ids, positions, kpool, vpool,
                             block_tables, kv_scales=None, backend="pallas",
                             qweights=None, lora=None, tp=None):
        """Batched decode over the paged pools (updated IN PLACE):
        token_ids `[slots, 1]`, positions `[slots]` int32, block_tables
        `[slots, max_blocks]` int32; int8 pools with `kv_scales`; `backend`
        the paged attention's (`dense` or `pallas`); `qweights` the int8
        weight snapshot or None; `lora` the slots' adapter pages or None.
        Returns hidden `[slots, 1, H]`. Under `tp` as
        `forward_prefill_chunk`."""
        if tp is not None:
            def attend(layer, q, k, v):
                return paged_attention_step_shards(
                    q, k, v, kpool, vpool, layer, block_tables, positions,
                    scales=kv_scales, backend=backend)

            pos = dict(zip(tp.mesh.devices, positions))
            h = self._embed_tp(token_ids,
                               lambda dev: pos[dev].unsqueeze(1), tp)
            return self._forward_tp(h, attend, lora, tp)
        h = self.wte(token_ids) + self.wpe(positions).unsqueeze(1)
        for i, blk in enumerate(self.blocks):
            h = blk.forward_decode_paged(h, kpool, vpool, i, block_tables,
                                         positions, kv_scales, backend,
                                         _layer(qweights, i), lora)
        return self.ln_f(h)

    def forward_verify_paged(self, token_ids, positions, draft_lens, kpool,
                             vpool, block_tables, kv_scales=None,
                             backend="pallas", qweights=None, lora=None,
                             tp=None):
        """Speculative verify step over the paged pools (updated IN
        PLACE): token_ids `[slots, W]` (the feed token, then up to W-1
        drafted tokens), positions `[slots]` int32 (row 0's absolute
        position), draft_lens `[slots]` int32 (rows past it are dead),
        block_tables `[slots, max_blocks]` int32; int8 pools with
        `kv_scales`; `qweights` the int8 weight snapshot or None; `lora`
        the slots' adapter pages or None. Returns hidden `[slots, W, H]`
        at every window row. Under `tp` as `forward_prefill_chunk`."""
        if tp is not None:
            W = token_ids[0].shape[1]

            def attend(layer, q, k, v):
                return paged_verify_window_shards(
                    q, k, v, kpool, vpool, layer, block_tables, positions,
                    draft_lens, scales=kv_scales, backend=backend)

            pos = dict(zip(tp.mesh.devices, positions))
            h = self._embed_tp(token_ids, lambda dev: torch.clamp(
                pos[dev][:, None] + torch.arange(
                    W, device=dev, dtype=pos[dev].dtype)[None],
                0, self.config.max_seq_len - 1), tp)
            return self._forward_tp(h, attend, lora, tp)
        W = token_ids.shape[1]
        # dead rows past a slot's draft may run beyond the position table:
        # their rows are garbage the engine ignores, but the gather must
        # stay in bounds
        wpos = torch.clamp(
            positions[:, None] + torch.arange(W, device=positions.device,
                                              dtype=positions.dtype)[None],
            0, self.config.max_seq_len - 1)
        h = self.wte(token_ids) + self.wpe(wpos)
        for i, blk in enumerate(self.blocks):
            h = blk.forward_verify_paged(h, kpool, vpool, i, block_tables,
                                         positions, draft_lens, kv_scales,
                                         backend, _layer(qweights, i), lora)
        return self.ln_f(h)


class GPTForCausalLM(nn.Module):
    """The LM head ties to `wte`.

    `device=None` means the CUDA card and raises without one; pass
    `device="cpu"` for the plain PyTorch path. Weights are drawn with the
    JAX package's init scheme from `generator` (a `torch.Generator` on
    `device`; seed 0 when None): N(0, initializer_range) for the
    embeddings and projections, fc2 scaled by 1/sqrt(2 * num_layers),
    zero biases, unit LayerNorm weights. In training mode with
    `config.dropout > 0`, dropout masks come from
    `self.gpt.dropout_generator` (seeded with 0; the caller may reseed
    it)."""

    def __init__(self, config: GPTConfig, device=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.gpt = GPTModel(config, device=self.device, dtype=dtype)
        self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator=None):
        c = self.config
        if generator is None:
            generator = torch.Generator(self.device).manual_seed(0)
        std = c.initializer_range
        out_std = std / math.sqrt(2 * c.num_layers)
        g = self.gpt
        g.wte.weight.normal_(0.0, std, generator=generator)
        g.wpe.weight.normal_(0.0, std, generator=generator)
        for blk in g.blocks:
            for lin, s in ((blk.attn.qkv_proj, std), (blk.attn.out_proj, std),
                           (blk.mlp.fc1, std), (blk.mlp.fc2, out_std)):
                lin.weight.normal_(0.0, s, generator=generator)
                if lin.bias is not None:
                    lin.bias.zero_()
        for ln in [g.ln_f] + [x for b in g.blocks for x in (b.ln1, b.ln2)]:
            ln.weight.fill_(1.0)
            ln.bias.zero_()

    def forward(self, input_ids, labels=None):
        """Logits `[B, S, vocab]` (the tied projection), or with `labels`
        `[B, S]` the mean cross entropy of the logits against them (as
        given: the caller shifts them if it wants next-token targets)."""
        logits = self._logits_of(self.gpt(input_ids))
        if labels is not None:
            return self.loss_fn(logits, labels)
        return logits

    def loss_fn(self, logits, labels):
        """Mean hard-label cross entropy over every position."""
        V = self.config.vocab_size
        return cross_entropy(logits.reshape(-1, V), labels.reshape(-1))

    def num_params(self):
        return sum(p.numel() for p in self.parameters())

    def flops_per_token(self, seq_len=None):
        """Approximate training FLOPs/token (6ND + attention)."""
        c = self.config
        s = seq_len or c.max_seq_len
        return 6 * self.num_params() + 12 * c.num_layers * c.hidden_size * s

    def _logits_of(self, hidden, tp=None):
        """Tied-embedding logits: hidden @ wte^T. Under `tp` (hidden the
        per-shard list) each shard computes its vocab columns with
        full-length dots over its wte rows, and one gather assembles the
        full logits on the first shard's device, where the engine's
        argmax, acceptance walk and draws run."""
        if tp is not None:
            return _mp_gather_to([torch.matmul(h, s["wte"].t())
                                  for h, s in zip(hidden, tp.shards)],
                                 tp.mesh.devices[0])
        return torch.matmul(hidden, self.gpt.wte.weight.t())

    @torch.no_grad()
    def generate(self, input_ids, max_length=None, eos_token_id=None,
                 use_cache=False):
        """Greedy decode: input_ids `[B, S0]` -> tokens `[B, max_length]`
        (positions after an early EOS repeat EOS: finished rows freeze).

        use_cache=False reruns the causal forward over the whole buffer per
        token; use_cache=True prefills the prompt once and decodes against
        a fixed-size KV cache. Generation is eval-mode: with active dropout
        it refuses."""
        max_length = max_length or self.config.max_seq_len
        B, S0 = input_ids.shape
        if max_length < S0:
            raise ValueError(f"max_length={max_length} < prompt {S0}")
        if self.training and self.config.dropout > 0:
            raise ValueError("generate() is deterministic (no dropout) — "
                             "call model.eval() first")
        input_ids = input_ids.to(self.device)
        if use_cache:
            return self._generate_cached(input_ids, max_length,
                                         eos_token_id)
        return self._generate_plain(input_ids, max_length, eos_token_id)

    @staticmethod
    def _freeze(nxt, done, eos_token_id):
        """Finished rows keep emitting EOS; returns (nxt, done)."""
        if eos_token_id is None:
            return nxt, done
        nxt = torch.where(done, torch.full_like(nxt, eos_token_id), nxt)
        return nxt, done | (nxt == eos_token_id)

    def _generate_plain(self, input_ids, max_length, eos_token_id):
        B, S0 = input_ids.shape
        tokens = torch.zeros((B, max_length), dtype=input_ids.dtype,
                             device=self.device)
        tokens[:, :S0] = input_ids
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        pos = S0
        while pos < max_length and not bool(done.all()):
            logits = self.forward(tokens)                   # [B, L, V]
            nxt = logits[:, pos - 1].argmax(-1).to(tokens.dtype)
            nxt, done = self._freeze(nxt, done, eos_token_id)
            tokens[:, pos] = nxt
            pos += 1
        return tokens

    def _generate_cached(self, input_ids, max_length, eos_token_id):
        B, S0 = input_ids.shape
        L = max_length
        tokens = torch.zeros((B, L), dtype=input_ids.dtype,
                             device=self.device)
        tokens[:, :S0] = input_ids
        hidden, kstack, vstack = self.gpt.forward_prefill(input_ids)

        def pad_cache(c):            # [layers, B, S0, heads, D] -> L slots
            z = c.new_zeros(c.shape[:2] + (L - S0,) + c.shape[3:])
            return torch.cat([c, z], dim=2)

        kstack, vstack = pad_cache(kstack), pad_cache(vstack)
        # only the last prompt position's logits matter
        cur = self._logits_of(hidden[:, S0 - 1]).argmax(-1) \
            .to(tokens.dtype)
        done = torch.zeros(B, dtype=torch.bool, device=self.device)
        if eos_token_id is not None:
            done = cur == eos_token_id
        if S0 < L:
            tokens[:, S0] = cur
        pos = S0
        # decode: the token at `pos` goes in, the token at pos+1 comes out
        while pos < L - 1 and not bool(done.all()):
            h = self.gpt.forward_decode(cur[:, None], pos, kstack, vstack)
            nxt = self._logits_of(h)[:, 0].argmax(-1).to(tokens.dtype)
            nxt, done = self._freeze(nxt, done, eos_token_id)
            tokens[:, pos + 1] = nxt
            cur = nxt
            pos += 1
        return tokens
